"""Batched inference engine and serving frontends, on the card.

The port of floodgan_tpu/serve.py:

- ``InferenceEngine``: the generator for one fixed batch shape, fed by the
  port's preprocessing.  ``aot=True`` runs one warm-up forward at that
  shape at construction, so the first request pays no kernel build and no
  cuDNN set-up.
- ``BatchingFrontend``: a dynamic micro-batcher.  Client threads submit
  single images; one worker thread owns the engine, groups requests into
  its fixed batch shape (zero-padding stragglers) and answers through
  futures.  It stages the next batch in pinned buffers while the card
  runs the current one (``InferenceEngine.launch``).
- ``ModelRepository`` + ``serve_http``: multi-model serving over a stdlib
  ThreadingHTTPServer speaking raw ``.npy`` bodies.

    engine = InferenceEngine("pairedattention", state_dict, "all",
                             batch_size=8, image_size=512)
    outputs = engine.predict(normalized_nhwc)    # (B,S,S,3) in [0,1], on the card

    engine = InferenceEngine.from_checkpoint("model.ckpt", batch_size=8,
                                             image_size=512)

    fe = BatchingFrontend(engine)
    img = fe.predict(stack)                      # thread-safe, numpy

``from_checkpoint`` reads the ``.ckpt`` files of either package.

While a torch profiler records, the worker, the engine and each request
record spans (``utils.profiling``): ``serve.stage`` for each request as it
is staged; ``serve.gather`` (and in it ``serve.fill``, from the batch's
head on) where the worker waited for a batch's head with the card idle;
``serve.batch`` and in it ``serve.stack``, ``engine.h2d``,
``engine.forward``, ``engine.d2h``, ``serve.deliver``; ``serve.request``
and in it ``serve.queue``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from floodgan_tpu_torch.ckpt import load_checkpoint
from floodgan_tpu_torch.core.config import TOPOGRAPHY_CHANNELS, model_is_cycle
from floodgan_tpu_torch.core.device import full_f32, resolve_device
from floodgan_tpu_torch.core import rng
from floodgan_tpu_torch.data.transforms import apply_transformations_batch, denormalize
from floodgan_tpu_torch.models.registry import build_generator, generator_image, generator_returns_mask
from floodgan_tpu_torch.utils.jax_params import state_dict_from_jax
from floodgan_tpu_torch.utils.profiling import new_id, record, span, tracing, under

class InferenceEngine:
    """The serving forward of one generator, of any family, at a fixed
    shape.

    ``gen_params`` is the generator's ``state_dict`` (for a cycle family,
    the A->B generator's).  Serving is f32: ``predict`` runs under
    ``full_f32()`` (TF32 off for convolutions and matmuls), and
    ``compute_dtype`` is accepted and, as in the JAX engine, leaves the
    forward in f32.  ``wire_dtype`` is the dtype inputs are cast to on the
    host, before the copy to ``device``; they are upcast to f32 there.
    Pix2Pix's dropout stays active, as in the reference, and each forward
    draws it from a fresh seed-47 generator (floodgan_tpu/serve.py:69 uses
    the fixed inference key); ``seed`` is kept for the JAX signature.  The
    other families draw no random numbers.  ``device=None`` means the
    card, and raises when there is none.
    """

    def __init__(
        self,
        model: str,
        gen_params: Mapping[str, torch.Tensor],
        topography: Optional[str],
        batch_size: int = 1,
        image_size: int = 512,
        seed: int = 47,
        compute_dtype: str = "bfloat16",
        aot: bool = True,
        wire_dtype: str = "float32",
        device=None,
    ):
        self.device = resolve_device(device, "InferenceEngine")
        self.model = model
        self.topography = topography
        self.batch_size = batch_size
        self.image_size = image_size
        self.channels = TOPOGRAPHY_CHANNELS[topography]
        self.seed = seed
        self.compute_dtype = compute_dtype
        self.gen_params = gen_params
        self.wire_dtype = getattr(torch, wire_dtype)
        if not self.wire_dtype.is_floating_point:
            raise ValueError(f"wire_dtype must be a float dtype, got {wire_dtype!r}")
        generator = build_generator(model, self.channels)
        generator.load_state_dict(gen_params)
        self.generator = generator.to(self.device).eval()
        self.returns_mask = generator_returns_mask(model)
        self.has_dropout = model == "pix2pix"
        if aot:
            self.predict(torch.zeros((batch_size,) + self.input_shape))
            self._sync()

    @classmethod
    def from_checkpoint(
        cls, ckpt_path: str, batch_size: int = 1, image_size: int = 512, **kwargs
    ) -> "InferenceEngine":
        """The engine of a ``.ckpt`` file's generator: the model and
        topography come from its meta, the weights from
        ``raw["gen_params"]`` (for a cycle-family file, the A->B
        generator's, ``raw["gen_params"]["ab"]``)."""
        meta, raw = load_checkpoint(ckpt_path)
        model, topography = meta["model"], meta["topography"]
        tree = raw["gen_params"]["ab"] if model_is_cycle(model) else raw["gen_params"]
        gen_params = state_dict_from_jax(build_generator(model, TOPOGRAPHY_CHANNELS[topography]), tree)
        return cls(model, gen_params, topography, batch_size=batch_size, image_size=image_size, **kwargs)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def preprocess(self, stacks, resize: Optional[int] = None) -> torch.Tensor:
        """Raw [0,1] 9-channel NHWC stacks -> the normalized, sliced,
        resized model input, on the engine's device."""
        b = stacks.shape[0]
        with full_f32():
            x, _ = apply_transformations_batch(
                stacks,
                np.zeros((b, stacks.shape[1], stacks.shape[2], 3), np.float32),
                np.zeros(b, bool),
                np.zeros(b, np.int32),
                topography=self.topography,
                resize=resize or self.image_size,
                crop=None,
                device=self.device,
            )
        return x

    def predict(self, inputs) -> torch.Tensor:
        """Normalized (B, S, S, C) inputs -> (B, S, S, 3) images in [0,1],
        a tensor on the engine's device (asynchronous on the card)."""
        x = inputs if torch.is_tensor(inputs) else torch.from_numpy(np.asarray(inputs, np.float32))
        with span("engine.h2d"):
            x = x.to(self.wire_dtype).to(self.device)
        with span("engine.forward", device=self.device), full_f32(), torch.inference_mode():
            x = x.float().permute(0, 3, 1, 2).contiguous()
            dropout = rng.inference(self.device) if self.has_dropout else None
            out = generator_image(self.generator, self.returns_mask, x, dropout)
            return denormalize(out).permute(0, 2, 3, 1).contiguous()

    def launch(self, x: torch.Tensor, out: torch.Tensor):
        """``predict`` of ``x``, a (B, S, S, C) batch already on the device
        in the wire dtype, with its (B, S, S, 3) images copied into ``out``
        (pinned host memory, for the card) without waiting.  Returns the
        CUDA event recorded after the copy, or None on the CPU, where the
        work is done on return."""
        out.copy_(self.predict(x), non_blocking=True)
        if self.device.type != "cuda":
            return None
        done = torch.cuda.Event(blocking=True)  # a waiting thread sleeps rather than spins
        done.record(torch.cuda.current_stream(self.device))
        return done

    @property
    def input_shape(self):
        return (self.image_size, self.image_size, self.channels)

    def benchmark(self, iters: int = 20) -> dict:
        """Host-clock latency of ``predict`` on an input already on the
        device, each call waited for."""
        x = torch.zeros((self.batch_size,) + self.input_shape, device=self.device)
        self.predict(x)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            self.predict(x)
        self._sync()
        dt = (time.perf_counter() - t0) / iters
        return {"latency_ms": dt * 1e3, "images_per_sec": self.batch_size / dt}


# ===================================================== dynamic micro-batching

class FrontendOverloaded(RuntimeError):
    """Raised by BatchingFrontend.submit when the pending backlog is at
    ``max_pending``: the caller should shed load or retry later."""


def _fut_deliver(fut: Future, result=None, exc=None) -> None:
    """Deliver a result or exception to a waiter's Future, tolerating
    futures that the client cancelled after submit: set_result on a
    cancelled future raises InvalidStateError, which would otherwise kill
    the batcher's worker thread and hang every later request."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except Exception:
        pass  # cancelled (or already resolved) waiter: nothing to deliver


class _Buffers(NamedTuple):
    """One batch's staging buffers, allocated once per frontend."""

    host: torch.Tensor  # (B, S, S, C) in the wire dtype, pinned for the card
    device: torch.Tensor  # the same on the engine's device
    out: torch.Tensor  # (B, S, S, 3) f32 images, pinned for the card


class _Batch:
    """A batch in the worker's pipeline: its number (its spans' ident), its
    buffer set, its requests, and what its spans and completion need."""

    def __init__(self, number: int, buffers: int, head_at: float, deadline: float, gather):
        self.number, self.buffers, self.head_at, self.deadline = number, buffers, head_at, deadline
        self.gather = gather  # (start, traced) of the card-idle wait for its head, or None
        self.group: list = []
        self.exc: Optional[BaseException] = None
        self.bid: Optional[int] = None  # its serve.batch span's id, taken at the close when traced
        self.closed = self.launched = self.completed = None
        self.event = None


class BatchingFrontend:
    """Groups concurrent single-image requests into fixed-shape batches.

    One worker thread owns the engine.  A request waits at most
    ``max_delay_ms`` for the batch to fill; partial batches are zero-padded
    to the engine's batch shape.  ``max_pending`` caps the queued backlog
    (requests not yet taken into a batch): submits beyond it fail fast with
    ``FrontendOverloaded``.  Requests already taken into a batch stop
    counting, so the next batch forms while one executes.

    The worker pipelines batches over two sets of buffers.  It copies each
    request, as it takes it, into its slot of the next batch's host buffer
    (pinned for the card) and starts that slot's copy to the card on a side
    stream, while the card runs the current batch.  A next batch that fills
    is launched behind the running one at once; a partial one when the
    running one completes.  A watcher thread waits for each launched
    batch's event and hands the batch back to the worker, which launches
    the next batch and then answers this one.  With the card idle, a batch
    closes as above, when full or at its head's deadline.  On a CPU engine
    the buffers are plain and a batch is done at launch.
    """

    def __init__(
        self,
        engine: InferenceEngine,
        max_delay_ms: float = 5.0,
        max_pending: Optional[int] = None,
    ):
        self.engine = engine
        self.max_delay = max_delay_ms / 1e3
        self.max_pending = max_pending
        self._pending = 0
        self._queue: "queue.Queue" = queue.Queue()  # requests, close()'s None, completed batches
        self._closed = False
        self._lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.batched_slots = 0
        self.staged_while_busy = 0
        dev = engine.device
        cuda = dev.type == "cuda"
        shape = (engine.batch_size,) + engine.input_shape
        self._buffers = [
            _Buffers(torch.empty(shape, dtype=engine.wire_dtype, pin_memory=cuda),
                     torch.empty(shape, dtype=engine.wire_dtype, device=dev),
                     torch.empty(shape[:-1] + (3,), pin_memory=cuda))
            for _ in range(2)
        ]
        self._copies = torch.cuda.Stream(dev) if cuda else None  # the slots' copies to the card
        # The worker's pipeline (its thread alone touches these).
        self._free = list(range(len(self._buffers)))
        self._staging: Optional[_Batch] = None  # the next batch, filling
        self._inflight: "collections.deque[_Batch]" = collections.deque()  # launched, oldest first
        self._held: collections.deque = collections.deque()  # taken while no buffer set is free
        self._idle_since = None  # (start, traced) of the card-idle wait for a head
        self._opened = 0
        self._launched: "queue.Queue" = queue.Queue()  # batches for the watcher, then None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._watcher = threading.Thread(target=self._watch, daemon=True)
        self._worker.start()
        self._watcher.start()

    # -------------------------------------------------------------- client
    def _check_shape(self, stack: np.ndarray) -> None:
        if stack.shape != self.engine.input_shape:
            raise ValueError(f"expected {self.engine.input_shape}, got {stack.shape}")

    def submit(self, stack: np.ndarray) -> Future:
        """Enqueue one (S, S, C) normalized input; returns a Future whose
        result is the (S, S, 3) prediction in [0, 1], as numpy."""
        stack = np.asarray(stack, np.float32)
        self._check_shape(stack)
        fut: Future = Future()
        submitted = time.perf_counter()
        # The closed-check and the enqueue are one atomic section, and
        # close() enqueues its sentinel inside the same lock, so the
        # sentinel is the last item the worker sees.
        with self._lock:
            if self._closed:
                raise RuntimeError("frontend is closed")
            if self.max_pending is not None and self._pending >= self.max_pending:
                raise FrontendOverloaded(
                    f"{self._pending} requests pending (max_pending={self.max_pending})"
                )
            self._pending += 1
            self._queue.put((stack, fut, submitted, self.requests, tracing()))
            self.requests += 1
        return fut

    def submit_many(self, stacks) -> list:
        """Admit a list of (S, S, C) inputs atomically: either every one is
        enqueued (returned as futures, in order) or none is and
        ``FrontendOverloaded`` raises."""
        stacks = [np.asarray(s, np.float32) for s in stacks]
        for s in stacks:
            self._check_shape(s)
        futs = [Future() for _ in stacks]
        submitted = time.perf_counter()
        with self._lock:
            if self._closed:
                raise RuntimeError("frontend is closed")
            if self.max_pending is not None and self._pending + len(stacks) > self.max_pending:
                raise FrontendOverloaded(
                    f"{self._pending} requests pending + {len(stacks)} "
                    f"submitted > max_pending={self.max_pending}"
                )
            traced = tracing()
            for k, (s, fut) in enumerate(zip(stacks, futs)):
                self._queue.put((s, fut, submitted, self.requests + k, traced))
            self._pending += len(stacks)
            self.requests += len(stacks)
        return futs

    def predict(self, stack: np.ndarray, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking single-image predict (thread-safe)."""
        return self.submit(stack).result(timeout=timeout)

    def stats(self) -> dict:
        """Counters since construction; ``staged_while_busy`` counts the
        requests staged while a batch was on the card."""
        with self._lock:
            b = max(self.batches, 1)
            return {
                "requests": self.requests,
                "batches": self.batches,
                "batch_size": self.engine.batch_size,
                "pending": self._pending,
                "mean_occupancy": self.batched_slots / (b * self.engine.batch_size),
                "staged_while_busy": self.staged_while_busy,
            }

    def close(self) -> None:
        """Answer every request admitted so far, the batches in flight
        included, then stop the worker and the watcher."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # the last request item (see submit)
        self._worker.join(timeout=60)
        self._watcher.join(timeout=60)

    # -------------------------------------------------------------- worker
    # A queued request is (stack, future, submit time, request number,
    # whether a profiler recorded at its submit).  Spans (utils.profiling):
    # serve.stage for each request as it is staged, naming its batch;
    # serve.gather (and in it serve.fill, from the head's arrival on) for a
    # batch whose head the worker waited for with the card idle; a batch's
    # serve.batch, from its close to its answers, holding serve.stack,
    # engine.h2d and engine.forward at the close, engine.d2h from the copy
    # back's start to the watcher's sight of its end, and serve.deliver.
    # A request's serve.request and serve.queue (submit to its batch's
    # close) are recorded as it is answered, where a profiler recorded at
    # its submit or records then.
    def _run(self) -> None:
        bs = self.engine.batch_size
        closing = False
        while not closing or self._inflight or self._staging is not None:  # held requests imply a batch in flight
            if self._idle_since is None and not self._inflight and self._staging is None:
                self._idle_since = (time.perf_counter(), tracing())
            timeout = None
            if self._staging is not None and not self._inflight:
                # The card is idle: the batch closes when full, at its head's
                # deadline, or on close().
                timeout = self._staging.deadline - time.perf_counter()
                if closing or timeout <= 0 or len(self._staging.group) == bs:
                    self._launch()
                    continue
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                continue
            if item is None:
                closing = True
            elif isinstance(item, _Batch):
                self._complete(item)
            else:
                self._take(item)
        self._launched.put(None)

    def _take(self, item) -> None:
        """Stage a request into the next batch, opening one on a free buffer
        set, or hold it while both sets are in flight.  A batch that fills
        while the card is busy is launched behind the one that runs."""
        if self._staging is None:
            if not self._free:
                self._held.append(item)
                return
            now = time.perf_counter()
            gather = None if self._inflight else self._idle_since
            self._staging = _Batch(self._opened, self._free.pop(), now, now + self.max_delay, gather)
            self._opened += 1
            self._idle_since = None
        batch, busy = self._staging, bool(self._inflight)
        bufs, slot = self._buffers[batch.buffers], len(batch.group)
        with span("serve.stage", ident=batch.number):
            if batch.exc is None:
                try:
                    bufs.host[slot].copy_(torch.from_numpy(item[0]))  # the wire cast, as predict's
                    with torch.cuda.stream(self._copies) if self._copies is not None else contextlib.nullcontext():
                        bufs.device[slot].copy_(bufs.host[slot], non_blocking=True)
                except Exception as e:  # reaches the batch's waiters at its close
                    batch.exc = e
        batch.group.append(item)
        with self._lock:
            self._pending -= 1  # admission reopens as a request is staged
            self.staged_while_busy += busy
        if busy and len(batch.group) == self.engine.batch_size:
            self._launch()

    def _launch(self) -> None:
        """Close the next batch and start it on the card, behind the batch
        that runs there, if any; a batch that fails here is answered at
        once."""
        batch, self._staging = self._staging, None
        batch.closed = time.perf_counter()
        if batch.gather is not None:
            gather_from, traced = batch.gather
            if traced or tracing():
                gid = record("serve.gather", gather_from, batch.closed)
                record("serve.fill", batch.head_at, batch.closed, parent=gid)
        if tracing():
            batch.bid = new_id()
        if batch.exc is None:
            bufs = self._buffers[batch.buffers]
            try:
                with under(batch.bid):
                    with span("serve.stack"):
                        bufs.device[len(batch.group):].zero_()  # no earlier batch's tile reaches the forward
                        if self._copies is not None:  # the forward follows the slots' copies
                            torch.cuda.current_stream(self.engine.device).wait_stream(self._copies)
                    batch.event = self.engine.launch(bufs.device, bufs.out)
                batch.launched = time.perf_counter()
            except Exception as e:  # surface device errors to the batch's waiters
                batch.exc = e
        if batch.exc is not None:
            self._deliver(batch)
            return
        self._inflight.append(batch)
        self._launched.put(batch)

    def _watch(self) -> None:
        """The watcher: wait for each launched batch's event in turn
        (``Event.synchronize`` releases the interpreter), then hand the
        batch back to the worker through its queue."""
        while True:
            batch = self._launched.get()
            if batch is None:
                return
            try:
                if batch.event is not None:
                    batch.event.synchronize()
            except Exception as e:  # a device error surfaces at the batch's event
                batch.exc = e
            batch.completed = time.perf_counter()
            self._queue.put(batch)

    def _complete(self, batch: _Batch) -> None:
        """The oldest batch in flight has ended: launch the next batch, full
        or not, answer this one, then stage the requests held meanwhile."""
        self._inflight.popleft()
        if self._staging is not None:
            self._launch()
        self._deliver(batch)
        while self._held and (self._staging is not None or self._free):
            self._take(self._held.popleft())

    def _deliver(self, batch: _Batch) -> None:
        """Answer the batch's waiters, each with its own copy of its image
        (the buffer is reused), and free its buffer set."""
        if batch.exc is None:
            with self._lock:
                self.batches += 1
                self.batched_slots += len(batch.group)
        with under(batch.bid), span("serve.deliver"):
            out = self._buffers[batch.buffers].out.numpy()
            for i, (_, fut, submitted, k, traced) in enumerate(batch.group):
                _fut_deliver(fut, None if batch.exc is not None else out[i].copy(), batch.exc)
                if traced or tracing():
                    rid = record("serve.request", submitted, time.perf_counter(), ident=k)
                    record("serve.queue", submitted, batch.closed, ident=batch.number, parent=rid)
        self._free.append(batch.buffers)
        if batch.bid is not None:
            if batch.completed is not None:
                record("engine.d2h", batch.launched, batch.completed, parent=batch.bid)
            record("serve.batch", batch.closed, time.perf_counter(), ident=batch.number, rid=batch.bid)


# ========================================================== multi-model serving

class ModelRepository:
    """Named set of engines, each behind its own BatchingFrontend; their
    worker threads serialize device access."""

    def __init__(self):
        self._frontends: dict = {}

    def add(
        self,
        name: str,
        engine: InferenceEngine,
        max_delay_ms: float = 5.0,
        max_pending: Optional[int] = None,
    ) -> None:
        if name in self._frontends:
            raise ValueError(f"model {name!r} already registered")
        self._frontends[name] = BatchingFrontend(
            engine, max_delay_ms=max_delay_ms, max_pending=max_pending
        )

    def add_checkpoint(self, name: str, ckpt_path: str, **engine_kwargs) -> None:
        self.add(name, InferenceEngine.from_checkpoint(ckpt_path, **engine_kwargs))

    def frontend(self, name: str) -> BatchingFrontend:
        try:
            return self._frontends[name]
        except KeyError:
            raise KeyError(f"unknown model {name!r}; have {sorted(self._frontends)}")

    def predict(self, name: str, stack: np.ndarray) -> np.ndarray:
        return self.frontend(name).predict(stack)

    def models(self) -> dict:
        return {
            name: {
                "input_shape": fe.engine.input_shape,
                "model": fe.engine.model,
                "topography": fe.engine.topography,
                **fe.stats(),
            }
            for name, fe in self._frontends.items()
        }

    def close(self) -> None:
        for fe in self._frontends.values():
            fe.close()


def serve_http(repo: ModelRepository, host: str = "127.0.0.1", port: int = 8000):
    """Expose a ModelRepository over HTTP (stdlib only).

    - ``POST /v1/models/<name>:predict``  body: one ``.npy`` array, either
      (S, S, C) or (N, S, S, C); response: ``.npy`` predictions.
    - ``GET /v1/models``  JSON model list + per-model batching stats.
    - ``GET /healthz``

    Status codes: 404 unknown route or model, 400 bad header or body, 413
    body over the limit (``FLOODGAN_SERVE_MAX_BATCH`` images of the input
    shape, default 64), 503 with ``"retry": true`` when admission control
    refuses, 500 for a failed forward.

    Returns the started ``ThreadingHTTPServer`` (listening with the
    kernel's largest backlog, not socketserver's 5, so that a burst of
    clients is answered rather than reset); serve with ``serve_forever()``
    in the caller's thread or a background one.
    """
    import io
    import json
    import socket
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet on the serving path
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/v1/models":
                self._json(200, repo.models())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if not (self.path.startswith("/v1/models/") and self.path.endswith(":predict")):
                return self._json(404, {"error": f"no route {self.path}"})
            name = self.path[len("/v1/models/"):-len(":predict")]
            try:
                fe = repo.frontend(name)
            except KeyError as e:
                return self._json(404, {"error": str(e)})
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                return self._json(400, {"error": "bad Content-Length header"})
            if length < 0:
                # -1 would make rfile.read block until client EOF.
                return self._json(400, {"error": "negative Content-Length"})
            # Bound the body before reading it: N_max images of the input
            # shape (f64 worst case) plus npy header slack.
            max_body = 8 * int(
                os.environ.get("FLOODGAN_SERVE_MAX_BATCH", "64")
            ) * int(np.prod(fe.engine.input_shape)) + 4096
            if length > max_body:
                return self._json(413, {"error": f"body {length} bytes exceeds limit {max_body}"})
            try:
                arr = np.load(io.BytesIO(self.rfile.read(length)), allow_pickle=False)
            except Exception as e:
                return self._json(400, {"error": f"bad .npy body: {e}"})
            single = arr.ndim == 3
            batch = arr[None] if single else arr
            if batch.ndim != 4 or batch.shape[1:] != fe.engine.input_shape:
                return self._json(400, {
                    "error": f"expected (N,)+{fe.engine.input_shape}, got {arr.shape}"
                })
            try:
                futs = fe.submit_many(list(batch))
                out = np.stack([f.result(timeout=120) for f in futs])
            except FrontendOverloaded as e:
                return self._json(503, {"error": str(e), "retry": True})
            except Exception as e:
                return self._json(500, {"error": str(e)})
            buf = io.BytesIO()
            np.save(buf, out[0] if single else out)
            self._send(200, buf.getvalue(), "application/octet-stream")

    class Server(ThreadingHTTPServer):
        # socketserver listens with a backlog of 5: a burst of more clients
        # connecting at once overflows the accept queue, and they see resets
        # or time out.  Let the kernel's own cap (somaxconn) bound it.
        request_queue_size = socket.SOMAXCONN

    return Server((host, port), Handler)
