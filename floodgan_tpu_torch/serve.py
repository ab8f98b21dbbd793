"""Batched inference engine and serving frontends, on the card.

The port of floodgan_tpu/serve.py:

- ``InferenceEngine``: the generator for one fixed batch shape, fed by the
  port's preprocessing.  ``aot=True`` runs one warm-up forward at that
  shape at construction, so the first request pays no kernel build and no
  cuDNN set-up.
- ``BatchingFrontend``: a dynamic micro-batcher.  Client threads submit
  single images; one worker thread owns the engine, groups requests into
  its fixed batch shape (zero-padding stragglers) and answers through
  futures.
- ``ModelRepository`` + ``serve_http``: multi-model serving over a stdlib
  ThreadingHTTPServer speaking raw ``.npy`` bodies.

    engine = InferenceEngine("pairedattention", state_dict, "all",
                             batch_size=8, image_size=512)
    outputs = engine.predict(normalized_nhwc)    # (B,S,S,3) in [0,1], on the card

    fe = BatchingFrontend(engine)
    img = fe.predict(stack)                      # thread-safe, numpy

Loading ``.ckpt`` files (``from_checkpoint``, ``add_checkpoint``) waits
for the checkpoint slice of the port.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Mapping, Optional

import numpy as np
import torch

from floodgan_tpu_torch.core.config import TOPOGRAPHY_CHANNELS
from floodgan_tpu_torch.core.device import full_f32, resolve_device
from floodgan_tpu_torch.data.transforms import apply_transformations_batch, denormalize
from floodgan_tpu_torch.models.registry import build_generator

class InferenceEngine:
    """The serving forward of one attention generator at a fixed shape.

    ``gen_params`` is the generator's ``state_dict`` (for AttentionGAN, the
    A->B generator's).  Serving is f32: ``predict`` runs under
    ``full_f32()`` (TF32 off for convolutions and matmuls), and
    ``compute_dtype`` is accepted and, as in the JAX engine, leaves the
    forward in f32.  ``wire_dtype`` is the dtype inputs are cast to on the
    host, before the copy to ``device``; they are upcast to f32 there.
    ``seed`` is kept for the JAX signature: the attention generator has no
    dropout, so the forward draws no random numbers.  ``device=None`` means
    the card, and raises when there is none.
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
        if aot:
            self.predict(torch.zeros((batch_size,) + self.input_shape))
            self._sync()

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
        x = x.to(self.wire_dtype).to(self.device)
        with full_f32(), torch.inference_mode():
            x = x.float().permute(0, 3, 1, 2).contiguous()
            out, _ = self.generator(x)
            return denormalize(out).permute(0, 2, 3, 1).contiguous()

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


class BatchingFrontend:
    """Groups concurrent single-image requests into fixed-shape batches.

    One worker thread owns the engine.  A request waits at most
    ``max_delay_ms`` for the batch to fill; partial batches are zero-padded
    to the engine's batch shape.  ``max_pending`` caps the queued backlog
    (requests not yet taken into a batch): submits beyond it fail fast with
    ``FrontendOverloaded``.  Requests already taken into a batch stop
    counting, so the next batch forms while one executes.
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
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.batched_slots = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

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
            self._queue.put((stack, fut))
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
        with self._lock:
            if self._closed:
                raise RuntimeError("frontend is closed")
            if self.max_pending is not None and self._pending + len(stacks) > self.max_pending:
                raise FrontendOverloaded(
                    f"{self._pending} requests pending + {len(stacks)} "
                    f"submitted > max_pending={self.max_pending}"
                )
            for s, fut in zip(stacks, futs):
                self._queue.put((s, fut))
            self._pending += len(stacks)
            self.requests += len(stacks)
        return futs

    def predict(self, stack: np.ndarray, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking single-image predict (thread-safe)."""
        return self.submit(stack).result(timeout=timeout)

    def stats(self) -> dict:
        with self._lock:
            b = max(self.batches, 1)
            return {
                "requests": self.requests,
                "batches": self.batches,
                "batch_size": self.engine.batch_size,
                "pending": self._pending,
                "mean_occupancy": self.batched_slots / (b * self.engine.batch_size),
            }

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # the last item (see submit)
        self._worker.join(timeout=60)

    # -------------------------------------------------------------- worker
    def _run(self) -> None:
        bs = self.engine.batch_size
        while True:
            head = self._queue.get()
            if head is None:
                return
            group = [head]
            deadline = time.monotonic() + self.max_delay
            while len(group) < bs:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    self._flush(group)
                    return
                group.append(item)
            self._flush(group)

    def _flush(self, group) -> None:
        bs = self.engine.batch_size
        # The group has left the queue: admission reopens now.
        with self._lock:
            self._pending -= len(group)
        stacks = np.stack([g[0] for g in group])
        if len(group) < bs:
            pad = np.zeros((bs - len(group),) + self.engine.input_shape, np.float32)
            stacks = np.concatenate([stacks, pad])
        try:
            out = self.engine.predict(stacks).cpu().numpy()
        except Exception as e:  # surface device errors to every waiter
            for _, fut in group:
                _fut_deliver(fut, exc=e)
            return
        with self._lock:
            self.batches += 1
            self.batched_slots += len(group)
        for i, (_, fut) in enumerate(group):
            _fut_deliver(fut, result=out[i])


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

    Returns the started ``ThreadingHTTPServer``; serve with
    ``serve_forever()`` in the caller's thread or a background one.
    """
    import io
    import json
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

    return ThreadingHTTPServer((host, port), Handler)
