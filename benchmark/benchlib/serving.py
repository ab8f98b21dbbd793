"""What the two serving loops share: the engine and its micro-batcher
from the seed's weights, the pool of tiles, the warm-up, the record of
the answers, and the check of every answer against the reference.

Parameters (the mix's file, the cell's over it): ``pool_tiles``,
``max_delay_ms``, ``warmup_batches``, ``trace_at``, ``trace_seconds``.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, Tuple

import numpy as np
import torch

from benchlib import inputs, program, weights
from reference import steps as ref_steps

GRACE_S = 60.0  # how long past the window's close an answer is waited for


class Served:
    """The engine, its frontend and the tiles, warmed up (and, for a traced
    run, the profiler)."""

    def __init__(self, config: dict, params: dict, seed: int, device, trace: bool = False):
        self.config, self.device = config, device
        gen = next(iter(config["instances"]))
        self.engine = program.build_engine(config, weights.make_state(config, seed, device, only={gen})[gen],
                                           device)
        self.frontend = program.frontend(self.engine, params["max_delay_ms"])
        self.tiles = [t.numpy() for t in inputs.tile_pool(config, params["pool_tiles"], seed, device).cpu()]
        warm = [self.frontend.submit(self.tiles[i % len(self.tiles)])
                for i in range(params["warmup_batches"] * config["batch"])]
        for f in warm:
            f.result(timeout=GRACE_S)
        if trace:
            from benchlib.trace import warm_up

            warm_up()

    def stats(self) -> dict:
        s = self.frontend.stats()
        s["slots"] = round(s["mean_occupancy"] * max(s["batches"], 1) * s["batch_size"])
        return s

    def close(self) -> int:
        """Stop the frontend, free the program's state; the peak memory."""
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        self.frontend.close()
        del self.frontend, self.engine
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return peak


class Answers:
    """Each request's due time, completion time, tile and answer, filled in
    by the futures' callbacks; ``wait`` blocks until ``expected`` requests
    have ended.  ``callback_s`` sums the time those callbacks (and any the
    loop adds through ``add``) take from the thread that resolves the
    futures, the micro-batcher's worker."""

    def __init__(self):
        self.lock = threading.Lock()
        self.callback_s = 0.0  # time in the harness's callbacks, which run on the micro-batcher's worker
        self.done: Dict[int, float] = {}
        self.answer: Dict[int, Tuple[int, np.ndarray]] = {}
        self.failed = 0
        self._ended = 0
        self._expected = None
        self._all = threading.Event()

    def track(self, k: int, tile: int, fut) -> None:
        def ended(f):
            t = time.perf_counter()
            exc = f.exception()
            with self.lock:
                self.done[k] = t
                if exc is None:
                    self.answer[k] = (tile, f.result())
                else:
                    self.failed += 1
                self._end()
                self.callback_s += time.perf_counter() - t
        fut.add_done_callback(ended)

    def add(self, seconds: float) -> None:
        with self.lock:
            self.callback_s += seconds

    def refused(self) -> None:
        with self.lock:
            self.failed += 1
            self._end()

    def _end(self) -> None:
        self._ended += 1
        if self._expected is not None and self._ended >= self._expected:
            self._all.set()

    def wait(self, expected: int, timeout: float) -> None:
        with self.lock:
            self._expected = expected
            if self._ended >= expected:
                self._all.set()
        self._all.wait(max(timeout, 0.0))


def slice_latency_line(due, latency_ms, counters: dict) -> str:
    """In a traced run, the p95 of the requests due before the profiling,
    while the profiler started, in the slice, and from the slice's end on
    (the reading of its events, then the rest of the window), beside one
    another; and the slice's batches."""
    if "profiled_from" not in counters:
        return "not traced"
    due = np.asarray(due)
    edges = [-np.inf, counters["profiled_from"], counters["slice_from"], counters["slice_to"], np.inf]
    parts = []
    for name, lo, hi in zip(("before the profiling", "while it started", "in the slice", "after the slice"),
                            edges, edges[1:]):
        m = (due >= lo) & (due < hi)
        p95 = float(np.percentile(latency_ms[m], 95)) if m.any() else float("nan")
        parts.append(f"{name} {p95!r} ({int(m.sum())})")
    return (f"traced run, p95 ms of the requests due {', '.join(parts)}; the slice "
            f"{counters['slice_to'] - counters['slice_from']!r} s with {counters['slice_batches']} batches, "
            f"the profiler's start {counters['slice_from'] - counters['profiled_from']!r} s and reading "
            f"{counters['profiled_to'] - counters['slice_to']!r} s")


def callback_line(answers: Answers, seconds: float, batches: int) -> str:
    """The harness's callbacks' share of the worker's time over the window."""
    return (f"harness callbacks on the worker: {answers.callback_s!r} s, {answers.callback_s / seconds:.4%} "
            f"of the window, {1e3 * answers.callback_s / max(batches, 1)!r} ms a batch")


def trace_slice(served: Served, window_start: float, seconds: float, params: dict, trace: bool):
    """In a traced run, profile ``trace_seconds`` from ``trace_at`` of the
    window in, from this thread; (summary, frontend counters over the
    slice, and the seconds and batches of all the time the profiling
    took)."""
    if not trace:
        return None, {}
    from benchlib.trace import Slice

    time.sleep(max(0.0, window_start + params["trace_at"] * seconds - time.perf_counter()))
    sl = Slice(host=False)
    first = served.stats()
    sl.start()
    before = served.stats()
    time.sleep(params["trace_seconds"])
    after = served.stats()
    summary = sl.stop()
    last = served.stats()
    return summary, {"slice_batches": after["batches"] - before["batches"],
                     "slice_slots": after["slots"] - before["slots"],
                     "profiled_s": sl.ended - sl.began, "profiled_batches": last["batches"] - first["batches"],
                     "profiled_from": sl.began, "slice_from": sl.lo_at, "slice_to": sl.hi_at,
                     "profiled_to": sl.ended}


def answer_numbers(config: dict, params: dict, seed: int, device, answers: Answers, attempted: int,
                   precision: str = "float32") -> Dict[str, float]:
    """``answer`` and ``unanswered`` over every request of the window."""
    unanswered = attempted - len(answers.answer)
    if not answers.answer:
        return {"answer": float("inf"), "unanswered": float(unanswered)}
    gen = next(iter(config["instances"]))
    state = weights.make_state(config, seed, device, only={gen})[gen]
    tiles = inputs.tile_pool(config, params["pool_tiles"], seed, device)
    used = sorted({t for t, _ in answers.answer.values()})
    ref = ref_steps.serve_outputs(state, tiles[used], precision).cpu().numpy()
    row = {t: i for i, t in enumerate(used)}
    worst = 0.0
    for t, a in answers.answer.values():
        gap = np.abs(a - ref[row[t]])
        worst = max(worst, float(gap.max()) if np.isfinite(gap).all() else float("inf"))
    return {"answer": worst, "unanswered": float(unanswered)}
