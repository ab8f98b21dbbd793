"""Closed-loop serving traffic: ``clients`` requests always outstanding,
each answer followed at once by its client's next tile of the pool,
through the micro-batcher, as the tiles of one region are predicted as
one job.

The clients start together when the window opens and send no request
after it closes; the rate is the answers that came within the window over
its length.  Requests are numbered as they are sent and take the pool's
tiles in a seeded order.  A client is a chain of callbacks, not a thread:
each answer's callback (on the micro-batcher's worker, after the answer is
recorded) sends the next request, so the load comes from one process with
no client threads contending for the interpreter (with a thread a client,
serve_bench's loop, the runs of this cell spread 7-11%).  The callbacks'
time on the worker is printed beside the worker's cycle.

Parameters: ``clients``, and those of ``serving``.
"""

from __future__ import annotations

import itertools
import threading
import time

import numpy as np

from benchlib import serving
from benchlib.outcome import Outcome


class _Clients:
    """The chains of requests; ``stopped`` is set when every chain has
    ended (its next request would have been sent after ``end``)."""

    def __init__(self, served, answers: serving.Answers, order, count: int):
        self.served, self.answers, self.order, self.count = served, answers, order, count
        self.numbers, self.lock = itertools.count(), threading.Lock()
        self.sent = {}
        self.ended = 0
        self.end = float("inf")
        self.stopped = threading.Event()

    def start(self, end: float) -> None:
        self.end = end
        for _ in range(self.count):
            self.send()

    def _stop_one(self) -> None:
        with self.lock:
            self.ended += 1
            if self.ended == self.count:
                self.stopped.set()

    def on_answer(self, _answered) -> None:
        """An answer's callback, on the micro-batcher's worker: the client's
        next request; its time is added to the answers' ``callback_s``."""
        t = time.perf_counter()
        self.send()
        self.answers.add(time.perf_counter() - t)

    def send(self) -> None:
        now = time.perf_counter()
        if now >= self.end:
            self._stop_one()
            return
        with self.lock:
            k = next(self.numbers)
            self.sent[k] = now
        tile = int(self.order[k % len(self.order)])
        try:
            fut = self.served.frontend.submit(self.served.tiles[tile])
        except Exception:  # refused or closed: it counts as failed, and the chain ends
            self.answers.refused()
            self._stop_one()
            return
        self.answers.track(k, tile, fut)
        fut.add_done_callback(self.on_answer)


def run(cell, seed: int, seconds: float, trace: bool, device) -> Outcome:
    config, p = cell.config, cell.params
    served = serving.Served(config, p, seed, device, trace)
    answers = serving.Answers()
    clients = _Clients(served, answers, np.random.default_rng(seed).permutation(len(served.tiles)), p["clients"])
    before = served.stats()
    start = time.perf_counter()
    end = start + seconds
    clients.start(end)
    sl, slice_counters = serving.trace_slice(served, start, seconds, p, trace)
    time.sleep(max(0.0, end - time.perf_counter()))
    at_close = served.stats()
    clients.stopped.wait(2 * serving.GRACE_S)
    with clients.lock:
        sent = dict(clients.sent)
    attempted = len(sent)
    answers.wait(attempted, serving.GRACE_S)
    peak = served.close()
    with answers.lock:
        done, answered = dict(answers.done), set(answers.answer)
    in_window = sum(1 for k, t in done.items() if t <= end and k in answered)
    lat_ms = np.array([(done[k] - sent[k]) * 1e3 if k in answered else np.inf for k in sent])
    numbers = serving.answer_numbers(config, p, seed, device, answers, attempted)
    batches = at_close["batches"] - before["batches"]
    q = [float(v) for v in np.percentile(lat_ms, [50, 95, 99])]
    return Outcome(
        window_start=start,
        end_to_end={"serve_images_per_s": in_window / seconds},
        attempted=attempted,
        failed=attempted - len(answered),
        memory_peak_bytes=peak,
        numbers=numbers,
        window={"seconds": seconds, "requests": attempted, "answered_in_window": in_window,
                "batches": batches, "slots": at_close["slots"] - before["slots"],
                "batch_size": at_close["batch_size"]},
        counters=slice_counters,
        trace=sl,
        info=[f"closed loop: {p['clients']} clients, {attempted} requests, {in_window} answered in "
              f"{seconds} s, {batches} batches",
              f"latency ms: p50 {q[0]!r} p95 {q[1]!r} p99 {q[2]!r}",
              serving.callback_line(answers, seconds, batches),
              serving.slice_latency_line([sent[k] for k in sent], lat_ms, slice_counters)],
    )
