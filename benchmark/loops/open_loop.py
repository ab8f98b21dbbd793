"""Open-loop serving traffic: single tiles arriving as independent users
send them, at a fixed mean rate, through the micro-batcher.

The schedule is fixed before the window opens: ``round(rate * seconds)``
arrivals whose gaps are the exponential distribution's quantiles at
(k + 1/2) / n, in an order drawn from the seed (so every seed offers the
same set of gaps, and so the same load, in another order), scaled to
span the window; each request takes a tile of the pool, in a seeded
order.  One thread submits each request when it is due; each is timed
from when it was due to when its answer came, so a stall counts against
every request behind it.  Every request due in the window is waited for
up to a minute past the close; one never answered counts as failed and
as infinitely late.

Parameters: ``rate_per_s`` (the cell's), and those of ``serving``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from benchlib import serving
from benchlib.outcome import Outcome


def schedule(rate: float, seconds: float, seed: int):
    """(arrival times from the window's start, tile order) of the window."""
    n = max(1, round(rate * seconds))
    rng = np.random.default_rng(seed)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng.shuffle(gaps)
    arrivals = (np.cumsum(gaps) - gaps) * (seconds / gaps.sum())
    return arrivals, rng


def window(served, rate: float, seconds: float, seed: int, params: dict, trace: bool = False) -> dict:
    """Run one open-loop window; what it measured."""
    arrivals, rng = schedule(rate, seconds, seed)
    n = len(arrivals)
    tiles = rng.permutation(np.arange(n) % len(served.tiles))
    answers = serving.Answers()
    sent = np.full(n, np.nan)

    def offer(start: float) -> None:
        for k in range(n):
            delay = start + arrivals[k] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            sent[k] = time.perf_counter()
            try:
                fut = served.frontend.submit(served.tiles[tiles[k]])
            except Exception:  # refused or closed: it counts as failed
                answers.refused()
                continue
            answers.track(k, int(tiles[k]), fut)

    before = served.stats()
    start = time.perf_counter()
    offerer = threading.Thread(target=offer, args=(start,))
    offerer.start()
    sl, slice_counters = serving.trace_slice(served, start, seconds, params, trace)
    offerer.join()
    answers.wait(n, start + seconds + serving.GRACE_S - time.perf_counter())
    after = served.stats()
    due = start + arrivals
    latency = np.array([answers.done.get(k, np.inf) - due[k] for k in range(n)])
    latency[[k for k in range(n) if k not in answers.answer]] = np.inf
    late = sent - due
    half = n // 2
    return {
        "start": start, "n": n, "answers": answers, "latency_s": latency, "due": due,
        "late_s": late, "slice": sl, "slice_counters": slice_counters,
        "batches": after["batches"] - before["batches"], "slots": after["slots"] - before["slots"],
        "batch_size": after["batch_size"],
        "first_half_median_s": float(np.median(latency[:half])) if half else float("nan"),
        "second_half_median_s": float(np.median(latency[half:])),
        "unfinished_at_close": int(sum(1 for k in range(n) if answers.done.get(k, np.inf) > start + seconds)),
    }


def run(cell, seed: int, seconds: float, trace: bool, device) -> Outcome:
    config, p = cell.config, cell.params
    served = serving.Served(config, p, seed, device, trace)
    w = window(served, p["rate_per_s"], seconds, seed, p, trace)
    peak = served.close()
    lat_ms = w["latency_s"] * 1e3
    answers = w["answers"]
    numbers = serving.answer_numbers(config, p, seed, device, answers, w["n"])
    q = [float(v) for v in np.percentile(lat_ms, [50, 95, 99])]
    return Outcome(
        window_start=w["start"],
        end_to_end={"serve_p95_ms": q[1]},
        attempted=w["n"],
        failed=w["n"] - len(answers.answer),
        memory_peak_bytes=peak,
        numbers=numbers,
        window={"seconds": seconds, "requests": w["n"], "batches": w["batches"], "slots": w["slots"],
                "batch_size": w["batch_size"]},
        counters=w["slice_counters"],
        trace=w["slice"],
        info=[f"open loop: {w['n']} requests at {p['rate_per_s']} /s over {seconds} s, {w['batches']} batches, "
              f"{w['slots']} slots",
              f"latency ms: p50 {q[0]!r} p95 {q[1]!r} p99 {q[2]!r} max {float(lat_ms.max())!r}",
              f"latency median s, first half {w['first_half_median_s']!r}, second half "
              f"{w['second_half_median_s']!r}; unanswered at the close {w['unfinished_at_close']}",
              f"offered late ms: p99 {float(np.percentile(w['late_s'] * 1e3, 99))!r} "
              f"max {float(np.nanmax(w['late_s']) * 1e3)!r}",
              serving.callback_line(answers, seconds, w["batches"]),
              serving.slice_latency_line(w["due"], lat_ms, w["slice_counters"])],
    )
