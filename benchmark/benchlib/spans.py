"""The spans the program records of itself while a profiler runs, read for
the per-layer metrics (metrics/*.py) through ``span_records()`` of
floodgan_tpu_torch/utils/profiling.py, the only name this module takes
from the program.

A record has ``name``, ``id``, ``parent``, ``ident``, ``start`` and
``end`` (``time.perf_counter`` seconds, the clock of the slice's bounds)
and ``device_ms``.  A program without spans gives None, as does a slice
that holds none of the records a reader needs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

# The worker's spans from a batch's head to its answers during which the
# engine has nothing on the card.  The gather's wait for a head
# (serve.gather less serve.fill) is left out: the offered load sets it.
WORKER_HOST = ("serve.fill", "serve.stack", "serve.deliver")


def _program_records() -> Optional[list]:
    try:
        from floodgan_tpu_torch.utils.profiling import span_records
    except ImportError:  # a program that records no spans
        return None
    return span_records()


def serving(ctx, overlapping: bool = False) -> Optional[List]:
    """The records whose span began in the traced serving slice
    ``[slice_from, slice_to)``, or with ``overlapping`` every record
    that shares time with it; None where there are none."""
    c = ctx.counters
    if "slice_from" not in c:
        return None
    recs = _program_records()
    if recs is None:
        return None
    lo, hi = c["slice_from"], c["slice_to"]
    if overlapping:
        recs = [r for r in recs if r.start < hi and r.end > lo]
    else:
        recs = [r for r in recs if lo <= r.start < hi]
    return recs or None


def training(ctx) -> Optional[List]:
    """The trainer's records of the traced slice (set-up's steps run with
    no profiler and make none), or None unless they hold exactly the
    slice's ``traced_steps`` steps."""
    n = ctx.window.get("traced_steps")
    if not n:
        return None
    recs = [r for r in _program_records() or () if r.name.startswith("train.")]
    if sum(r.name == "train.step" for r in recs) != n:
        return None
    return recs


def durations_ms(recs: Sequence, name: str) -> List[float]:
    return [1e3 * (r.end - r.start) for r in recs if r.name == name]


def percentile_ms(ctx, name: str, q: float) -> Optional[float]:
    """The ``q``-th percentile (numpy's linear rule) of the slice's
    ``name`` spans' lengths."""
    recs = serving(ctx)
    ms = durations_ms(recs or (), name)
    return float(np.percentile(ms, q)) if ms else None


def mean_ms(ctx, name: str) -> Optional[float]:
    ms = durations_ms(serving(ctx) or (), name)
    return float(np.mean(ms)) if ms else None


def worker_host_share(ctx) -> Optional[float]:
    """The slice's time in the worker's host spans (``WORKER_HOST``), each
    clipped to the slice, over the slice's length, in percent."""
    recs = serving(ctx, overlapping=True)
    if recs is None:
        return None
    lo, hi = ctx.counters["slice_from"], ctx.counters["slice_to"]
    host = [min(r.end, hi) - max(r.start, lo) for r in recs if r.name in WORKER_HOST]
    return 100.0 * sum(host) / (hi - lo) if host else None


def device_ms_per_step(ctx, names: Sequence[str]) -> Optional[float]:
    """The card's milliseconds a traced step in the spans ``names``."""
    recs = training(ctx)
    if recs is None:
        return None
    ms = [r.device_ms for r in recs if r.name in names]
    if not ms or any(v is None for v in ms):
        return None
    return sum(ms) / ctx.window["traced_steps"]
