"""The arithmetic the per-layer metrics' readers share (metrics/*.py).

A reader returns None where it finds nothing to read: no traced slice, a
slice in which the kernels it times did not run, a card whose peak is not
in the table.  Shares are in percent.
"""

from __future__ import annotations

from typing import Optional, Sequence

from benchlib import counts
from benchlib.device import PRECISION_OF


def per_step_s(ctx, categories: Sequence[str]) -> Optional[float]:
    """Device seconds a traced step in ``categories``, or None unless each
    of them ran in the slice."""
    t = ctx.trace
    if t is None or not ctx.window.get("traced_steps"):
        return None
    if any(t.category_s.get(c, 0.0) <= 0.0 for c in categories):
        return None
    return sum(t.category_s[c] for c in categories) / ctx.window["traced_steps"]


def device_ms_per_step(ctx, category: str) -> Optional[float]:
    s = per_step_s(ctx, [category])
    return None if s is None else s * 1e3


def roofline(ctx, nbytes: float, categories: Sequence[str]) -> Optional[float]:
    """The least time of ``nbytes`` at the card's bandwidth over the traced
    time a step of the kernels that move them, in percent."""
    s = per_step_s(ctx, categories)
    return None if s is None else 100.0 * nbytes / ctx.hbm_bytes_per_s / s


def train_work(ctx) -> counts.Work:
    return counts.work(ctx.config, "train")


def step_mfu(ctx) -> Optional[float]:
    """The benchmark's operations of the window's steps over the window's
    length, both without the traced slice (the profiler slows the steps
    it records), against the dense peak of the compute dtype."""
    peak = ctx.peak_tflops(PRECISION_OF[ctx.config["compute_dtype"]])
    w = ctx.window
    if peak is None or not w.get("untraced_steps"):
        return None
    return 100.0 * train_work(ctx).flops * w["untraced_steps"] / w["untraced_seconds"] / (peak * 1e12)


def engine_mfu(ctx) -> Optional[float]:
    """The forward operations of the images the engine answered in the
    slice (not the padding) over the device's busy time in it, against
    the dense peak of the serving dtype."""
    t, c = ctx.trace, ctx.counters
    peak = ctx.peak_tflops(PRECISION_OF[ctx.config["serve_dtype"]])
    if t is None or peak is None or not c.get("slice_slots") or t.busy_s <= 0.0:
        return None
    return 100.0 * counts.work(ctx.config, "serve").flops * c["slice_slots"] / t.busy_s / (peak * 1e12)


def idle_share(ctx) -> Optional[float]:
    t = ctx.trace
    if t is None or t.window_s <= 0.0 or t.device_events == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
