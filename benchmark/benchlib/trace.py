"""A traced slice of the window, and what is read from it.

``torch.profiler`` runs over a short, steady slice of the window; the
device's kernels and copies inside it are summed by kernel-name category
and by name, their union is the device's busy time, and the gaps between
them are attributed to what the host was doing.  A training slice traces
CPU and CUDA activity, and is marked by a ``record_function`` range; a
serving slice, whose host work is what the cell measures, traces CUDA
activity alone (recording every host operation slowed the micro-batcher's
worker), and is bounded by the wall clock read at its start and stop, the
clock the profiler's timestamps count from; an idle gap that no traced
host call (such as a CUDA runtime call) spans is named by the device
operation that ended it.

``CATEGORIES``, ``TRAIN_CATEGORIES``, ``category`` and ``busy_us`` are
frozen copies of floodgan_tpu_torch/serve_profile.py:33-61 and
floodgan_tpu_torch/train_profile.py:37-45.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

# First match wins; names are matched lower-cased.
CATEGORIES = (
    ("in_act (K1)", ("in_act_kernel",)),
    ("attention_compose (K3)", ("compose_kernel",)),
    ("reflect pad", ("reflection_pad",)),
    ("host<->card copy", ("memcpy htod", "memcpy dtoh")),
    ("convolution", ("conv", "cudnn", "xmma", "gemm", "winograd", "fft", "dgrad", "fprop",
                     "wgrad", "cutlass", "implicit")),
)

# Ahead of the serving categories: first match wins.
TRAIN_CATEGORIES = (
    ("in_bwd (K2)", ("in_bwd_kernel",)),
    ("reflect_pad_bwd (K6)", ("reflect_pad_bwd_kernel",)),
    ("attention_compose_bwd (K4)", ("compose_bwd_kernel",)),
    ("cuDNN layout transform", ("nchwtonhwc", "nhwctonchw")),
    ("Adam", ("multi_tensor_apply",)),
    ("copies and casts", ("copy_kernel",)),
) + CATEGORIES

SLICE = "benchmark_slice"
TOP = 10           # entries of each breakdown list
LABELLED_GAPS = 2000


def category(name: str, categories=TRAIN_CATEGORIES) -> str:
    low = name.lower()
    for label, keys in categories:
        if any(k in low for k in keys):
            return label
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    category_s: Dict[str, float]
    name_s: Dict[str, float]
    idle_gaps: List[Tuple[str, float]]
    device_events: int


class Slice:
    """The profiler over one slice: ``start()``, the slice's work,
    ``stop()``, which returns the slice's summary; both wait for the
    device, so the slice holds whole kernels.  ``host`` traces the host's
    operations too.  ``began`` and ``ended`` bracket all the time the
    profiling took from the window, the reading of its events included;
    ``lo_at`` and ``hi_at`` the slice itself (``time.perf_counter``)."""

    def __init__(self, host: bool = True):
        self.host = host
        self.prof = None
        self._range = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.began = time.perf_counter()
        torch.cuda.synchronize()
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.host else [])
        self.prof = profile(activities=activities)
        self.prof.start()
        self._lo_ns = time.time_ns()
        self.lo_at = time.perf_counter()
        if self.host:
            self._range = torch.profiler.record_function(SLICE)
            self._range.__enter__()

    def stop(self) -> Summary:
        """Stop, and read the slice at once, while every thread that ran in
        it is still alive (read after the micro-batcher's worker had ended,
        the profiler's events held none of its kernels)."""
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        hi_ns = time.time_ns()
        self.hi_at = time.perf_counter()
        if self.host:
            self._range.__exit__(None, None, None)
        self.prof.stop()
        events = self.prof.events()
        if self.host:
            mark = next(e for e in events if e.name == SLICE and e.device_type == DeviceType.CPU)
            lo, hi = mark.time_range.start, mark.time_range.end
        else:
            base = self.prof.profiler.kineto_results.trace_start_ns()
            lo, hi = (self._lo_ns - base) * 1e-3, (hi_ns - base) * 1e-3
        by_cat, by_name, spans = collections.Counter(), collections.Counter(), []
        host = []
        for e in events:
            start, end = e.time_range.start, e.time_range.end
            if e.name == SLICE or getattr(e, "is_user_annotation", False):
                continue
            if e.device_type == DeviceType.CUDA:
                start, end = max(start, lo), min(end, hi)
                if end <= start:
                    continue
                by_cat[category(e.name)] += (end - start) * 1e-6
                by_name[e.name] += (end - start) * 1e-6
                spans.append((start, end, e.name))
            elif end > start:
                host.append((start, end, e.name))
        busy = busy_us([sp[:2] for sp in spans])
        self.ended = time.perf_counter()
        return Summary(window_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6, category_s=dict(by_cat),
                       name_s=dict(by_name), idle_gaps=_idle_gaps(spans, host, lo, hi),
                       device_events=len(spans))


def warm_up() -> None:
    """Start and stop the profiler once on the card, so that a slice in the
    window does not pay the tracing library's first start (part of a
    traced run's set-up)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def _idle_gaps(spans, host, lo, hi) -> List[Tuple[str, float]]:
    """The device's idle time in the slice, summed by the innermost traced
    host operation running at the middle of each gap, or where there is
    none, by the category of the device operation that ended the gap
    (the longest gaps)."""
    gaps, cur = [], lo
    for start, end, name in sorted(spans):
        if start > cur:
            gaps.append((cur, start, f"host, until {category(name)}"))
        cur = max(cur, end)
    if hi > cur:
        gaps.append((cur, hi, "host, until the slice's end"))
    gaps.sort(key=lambda g: g[0] - g[1])
    if host:
        hs = np.array([h[0] for h in host])
        he = np.array([h[1] for h in host])
        length = he - hs
    by_label = collections.Counter()
    for start, end, until in gaps[:LABELLED_GAPS]:
        label = until
        if host:
            mid = 0.5 * (start + end)
            inside = np.flatnonzero((hs <= mid) & (he >= mid))
            if inside.size:
                label = host[inside[np.argmin(length[inside])]][2]
        by_label[label] += (end - start) * 1e-6
    return by_label.most_common(TOP)


def breakdown(summary: Summary) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time in the slice, and the idle gaps by what the host was doing, in
    seconds over the slice."""
    return {"device_ops": [[name[:160], s] for name, s in collections.Counter(summary.name_s).most_common(TOP)],
            "idle_gaps": [[label[:160], s] for label, s in summary.idle_gaps]}
