"""Profiling hooks: the port of floodgan_tpu/utils/profiling.py.

``trace(profile_dir)`` records a ``torch.profiler`` trace (CPU and, where
there is a card, CUDA activity) of its body and writes it into
``profile_dir`` as a Chrome trace (open it in chrome://tracing or
Perfetto).  ``StepTimer`` is the wall-clock step timer with a warm-up
discard.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    """Profile the body into ``profile_dir/trace.json``; no-op for None."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


class StepTimer:
    """Wall-clock step timer with warm-up discard — the measurement
    convention of the reference's Inference column (models/group.py:198-200
    drops the first 5 samples).  The caller synchronises the card before
    ``stop`` when it times device work."""

    def __init__(self, warmup: int = 5):
        self.warmup = warmup
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() called before start()")
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        return dt

    @property
    def mean(self) -> float:
        kept = self.samples[self.warmup:] or self.samples
        if not kept:
            return float("nan")
        return sum(kept) / len(kept)

    @property
    def steps_per_sec(self) -> float:
        m = self.mean
        return 1.0 / m if m else float("inf")
