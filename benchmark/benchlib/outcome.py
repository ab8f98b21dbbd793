"""What a traffic loop hands back to ``run.py``."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from benchlib.trace import Summary


@dataclasses.dataclass
class Outcome:
    window_start: float               # time.perf_counter() when the window opened
    end_to_end: Dict[str, float]      # by the end-to-end metric's name
    attempted: int
    failed: int
    memory_peak_bytes: int            # read once the window closed, before the reference ran
    numbers: Dict[str, float]         # the check's numbers, by name
    window: Dict[str, float]          # what the window did, for the per-layer readers
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Optional[Summary] = None
    info: List[str] = dataclasses.field(default_factory=list)  # lines printed ahead of the result
