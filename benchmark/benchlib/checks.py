"""The numbers that decide ``correct``, and their judgement.

Training (the program's first steps against the reference's, from the
same weights over the same batches; a cell's limits name the ones it
compares, and the others are printed beside them):
- ``loss``: the largest relative gap of any loss term of any step;
- ``loss1``: the same over the first step;
- ``grad``: over the leaves, the largest gap between the program's and the
  reference's norm of the first gradient, over the reference's norm of
  that leaf or of the median leaf, whichever is larger;
- ``grad_diff``: the same of the norm of the two first gradients'
  difference;
- ``grad_median``: the median leaf's ``grad_diff`` reading;
- ``change``: as ``grad``, of the parameters' change over the steps, over
  the leaves whose first reference gradient is at least a thousandth of
  the median leaf's (the others, such as a convolution's bias under an
  instance norm, have a gradient that is nought to rounding and move under
  Adam by round-off alone).
- ``buffer`` (cycle steps): which image each slot of both replay buffers
  holds after the steps.  Over the slots, the largest norm of the
  program's stored condition channels (those past the synthetic's three,
  which are the input tile's own, copied) less the reference's, over the
  reference's norm or the median slot's, whichever is larger; a slot that
  one side filled and the other did not reads 1.  Sound, only the
  buffer's own rounding shows; a slot holding another tile reads about
  the square root of 2.
- ``buffer_synthetic``: the same over the synthetic's three channels,
  where the generator's drift under the compute dtype shows too.

Serving (every answer the window delivered against the reference's image
of its tile):
- ``answer``: the largest absolute gap of any pixel of any answer;
- ``unanswered``: requests that failed or were never answered.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, Tuple

import torch

MOVED = 1e-3  # a leaf moves when its first reference gradient is at least this share of the median leaf's


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    floor = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor) for k in leaves}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    if set(prog["grad_norms"]) != set(ref["grad_norms"]) or len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the program's and the reference's readings are of different leaves or steps")
    by_step = [max(abs(p[k] - r[k]) / abs(r[k]) for k in r) for p, r in zip(prog["losses"], ref["losses"])]
    grads = ref["grad_norms"]
    floor = statistics.median(grads.values())
    moved = [k for k, v in grads.items() if v >= MOVED * floor]
    diffs = _diff_gaps(prog["grads"], ref["grads"], grads)
    numbers = {"loss": max(by_step), "loss1": by_step[0],
               "grad": max(_leaf_gaps(prog["grad_norms"], grads, list(grads)).values()),
               "grad_diff": max(diffs.values()), "grad_median": statistics.median(diffs.values()),
               "change": max(_leaf_gaps(prog["change_norms"], ref["change_norms"], moved).values())}
    if "buffers" in prog or "buffers" in ref:
        for name, channels in (("buffer", CONDITIONS), ("buffer_synthetic", SYNTHETIC)):
            numbers[name] = max(_buffer_gaps(prog["buffers"], ref["buffers"], channels).values(), default=0.0)
    return numbers


SYNTHETIC, CONDITIONS = slice(0, 3), slice(3, None)  # a buffered image: the synthetic RGB, then the tile's conditions


def _buffer_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], channels: slice) -> Dict[str, float]:
    """Each filled slot's gap over ``channels``, named ``<buffer>[<slot>]``."""
    if set(prog) != set(ref):
        raise ValueError("the program's and the reference's readings are of different buffers")
    gaps = {}
    for k, r in ref.items():
        p = prog[k]
        m = min(len(p), len(r))
        r = r[:, channels].float()
        norms = torch.linalg.vector_norm(r.flatten(1), dim=1)
        floor = float(norms.median()) if len(r) else 0.0
        diff = torch.linalg.vector_norm((p[:m, channels].float() - r[:m]).flatten(1), dim=1)
        gaps.update({f"{k}[{s}]": float(v) for s, v in enumerate(diff / norms[:m].clamp(min=floor))})
        gaps.update({f"{k}[{s}]": 1.0 for s in range(m, max(len(p), len(r)))})
    return gaps


def _diff_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], norms: Dict[str, float]) -> Dict[str, float]:
    floor = statistics.median(norms.values())
    return {k: float(torch.linalg.vector_norm(prog[k] - ref[k])) / max(norms[k], floor) for k in norms}


def train_detail(prog: dict, ref: dict) -> dict:
    """Which leaves set the training numbers, and each step's loss gap."""
    grads = ref["grad_norms"]
    floor = statistics.median(grads.values())
    moved = [k for k, v in grads.items() if v >= MOVED * floor]
    change = _leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    diffs = _diff_gaps(prog["grads"], ref["grads"], grads)

    def top(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:3]

    detail = {"loss_by_step": [max(abs(p[k] - r[k]) / abs(r[k]) for k in r)
                               for p, r in zip(prog["losses"], ref["losses"])],
              "grad_diff_worst": top(diffs), "change_worst": top(change),
              "left_out_of_change": len(grads) - len(moved)}
    if "buffers" in ref:
        detail["buffer_worst"] = top(_buffer_gaps(prog["buffers"], ref["buffers"], CONDITIONS))
    return detail


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every number that ``limits`` names within its limit, {name:
    {"value", "limit"}}).  A number that is not finite is not within any
    limit."""
    missing = set(limits) - set(numbers)
    if missing:
        raise ValueError(f"limits for {sorted(missing)}, which the check does not compute")
    shown = {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in shown.values())  # NaN compares false
    return ok, shown


def print_numbers(shown: Dict[str, dict]) -> None:
    """Each number beside its limit, as the last lines on standard error."""
    for k, v in shown.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
