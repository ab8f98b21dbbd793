"""Optimizer: torch's Adam with the reference's betas, and an LR set per
step by the caller (floodgan_tpu/train/optim.py).

The JAX package passes the LR as a traced argument of its train step, so
the reference's per-epoch LambdaLR schedule is a host-side scalar.  The
port does the same: ``apply_adam`` writes the step's LR into the
optimizer before it steps.  optax's ``scale_by_adam`` (eps outside the
sqrt, eps_root 0) and torch's Adam compute the same update.
"""

from __future__ import annotations

from typing import Iterable

import torch


def adam(params: Iterable[torch.nn.Parameter], b1: float = 0.5, b2: float = 0.999,
         eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=eps)


def apply_adam(opt: torch.optim.Optimizer, lr: float) -> None:
    """One Adam step at ``lr`` on the gradients in the parameters' ``.grad``."""
    for group in opt.param_groups:
        group["lr"] = float(lr)
    opt.step()
