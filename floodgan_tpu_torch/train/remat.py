"""Rematerialisation of the generator reads: the port of the JAX trainers'
``remat`` option (floodgan_tpu/train/paired.py:107-118, 270-284,
train/cycle.py:196-205, 225-250, train/seg.py:38-40, 65).

A rematerialised read keeps less of its forward for the backward and
recomputes the rest there.  Every policy is a non-reentrant
``torch.utils.checkpoint.checkpoint``: the reentrant form does not run
under ``backward(inputs=...)``, which the G updates use.  The policies:

- ``"full"`` saves the region's inputs only and replays the whole read;
- ``"boundaries"`` checkpoints one segment at a time, between the
  generators' ``seg_boundary`` marks (``forward(x, run=...)`` of the
  attention and CycleGAN generators), so each segment's output is what is
  saved.  A generator without marks (Pix2Pix) replays whole, as JAX's
  ``save_only_these_names`` with no named tensor does;
- ``"convs"`` saves the convolutions' outputs and recomputes the rest (the
  instance norms, the pads, the compose), JAX's policy of saving
  ``conv_general_dilated`` alone.  It is selective activation
  checkpointing: ``CONV_OPS``, the aten ops a convolution or transposed
  convolution reaches the policy as under autocast, are ``MUST_SAVE`` and
  everything else ``PREFER_RECOMPUTE``.  The hand-written kernels are no
  aten ops, so their forwards run again, as JAX's policy recomputes its
  Pallas calls.

A recompute runs inside the backward, where no autocast region is open:
the checkpoint restores the autocast state it recorded, so callers start
it inside their region.  It stops once the tensors the backward needs are
back (``set_checkpoint_early_stop``, on by default), but in these
generators every region ends in an op that saves a tensor after it ran
(an IN or the compose: an autograd Function packs its saved inputs after
its forward), so each recompute runs every forward kernel of its region
once more.

On the mesh's spatial axis a segment holds halo exchanges and the
instance norms' all-reduces (``parallel.spatial``).  Its recompute issues
them again, inside the backward, under every policy: ``"convs"`` replays
them with every other op but the convolutions.  Every rank's graph is the same, so the
backward reaches each recompute at the same point, and the early stop, at
the same saved tensor, on every rank: the exchanges pair up.  The
recomputed statistics are the forward's, bit for bit (the same sums in the
same order).

An explicit ``torch.Generator`` (Pix2Pix's dropout) is not among the
states a checkpoint stashes; ``replayable`` rewinds it at the start of the
region, so the recompute draws the masks the forward drew.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

PAIRED_POLICIES = ("boundaries", "full")
CYCLE_POLICIES = ("convs", "boundaries", "full")

# The op a convolution reaches the policy as, on the CPU and on the card,
# with autocast on or off: F.conv2d and F.conv_transpose2d both dispatch
# aten.convolution, whose backend variants (cudnn_convolution, mkldnn,
# slow) run beneath the policy's dispatch mode and never reach it.
CONV_OPS = frozenset({torch.ops.aten.convolution.default})


def check_policy(policy: str, allowed) -> str:
    """``policy`` itself, or JAX's ``ValueError`` for one ``allowed`` lacks."""
    if policy not in allowed:
        raise ValueError(f"unknown remat_policy {policy!r}")
    return policy


def _convs_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in CONV_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _convs_context():
    return create_selective_checkpoint_contexts(_convs_policy)


def recompute(fn: Callable, *args, policy: str = "full"):
    """``fn(*args)`` whose activations are recomputed in the backward:
    all of them (``"full"``; with the default policy it is also the
    ``run`` a segmented generator takes under ``"boundaries"``, one
    checkpoint a segment) or all but the convolutions' outputs
    (``"convs"``)."""
    if policy == "convs":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=_convs_context)
    return checkpoint(fn, *args, use_reentrant=False)


def replayable(fn: Callable, generator: Optional[torch.Generator]) -> Callable:
    """``fn`` that first sets ``generator`` back to the state it has now,
    so that a recompute draws what the forward drew, and the generator
    ends where one forward leaves it."""
    if generator is None:
        return fn
    state = generator.get_state()

    @functools.wraps(fn)
    def rewound(*args):
        generator.set_state(state)
        return fn(*args)

    return rewound
