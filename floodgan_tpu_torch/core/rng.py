"""Named random streams on explicit ``torch.Generator``s: the port's
version of floodgan_tpu/core/rng.py.

The reference pins randomness with ``torch.manual_seed`` at three points:
parameter initialisation, each epoch, and before every inference-time
generator call (dropout stays active at evaluation).  The JAX package
reproduces those semantics with ``jax.random`` keys; the port does with
seeded generators.  Bit parity with ``jax.random`` is impossible and is
not attempted.

- ``init(seed)``: the CPU generator that draws the initial weights.
- ``epoch(e, step)``: the draws of training step ``step`` of epoch ``e``
  (Pix2Pix dropout masks, replay-buffer choices).  It depends on (e, step)
  only, as the JAX package's ``fold_in(epoch(e), step)`` does, so a
  resumed run draws what an unbroken run draws.
- ``inference()``: always seed 47, the reference's ``manual_seed(47)``
  before evaluation-time generator calls, whatever the run's seed is.
"""

from __future__ import annotations

import torch

INFERENCE_SEED = 47
_MASK64 = (1 << 64) - 1


def _mix(*words: int) -> int:
    """A 63-bit seed from a sequence of integers (splitmix64 over each
    word in turn), so that nearby (epoch, step) pairs seed unrelated
    streams."""
    z = 0x9E3779B97F4A7C15
    for w in words:
        z = (z + (w & _MASK64) + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


def init(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def epoch(epoch: int, step: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_mix(epoch, step))


def inference(device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(INFERENCE_SEED)
