"""Model-name -> architecture dispatch (floodgan_tpu/models/registry.py):
all four families.

The conditional-discriminator property (input = condition stack ⊕ RGB
image, +3 channels) belongs to Pix2Pix and PairedAttention; CycleGAN and
AttentionGAN discriminate their input-stack-shaped image alone.  Pix2Pix's
PatchGAN uses batch norm, the others instance norm.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from floodgan_tpu_torch.core.config import _check_model
from floodgan_tpu_torch.models.attention import AttentionGenerator
from floodgan_tpu_torch.models.cyclegan import CycleGANGenerator
from floodgan_tpu_torch.models.patchgan import PatchGANDiscriminator
from floodgan_tpu_torch.models.pix2pix import Pix2PixGenerator

_GENERATORS = {
    "pix2pix": Pix2PixGenerator,
    "cyclegan": CycleGANGenerator,
    "attentiongan": AttentionGenerator,
    "pairedattention": AttentionGenerator,
}

_DISC_NORM = {
    "pix2pix": "batch",
    "cyclegan": "instance",
    "attentiongan": "instance",
    "pairedattention": "instance",
}

_DISC_CONDITIONAL = {
    "pix2pix": True,
    "cyclegan": False,
    "attentiongan": False,
    "pairedattention": True,
}


def build_generator(model: str, input_channels: int, dropout_rate: float = 0.5) -> nn.Module:
    """The generator of ``model`` over ``input_channels`` channels;
    ``dropout_rate`` is Pix2Pix's (the other families have no dropout)."""
    cls = _GENERATORS[_check_model(model)]
    if cls is Pix2PixGenerator:
        return cls(input_channels=input_channels, dropout_rate=dropout_rate)
    return cls(input_channels=input_channels)


def build_discriminator(model: str, input_channels: int) -> nn.Module:
    """The PatchGAN of ``model`` over ``input_channels`` channels (the D's
    own input: for a conditional D, the stack's channels + 3)."""
    return PatchGANDiscriminator(input_channels, norm=_DISC_NORM[_check_model(model)])


def discriminator_is_conditional(model: str) -> bool:
    return _DISC_CONDITIONAL[_check_model(model)]


def generator_returns_mask(model: str) -> bool:
    """Attention generators return (output, background_mask)."""
    return _GENERATORS[_check_model(model)] is AttentionGenerator


def generator_is_segmented(model: str) -> bool:
    """The generators whose ``forward`` takes ``run``, segment by segment
    between JAX's ``seg_boundary`` marks (Pix2Pix has none)."""
    return _GENERATORS[_check_model(model)] is not Pix2PixGenerator


def generator_image(generator: nn.Module, returns_mask: bool, x: torch.Tensor,
                    dropout_generator=None, run: Optional[Callable] = None) -> torch.Tensor:
    """The generator's output image alone, whatever the family: the
    attention generators also return a mask, which is dropped; Pix2Pix
    draws its dropout from ``dropout_generator``; a segmented generator
    calls its segments through ``run`` when one is given."""
    if run is not None:
        out = generator(x, run=run)
        return out[0] if returns_mask else out
    if returns_mask:
        return generator(x)[0]
    if dropout_generator is None:
        return generator(x)
    return generator(x, dropout_generator)
