"""Model-name -> architecture dispatch (floodgan_tpu/models/registry.py).

The port carries the attention generator and the InstanceNorm PatchGAN;
the other families raise until their slices land (ROADMAP.md, Queue 1).
The conditional-discriminator property (input = condition stack ⊕ RGB
image, +3 channels) belongs to Pix2Pix and PairedAttention.
"""

from __future__ import annotations

from torch import nn

from floodgan_tpu_torch.core.config import _check_model, model_is_attention
from floodgan_tpu_torch.models.attention import AttentionGenerator
from floodgan_tpu_torch.models.patchgan import PatchGANDiscriminator

_NOT_PORTED = {
    "pix2pix": "the Pix2Pix family (ROADMAP.md Queue 1, 'Pix2Pix family')",
    "cyclegan": "the cycle family (ROADMAP.md Queue 1, 'Cycle family')",
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


def build_generator(model: str, input_channels: int) -> nn.Module:
    model = _check_model(model)
    if model in _NOT_PORTED:
        raise NotImplementedError(
            f"{model} is not ported to floodgan_tpu_torch yet: it waits for {_NOT_PORTED[model]}"
        )
    return AttentionGenerator(input_channels=input_channels)


def build_discriminator(model: str, input_channels: int) -> nn.Module:
    """The PatchGAN of ``model`` over ``input_channels`` channels (the D's
    own input: for a conditional D, the stack's channels + 3)."""
    return PatchGANDiscriminator(input_channels, norm=_DISC_NORM[_check_model(model)])


def discriminator_is_conditional(model: str) -> bool:
    return _DISC_CONDITIONAL[_check_model(model)]


def generator_returns_mask(model: str) -> bool:
    """Attention generators return (output, background_mask)."""
    return model_is_attention(model)
