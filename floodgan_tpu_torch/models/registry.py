"""Model-name -> generator dispatch (floodgan_tpu/models/registry.py).

This slice of the port carries the attention generator only; the other
families raise until their slices land (ROADMAP.md, Queue 1)."""

from __future__ import annotations

from torch import nn

from floodgan_tpu_torch.core.config import _check_model
from floodgan_tpu_torch.models.attention import AttentionGenerator

_NOT_PORTED = {
    "pix2pix": "the Pix2Pix family (ROADMAP.md Queue 1, 'Pix2Pix family')",
    "cyclegan": "the cycle family (ROADMAP.md Queue 1, 'Cycle family')",
}


def build_generator(model: str, input_channels: int) -> nn.Module:
    model = _check_model(model)
    if model in _NOT_PORTED:
        raise NotImplementedError(
            f"{model} is not ported to floodgan_tpu_torch yet: it waits for {_NOT_PORTED[model]}"
        )
    return AttentionGenerator(input_channels=input_channels)
