"""Weight initialisation of the reference's ``initialise_weights``: conv and
transposed-conv weights ~ N(0, 0.02), zero bias (floodgan_tpu/models/
layers.py:16).  The port's layers are plain ``nn.Conv2d`` and
``nn.ConvTranspose2d``."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every conv weight of ``module`` from N(0, 0.02) with
    ``generator`` (a CPU generator: the draws do not depend on the device
    the module lives on) and zero every conv bias."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = torch.randn(m.weight.shape, generator=generator, dtype=torch.float32) * 0.02
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
    return module
