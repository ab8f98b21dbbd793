"""Weight initialisation of the reference's ``initialise_weights`` and the
batch-norm layer of the U-Net.

Conv and transposed-conv weights ~ N(0, 0.02) with zero bias, batch-norm
scale ~ 1 + 0.02 N(0, 1) with zero bias (floodgan_tpu/models/layers.py:16-20,
``conv_init`` and ``bn_scale_init``).  The port's conv layers are plain
``nn.Conv2d`` and ``nn.ConvTranspose2d``.
"""

from __future__ import annotations

import torch
from torch import nn

from floodgan_tpu_torch.ops import nn_ops


class BatchNorm2d(nn.Module):
    """BatchNorm2d permanently in training mode (``nn_ops.batch_norm``),
    with ``weight`` (the JAX ``scale``) and ``bias`` and no running
    statistics: they would never be read."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.batch_norm(x, self.weight, self.bias)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every conv weight of ``module`` from N(0, 0.02) and every
    batch-norm scale from 1 + 0.02 N(0, 1), in module order, with
    ``generator`` (a CPU generator: the draws do not depend on the device
    the module lives on), and zero every bias."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator, dtype=torch.float32) * 0.02)
        elif isinstance(m, BatchNorm2d):
            m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape, generator=generator, dtype=torch.float32))
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    return module
