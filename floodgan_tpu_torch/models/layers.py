"""Weight initialisation of the reference's ``initialise_weights``, the
batch-norm layer of the U-Net, the Pix2Pix U-Net and the BatchNorm
PatchGAN, and Pix2Pix's dropout.

Conv and transposed-conv weights ~ N(0, 0.02) with zero bias, batch-norm
scale ~ 1 + 0.02 N(0, 1) with zero bias (floodgan_tpu/models/layers.py:16-20,
``conv_init`` and ``bn_scale_init``).  The port's conv layers are plain
``nn.Conv2d`` and ``nn.ConvTranspose2d``.
"""

from __future__ import annotations

from typing import Optional

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


class Dropout(nn.Module):
    """``nn.Dropout`` as floodgan_tpu/models/layers.py:188-199 has it
    (``TorchDropout`` over ``ops.dropout``): inverted dropout, ``x / keep``
    where kept and 0 elsewhere, active in training and at inference alike.
    The reference pins the inference draws with a fixed seed, so the caller
    passes the ``torch.Generator`` (on ``x``'s device) the mask is drawn
    from.  Rate 0 is the identity and draws nothing."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout at a rate above 0 draws its mask from a generator the caller passes")
        keep = 1.0 - self.rate
        kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(kept, x / keep, torch.zeros_like(x))


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
