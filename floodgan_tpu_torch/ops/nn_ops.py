"""Image-space neural-net primitives on NCHW tensors.

Twins of the image-space subset of floodgan_tpu/ops/nn_ops.py.  The JAX
package's phase-space lowerings re-express the same math for the TPU's
layout and are not ported.  Convolutions are F.conv2d and
F.conv_transpose2d (the twins of ``conv2d`` and ``conv_transpose2d``
there); instance norm goes to the hand-written kernel on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from floodgan_tpu_torch.ops.kernels import instance_norm_act

__all__ = ["instance_norm_act", "leaky_relu", "reflect_conv2d", "reflect_pad2d"]


def reflect_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """ReflectionPad2d(pad) on (H, W)."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def reflect_conv2d(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, pad: int = 1
) -> torch.Tensor:
    """conv2d(reflect_pad2d(x, pad), w, b) for odd k = 2*pad+1 kernels (the
    trunk's pad-1 3x3 shape); ``w`` is OIHW."""
    return F.conv2d(reflect_pad2d(x, pad), w, b)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """``where(x >= 0, x, x * slope)``, the PatchGAN's stem activation."""
    return torch.where(x >= 0, x, x * negative_slope)
