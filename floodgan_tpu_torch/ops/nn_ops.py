"""Image-space neural-net primitives on NCHW tensors.

Twins of the image-space subset of floodgan_tpu/ops/nn_ops.py.  The JAX
package's phase-space lowerings re-express the same math for the TPU's
layout and are not ported.  Convolutions are F.conv2d and
F.conv_transpose2d (the twins of ``conv2d`` and ``conv_transpose2d``
there); instance norm goes to the hand-written kernel on the card.  The
U-Net's batch norm and max-pool were XLA ops there, not Pallas kernels,
and go to cuDNN and ATen here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from floodgan_tpu_torch.ops.kernels import instance_norm_act

__all__ = [
    "batch_norm", "instance_norm_act", "leaky_relu", "max_pool2d", "pad_to_match", "reflect_conv2d",
    "reflect_pad2d",
]


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


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm2d in training mode, always: batch statistics over (N, H, W),
    biased variance, no running statistics.  The reference never calls
    ``.eval()``, so inference normalises with the batch's own statistics
    too, and an image's result depends on the images beside it.  The
    statistics and the normalisation run in f32 for a half-precision ``x``
    (in ``x``'s own dtype otherwise); the result has ``x``'s dtype."""
    work = torch.promote_types(x.dtype, torch.float32)
    y = F.batch_norm(x.to(work), None, None, scale.to(work), bias.to(work), training=True, eps=eps)
    return y.to(x.dtype)


def max_pool2d(x: torch.Tensor, window: int = 2, stride: Optional[int] = None) -> torch.Tensor:
    """MaxPool2d(window), no padding.  Its gradient goes to the first
    maximum of each window in scan order, as XLA's select-and-scatter
    sends it; after BN and ReLU many windows are all-zero ties."""
    return F.max_pool2d(x, window, stride or window)


def pad_to_match(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Zero-pad H and W up to the target, the smaller half first
    (``F.pad([dX//2, dX-dX//2, dY//2, dY-dY//2])``, the U-Net's up path)."""
    dh, dw = target_h - x.shape[2], target_w - x.shape[3]
    return F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
