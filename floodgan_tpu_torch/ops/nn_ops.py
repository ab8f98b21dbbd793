"""Image-space neural-net primitives on NCHW tensors.

Twins of the image-space subset of floodgan_tpu/ops/nn_ops.py.  The JAX
package's phase-space lowerings re-express the same math for the TPU's
layout and are not ported.  Convolutions are F.conv2d and
F.conv_transpose2d (the twins of ``conv2d`` and ``conv_transpose2d``
there).  Instance norm and the reflect pads go through ``ops.fused_grads``
and their hand-written gradients, as the JAX package's default route
does (its ``custom_vjp_norms``): the instance norm's kernels on the card,
the reflect pad's backward kernel.  With a spatial group (the mesh's
``spatial`` axis) the reflect pads read their halo rows from the
neighbouring ranks and the instance norm reduces its statistics over the
group (``parallel.spatial``).  The U-Net's batch norm and max-pool were
XLA ops there, not Pallas kernels, and are ATen ops here; batch norm
spells out its statistics, and its closed-form backward its two sums, so
that a data mesh can make them global (``fused_grads`` re-exports it).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from floodgan_tpu_torch.ops import fused_grads, kernels
from floodgan_tpu_torch.parallel import spatial as spatial_lib

__all__ = [
    "batch_norm", "instance_norm_act", "leaky_relu", "max_pool2d", "pad_to_match", "reflect_conv2d",
    "reflect_pad2d",
]


def reflect_pad2d(x: torch.Tensor, pad: int, spatial=None, layer: str = "reflect pad") -> torch.Tensor:
    """ReflectionPad2d(pad) on (H, W).  With a ``spatial`` group
    (``parallel.spatial.SpatialGroup``) x holds this rank's rows of each
    image: the rows beyond them come from the neighbouring ranks, and only
    the image's own top and bottom reflect.  Without one,
    ``fused_grads.reflect_pad2d``."""
    if spatial is not None:
        return spatial_lib.reflect_pad2d(x, pad, spatial, layer)
    return fused_grads.reflect_pad2d(x, pad)


def reflect_conv2d(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, pad: int = 1, spatial=None,
    layer: str = "reflect conv",
) -> torch.Tensor:
    """conv2d(reflect_pad2d(x, pad), w, b) for odd k = 2*pad+1 kernels (the
    trunk's pad-1 3x3 shape); ``w`` is OIHW.  ``spatial`` as for
    ``reflect_pad2d``."""
    fused_grads.check_reflect_kernel(w, pad)
    return F.conv2d(reflect_pad2d(x, pad, spatial, layer), w, b)


def instance_norm_act(
    x: torch.Tensor,
    relu: bool = False,
    residual: Optional[torch.Tensor] = None,
    negative_slope: float = 0.0,
    eps: float = kernels.EPS,
    spatial=None,
) -> torch.Tensor:
    """IN(+activation)(+residual) over NCHW: ``fused_grads.in_act`` and
    ``in_act_res`` (K1 forward, K2 backward from the saved statistics).
    With a ``spatial`` group x holds this rank's rows of each plane, and
    the statistics are the group's sums (``kernels.instance_norm_act``)."""
    if spatial is not None:
        return kernels.instance_norm_act(x, relu, residual, negative_slope, eps, spatial)
    if residual is None:
        return fused_grads.in_act(x, relu, negative_slope, eps)
    return fused_grads.in_act_res(x, residual, relu, negative_slope, eps)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """``where(x >= 0, x, x * slope)``, the PatchGAN's stem activation."""
    return torch.where(x >= 0, x, x * negative_slope)


class _BatchNorm(torch.autograd.Function):
    """Training-mode batch norm whose statistics, and their gradient, a mesh
    can sum over the ranks.  Each rank's (count, mean, variance) comes from
    one Welford pass; the global count is the ranks' counts summed (a
    rank's rows may be fewer than another's), the global mean the
    count-weighted mean of the means, the global variance the ranks'
    variances about it (the pairwise form of Chan et al.); ATen's
    inference-mode batch norm then normalises with them in one pass.  The
    backward takes the two channel sums (of g and of g * x̂) from ATen's
    batch-norm backward reduction, sums them over the same ranks, and forms
    dx from the global means.  ``reduce(t)`` sums ``t`` over the ranks in
    place; without it the same arithmetic runs with no sum.  Saves x and
    the two statistics, as ATen's batch norm does."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, reduce):
        work = torch.promote_types(x.dtype, torch.float32)
        x32 = x.to(work)
        count = x.numel() // x.shape[1]
        var, mean = torch.var_mean(x32, dim=_BN_DIMS, correction=0)
        # The count rides with the sums: one reduction for both.
        mean_sum = torch.cat([mean * count, mean.new_full((1,), count)])
        if reduce is not None:
            reduce(mean_sum)
        total = mean_sum[-1]
        global_mean = mean_sum[:-1] / total
        sq = (var + (mean - global_mean).square()) * count
        if reduce is not None:
            reduce(sq)
        global_var = sq / total
        y = F.batch_norm(x32, global_mean, global_var, scale.to(work), bias.to(work), training=False, eps=eps)
        ctx.save_for_backward(x, global_mean, torch.rsqrt(global_var + eps), scale, total)
        ctx.eps, ctx.reduce, ctx.bias_dtype = eps, reduce, bias.dtype
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, mean, invstd, scale, total = ctx.saved_tensors
        work = torch.promote_types(x.dtype, torch.float32)
        x32, g32, scale32 = x.to(work), g.to(work).contiguous(), scale.to(work)
        _, sum_gx, sum_g = torch.ops.aten.native_batch_norm_backward(
            g32, x32, scale32, None, None, mean, invstd, True, ctx.eps, [False, True, True])
        sums = torch.stack([sum_g, sum_gx])
        if ctx.reduce is not None:
            ctx.reduce(sums)
        mean_g, mean_gx = (sums / total).unbind()
        a = scale32 * invstd
        # dx = a * (g - mean(g) - x̂ * mean(g * x̂)), with x̂ = (x - mean) * invstd.
        dx = torch.addcmul((-a * mean_g).view(1, -1, 1, 1), x32 - mean.view(1, -1, 1, 1),
                           (-a * invstd * mean_gx).view(1, -1, 1, 1))
        dx.addcmul_(g32, a.view(1, -1, 1, 1))
        return dx.to(x.dtype), sum_gx.to(scale.dtype), sum_g.to(ctx.bias_dtype), None, None


_BN_DIMS = (0, 2, 3)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
               reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """BatchNorm2d in training mode, always: batch statistics over (N, H, W),
    biased variance, no running statistics.  The reference never calls ``.eval()``, so
    inference normalises with the batch's own statistics too, and an
    image's result depends on the images beside it.  The statistics and the
    normalisation run in f32 for a half-precision ``x`` (in ``x``'s own
    dtype otherwise); the result has ``x``'s dtype.  ``reduce`` (a mesh's
    in-place sum over the ranks whose elements share the statistics:
    ``DataMesh.all_reduce_sum_`` or ``data_reduce_sum_``) makes them those
    of the global batch, as GSPMD's batch norm over a sharded batch
    computes them; the same arithmetic runs without one."""
    return _BatchNorm.apply(x, scale, bias, eps, reduce)


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
