"""Hand-written gradients of the normalisation and padding chains: the
port of the image-space forms of floodgan_tpu/ops/fused_grads.py, on NCHW.

The JAX package's default training step reaches every instance norm,
reflect pad and batch norm through that module (its ``custom_vjp_norms``
route); so does the port's, through ``ops.nn_ops``:

- ``in_act`` and ``in_act_res``: IN(+activation)(+residual) whose forward
  saves (x, mean, inv) and whose backward reads (x, g) once for the two
  plane sums and once for dx, ``dx = inv * (g~ - mean(g~) - yhat *
  mean(g~ * yhat))``: K1 writes the statistics beside y and K2 reads them
  (``kernels.InstanceNormAct``);
- ``reflect_pad2d``: the reflect pad, whose backward is the interior slice
  plus the flipped border blocks added in a fixed order, H then W, each
  add rounded to the gradient's dtype: K6 on the card
  (``kernels.reflect_pad``).  It is deterministic, where ATen's backward
  of the pad scatters with atomics;
- ``reflect_conv2d``: conv2d(reflect_pad2d(x, pad), w, b) for k = 2*pad+1;
- ``batch_norm``: ``ops.nn_ops.batch_norm``, re-exported: training-mode
  batch norm with the closed-form backward (its two channel sums, then dx
  from their means), whose statistics and gradient sums a mesh can make
  global.

Not ported, by design: JAX's band-convolution backward of
``reflect_conv2d`` (fused_grads.py:456-563), a fix for XLA's tiling of
the full-padding transposed convolution that JAX itself keeps off the CPU
(floodgan_tpu/ops/nn_ops.py:612-631); here the pad's backward is K6 and
the convolution's is cuDNN's.  The phase-layout forms ``in_act_phases``
and ``reflect_pad_phases`` (fused_grads.py:297-456) are TPU layout
lowerings, as the port leaves all of them.

Arithmetic: the instance norm's statistics and apply run in f32 (the
kernels' policy, one cast at the store), as the JAX route runs them for
f32 inputs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from floodgan_tpu_torch.ops import kernels

__all__ = ["batch_norm", "check_reflect_kernel", "in_act", "in_act_res", "reflect_conv2d", "reflect_pad2d"]


def in_act(x: torch.Tensor, relu: bool = False, slope: float = 0.0, eps: float = kernels.EPS) -> torch.Tensor:
    """InstanceNorm (no affine, biased variance) + optional ``where(y >= 0,
    y, slope * y)`` over NCHW, with the closed-form backward from the
    saved statistics."""
    return kernels.InstanceNormAct.apply(x, None, relu, slope, eps)


def in_act_res(x: torch.Tensor, residual: torch.Tensor, relu: bool = False, slope: float = 0.0,
               eps: float = kernels.EPS) -> torch.Tensor:
    """``in_act(x, relu, slope) + residual`` (the trunk block's tail); the
    residual's gradient is g itself."""
    return kernels.InstanceNormAct.apply(x, residual, relu, slope, eps)


def reflect_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """ReflectionPad2d(pad) on (H, W), with the deterministic slice-and-add
    backward."""
    return kernels.reflect_pad(x, (pad, pad, pad, pad))


def reflect_conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], pad: int) -> torch.Tensor:
    """conv2d(reflect_pad2d(x, pad), w, b), stride 1, for odd k = 2*pad + 1
    kernels; ``w`` is OIHW."""
    check_reflect_kernel(w, pad)
    return F.conv2d(reflect_pad2d(x, pad), w, b)


def check_reflect_kernel(w: torch.Tensor, pad: int) -> None:
    """Raise unless ``w`` (OIHW) is square with k = 2*pad + 1, the shape
    the reflect convolution is derived for."""
    kh, kw = w.shape[2:]
    if kh != kw or kh != 2 * pad + 1:
        raise ValueError(f"reflect_conv2d derived for k = 2*pad+1, got k={kh} pad={pad}")


def __getattr__(name: str):
    # ``batch_norm`` lives in ops.nn_ops, which imports this module.
    if name == "batch_norm":
        from floodgan_tpu_torch.ops.nn_ops import batch_norm

        return batch_norm
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
