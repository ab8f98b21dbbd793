"""The hand-written CUDA kernels of the port, their plain PyTorch versions,
their autograd Functions and their launch counters.

- ``instance_norm_act_fwd`` (csrc/instance_norm.cu, K1) replaces the TPU
  kernel ``_in_fwd_kernel`` of floodgan_tpu/ops/pallas_kernels.py, and
  ``instance_norm_act_bwd`` (K2, same file) replaces ``_in_bwd_kernel``;
- ``attention_compose_fwd`` (csrc/attention_compose.cu, K3) replaces
  ``_compose_kernel``, and ``attention_compose_bwd`` (K4, same file)
  replaces ``_compose_bwd_kernel``;
- ``row_copy_fwd`` (csrc/row_copy.cu, K5) replaces ``copy_kernel``, the
  Pallas layout fence of tools/microbench_head.py;
- the partial forms of K1 and K2 (csrc/instance_norm.cu) serve a plane
  whose rows are split over the ranks of the mesh's spatial axis:
  ``instance_norm_stats`` (K1s) and ``instance_norm_apply`` (K1a) around a
  sum of the per-plane statistics over the ranks, and
  ``instance_norm_bwd_stats`` (K2s) and ``instance_norm_bwd_apply`` (K2a)
  around a sum of the per-plane gradient sums.  JAX runs K1/K2 on a
  gathered tensor there (a ``pallas_call`` cannot be partitioned).

``InstanceNormAct``, ``SpatialInstanceNormAct`` and ``AttentionCompose`` pair each forward with its
backward, as the JAX package's custom VJPs do; ``instance_norm_act`` and
``attention_compose`` are the entry points the models call.  With grad
disabled they launch the forward kernels only.  ``RowCopy`` (entry point
``row_copy``) has a forward only, as the Pallas fence has.

A wrapper takes the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises: a failed build, a refused
launch, and a dtype, shape, layout or device the kernel does not take all
raise.  ``LAUNCHES`` counts the kernel launches, and nothing else, so a run
can show that its path went through the kernels.

Layout is NCHW: an instance-norm plane is one contiguous (n, c) slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from floodgan_tpu_torch.ops import _build

LAUNCHES = {"in_act": 0, "in_bwd": 0, "compose": 0, "compose_bwd": 0, "copy": 0,
            "in_stats": 0, "in_apply": 0, "in_bwd_stats": 0, "in_bwd_apply": 0}

EPS = 1e-5


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed with cudaError {err} "
            f"({torch.cuda.get_device_name()})"
        )


def _cuda_operand(t: torch.Tensor, like: torch.Tensor, name: str) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {like.dtype}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    """The kernels' arithmetic type: f32, or wider for a wider input (the
    float64 gradient checks)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ============================================================ instance norm

_IN_ENTRY = {torch.float32: "floodgan_in_act_f32", torch.bfloat16: "floodgan_in_act_bf16"}
_IN_BWD_ENTRY = {torch.float32: "floodgan_in_bwd_f32", torch.bfloat16: "floodgan_in_bwd_bf16"}


def _plane_stats(x32: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = x32.mean(dim=(2, 3), keepdim=True)
    meansq = (x32 * x32).mean(dim=(2, 3), keepdim=True)
    return mean, torch.rsqrt(meansq - mean * mean + eps)


def instance_norm_act_plain(
    x: torch.Tensor,
    relu: bool = False,
    residual: Optional[torch.Tensor] = None,
    negative_slope: float = 0.0,
    eps: float = EPS,
) -> torch.Tensor:
    """InstanceNorm2d (no affine, biased variance) + optional
    ``where(y >= 0, y, slope * y)`` + optional residual, on NCHW.  The
    kernel's arithmetic: f32 statistics in the E[x^2] - mean^2 form, f32
    apply, one cast to x's dtype at the end."""
    x32 = _f32(x)
    mean, inv = _plane_stats(x32, eps)
    y = (x32 - mean) * inv
    if relu:
        y = torch.where(y >= 0.0, y, y * negative_slope)
    if residual is not None:
        y = y + _f32(residual)
    return y.to(x.dtype)


def instance_norm_act_bwd_plain(
    x: torch.Tensor,
    g: torch.Tensor,
    relu: bool = False,
    negative_slope: float = 0.0,
    eps: float = EPS,
) -> torch.Tensor:
    """dx of ``instance_norm_act_plain`` from its input x and the gradient
    g of its output, in K2's order: the statistics again, yhat, g~ = g *
    (yhat >= 0 ? 1 : slope) with the activation on, then dx = inv * (g~ -
    mean(g~) - yhat * mean(g~ * yhat)); f32, one cast to x's dtype.  The
    residual's gradient is g itself."""
    x32 = _f32(x)
    g32 = _f32(g)
    mean, inv = _plane_stats(x32, eps)
    yh = (x32 - mean) * inv
    if relu:
        g32 = torch.where(yh >= 0.0, g32, g32 * negative_slope)
    mg = g32.mean(dim=(2, 3), keepdim=True)
    mgy = (g32 * yh).mean(dim=(2, 3), keepdim=True)
    return (inv * (g32 - mg - yh * mgy)).to(x.dtype)


def _in_cuda_checks(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{name}: expected NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _IN_ENTRY:
        raise ValueError(f"{name}: no kernel for {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be NCHW-contiguous")


def _same_layout(t: torch.Tensor, x: torch.Tensor, what: str, name: str) -> None:
    _cuda_operand(t, x, what)
    if t.shape != x.shape or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous and of x's shape")


def instance_norm_act_fwd(
    x: torch.Tensor,
    relu: bool = False,
    residual: Optional[torch.Tensor] = None,
    negative_slope: float = 0.0,
    eps: float = EPS,
) -> torch.Tensor:
    """K1: IN(+activation)(+residual) over an NCHW tensor: the CUDA kernel
    for a CUDA tensor (f32 or bf16, contiguous), the plain version for a
    CPU tensor.  With both, the activation applies before the add."""
    if x.device.type == "cpu":
        return instance_norm_act_plain(x, relu, residual, negative_slope, eps)
    _in_cuda_checks(x, "instance_norm_act")
    if residual is not None:
        _same_layout(residual, x, "residual", "instance_norm_act")
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    fn = getattr(_build.library(), _IN_ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            y.data_ptr(),
            n * c,
            h * w,
            int(relu),
            float(negative_slope),
            float(eps),
            _stream(x),
        )
    _check_launch(err, "instance_norm_act")
    LAUNCHES["in_act"] += 1
    return y


def instance_norm_act_bwd(
    x: torch.Tensor,
    g: torch.Tensor,
    relu: bool = False,
    negative_slope: float = 0.0,
    eps: float = EPS,
) -> torch.Tensor:
    """K2: dx of ``instance_norm_act_fwd`` from the saved input x and the
    output's gradient g: the CUDA kernel for CUDA tensors (f32 or bf16,
    both contiguous, of one dtype and shape), the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return instance_norm_act_bwd_plain(x, g, relu, negative_slope, eps)
    _in_cuda_checks(x, "instance_norm_act_bwd")
    _same_layout(g, x, "g", "instance_norm_act_bwd")
    n, c, h, w = x.shape
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    fn = getattr(_build.library(), _IN_BWD_ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(),
            g.data_ptr(),
            dx.data_ptr(),
            n * c,
            h * w,
            int(relu),
            float(negative_slope),
            float(eps),
            _stream(x),
        )
    _check_launch(err, "instance_norm_act_bwd")
    LAUNCHES["in_bwd"] += 1
    return dx


class InstanceNormAct(torch.autograd.Function):
    """K1 forward, K2 backward.  Saves the pre-norm x only, as
    ``_fused_in_fwd`` does; the backward recomputes the statistics.  The
    residual's gradient passes g through."""

    @staticmethod
    def forward(ctx, x, residual, relu, negative_slope, eps):
        ctx.save_for_backward(x)
        ctx.args = (relu, negative_slope, eps)
        ctx.has_residual = residual is not None
        return instance_norm_act_fwd(x, relu, residual, negative_slope, eps)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        relu, negative_slope, eps = ctx.args
        g = g.contiguous()  # autograd may hand over a view
        dx = instance_norm_act_bwd(x, g, relu, negative_slope, eps) if ctx.needs_input_grad[0] else None
        dres = g if ctx.has_residual and ctx.needs_input_grad[1] else None
        return dx, dres, None, None, None


# ------------------------------------------ the partial forms (spatial axis)
#
# A statistics buffer holds 2 * planes + 1 values: (sum x, sum x^2) of each
# (n, c) plane, then the plane's row count.  ``instance_norm_stats`` gives
# this rank's; summed over the ranks that hold the plane's rows, it is the
# whole plane's, with n = rows * W.  The plain versions work in x's type
# promoted to f32 (float64 for the gradient checks).

_IN_STATS_ENTRY = {torch.float32: "floodgan_in_stats_f32", torch.bfloat16: "floodgan_in_stats_bf16"}
_IN_APPLY_ENTRY = {torch.float32: "floodgan_in_apply_f32", torch.bfloat16: "floodgan_in_apply_bf16"}
_IN_BWD_STATS_ENTRY = {torch.float32: "floodgan_in_bwd_stats_f32", torch.bfloat16: "floodgan_in_bwd_stats_bf16"}
_IN_BWD_APPLY_ENTRY = {torch.float32: "floodgan_in_bwd_apply_f32", torch.bfloat16: "floodgan_in_bwd_apply_bf16"}


def _summed_stats(x: torch.Tensor, stats: torch.Tensor, eps: float):
    """(mean, inv, n) of each plane of x from a summed statistics buffer:
    mean and inv shaped (N, C, 1, 1), n the global element count."""
    nb, c, _, w = x.shape
    planes = nb * c
    n = stats[2 * planes] * w
    sums = stats[:2 * planes].view(nb, c, 1, 1, 2)
    mean = sums[..., 0] / n
    return mean, torch.rsqrt(sums[..., 1] / n - mean * mean + eps), n


def instance_norm_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """K1s's function: the statistics buffer of x's rows."""
    x32 = _f32(x)
    sums = torch.stack([x32.sum(dim=(2, 3)), (x32 * x32).sum(dim=(2, 3))], -1).reshape(-1)
    return torch.cat([sums, sums.new_tensor([x.shape[2]])])


def instance_norm_apply_plain(x, stats, relu=False, residual=None, negative_slope=0.0, eps=EPS):
    """K1a's function: ``instance_norm_act_plain``'s apply with the
    statistics of a summed buffer."""
    x32 = _f32(x)
    mean, inv, _ = _summed_stats(x, stats.to(x32.dtype), eps)
    y = (x32 - mean) * inv
    if relu:
        y = torch.where(y >= 0.0, y, y * negative_slope)
    if residual is not None:
        y = y + _f32(residual)
    return y.to(x.dtype)


def _yhat_gtilde(x, g, stats, relu, negative_slope, eps):
    x32, g32 = _f32(x), _f32(g)
    mean, inv, n = _summed_stats(x, stats.to(x32.dtype), eps)
    yh = (x32 - mean) * inv
    if relu:
        g32 = torch.where(yh >= 0.0, g32, g32 * negative_slope)
    return yh, g32, inv, n


def instance_norm_bwd_stats_plain(x, g, stats, relu=False, negative_slope=0.0, eps=EPS):
    """K2s's function: (sum g~, sum g~ * yhat) of each plane of x's rows,
    2 * planes values, yhat from the summed statistics."""
    yh, g32, _, _ = _yhat_gtilde(x, g, stats, relu, negative_slope, eps)
    return torch.stack([g32.sum(dim=(2, 3)), (g32 * yh).sum(dim=(2, 3))], -1).reshape(-1)


def instance_norm_bwd_apply_plain(x, g, stats, gsums, relu=False, negative_slope=0.0, eps=EPS):
    """K2a's function: ``instance_norm_act_bwd_plain``'s dx with the summed
    statistics and gradient sums."""
    yh, g32, inv, n = _yhat_gtilde(x, g, stats, relu, negative_slope, eps)
    sums = gsums.to(g32.dtype).view(x.shape[0], x.shape[1], 1, 1, 2)
    return (inv * (g32 - sums[..., 0] / n - yh * (sums[..., 1] / n))).to(x.dtype)


def _stats_operand(t: torch.Tensor, x: torch.Tensor, size: int, what: str, name: str) -> None:
    if t.device != x.device or t.dtype != torch.float32 or t.shape != (size,) or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous f32 vector of {size} on {x.device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def instance_norm_stats(x: torch.Tensor) -> torch.Tensor:
    """K1s: the statistics buffer of x's rows, f32: the CUDA kernel for a
    CUDA tensor (f32 or bf16, contiguous), the plain version for a CPU
    tensor."""
    if x.device.type == "cpu":
        return instance_norm_stats_plain(x)
    name = "instance_norm_stats"
    _in_cuda_checks(x, name)
    n, c, h, w = x.shape
    stats = torch.empty(2 * n * c + 1, device=x.device, dtype=torch.float32)
    fn = getattr(_build.library(), _IN_STATS_ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), stats.data_ptr(), n * c, h * w, float(h), _stream(x))
    _check_launch(err, name)
    LAUNCHES["in_stats"] += 1
    return stats


def instance_norm_apply(x, stats, relu=False, residual=None, negative_slope=0.0, eps=EPS):
    """K1a: IN(+activation)(+residual) of x's rows with the statistics of a
    summed buffer: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if x.device.type == "cpu":
        return instance_norm_apply_plain(x, stats, relu, residual, negative_slope, eps)
    name = "instance_norm_apply"
    _in_cuda_checks(x, name)
    n, c, h, w = x.shape
    _stats_operand(stats, x, 2 * n * c + 1, "stats", name)
    if residual is not None:
        _same_layout(residual, x, "residual", name)
    y = torch.empty_like(x)
    fn = getattr(_build.library(), _IN_APPLY_ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), residual.data_ptr() if residual is not None else None, stats.data_ptr(),
                 y.data_ptr(), n * c, h * w, float(w), int(relu), float(negative_slope), float(eps), _stream(x))
    _check_launch(err, name)
    LAUNCHES["in_apply"] += 1
    return y


def instance_norm_bwd_stats(x, g, stats, relu=False, negative_slope=0.0, eps=EPS):
    """K2s: (sum g~, sum g~ * yhat) of each plane of x's rows, f32: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return instance_norm_bwd_stats_plain(x, g, stats, relu, negative_slope, eps)
    name = "instance_norm_bwd_stats"
    _in_cuda_checks(x, name)
    _same_layout(g, x, "g", name)
    n, c, h, w = x.shape
    _stats_operand(stats, x, 2 * n * c + 1, "stats", name)
    gsums = torch.empty(2 * n * c, device=x.device, dtype=torch.float32)
    fn = getattr(_build.library(), _IN_BWD_STATS_ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), stats.data_ptr(), gsums.data_ptr(), n * c, h * w, float(w),
                 int(relu), float(negative_slope), float(eps), _stream(x))
    _check_launch(err, name)
    LAUNCHES["in_bwd_stats"] += 1
    return gsums


def instance_norm_bwd_apply(x, g, stats, gsums, relu=False, negative_slope=0.0, eps=EPS):
    """K2a: dx of x's rows from the summed statistics and gradient sums: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return instance_norm_bwd_apply_plain(x, g, stats, gsums, relu, negative_slope, eps)
    name = "instance_norm_bwd_apply"
    _in_cuda_checks(x, name)
    _same_layout(g, x, "g", name)
    n, c, h, w = x.shape
    _stats_operand(stats, x, 2 * n * c + 1, "stats", name)
    _stats_operand(gsums, x, 2 * n * c, "gsums", name)
    dx = torch.empty_like(x)
    fn = getattr(_build.library(), _IN_BWD_APPLY_ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), stats.data_ptr(), gsums.data_ptr(), dx.data_ptr(), n * c, h * w,
                 float(w), int(relu), float(negative_slope), float(eps), _stream(x))
    _check_launch(err, name)
    LAUNCHES["in_bwd_apply"] += 1
    return dx


class SpatialInstanceNormAct(torch.autograd.Function):
    """IN(+activation)(+residual) of a plane whose rows are split over the
    ranks of a spatial ``group`` (``parallel.spatial.SpatialGroup``): K1s,
    the statistics summed over the group, K1a.  The backward saves x and
    the summed statistics (8 bytes a plane and the row count), so it
    reduces only the gradient sums: K2s, their sum over the group, K2a."""

    @staticmethod
    def forward(ctx, x, residual, relu, negative_slope, eps, group):
        stats = group.all_reduce_sum_(instance_norm_stats(x))
        ctx.save_for_backward(x, stats)
        ctx.args = (relu, negative_slope, eps, group)
        ctx.has_residual = residual is not None
        return instance_norm_apply(x, stats, relu, residual, negative_slope, eps)

    @staticmethod
    def backward(ctx, g):
        x, stats = ctx.saved_tensors
        relu, negative_slope, eps, group = ctx.args
        g = g.contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            gsums = group.all_reduce_sum_(instance_norm_bwd_stats(x, g, stats, relu, negative_slope, eps))
            dx = instance_norm_bwd_apply(x, g, stats, gsums, relu, negative_slope, eps)
        dres = g if ctx.has_residual and ctx.needs_input_grad[1] else None
        return dx, dres, None, None, None, None


def instance_norm_act(
    x: torch.Tensor,
    relu: bool = False,
    residual: Optional[torch.Tensor] = None,
    negative_slope: float = 0.0,
    eps: float = EPS,
    spatial=None,
) -> torch.Tensor:
    """IN(+activation)(+residual) over NCHW, differentiable: K1 forward and
    K2 backward on the card, the plain versions on the CPU.  With a
    ``spatial`` group x holds this rank's rows of each plane, and the
    partial forms run around the group's sums (``SpatialInstanceNormAct``)."""
    if spatial is not None:
        return SpatialInstanceNormAct.apply(x, residual, relu, negative_slope, eps, spatial)
    return InstanceNormAct.apply(x, residual, relu, negative_slope, eps)


# ======================================================== attention compose

_COMPOSE_ENTRY = {
    torch.float32: "floodgan_attention_compose_f32",
    torch.bfloat16: "floodgan_attention_compose_bf16",
}
_COMPOSE_BWD_ENTRY = {
    torch.float32: "floodgan_attention_compose_bwd_f32",
    torch.bfloat16: "floodgan_attention_compose_bwd_bf16",
}


def _softmax10(attn_logits: torch.Tensor) -> torch.Tensor:
    logits = _f32(attn_logits)
    e = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def attention_compose_plain(
    content: torch.Tensor, attn_logits: torch.Tensor, rgb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(content (N,27,H,W) tanh'd, logits (N,10,H,W), rgb (N,3,H,W)) ->
    (output (N,3,H,W), background mask (N,H,W)), in the kernel's order:
    f32 softmax, then rgb * a_9 plus the nine content * a_k terms."""
    c = _f32(content)
    r = _f32(rgb)
    a = _softmax10(attn_logits)
    cols = []
    for ch in range(3):
        acc = r[:, ch] * a[:, 9]
        for k in range(9):
            acc = acc + c[:, 3 * k + ch] * a[:, k]
        cols.append(acc)
    return torch.stack(cols, dim=1).to(content.dtype), a[:, 9].to(content.dtype)


def attention_compose_bwd_plain(
    content: torch.Tensor,
    attn_logits: torch.Tensor,
    rgb: torch.Tensor,
    gout: torch.Tensor,
    gmask: Optional[torch.Tensor] = None,
    rgb_grad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(dcontent, dlogits, drgb) of ``attention_compose_plain`` from its
    inputs and the gradients of its two outputs, in K4's order: the softmax
    again; dcontent[3k+c] = gout_c * a_k; da_k = sum_c gout_c *
    content[3k+c]; da_9 = gmask + sum_c gout_c * rgb_c; dlogits = a * (da -
    sum_j a_j da_j); drgb = gout * a_9.  ``gmask=None`` means zero;
    ``rgb_grad=False`` gives drgb None."""
    c = _f32(content)
    r = _f32(rgb)
    go = _f32(gout)
    a = _softmax10(attn_logits)
    dcontent, da = [], []
    for k in range(9):
        acc = torch.zeros_like(a[:, 0])
        for ch in range(3):
            dcontent.append(go[:, ch] * a[:, k])
            acc = acc + go[:, ch] * c[:, 3 * k + ch]
        da.append(acc)
    acc = _f32(gmask) if gmask is not None else torch.zeros_like(a[:, 0])
    for ch in range(3):
        acc = acc + go[:, ch] * r[:, ch]
    da.append(acc)
    da = torch.stack(da, dim=1)
    dlogits = a * (da - (a * da).sum(dim=1, keepdim=True))
    drgb = (go * a[:, 9:10]).to(rgb.dtype) if rgb_grad else None
    return torch.stack(dcontent, dim=1).to(content.dtype), dlogits.to(attn_logits.dtype), drgb


def _compose_cuda_checks(content, attn_logits, rgb, name: str) -> None:
    if content.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {content.device}")
    if content.dtype not in _COMPOSE_ENTRY:
        raise ValueError(f"{name}: no kernel for {content.dtype}")
    _cuda_operand(attn_logits, content, "attn_logits")
    _cuda_operand(rgb, content, "rgb")
    n, cc, h, w = content.shape
    if cc != 27 or attn_logits.shape != (n, 10, h, w) or rgb.shape != (n, 3, h, w):
        raise ValueError(
            f"{name}: expected content (N,27,H,W), logits (N,10,H,W), rgb (N,3,H,W); "
            f"got {tuple(content.shape)}, {tuple(attn_logits.shape)}, {tuple(rgb.shape)}"
        )
    if n > 65535:
        raise ValueError(f"{name}: batch {n} exceeds the grid's 65535")
    if not (content.is_contiguous() and attn_logits.is_contiguous()):
        raise ValueError(f"{name}: content and logits must be NCHW-contiguous")
    if rgb.stride()[1:] != (h * w, w, 1):
        raise ValueError(f"{name}: rgb planes must be contiguous, strides {rgb.stride()}")


def attention_compose_fwd(
    content: torch.Tensor, attn_logits: torch.Tensor, rgb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3, the AttentionGAN composition head: the CUDA kernel for CUDA
    tensors (f32 or bf16, one dtype; ``rgb`` may be the channel slice
    ``x[:, :3]`` of a contiguous NCHW input), the plain version for CPU
    tensors."""
    if content.device.type == "cpu":
        return attention_compose_plain(content, attn_logits, rgb)
    _compose_cuda_checks(content, attn_logits, rgb, "attention_compose")
    n, _, h, w = content.shape
    out = torch.empty((n, 3, h, w), device=content.device, dtype=content.dtype)
    mask = torch.empty((n, h, w), device=content.device, dtype=content.dtype)
    if out.numel() == 0:
        return out, mask
    fn = getattr(_build.library(), _COMPOSE_ENTRY[content.dtype])
    with torch.cuda.device(content.device):
        err = fn(
            content.data_ptr(),
            attn_logits.data_ptr(),
            rgb.data_ptr(),
            out.data_ptr(),
            mask.data_ptr(),
            n,
            h * w,
            rgb.stride(0),
            _stream(content),
        )
    _check_launch(err, "attention_compose")
    LAUNCHES["compose"] += 1
    return out, mask


def attention_compose_bwd(
    content: torch.Tensor,
    attn_logits: torch.Tensor,
    rgb: torch.Tensor,
    gout: torch.Tensor,
    gmask: Optional[torch.Tensor] = None,
    rgb_grad: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K4: (dcontent, dlogits, drgb) of ``attention_compose_fwd``: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  ``gout``
    (N,3,H,W) and ``gmask`` (N,H,W; None means zero) are contiguous, of the
    inputs' dtype; ``rgb_grad=False`` skips drgb and returns None for it."""
    if content.device.type == "cpu":
        return attention_compose_bwd_plain(content, attn_logits, rgb, gout, gmask, rgb_grad)
    name = "attention_compose_bwd"
    _compose_cuda_checks(content, attn_logits, rgb, name)
    n, _, h, w = content.shape
    _cuda_operand(gout, content, "gout")
    if gout.shape != (n, 3, h, w) or not gout.is_contiguous():
        raise ValueError(f"{name}: gout must be a contiguous (N,3,H,W), got {tuple(gout.shape)}")
    if gmask is not None:
        _cuda_operand(gmask, content, "gmask")
        if gmask.shape != (n, h, w) or not gmask.is_contiguous():
            raise ValueError(f"{name}: gmask must be a contiguous (N,H,W), got {tuple(gmask.shape)}")
    dcontent = torch.empty_like(content)
    dlogits = torch.empty_like(attn_logits)
    drgb = torch.empty((n, 3, h, w), device=content.device, dtype=content.dtype) if rgb_grad else None
    if dcontent.numel() == 0:
        return dcontent, dlogits, drgb
    fn = getattr(_build.library(), _COMPOSE_BWD_ENTRY[content.dtype])
    with torch.cuda.device(content.device):
        err = fn(
            content.data_ptr(),
            attn_logits.data_ptr(),
            rgb.data_ptr(),
            gout.data_ptr(),
            gmask.data_ptr() if gmask is not None else None,
            dcontent.data_ptr(),
            dlogits.data_ptr(),
            drgb.data_ptr() if drgb is not None else None,
            n,
            h * w,
            rgb.stride(0),
            _stream(content),
        )
    _check_launch(err, name)
    LAUNCHES["compose_bwd"] += 1
    return dcontent, dlogits, drgb


class AttentionCompose(torch.autograd.Function):
    """K3 forward, K4 backward.  Gradients autograd does not produce stay
    absent: no gradient for the mask reaches K4 as a null gmask, and an rgb
    that needs none (the generator input) gets no drgb."""

    @staticmethod
    def forward(ctx, content, attn_logits, rgb):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(content, attn_logits, rgb)
        return attention_compose_fwd(content, attn_logits, rgb)

    @staticmethod
    def backward(ctx, gout, gmask):
        content, attn_logits, rgb = ctx.saved_tensors
        if gout is None and gmask is None:
            return None, None, None
        if gout is None:
            n, _, h, w = content.shape
            gout = torch.zeros((n, 3, h, w), device=content.device, dtype=content.dtype)
        return attention_compose_bwd(
            content,
            attn_logits,
            rgb,
            gout.contiguous(),
            None if gmask is None else gmask.contiguous(),
            rgb_grad=ctx.needs_input_grad[2],
        )


def attention_compose(
    content: torch.Tensor, attn_logits: torch.Tensor, rgb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The AttentionGAN composition head, differentiable: K3 forward and K4
    backward on the card, the plain versions on the CPU.  Returns (output
    (N,3,H,W), background mask (N,H,W))."""
    return AttentionCompose.apply(content, attn_logits, rgb)


# ================================================================= row copy


def row_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous tensor equal to x: K5's function."""
    return x.clone(memory_format=torch.contiguous_format)


def row_copy_fwd(x: torch.Tensor) -> torch.Tensor:
    """K5: a fresh tensor equal to x bit for bit: the CUDA kernel for a
    contiguous CUDA tensor (any dtype; the kernel copies bytes), the plain
    version for a CPU tensor."""
    if x.device.type == "cpu":
        return row_copy_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"row_copy: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"row_copy: x must be contiguous, strides {x.stride()}")
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if y.numel() == 0:
        return y
    fn = _build.library().floodgan_row_copy
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), x.numel() * x.element_size(), _stream(x))
    _check_launch(err, "row_copy")
    LAUNCHES["copy"] += 1
    return y


class RowCopy(torch.autograd.Function):
    """K5 forward, and no backward.  Without the Function a copy made by
    the kernel would carry no ``grad_fn``, and a gradient through it would
    stop without a word on the card while ``clone`` passed it on the CPU."""

    @staticmethod
    def forward(ctx, x):
        return row_copy_fwd(x)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "row_copy has no backward: the Pallas layout fence it replaces "
            "(tools/microbench_head.py:head_raw_pallasfence) has no reverse rule either; "
            "time raw_pallasfence forward only"
        )


def row_copy(x: torch.Tensor) -> torch.Tensor:
    """The layout fence of the content-head microbench: K5 on the card, the
    plain version on the CPU.  Differentiating through it raises."""
    return RowCopy.apply(x)
