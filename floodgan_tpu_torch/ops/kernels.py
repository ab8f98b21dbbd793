"""The two hand-written CUDA kernels of the serving path, their plain
PyTorch versions and their launch counters.

- ``instance_norm_act`` (csrc/instance_norm.cu) replaces the TPU kernel
  ``_in_fwd_kernel`` of floodgan_tpu/ops/pallas_kernels.py;
- ``attention_compose`` (csrc/attention_compose.cu) replaces
  ``_compose_kernel`` of the same file.

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

LAUNCHES = {"in_act": 0, "compose": 0}

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


# ============================================================ instance norm

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
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    meansq = (x32 * x32).mean(dim=(2, 3), keepdim=True)
    inv = torch.rsqrt(meansq - mean * mean + eps)
    y = (x32 - mean) * inv
    if relu:
        y = torch.where(y >= 0.0, y, y * negative_slope)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


_IN_ENTRY = {torch.float32: "floodgan_in_act_f32", torch.bfloat16: "floodgan_in_act_bf16"}


def instance_norm_act(
    x: torch.Tensor,
    relu: bool = False,
    residual: Optional[torch.Tensor] = None,
    negative_slope: float = 0.0,
    eps: float = EPS,
) -> torch.Tensor:
    """IN(+activation)(+residual) over an NCHW tensor: the CUDA kernel for
    a CUDA tensor (f32 or bf16, contiguous), the plain version for a CPU
    tensor.  With both, the activation applies before the add."""
    if x.device.type == "cpu":
        return instance_norm_act_plain(x, relu, residual, negative_slope, eps)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_act: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"instance_norm_act: expected NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _IN_ENTRY:
        raise ValueError(f"instance_norm_act: no kernel for {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("instance_norm_act: x must be NCHW-contiguous")
    if residual is not None:
        _cuda_operand(residual, x, "residual")
        if residual.shape != x.shape or not residual.is_contiguous():
            raise ValueError("instance_norm_act: residual must be contiguous and of x's shape")
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
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check_launch(err, "instance_norm_act")
    LAUNCHES["in_act"] += 1
    return y


# ======================================================== attention compose

def attention_compose_plain(
    content: torch.Tensor, attn_logits: torch.Tensor, rgb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(content (N,27,H,W) tanh'd, logits (N,10,H,W), rgb (N,3,H,W)) ->
    (output (N,3,H,W), background mask (N,H,W)), in the kernel's order:
    f32 softmax, then rgb * a_9 plus the nine content * a_k terms."""
    c = content.float()
    r = rgb.float()
    logits = attn_logits.float()
    e = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    a = e / e.sum(dim=1, keepdim=True)
    cols = []
    for ch in range(3):
        acc = r[:, ch] * a[:, 9]
        for k in range(9):
            acc = acc + c[:, 3 * k + ch] * a[:, k]
        cols.append(acc)
    return torch.stack(cols, dim=1).to(content.dtype), a[:, 9].to(content.dtype)


def attention_compose(
    content: torch.Tensor, attn_logits: torch.Tensor, rgb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The AttentionGAN composition head: the CUDA kernel for CUDA tensors
    (f32; ``rgb`` may be the channel slice ``x[:, :3]`` of a contiguous
    NCHW input), the plain version for CPU tensors."""
    if content.device.type == "cpu":
        return attention_compose_plain(content, attn_logits, rgb)
    if content.device.type != "cuda":
        raise ValueError(f"attention_compose: no kernel for device {content.device}")
    if content.dtype != torch.float32:
        raise ValueError(f"attention_compose: no kernel for {content.dtype}")
    _cuda_operand(attn_logits, content, "attn_logits")
    _cuda_operand(rgb, content, "rgb")
    n, cc, h, w = content.shape
    hw = h * w
    if cc != 27 or attn_logits.shape != (n, 10, h, w) or rgb.shape != (n, 3, h, w):
        raise ValueError(
            "attention_compose: expected content (N,27,H,W), logits (N,10,H,W), rgb (N,3,H,W); "
            f"got {tuple(content.shape)}, {tuple(attn_logits.shape)}, {tuple(rgb.shape)}"
        )
    if n > 65535:
        raise ValueError(f"attention_compose: batch {n} exceeds the grid's 65535")
    if not (content.is_contiguous() and attn_logits.is_contiguous()):
        raise ValueError("attention_compose: content and logits must be NCHW-contiguous")
    if rgb.stride()[1:] != (hw, w, 1):
        raise ValueError(f"attention_compose: rgb planes must be contiguous, strides {rgb.stride()}")
    out = torch.empty((n, 3, h, w), device=content.device, dtype=content.dtype)
    mask = torch.empty((n, h, w), device=content.device, dtype=content.dtype)
    if out.numel() == 0:
        return out, mask
    fn = _build.library().floodgan_attention_compose_f32
    with torch.cuda.device(content.device):
        err = fn(
            content.data_ptr(),
            attn_logits.data_ptr(),
            rgb.data_ptr(),
            out.data_ptr(),
            mask.data_ptr(),
            n,
            hw,
            rgb.stride(0),
            torch.cuda.current_stream(content.device).cuda_stream,
        )
    _check_launch(err, "attention_compose")
    LAUNCHES["compose"] += 1
    return out, mask
