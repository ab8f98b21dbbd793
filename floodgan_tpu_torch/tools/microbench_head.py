"""Content-head conv experiments in the setting of the generator's train step.

    python -m floodgan_tpu_torch.tools.microbench_head [--variant all|check|NAME] [--fwd]
                                                       [--iters 20] [--device cpu] [--profile]

The counterpart of tools/microbench_head.py.  It rebuilds one piece of the
generator's training step: ConvT 128->64 from 256^2 to 512^2, reflect pad
3, the 7x7 64->27 content-head conv and the gradient with respect to the
ConvT input, at batch 8 in bf16 from ``np.random.default_rng(0)``.  It
races formulations of the head conv (``HEADS``) inside it.

Arguments follow the JAX tool: ``xp`` is (N, H, W, C) and ``w`` is HWIO
(7, 7, C, 27), so the tests feed both tools the same arrays.  The memory is
NHWC too: each conv takes its input and weight in ``torch.channels_last``,
the layout of cuDNN's Hopper kernels.  Only ``raw_nchw`` transposes to
contiguous NCHW and back, to measure what that costs.

``--variant check`` runs every variant on one context and prints its max
|diff| against ``raw`` (``none`` computes no conv, so its difference is not
an error).  Otherwise each variant is timed over ``--iters`` calls after one
warm-up, fwd+bwd or, with ``--fwd``, forward only, and printed in ms and in
TF/s of the head conv alone: 2*N*H*W*C*27*49 FLOP a forward, three times
that for fwd+bwd, as the JAX tool counts.  ``raw_pallasfence`` runs forward
only, because its copy (K5) has no backward, as the Pallas fence it
replaces has no reverse rule.  ``--profile`` adds the card's kernels of one
call of each variant, from torch.profiler.

It runs on the card unless ``--device cpu`` is given, and raises where
there is none.  ``main`` returns what it printed, as a dict.
"""

from __future__ import annotations

import argparse
import collections
import functools
import itertools
import time

import numpy as np
import torch
import torch.nn.functional as F

from floodgan_tpu_torch.core.device import resolve_device
from floodgan_tpu_torch.ops.kernels import row_copy
from floodgan_tpu_torch.ops.nn_ops import reflect_pad2d

B = 8        # batch
SIZE = 256   # ConvT input height and width; the head conv's output is twice that
C_IN = 128   # ConvT input channels
C_MID = 64   # ConvT output channels: the head conv's input
C_OUT = 27   # head conv output channels
K = 7        # head conv kernel size
PAD = 3      # reflect pad in front of the head conv
LAYOUT_TRANSFORMS = ("nchwtonhwc", "nhwctonchw")  # cuDNN's transpose kernels, lower case


def _cl(x: torch.Tensor) -> torch.Tensor:
    """An (N, H, W, C) tensor as the NCHW-shaped channels_last tensor that
    F.conv2d takes: a view of a contiguous x."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _w_cl(w: torch.Tensor) -> torch.Tensor:
    """HWIO weights as OIHW in channels_last memory: (O, H, W, I)."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def _conv(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID stride-1 conv, NHWC in and out (a view of the channels_last
    output), HWIO weights."""
    return F.conv2d(_cl(xp), _w_cl(w)).permute(0, 2, 3, 1)


def head_pad128(xp, w):
    """Zero-pad cout to 128, conv, slice back: the JAX package's production path."""
    return _conv(xp, F.pad(w, (0, 128 - w.shape[3])))[..., : w.shape[3]]


def head_raw(xp, w):
    return _conv(xp, w)


def head_rowsum(xp, w):
    """7x7 as the sum of 7 row-shifted 1x7 convs."""
    ho = xp.shape[1] - K + 1
    out = None
    for r in range(K):
        part = _conv(xp[:, r : r + ho], w[r : r + 1])
        out = part if out is None else out + part
    return out


@functools.lru_cache(maxsize=None)
def _s2d_taps(device: torch.device) -> torch.Tensor:
    """idx[r, c, bj, bk, p]: the tap j*K + k of the 7x7 kernel that output
    phase (r, c) reads through block (bj, bk), input phase p = 2*pj + pk of
    the space-to-depth 4x4 conv, or K*K (a zero tap).  Output (2t+r, 2u+c)
    sums taps (j, k) over x[2t+r+j, 2u+c+k], which lies in block
    ((r+j)//2, (c+k)//2), phase ((r+j)%2, (c+k)%2)."""
    idx = np.full((2, 2, 4, 4, 4), K * K, np.int64)
    for r, c, j, k in itertools.product(range(2), range(2), range(K), range(K)):
        idx[r, c, (r + j) // 2, (c + k) // 2, ((r + j) % 2) * 2 + (c + k) % 2] = j * K + k
    return torch.from_numpy(idx).to(device)


def _space_to_depth(xp):
    """(N, H, W, C), H and W even after a zero pad of 2: (N, (H+2)/2,
    (W+2)/2, 4C), channel (2*pj + pk)*C + ch."""
    xq = F.pad(xp, (0, 0, 0, 2, 0, 2))
    n, hq, wq, c = xq.shape
    xs = xq.reshape(n, hq // 2, 2, wq // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return xs.reshape(n, hq // 2, wq // 2, 4 * c)


def _tap_weights(w):
    """The 7x7 taps, then one zero tap: (K*K + 1, C, O)."""
    k, _, c, o = w.shape
    return torch.cat([w.reshape(k * k, c, o), w.new_zeros(1, c, o)])


def head_s2d(xp, w):
    """Space-to-depth: the 7x7 conv as four 4x4 convs over (H/2, W/2, 4C),
    one per output phase, interleaved back."""
    n, h, wd, c = xp.shape
    ho, wo, o = h - K + 1, wd - K + 1, w.shape[3]
    xs = _space_to_depth(xp)
    taps, idx = _tap_weights(w), _s2d_taps(w.device)
    rows = []
    for r in (0, 1):
        row = []
        for col in (0, 1):
            wk = taps[idx[r, col]].reshape(4, 4, 4 * c, o)
            row.append(_conv(xs, wk)[:, : ho // 2, : wo // 2])
        rows.append(torch.stack(row, dim=3))
    return torch.stack(rows, dim=2).reshape(n, ho, wo, o)


def head_s2d2(xp, w):
    """Like ``head_s2d``, with the four output phases folded into one conv's
    cout (4*27 = 108)."""
    n, h, wd, c = xp.shape
    ho, wo, o = h - K + 1, wd - K + 1, w.shape[3]
    wk = _tap_weights(w)[_s2d_taps(w.device)]          # (r, c, bj, bk, p, C, O)
    wk = wk.permute(2, 3, 4, 5, 0, 1, 6).reshape(4, 4, 4 * c, 4 * o)
    out = _conv(_space_to_depth(xp), wk)[:, : ho // 2, : wo // 2]
    out = out.reshape(n, ho // 2, wo // 2, 2, 2, o).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(n, ho, wo, o)


def head_raw_ob(xp, w):
    """Exactly ``raw``: eager PyTorch has no compiler whose fusion a barrier would stop."""
    return head_raw(xp, w)


def head_pad128_ob(xp, w):
    """Exactly ``pad128``: eager PyTorch has no compiler whose fusion a barrier would stop."""
    return head_pad128(xp, w)


def head_raw_nchw(xp, w):
    """A physical transpose to contiguous NCHW, the conv there, and back."""
    xt = xp.permute(0, 3, 1, 2).contiguous()
    wt = w.permute(3, 2, 0, 1).contiguous()
    return F.conv2d(xt, wt).permute(0, 2, 3, 1).contiguous()


def head_raw_relayout(xp, w):
    """Exactly ``raw``: eager PyTorch has no layout assignment to force."""
    return head_raw(xp, w)


def head_raw_pallasfence(xp, w):
    """K5, the port of the Pallas layout fence, then ``raw``."""
    return head_raw(row_copy(xp), w)


def head_none(xp, w):
    """Context baseline: no head conv at all."""
    return xp[:, PAD:-PAD, PAD:-PAD, : w.shape[3]]


HEADS = {"pad128": head_pad128, "raw": head_raw, "rowsum": head_rowsum,
         "s2d": head_s2d, "s2d2": head_s2d2, "raw_ob": head_raw_ob, "pad128_ob": head_pad128_ob,
         "raw_nchw": head_raw_nchw, "none": head_none,
         "raw_relayout": head_raw_relayout,
         "raw_pallasfence": head_raw_pallasfence}
FORWARD_ONLY = ("raw_pallasfence",)


def context(device: torch.device):
    """(h, wt, w7) in bf16 as the JAX tool makes them: h (B, SIZE, SIZE,
    C_IN) N(0, 1), wt (3, 3, C_IN, C_MID) and w7 (K, K, C_MID, C_OUT)
    N(0, 0.05^2), in that order from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    arrays = (rng.standard_normal((B, SIZE, SIZE, C_IN), np.float32),
              rng.standard_normal((3, 3, C_IN, C_MID), np.float32) * 0.05,
              rng.standard_normal((K, K, C_MID, C_OUT), np.float32) * 0.05)
    return tuple(torch.from_numpy(a).to(device=device, dtype=torch.bfloat16) for a in arrays)


def upsample_pad(h: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """The head's input in the train step: ConvT 2x of NHWC h with HWIO wt,
    then reflect pad 3; NHWC out.  The JAX tool's conv with lhs_dilation 2
    and padding ((1, 2), (1, 2)) on the flipped wt is conv_transpose2d with
    stride 2, padding 1, output_padding 1 and wt as (I, O, kh, kw), not
    flipped."""
    w = wt.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)
    x = F.conv_transpose2d(_cl(h), w, stride=2, padding=1, output_padding=1)
    xp = reflect_pad2d(x, PAD).contiguous(memory_format=torch.channels_last)
    return xp.permute(0, 2, 3, 1)


def make_loss(fn, wt, w7):
    """h -> sum((fn(upsample_pad(h, wt), w7) in f32)^2)."""
    def loss(h):
        return (fn(upsample_pad(h, wt), w7).float() ** 2).sum()
    return loss


def make_step(fn, wt, w7, fwd: bool):
    """One timed call: the loss under no_grad, or its gradient w.r.t. h."""
    loss = make_loss(fn, wt, w7)
    if fwd:
        def step(h):
            with torch.no_grad():
                return loss(h)
    else:
        def step(h):
            hg = h.detach().requires_grad_()
            return torch.autograd.grad(loss(hg), hg)[0]
    return step


def head_flops(fwd: bool) -> int:
    """The head conv's FLOPs of one call, as the JAX tool counts them."""
    ho = 2 * SIZE
    return 2 * B * ho * ho * C_MID * C_OUT * K * K * (1 if fwd else 3)


def check(h, wt, w7) -> tuple:
    """(max |raw|, {name: max |variant - raw|}) on one context, in f32."""
    with torch.no_grad():
        xp = upsample_pad(h, wt)
        base = head_raw(xp, w7).float()
        diffs = {name: float((fn(xp, w7).float() - base).abs().max()) for name, fn in HEADS.items()}
    return float(base.abs().max()), diffs


def seconds_per_call(call, iters: int, device: torch.device) -> float:
    """Over ``iters`` calls after one warm-up: CUDA events on the card, the
    host clock on the CPU."""
    call()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def profile_call(call) -> list:
    """[(kernel name, device ms)] of one call on the card, longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.end - e.time_range.start
    return [(name, us / 1e3) for name, us in by_name.most_common()]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=sorted(HEADS) + ["all", "check"], default="all")
    ap.add_argument("--fwd", action="store_true", help="time forward only")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="cpu for the plain versions; default: the card")
    ap.add_argument("--profile", action="store_true",
                    help="also list the card's kernels of one call of each variant")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, "microbench_head")
    if args.profile and device.type != "cuda":
        ap.error("--profile needs the card")

    h, wt, w7 = context(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{kind}: batch {B}, ConvT {C_IN}->{C_MID} {SIZE}^2 -> {2 * SIZE}^2, reflect pad {PAD}, "
          f"head {K}x{K} {C_MID}->{C_OUT}, bf16, channels_last")

    if args.variant == "check":
        top, diffs = check(h, wt, w7)
        print("max|raw| =", top)
        for name, d in diffs.items():
            print(name, "max|diff| =", d)
        return {"max_abs_raw": top, "max_abs_diff": diffs}

    mode = "fwd" if args.fwd else "fwd+bwd"
    flops = head_flops(args.fwd)
    out = {"mode": mode, "ms": {}, "tflops": {}, "kernels": {}}
    names = sorted(HEADS) if args.variant == "all" else [args.variant]
    for name in names:
        if name in FORWARD_ONLY and not args.fwd:
            print(f"{name:15s} {mode:7s} skipped: forward only (its copy has no backward, as the "
                  "Pallas fence has no reverse rule); time it with --fwd")
            continue
        step = make_step(HEADS[name], wt, w7, args.fwd)
        t = seconds_per_call(lambda: step(h), args.iters, device)
        out["ms"][name], out["tflops"][name] = t * 1e3, flops / t / 1e12
        print(f"{name:15s} {mode:7s} {t * 1e3:8.3f} ms   ~{flops / t / 1e12:6.1f} TF/s (head-only flops)")
        if args.profile:
            kernels = profile_call(lambda: step(h))
            out["kernels"][name] = kernels
            layout = sum(ms for k, ms in kernels if any(key in k.lower() for key in LAYOUT_TRANSFORMS))
            print(f"  profile: {sum(ms for _, ms in kernels):.3f} ms on the card, of which cuDNN "
                  f"layout transforms {layout:.3f} ms, over {len(kernels)} kernel names; longest:")
            for k, ms in kernels[:8]:
                print(f"    {ms:8.3f} ms  {k[:140]}")
    return out


if __name__ == "__main__":
    main()
