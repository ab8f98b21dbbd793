#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (floodgan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's three main paths at full width: serving and paired
training of PairedAttention (topography "all", 9 input channels) at 512^2,
and the content-head microbench (a ConvT 128->64 to 512^2, reflect pad,
the 7x7 64->27 head conv) at batch 8 in bf16.  It fails unless every phase
passes:

1. device   - a CUDA card is present; prints its name and power limit.
2. build    - compiles csrc/*.cu with nvcc for sm_90a (ops/_build.py).
3. kernels  - each hand-written kernel against its plain PyTorch version on
              the card, at the shapes the main paths give it (K1 instance
              norm and K3 compose, f32 and bf16; K2 instance-norm backward
              at the 4 generator and 3 PatchGAN sites, f32 and bf16; K4
              compose backward, f32 and bf16, with and without the mask
              gradient; K5 row copy at the head's padded input, bf16 and
              f32, bit for bit), with its median time (CUDA events), its
              bound, the plain version's time and, where one PyTorch call
              computes the same function, that call's time; then odd edge
              shapes and misaligned pointers.
4. engine   - InferenceEngine at batch 8 and batch 1 from a seeded init: one
              predict launches the IN kernel 25 times and compose once, and
              no backward kernel; the output is finite, in [0, 1]; latency
              and images/s.
5. requests - 12 requests from 4 threads through BatchingFrontend, with the
              launch counts set to 0 before and read after: the serving path.
6. card-cpu - the same weights at 128^2, batch 1: card engine against the
              CPU engine (plain versions), TF32 off.
7. train    - PairedTrainer at 512^2, batch 8, bf16, from a seeded init: one
              train_step, with the launch counts set to 0 before and read
              after, launches K1 34 times, K2 34 times, K3 and K4 once: the
              training path.  Five steps give finite losses and change both
              parameter sets; then the median step time over 10 steps,
              samples/s and peak memory.
8. head     - python -m floodgan_tpu_torch.tools.microbench_head, through its
              main(), with the launch counts set to 0 before and read after:
              check (every variant within TOL_HEAD_ULPS of raw, and K5 then
              raw equal to raw bit for bit), the fwd+bwd race of every
              variant that has a backward, and the forward race of all 11;
              K5 launches once per raw_pallasfence forward.
9. train card-cpu - the same seeded trainer at 64^2, batch 2, f32 (TF32
              off) on the card and on the CPU (plain versions): step-1 and
              step-2 losses.

The line before the verdict is one JSON "kernels" line.  The last line is
{"ok": true, "device": {...}}.  Without a card, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SEED = 47
S = 512
BATCH = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12      # H100 SXM, f32 outside the tensor cores
TIMED_RUNS = 20
PRE_WAIT_CYCLES = 1_000_000  # about 0.5 ms of device wait ahead of each timed call

# Instance-norm sites of one batch-8 512^2 generator forward (NCHW):
# (label, shape, relu, residual, sites per forward).  25 sites in all.
IN_SITES = (
    ("512^2x64 relu", (BATCH, 64, S, S), True, False, 3),
    ("256^2x128 relu", (BATCH, 128, S // 2, S // 2), True, False, 3),
    ("128^2x256 relu", (BATCH, 256, S // 4, S // 4), True, False, 10),
    ("128^2x256 residual", (BATCH, 256, S // 4, S // 4), False, True, 9),
)
# PatchGAN instance-norm levels of one batch-8 512^2 D read (all leaky 0.2):
# (label, shape).  Each is read 3 times per train step (the D update's two
# reads and the G update's one), forward and backward.
D_SITES = (
    ("128^2x128 leaky", (BATCH, 128, S // 4, S // 4)),
    ("64^2x256 leaky", (BATCH, 256, S // 8, S // 8)),
    ("63^2x512 leaky", (BATCH, 512, S // 8 - 1, S // 8 - 1)),
)
D_READS = 3
LR = 2e-4
TRAIN_STEP_LAUNCHES = {"in_act": 34, "in_bwd": 34, "compose": 1, "compose_bwd": 1, "copy": 0}
SERVE_LAUNCHES = {"in_act": 25, "in_bwd": 0, "compose": 1, "compose_bwd": 0, "copy": 0}
COPY_SHAPE = (BATCH, S + 6, S + 6, 64)  # the head's input: the reflect-padded ConvT output, NHWC
HEAD_ITERS = 20
# [head] check: the variants sum the 49*64 taps in other orders (rowsum adds
# seven bf16 partial outputs), so each may differ from raw by a few bf16
# roundings; the limit is 4 bf16 ulps (2^-7 each) of max|raw|.  none
# computes no conv: its difference is printed, not held.
TOL_HEAD_ULPS = 4
TOL_F32_IN = 1e-4      # f32, another summation order of the plane statistics
TOL_F32 = 1e-5         # f32 elementwise (compose)
TOL_BF16 = 2e-2        # bf16 output, plus one bf16 ulp (2^-7 relative) for a
BF16_RTOL = 2.0 ** -7  # rounding flipped by the statistics' summation order
KINK = 1e-5            # |yhat| within which the kernel and the plain IN backward
                       # may take either side of the activation's kink (g is
                       # zeroed there for the comparison)
TOL_TRAIN_STEP1 = 1e-4  # card against CPU, step-1 losses
# Step-2 losses follow one Adam update, whose first step is about
# lr * sign(grad): a gradient that is zero up to rounding flips sign between
# the card and the CPU.  The JAX package's own two routes differ by 4.3e-4
# there; the CPU tests hold the port to JAX at the same 2e-3.
TOL_TRAIN_STEP2 = 2e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median over ``runs`` calls of fn, each bracketed by CUDA events.  A
    device-side wait goes ahead of each bracket, so the host enqueues the
    call while the card is still busy, and the bracket holds device time,
    not a Python wrapper's launch work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(PRE_WAIT_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _in_turns(fns: dict, rounds: int = 4) -> dict:
    """{name: median of ``median_ms`` over ``rounds`` rounds}, the functions
    timed in turns, in order and then in reverse."""
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(rounds):
        for k in names if r % 2 == 0 else names[::-1]:
            times[k].append(median_ms(fns[k]))
    return {k: statistics.median(v) for k, v in times.items()}


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phases

def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
                  f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)
    return smi


def phase_build() -> None:
    from floodgan_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, log = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    say("build", f"{path.name} in {dt:.2f} s ({len(_build.sources())} sources, one nvcc call "
                 "each, in parallel, then one link)")
    for line in log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            say("build", "ptxas " + line.split("info    :")[-1].strip())


def _randn(shape, dtype, gen, mean=0.0):
    return (torch.randn(shape, generator=gen, device="cuda") + mean).to(dtype)


def _off_kink(x, g, relu: bool):
    """g with zeros where |yhat| <= KINK (yhat as the plain statistics give
    it), and how many.  There the kernel and the plain version may take
    either side of the activation's kink, because their statistics differ
    in summation order; a zero g makes both sides the same, so the whole
    output, plane means included, compares exactly."""
    if not relu:
        return g, 0
    from floodgan_tpu_torch.ops import kernels

    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    inv = torch.rsqrt((x32 * x32).mean(dim=(2, 3), keepdim=True) - mean * mean + kernels.EPS)
    at = ((x32 - mean) * inv).abs() <= KINK
    return g.masked_fill(at, 0), int(at.sum())


def _close(got, want, dtype, tol_f32):
    """(max abs error, within tolerance): f32 within tol_f32; bf16 within
    TOL_BF16 plus one bf16 ulp of the plain value."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if dtype == torch.float32:
        return err, err <= tol_f32
    return err, bool((diff <= TOL_BF16 + BF16_RTOL * want.float().abs()).all())


def _tol_text(dtype, tol_f32) -> str:
    return f"{tol_f32:g}" if dtype == torch.float32 else f"{TOL_BF16:g} + 2^-7 |y|"


def _fmt(ms) -> str:
    return "null" if ms is None else f"{ms:.4f}"


class _Total:
    """A kernel's row of the JSON line, summed over the sites of one pass
    (each site's time times its count)."""

    def __init__(self):
        self.ms = self.plain_ms = self.bound_ms = self.err = 0.0
        self.by = {"bytes": 0.0, "operations": 0.0}

    def add(self, count, ms, plain_ms, b_ms, b_by, err):
        self.ms += count * ms
        self.plain_ms += count * plain_ms
        self.bound_ms += count * b_ms
        self.by[b_by] += count * b_ms
        self.err = max(self.err, err)

    def row(self, name, source, replaces):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": None, "max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": max(self.by, key=self.by.get), "library_ms": None}


def _in_case(gen, label, shape, dtype, relu, has_res, slope, backward):
    """One instance-norm site: K1 (or K2 with ``backward``) against its
    plain version.  Returns (ms, plain_ms, bound_ms, bound_by, err)."""
    from floodgan_tpu_torch.ops import kernels

    x = _randn(shape, dtype, gen, mean=0.5)
    other = _randn(shape, dtype, gen) if (has_res or backward) else None
    at_kink = 0
    if backward:
        other, at_kink = _off_kink(x, other, relu)

        def kern():
            return kernels.instance_norm_act_bwd(x, other, relu=relu, negative_slope=slope)

        def plain():
            return kernels.instance_norm_act_bwd_plain(x, other, relu=relu, negative_slope=slope)
    else:
        def kern():
            return kernels.instance_norm_act_fwd(x, relu=relu, residual=other, negative_slope=slope)

        def plain():
            return kernels.instance_norm_act_plain(x, relu=relu, residual=other, negative_slope=slope)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    check(got.dtype == dtype and got.shape == x.shape, f"{label}: bad output")
    err, ok = _close(got, want, dtype, TOL_F32_IN)
    ms, plain_ms = median_ms(kern), median_ms(plain)
    lib_ms = None
    if not relu:
        # The no-activation IN: F.instance_norm forward, or its backward
        # alone (a residual site's input gradient is the same function).
        if backward:
            xr = x.detach().requires_grad_()
            yl = torch.nn.functional.instance_norm(xr, eps=kernels.EPS)
            lib_ms = median_ms(lambda: torch.autograd.grad(yl, xr, other, retain_graph=True))
            del xr, yl
        elif not has_res:
            lib_ms = median_ms(lambda: torch.nn.functional.instance_norm(x, eps=kernels.EPS))
    n_io = 3 if (has_res or backward) else 2
    ops = x.numel() * ((13 + int(relu)) if backward else (4 + int(relu) + int(has_res)))
    b_ms, b_by = bound_ms(x.numel() * x.element_size() * n_io, ops)
    name = "in_bwd" if backward else "in_act"
    kink = f", g zeroed at {at_kink} of {x.numel()} on the kink" if backward and relu else ""
    say("kernels", f"{name} {label} {str(dtype)[6:]} {tuple(shape)}: max_abs_err {err:.3g} "
                   f"(tol {_tol_text(dtype, TOL_F32_IN)}{kink}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
                   f"bound_ms {b_ms:.4f} ({b_by}) library_ms {_fmt(lib_ms)}")
    check(ok, f"{name} {label} {dtype}: max_abs_err {err} over tolerance")
    del x, other, got, want
    return ms, plain_ms, b_ms, b_by, err


def _compose_inputs(gen, n, h, w, dtype):
    content = torch.tanh(torch.randn((n, 27, h, w), generator=gen, device="cuda")).to(dtype)
    logits = (3.0 * torch.randn((n, 10, h, w), generator=gen, device="cuda")).to(dtype)
    x9 = torch.randn((n, 9, h, w), generator=gen, device="cuda").to(dtype)
    gout = torch.randn((n, 3, h, w), generator=gen, device="cuda").to(dtype)
    gmask = torch.randn((n, h, w), generator=gen, device="cuda").to(dtype)
    return content, logits, x9[:, :3], gout, gmask


def _compose_case(gen, dtype, backward, with_gmask=False, rgb_grad=False):
    """K3 (or K4 with ``backward``) at batch 8, 512^2, rgb the channel slice
    of a 9-channel input.  Returns (ms, plain_ms, bound_ms, bound_by, err)."""
    from floodgan_tpu_torch.ops import kernels

    content, logits, rgb, gout, gmask = _compose_inputs(gen, BATCH, S, S, dtype)
    gm = gmask if with_gmask else None
    if backward:
        def kern():
            return kernels.attention_compose_bwd(content, logits, rgb, gout, gm, rgb_grad)

        def plain():
            return kernels.attention_compose_bwd_plain(content, logits, rgb, gout, gm, rgb_grad)
        # read: content, logits, rgb, gout (+ gmask); write: dcontent, dlogits (+ drgb)
        planes = 27 + 10 + 3 + 3 + int(with_gmask) + 27 + 10 + 3 * int(rgb_grad)
        ops_px = 150
        label = f"attention_compose_bwd gmask {'yes' if with_gmask else 'no'} drgb {'yes' if rgb_grad else 'no'}"
    else:
        def kern():
            return kernels.attention_compose_fwd(content, logits, rgb)

        def plain():
            return kernels.attention_compose_plain(content, logits, rgb)
        planes, ops_px, label = 40 + 4, 107, "attention_compose"
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if backward:
        check((got[2] is None) == (not rgb_grad), f"{label}: drgb presence")
    err, ok = 0.0, True
    for g, w in zip(got, want):
        if g is None:
            continue
        check(g.dtype == dtype and g.shape == w.shape, f"{label}: bad output")
        e, o = _close(g, w, dtype, TOL_F32)
        err, ok = max(err, e), ok and o
    ms, plain_ms = median_ms(kern), median_ms(plain)
    b_ms, b_by = bound_ms(planes * BATCH * S * S * content.element_size(), ops_px * BATCH * S * S)
    say("kernels", f"{label} ({BATCH},27+10+3,{S},{S}) {str(dtype)[6:]}: max_abs_err {err:.3g} "
                   f"(tol {_tol_text(dtype, TOL_F32)}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
                   f"bound_ms {b_ms:.4f} ({b_by}) library_ms null")
    check(ok, f"{label} {dtype}: max_abs_err {err} over tolerance")
    del content, logits, rgb, gout, gmask, got, want
    return ms, plain_ms, b_ms, b_by, err


def _same_bits(got, x) -> bool:
    """got is a contiguous copy of x, bit for bit, in a storage of its own."""
    return (got.shape == x.shape and got.dtype == x.dtype and got.is_contiguous()
            and got.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
            and torch.equal(got.reshape(-1).view(torch.uint8), x.reshape(-1).view(torch.uint8)))


def _row_copy_case(gen, dtype):
    """K5 at the [head] phase's shape, bit for bit against its plain version.
    Returns (ms, plain_ms, bound_ms, bound_by, err, library_ms)."""
    from floodgan_tpu_torch.ops import kernels

    x = _randn(COPY_SHAPE, dtype, gen)
    got, want = kernels.row_copy_fwd(x), kernels.row_copy_plain(x)
    torch.cuda.synchronize()
    label = f"row_copy {tuple(COPY_SHAPE)} {str(dtype)[6:]}"
    check(_same_bits(got, x) and _same_bits(want, x), f"{label}: not a bitwise copy in new storage")
    err = float((got.float() - want.float()).abs().max())
    # The three are within a percent of each other: time them in turns.
    t = _in_turns({"kernel": lambda: kernels.row_copy_fwd(x), "plain": lambda: kernels.row_copy_plain(x),
                   "library": lambda: x.clone()})  # the plain version is this library call
    ms, plain_ms, lib_ms = t["kernel"], t["plain"], t["library"]
    b_ms, b_by = bound_ms(2 * x.numel() * x.element_size(), 0)
    say("kernels", f"{label}: bitwise, max_abs_err {err:.3g} ms {ms:.4f} plain_ms {plain_ms:.4f} "
                   f"bound_ms {b_ms:.4f} ({b_by}) library_ms (x.clone(), the plain version) {lib_ms:.4f}")
    del x, got, want
    return ms, plain_ms, b_ms, b_by, err, lib_ms


def phase_copy_edges(gen) -> None:
    """K5 off the main path: a 70-byte row, odd sizes, sources 2 or 4 bytes
    into their storage (narrower vectors); then, through the C entry, source
    and destination 0-15 bytes into theirs (the scalar head, the vectors, the
    tail), with the bytes around each copy untouched."""
    from floodgan_tpu_torch.ops import _build, kernels

    for dtype in (torch.bfloat16, torch.float32):
        for shape in ((1, 3, 5, 7), (2, 1, 1, 1), (3, 17, 19, 5)):
            x = _randn(shape, dtype, gen)
            inside = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:].view(shape)
            inside.copy_(x)
            for src in (x, inside):
                got = kernels.row_copy_fwd(src)
                check(_same_bits(got, src), f"row_copy {shape} {dtype} at byte "
                                            f"{src.data_ptr() % 16} of 16: not a bitwise copy")
    lib = _build.library()
    src = torch.randint(0, 255, (4096,), generator=gen, device="cuda", dtype=torch.uint8)
    cases = ((3, 3, 4000), (15, 15, 17), (1, 9, 1000), (8, 0, 3001), (4, 12, 2), (0, 0, 4096))
    for s_off, d_off, n in cases:
        dst = torch.full((4096 + 16,), 255, device="cuda", dtype=torch.uint8)  # src holds no 255
        err = lib.floodgan_row_copy(src[s_off:].data_ptr(), dst[d_off:].data_ptr(), n,
                                    torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        check(err == 0, f"floodgan_row_copy at offsets {s_off}, {d_off}: cudaError {err}")
        check(torch.equal(dst[d_off:d_off + n], src[s_off:s_off + n])
              and bool((dst[:d_off] == 255).all()) and bool((dst[d_off + n:] == 255).all()),
              f"floodgan_row_copy of {n} bytes at offsets {s_off}, {d_off}: wrong bytes")
    say("kernels", "row_copy edge shapes (70-byte rows, odd sizes, sources 2 or 4 bytes into their "
                   f"storage, bf16 and f32) bit for bit; {len(cases)} byte copies at offsets 0-15 exact, "
                   "no byte outside written")


def phase_kernels() -> dict:
    """Every kernel at the main paths' shapes.  Returns the JSON rows by
    kernel name: in_act and attention_compose over one f32 serving
    forward (as in the first slice), in_bwd and attention_compose_bwd over
    one bf16 train step, row_copy at the head's bf16 input."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    serve_in, train_in, train_bwd = _Total(), _Total(), _Total()

    for label, shape, relu, res, n in IN_SITES:
        serve_in.add(n, *_in_case(gen, label, shape, f32, relu, res, 0.0, False))
    for label, shape, relu, res, n in IN_SITES:
        train_in.add(n, *_in_case(gen, label, shape, bf16, relu, res, 0.0, False))
    for label, shape in D_SITES:
        train_in.add(D_READS, *_in_case(gen, label, shape, bf16, True, False, 0.2, False))
    for label, shape, relu, res in (
        ("128^2x256 leaky 0.2", (BATCH, 256, S // 4, S // 4), True, False),
        ("128^2x256 no act", (BATCH, 256, S // 4, S // 4), False, False),
    ):
        _in_case(gen, label, shape, f32, relu, res, 0.2 if relu else 0.0, False)

    # K2: the backward of each site; a residual site's input gradient is
    # the no-activation backward (the residual takes g itself).
    for dtype in (f32, bf16):
        for label, shape, relu, _, n in IN_SITES:
            r = _in_case(gen, label.replace("residual", "no act (residual)"), shape, dtype,
                         relu, False, 0.0, True)
            if dtype == bf16:
                train_bwd.add(n, *r)
        for label, shape in D_SITES:
            r = _in_case(gen, label, shape, dtype, True, False, 0.2, True)
            if dtype == bf16:
                train_bwd.add(D_READS, *r)

    compose = _compose_case(gen, f32, False)
    _compose_case(gen, bf16, False)
    for dtype in (f32, bf16):
        _compose_case(gen, dtype, True, with_gmask=True, rgb_grad=True)
    _compose_case(gen, f32, True)
    compose_bwd = _compose_case(gen, bf16, True)  # the train step's case
    copy_ms, copy_plain, copy_bound, copy_by, copy_err, copy_lib = _row_copy_case(gen, bf16)  # the head's
    copy_err = max(copy_err, _row_copy_case(gen, f32)[4])

    say("kernels", f"in_act, the 25 f32 sites of one batch-{BATCH} {S}^2 forward: ms {serve_in.ms:.4f} "
                   f"plain_ms {serve_in.plain_ms:.4f} bound_ms {serve_in.bound_ms:.4f}")
    say("kernels", f"in_act, the 34 bf16 sites of one batch-{BATCH} {S}^2 train step: ms {train_in.ms:.4f} "
                   f"plain_ms {train_in.plain_ms:.4f} bound_ms {train_in.bound_ms:.4f}")
    say("kernels", f"in_bwd, the 34 bf16 sites of one batch-{BATCH} {S}^2 train step: ms {train_bwd.ms:.4f} "
                   f"plain_ms {train_bwd.plain_ms:.4f} bound_ms {train_bwd.bound_ms:.4f}")
    phase_kernel_edges(gen)
    phase_copy_edges(gen)

    def single(name, source, replaces, r):
        ms, plain_ms, b_ms, b_by, err = r
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    in_src = "floodgan_tpu_torch/csrc/instance_norm.cu"
    co_src = "floodgan_tpu_torch/csrc/attention_compose.cu"
    return {
        "in_act": serve_in.row("in_act", in_src, "floodgan_tpu/ops/pallas_kernels.py:53"),
        "in_bwd": train_bwd.row("in_bwd", in_src, "floodgan_tpu/ops/pallas_kernels.py:109"),
        "compose": single("attention_compose", co_src, "floodgan_tpu/ops/pallas_kernels.py:272", compose),
        "compose_bwd": single("attention_compose_bwd", co_src,
                              "floodgan_tpu/ops/pallas_kernels.py:317", compose_bwd),
        "copy": {"name": "row_copy", "route": "cuda", "source": "floodgan_tpu_torch/csrc/row_copy.cu",
                 "replaces": "tools/microbench_head.py:144", "launches": None, "max_abs_err": copy_err,
                 "ms": copy_ms, "plain_ms": copy_plain, "bound_ms": copy_bound, "bound_by": copy_by,
                 "library_ms": copy_lib},
    }


def phase_kernel_edges(gen) -> None:
    """Shapes off the main paths: H*W not a multiple of the vector width
    (scalar tail; misaligned planes after the first), and rgb as the
    channel slice of an odd-sized input, forward and backward."""
    from floodgan_tpu_torch.ops import kernels

    worst = {"in_act": 0.0, "in_bwd": 0.0, "compose": 0.0, "compose_bwd": 0.0}
    for dtype, tol in ((torch.float32, TOL_F32_IN), (torch.bfloat16, TOL_BF16)):
        for shape in ((2, 5, 13, 11), (1, 3, 1, 7), (3, 4, 33, 35)):
            x = _randn(shape, dtype, gen, mean=0.5)
            res = _randn(shape, dtype, gen)
            for relu, r, slope in ((True, None, 0.0), (False, res, 0.0), (True, res, 0.2)):
                g, _ = _off_kink(x, res, relu)
                for name, got, want in (
                    ("in_act", kernels.instance_norm_act_fwd(x, relu=relu, residual=r, negative_slope=slope),
                     kernels.instance_norm_act_plain(x, relu=relu, residual=r, negative_slope=slope)),
                    ("in_bwd", kernels.instance_norm_act_bwd(x, g, relu=relu, negative_slope=slope),
                     kernels.instance_norm_act_bwd_plain(x, g, relu=relu, negative_slope=slope)),
                ):
                    err, ok = _close(got, want, dtype, tol)
                    check(ok, f"{name} {shape} {dtype} relu={relu} slope={slope}: max_abs_err {err}")
                    worst[name] = max(worst[name], err)
        content, logits, rgb, gout, gmask = _compose_inputs(gen, 2, 13, 11, dtype)
        pairs = [("compose", kernels.attention_compose_fwd(content, logits, rgb),
                  kernels.attention_compose_plain(content, logits, rgb))]
        for gm, rgb_grad in ((gmask, True), (None, False)):
            pairs.append(("compose_bwd",
                          kernels.attention_compose_bwd(content, logits, rgb, gout, gm, rgb_grad),
                          kernels.attention_compose_bwd_plain(content, logits, rgb, gout, gm, rgb_grad)))
        for name, got, want in pairs:
            for g, w in zip(got, want):
                check((g is None) == (w is None), f"{name} at 13x11: drgb presence")
                if g is not None:
                    err, ok = _close(g, w, dtype, TOL_F32)
                    check(ok, f"{name} at 13x11 {dtype}: max_abs_err {err}")
                    worst[name] = max(worst[name], err)
    torch.cuda.synchronize()
    say("kernels", "edge shapes (odd H*W, scalar tails, strided rgb, f32 and bf16) within tolerance; "
                   "max_abs_err " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def _state_dict():
    from floodgan_tpu_torch.models.layers import init_weights
    from floodgan_tpu_torch.models.registry import build_generator

    g = build_generator("pairedattention", 9)
    return init_weights(g, torch.Generator().manual_seed(SEED)).state_dict()


def _inputs(rng, b, size):
    return rng.uniform(-1.0, 1.0, (b, size, size, 9)).astype(np.float32)


def phase_engine(sd, smi):
    from floodgan_tpu_torch.ops import kernels
    from floodgan_tpu_torch.serve import InferenceEngine

    rng = np.random.default_rng(SEED)
    engines = {}
    for b in (BATCH, 1):
        t0 = time.perf_counter()
        eng = InferenceEngine("pairedattention", sd, "all", batch_size=b, image_size=S)
        setup = time.perf_counter() - t0
        x = _inputs(rng, b, S)
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        out = eng.predict(x)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        check(counts == SERVE_LAUNCHES, f"batch {b}: one predict launched {counts}, expected {SERVE_LAUNCHES}")
        check(out.device.type == "cuda" and tuple(out.shape) == (b, S, S, 3),
              f"batch {b}: output {tuple(out.shape)} on {out.device}")
        check(bool(torch.isfinite(out).all()), f"batch {b}: non-finite output")
        lo, hi = float(out.min()), float(out.max())
        check(0.0 <= lo and hi <= 1.0, f"batch {b}: output outside [0, 1]: [{lo}, {hi}]")
        bench = eng.benchmark(iters=20)
        say("engine", f"batch {b} at {S}^2 f32: launches {counts}, output in [{lo:.4f}, {hi:.4f}], "
                      f"set-up {setup:.2f} s, latency {bench['latency_ms']:.3f} ms, "
                      f"{bench['images_per_sec']:.2f} images/s ({smi})")
        engines[b] = eng
    return engines[BATCH]


def phase_requests(engine) -> dict:
    from floodgan_tpu_torch.ops import kernels
    from floodgan_tpu_torch.serve import BatchingFrontend

    rng = np.random.default_rng(SEED + 1)
    stacks = _inputs(rng, 12, S)
    results = [None] * len(stacks)
    errors = []

    def client(idx):
        try:
            for i in idx:
                results[i] = fe.predict(stacks[i], timeout=300)
        except Exception as e:  # reported below; the phase then fails
            errors.append(e)

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    fe = BatchingFrontend(engine, max_delay_ms=20.0)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(range(t, 12, 4),)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    fe.close()
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    stats = fe.stats()
    check(not errors and not any(t.is_alive() for t in threads), f"requests failed: {errors}")
    check(stats["requests"] == 12, f"frontend counted {stats['requests']} requests")
    batches = stats["batches"]
    want = {k: v * batches for k, v in SERVE_LAUNCHES.items()}
    check(counts == want, f"{batches} batches launched {counts}, expected {want}")

    # Each answer against engine.predict of a zero-padded batch holding it.
    worst = 0.0
    for lo in range(0, 12, BATCH):
        chunk = stacks[lo:lo + BATCH]
        pad = np.zeros((BATCH - len(chunk),) + chunk.shape[1:], np.float32)
        want = engine.predict(np.concatenate([chunk, pad])).cpu().numpy()
        for j in range(len(chunk)):
            np.testing.assert_allclose(results[lo + j], want[j], rtol=1e-5, atol=1e-6)
            worst = max(worst, float(np.abs(results[lo + j] - want[j]).max()))
    say("requests", f"12 requests from 4 threads in {wall:.3f} s: launches {counts}, "
                    f"stats {json.dumps(stats)}, max |frontend - engine| {worst:.3g}")
    return counts


def phase_card_vs_cpu(sd) -> None:
    from floodgan_tpu_torch.serve import InferenceEngine

    size = 128
    x = _inputs(np.random.default_rng(SEED + 2), 1, size)
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = InferenceEngine("pairedattention", sd, "all", batch_size=1, image_size=size,
                              device=dev, aot=False)
        outs[dev] = eng.predict(x).cpu().numpy()
    diff = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    say("card-cpu", f"{size}^2 batch 1, card against CPU (TF32 off): max_abs_diff {diff:.3g} (tol 1e-3)")
    check(diff <= 1e-3, f"card and CPU forwards differ by {diff}")


def _train_inputs(rng, b, size):
    return (rng.uniform(-1.0, 1.0, (b, size, size, 9)).astype(np.float32),
            rng.uniform(-1.0, 1.0, (b, size, size, 3)).astype(np.float32))


def _changed(module, start) -> tuple:
    """(weight tensors changed, weight tensors, all tensors changed, all)."""
    sd = module.state_dict()
    moved = {k for k, v in sd.items() if not torch.equal(v, start[k])}
    weights = [k for k in sd if k.endswith("weight")]
    return sum(k in moved for k in weights), len(weights), len(moved), len(sd)


def phase_train(smi) -> dict:
    from floodgan_tpu_torch.ops import kernels
    from floodgan_tpu_torch.train.paired import PairedTrainer

    x, y = _train_inputs(np.random.default_rng(SEED + 3), BATCH, S)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    t0 = time.perf_counter()
    trainer = PairedTrainer("pairedattention", 9, compute_dtype="bfloat16", seed=SEED)
    setup = time.perf_counter() - t0
    start = {m: {k: v.clone() for k, v in getattr(trainer, m).state_dict().items()}
             for m in ("generator", "discriminator")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    trainer.train_step(x, y, LR)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    check(counts == TRAIN_STEP_LAUNCHES, f"one train step launched {counts}, expected {TRAIN_STEP_LAUNCHES}")

    for _ in range(4):
        metrics = trainer.train_step(x, y, LR)
    losses = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in losses.values()), f"non-finite losses after 5 steps: {losses}")
    moved = {m: _changed(getattr(trainer, m), start[m]) for m in start}
    for m, (w_moved, w_all, moved_all, n_all) in moved.items():
        check(w_moved == w_all, f"{m}: only {w_moved} of {w_all} weight tensors changed in 5 steps")

    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        trainer.train_step(x, y, LR)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times) * 1e3
    peak = torch.cuda.max_memory_allocated()
    say("train", f"PairedAttention {S}^2 batch {BATCH} bf16, seed {SEED}: one step launched {counts}; "
                 f"set-up {setup:.2f} s")
    say("train", f"after 5 steps: losses {json.dumps(losses)}; tensors changed: " + ", ".join(
        f"{m} {mv[2]}/{mv[3]} (weights {mv[0]}/{mv[1]})" for m, mv in moved.items()))
    say("train", f"step ms median {step_ms:.3f} over 10 (min {min(times) * 1e3:.3f}, "
                 f"max {max(times) * 1e3:.3f}), {BATCH / (step_ms / 1e3):.3f} samples/s, "
                 f"peak memory {peak / 2**30:.3f} GiB ({smi})")
    del trainer, x, y
    torch.cuda.empty_cache()
    return counts


def phase_head(smi) -> dict:
    """The content-head microbench through its entry point, at full width."""
    from floodgan_tpu_torch.ops import kernels
    from floodgan_tpu_torch.tools import microbench_head

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    chk = microbench_head.main(["--variant", "check"])
    both = microbench_head.main(["--variant", "all", "--iters", str(HEAD_ITERS)])
    fwd = microbench_head.main(["--variant", "all", "--fwd", "--iters", str(HEAD_ITERS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    # one raw_pallasfence forward in check, and a warm-up plus HEAD_ITERS in the forward race
    want = {k: 0 for k in counts} | {"copy": 2 + HEAD_ITERS}
    check(counts == want, f"the head microbench launched {counts}, expected {want}")

    top, diffs = chk["max_abs_raw"], chk["max_abs_diff"]
    tol = TOL_HEAD_ULPS * 2.0 ** -7 * top
    check(np.isfinite(top) and top > 0, f"head check: max|raw| is {top}")
    say("head", f"check at batch {microbench_head.B}, {2 * microbench_head.SIZE}^2 bf16: max|raw| {top}, "
                f"tol {TOL_HEAD_ULPS} bf16 ulps of it = {tol:.4g}; max|variant - raw|: "
                + ", ".join(f"{k} {v:.4g}" for k, v in diffs.items()) + " (none: no conv, not held)")
    check(set(diffs) == set(microbench_head.HEADS), f"head check ran {sorted(diffs)}")
    bad = {k: v for k, v in diffs.items() if k != "none" and not v <= tol}
    check(not bad, f"head variants off raw by more than {tol}: {bad}")
    check(diffs["raw_pallasfence"] == 0.0,
          f"K5 then raw differs from raw by {diffs['raw_pallasfence']}; expected bit for bit")

    backward = set(microbench_head.HEADS) - set(microbench_head.FORWARD_ONLY)
    check(set(both["ms"]) == backward and set(fwd["ms"]) == set(microbench_head.HEADS),
          f"race ran fwd+bwd {sorted(both['ms'])}, fwd {sorted(fwd['ms'])}")
    times = list(both["ms"].values()) + list(fwd["ms"].values())
    check(all(np.isfinite(t) and t > 0 for t in times), f"head race times {both['ms']} {fwd['ms']}")
    for name in sorted(microbench_head.HEADS):
        fb = both["ms"].get(name)
        say("head", f"{name:15s} fwd {fwd['ms'][name]:8.3f} ms ({fwd['tflops'][name]:6.1f} TF/s)   fwd+bwd "
                    + (f"{fb:8.3f} ms ({both['tflops'][name]:6.1f} TF/s)" if fb is not None else "forward only"))
    say("head", f"raw (channels_last) against raw_nchw (NCHW and back): fwd {fwd['ms']['raw']:.3f} against "
                f"{fwd['ms']['raw_nchw']:.3f} ms, fwd+bwd {both['ms']['raw']:.3f} against "
                f"{both['ms']['raw_nchw']:.3f} ms; launches {counts}; {wall:.1f} s ({smi})")
    return counts


def phase_train_card_vs_cpu() -> None:
    from floodgan_tpu_torch.train.paired import PairedTrainer

    size, b = 64, 2
    x, y = _train_inputs(np.random.default_rng(SEED + 4), b, size)
    runs = {}
    for dev in ("cuda", "cpu"):
        trainer = PairedTrainer("pairedattention", 9, compute_dtype="float32", device=dev, seed=SEED)
        runs[dev] = [{k: float(v) for k, v in trainer.train_step(x, y, LR).items()} for _ in range(2)]
    rel = [{k: abs(card[k] - cpu[k]) / abs(cpu[k]) for k in cpu}
           for card, cpu in zip(runs["cuda"], runs["cpu"])]
    for step, tol in ((1, TOL_TRAIN_STEP1), (2, TOL_TRAIN_STEP2)):
        say("train card-cpu", f"{size}^2 batch {b} f32 (TF32 off), step {step}: card "
                              f"{json.dumps(runs['cuda'][step - 1])} cpu {json.dumps(runs['cpu'][step - 1])}; "
                              f"max rel diff {max(rel[step - 1].values()):.3g} (tol {tol:g})")
    for step, tol in ((1, TOL_TRAIN_STEP1), (2, TOL_TRAIN_STEP2)):
        check(max(rel[step - 1].values()) <= tol,
              f"step {step}: card and CPU losses differ by {rel[step - 1]} (tol {tol})")


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    sd = _state_dict()
    engine = phase_engine(sd, smi)
    serve_counts = phase_requests(engine)
    del engine
    phase_card_vs_cpu(sd)
    train_counts = phase_train(smi)
    head_counts = phase_head(smi)
    for k, row in rows.items():
        row["launches"] = serve_counts[k] + train_counts[k] + head_counts[k]
    check(all(row["launches"] > 0 for row in rows.values()),
          f"a kernel of the main paths never ran: serving {serve_counts}, training {train_counts}, "
          f"head {head_counts}")
    phase_train_card_vs_cpu()
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
