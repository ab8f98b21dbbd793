#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (floodgan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving path for PairedAttention (topography "all", 9
input channels) at full width, 512^2, and fails unless every phase passes:

1. device   - a CUDA card is present; prints its name and power limit.
2. build    - compiles csrc/*.cu with nvcc for sm_90a (ops/_build.py).
3. kernels  - each hand-written kernel against its plain PyTorch version on
              the card, at the shapes one batch-8 512^2 forward gives it, with
              its median time (CUDA events), its bound, the plain version's
              time and, where one PyTorch call computes the same function,
              that call's time.  Ends with one JSON "kernels" line.
4. engine   - InferenceEngine at batch 8 and batch 1 from a seeded init: one
              predict launches the IN kernel 25 times and compose once; the
              output is finite, in [0, 1]; latency and images/s.
5. requests - 12 requests from 4 threads through BatchingFrontend, with the
              launch counts set to 0 before and read after: the main path.
6. card-cpu - the same weights at 128^2, batch 1: card engine against the
              CPU engine (plain versions), TF32 off.

The last line is {"ok": true, "device": {...}}.  Without a card, or without
the package beside it, the script exits non-zero and prints no result.
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

# Instance-norm sites of one batch-8 512^2 generator forward (NCHW):
# (label, shape, relu, residual, sites per forward).  25 sites in all.
IN_SITES = (
    ("512^2x64 relu", (BATCH, 64, S, S), True, False, 3),
    ("256^2x128 relu", (BATCH, 128, S // 2, S // 2), True, False, 3),
    ("128^2x256 relu", (BATCH, 256, S // 4, S // 4), True, False, 10),
    ("128^2x256 residual", (BATCH, 256, S // 4, S // 4), False, True, 9),
)
TOL_F32_IN = 1e-4      # f32, another summation order of the plane statistics
TOL_F32 = 1e-5         # f32 elementwise (compose)
TOL_BF16 = 2e-2        # bf16 output, plus one bf16 ulp (2^-7 relative) for a
BF16_RTOL = 2.0 ** -7  # rounding flipped by the statistics' summation order


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def median_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median over ``runs`` calls of fn, each bracketed by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


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
    say("build", f"{path.name} in {dt:.2f} s ({len(_build.sources())} sources, one nvcc call)")
    for line in log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            say("build", "ptxas " + line.split("info    :")[-1].strip())


def _randn(shape, dtype, gen, mean=0.0):
    return (torch.randn(shape, generator=gen, device="cuda") + mean).to(dtype)


def phase_kernels() -> list:
    from floodgan_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
    bound_by_ms = {"bytes": 0.0, "operations": 0.0}
    cases = [(lbl, shp, relu, res, n, torch.float32, 0.0) for lbl, shp, relu, res, n in IN_SITES]
    cases += [(lbl, shp, relu, res, 0, torch.bfloat16, 0.0) for lbl, shp, relu, res, _ in IN_SITES]
    cases += [
        ("128^2x256 leaky 0.2", (BATCH, 256, S // 4, S // 4), True, False, 0, torch.float32, 0.2),
        ("128^2x256 no act", (BATCH, 256, S // 4, S // 4), False, False, 0, torch.float32, 0.0),
    ]
    for label, shape, relu, has_res, per_forward, dtype, slope in cases:
        x = _randn(shape, dtype, gen, mean=0.5)
        res = _randn(shape, dtype, gen) if has_res else None

        def kern():
            return kernels.instance_norm_act(x, relu=relu, residual=res, negative_slope=slope)

        def plain():
            return kernels.instance_norm_act_plain(x, relu=relu, residual=res, negative_slope=slope)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == x.shape, f"in_act {label}: bad output")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if dtype == torch.float32:
            ok, tol = err <= TOL_F32_IN, f"{TOL_F32_IN:g}"
        else:
            ok = bool((diff <= TOL_BF16 + BF16_RTOL * want.float().abs()).all())
            tol = f"{TOL_BF16:g} + 2^-7 |y|"
        ms, plain_ms = median_ms(kern), median_ms(plain)
        lib_ms = None
        if not relu and not has_res:
            lib_ms = median_ms(lambda: torch.nn.functional.instance_norm(x, eps=kernels.EPS))
        esize = x.element_size()
        nbytes = x.numel() * esize * (3 if has_res else 2)
        ops = x.numel() * (4 + int(relu) + int(has_res))
        b_ms, b_by = bound_ms(nbytes, ops)
        say("kernels", f"in_act {label} {str(dtype)[6:]} {tuple(shape)}: max_abs_err {err:.3g} "
                       f"(tol {tol}) ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} "
                       f"({b_by}) library_ms {'null' if lib_ms is None else f'{lib_ms:.4f}'}"
                       + (f" x{per_forward} per forward" if per_forward else ""))
        check(ok, f"in_act {label} {dtype}: max_abs_err {err} over tolerance {tol}")
        if per_forward:
            totals["ms"] += per_forward * ms
            totals["plain_ms"] += per_forward * plain_ms
            totals["bound_ms"] += per_forward * b_ms
            bound_by_ms[b_by] += per_forward * b_ms
            totals["err"] = max(totals["err"], err)
        del x, res, got, want, diff

    n, hw = BATCH, S * S
    content = torch.tanh(torch.randn((n, 27, S, S), generator=gen, device="cuda"))
    logits = 3.0 * torch.randn((n, 10, S, S), generator=gen, device="cuda")
    x9 = torch.randn((n, 9, S, S), generator=gen, device="cuda")
    rgb = x9[:, :3]
    got_out, got_mask = kernels.attention_compose(content, logits, rgb)
    want_out, want_mask = kernels.attention_compose_plain(content, logits, rgb)
    torch.cuda.synchronize()
    err = max(float((got_out - want_out).abs().max()), float((got_mask - want_mask).abs().max()))
    ms = median_ms(lambda: kernels.attention_compose(content, logits, rgb))
    plain_ms = median_ms(lambda: kernels.attention_compose_plain(content, logits, rgb))
    c_bound, c_by = bound_ms((40 + 4) * n * hw * 4, 107 * n * hw)
    say("kernels", f"attention_compose ({n},27+10+3,{S},{S}) f32: max_abs_err {err:.3g} "
                   f"(tol {TOL_F32:g}) ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {c_bound:.4f} "
                   f"({c_by}) library_ms null")
    check(err <= TOL_F32, f"attention_compose: max_abs_err {err} over tolerance {TOL_F32}")
    del content, logits, x9, rgb, got_out, got_mask, want_out, want_mask

    say("kernels", f"in_act, the 25 f32 sites of one batch-8 {S}^2 forward: ms {totals['ms']:.4f} "
                   f"plain_ms {totals['plain_ms']:.4f} bound_ms {totals['bound_ms']:.4f}")
    phase_kernel_edges(gen)
    return [
        {"name": "in_act", "route": "cuda", "source": "floodgan_tpu_torch/csrc/instance_norm.cu",
         "replaces": "floodgan_tpu/ops/pallas_kernels.py:53", "launches": None,
         "max_abs_err": totals["err"], "ms": totals["ms"], "plain_ms": totals["plain_ms"],
         "bound_ms": totals["bound_ms"], "bound_by": max(bound_by_ms, key=bound_by_ms.get),
         "library_ms": None},
        {"name": "attention_compose", "route": "cuda",
         "source": "floodgan_tpu_torch/csrc/attention_compose.cu",
         "replaces": "floodgan_tpu/ops/pallas_kernels.py:272", "launches": None,
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": c_bound,
         "bound_by": c_by, "library_ms": None},
    ]


def phase_kernel_edges(gen) -> None:
    """Shapes off the serving path: H*W not a multiple of the vector width
    (scalar tail; misaligned planes after the first), and rgb as the
    channel slice of an odd-sized input."""
    from floodgan_tpu_torch.ops import kernels

    worst = 0.0
    for dtype, tol in ((torch.float32, TOL_F32_IN), (torch.bfloat16, TOL_BF16)):
        for shape in ((2, 5, 13, 11), (1, 3, 1, 7), (3, 4, 33, 35)):
            x = _randn(shape, dtype, gen, mean=0.5)
            res = _randn(shape, dtype, gen)
            for relu, r, slope in ((True, None, 0.0), (False, res, 0.0), (True, res, 0.2)):
                got = kernels.instance_norm_act(x, relu=relu, residual=r, negative_slope=slope)
                want = kernels.instance_norm_act_plain(x, relu=relu, residual=r, negative_slope=slope)
                diff = (got.float() - want.float()).abs()
                bad = diff > tol + (BF16_RTOL * want.float().abs() if dtype == torch.bfloat16 else 0)
                check(not bool(bad.any()),
                      f"in_act {shape} {dtype} relu={relu} slope={slope}: max_abs_err {float(diff.max())}")
                if dtype == torch.float32:
                    worst = max(worst, float(diff.max()))
    x9 = torch.randn((2, 9, 13, 11), generator=gen, device="cuda")
    content = torch.tanh(torch.randn((2, 27, 13, 11), generator=gen, device="cuda"))
    logits = torch.randn((2, 10, 13, 11), generator=gen, device="cuda")
    got = kernels.attention_compose(content, logits, x9[:, :3])
    want = kernels.attention_compose_plain(content, logits, x9[:, :3])
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err <= TOL_F32, f"attention_compose at 13x11: max_abs_err {err}")
    torch.cuda.synchronize()
    say("kernels", f"edge shapes (odd H*W, scalar tails, strided rgb): in_act f32 max_abs_err "
                   f"{worst:.3g}, bf16 within tolerance; attention_compose max_abs_err {err:.3g}")


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
        check(counts == {"in_act": 25, "compose": 1},
              f"batch {b}: one predict launched {counts}, expected 25 in_act and 1 compose")
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
    check(counts == {"in_act": 25 * batches, "compose": batches},
          f"{batches} batches launched {counts}, expected {25 * batches} in_act, {batches} compose")

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


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    table = phase_kernels()
    sd = _state_dict()
    engine = phase_engine(sd, smi)
    counts = phase_requests(engine)
    table[0]["launches"] = counts["in_act"]
    table[1]["launches"] = counts["compose"]
    check(all(row["launches"] > 0 for row in table), f"a kernel of the path never ran: {counts}")
    phase_card_vs_cpu(sd)
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
