"""Where the time of one served batch goes on the card.

    python3 -m floodgan_tpu_torch.serve_profile [--batch 8] [--size 512] [--iters 5]

Builds ``InferenceEngine("pairedattention", ..., "all")`` on the card from a
seeded init and serves ``iters`` batches the way ``BatchingFrontend._flush``
does (a numpy batch in, ``engine.predict``, ``.cpu().numpy()`` out) under
``torch.profiler``.  Prints one JSON line: the host wall time per batch, the
device's busy share of it, the device time per batch by category
(convolutions, the port's two kernels, reflect pads, copies between host and
card, the rest), the kernels that take the most time, and the convolution
FLOPs of one forward (counted by ``FlopCounterMode``) with the rate the
convolutions reached.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from floodgan_tpu_torch.core.device import card_label
from floodgan_tpu_torch.models.layers import init_weights
from floodgan_tpu_torch.models.registry import build_generator
from floodgan_tpu_torch.serve import InferenceEngine

# First match wins; names are matched lower-cased.
CATEGORIES = (
    ("in_act (K1)", ("in_act_kernel",)),
    ("attention_compose (K3)", ("compose_kernel",)),
    ("reflect pad", ("reflection_pad",)),
    ("host<->card copy", ("memcpy htod", "memcpy dtoh")),
    ("convolution", ("conv", "cudnn", "xmma", "gemm", "winograd", "fft", "dgrad", "fprop",
                     "wgrad", "cutlass", "implicit")),
)


def category(name: str, categories=CATEGORIES) -> str:
    low = name.lower()
    for label, keys in categories:
        if any(k in low for k in keys):
            return label
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def profile_engine(batch: int, size: int, iters: int, seed: int = 47) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("serve_profile needs a CUDA card")
    gen = build_generator("pairedattention", 9)
    sd = init_weights(gen, torch.Generator().manual_seed(seed)).state_dict()
    engine = InferenceEngine("pairedattention", sd, "all", batch_size=batch, image_size=size)
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, (batch, size, size, 9)).astype(np.float32)
    engine.predict(x).cpu().numpy()  # steady state: the library and cuDNN are warm
    with torch.inference_mode(), FlopCounterMode(display=False) as flops:
        engine.generator(torch.zeros((batch, 9, size, size), device=engine.device))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.predict(x).cpu().numpy()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_cat = collections.Counter()
    by_name = collections.Counter()
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_cat[category(e.name)] += dur
        by_name[e.name] += dur
    device_us = sum(by_cat.values())
    conv_flop = flops.get_total_flops()
    return {
        "batch": batch,
        "size": size,
        "iters": iters,
        "wall_ms_per_batch": wall_us / iters / 1e3,
        "device_ms_per_batch": device_us / iters / 1e3,
        "device_busy_share": (
            busy_us((e.time_range.start, e.time_range.end) for e in kernels) / wall_us
            if kernels else None
        ),
        "device_ms_per_batch_by_category": {k: v / iters / 1e3 for k, v in by_cat.most_common()},
        "top_kernels_ms_per_batch": {k[:120]: v / iters / 1e3 for k, v in by_name.most_common(8)},
        "kernel_events": len(kernels),
        "conv_tflop_per_batch": conv_flop / 1e12,
        "conv_tflop_per_s": (
            conv_flop * iters / (by_cat["convolution"] * 1e-6) / 1e12
            if by_cat["convolution"] else None
        ),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args(argv)
    out = profile_engine(args.batch, args.size, args.iters)
    out["device"] = card_label()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
