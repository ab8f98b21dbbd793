"""Where the time of one train step goes on the card.

    python3 -m floodgan_tpu_torch.train_profile [--model pairedattention] [--batch 8]
                                                [--size 512] [--iters 5] [--dtype bfloat16]

Builds the family's trainer over 9 input channels on the card from a
seeded init (``PairedTrainer`` for PairedAttention and Pix2Pix,
``CycleTrainer`` for CycleGAN and AttentionGAN), takes two warm-up steps,
then ``iters`` steps under
``torch.profiler`` with the batch already on the card.  Prints one JSON
line: the host wall time per step, the device's busy share of it, the
device time per step by category (convolutions, the port's four kernels,
reflect pads, cuDNN layout transforms, Adam, copies and casts, the rest),
the kernels that take the most time, and the convolution FLOPs of one step
(forward and backward, counted by ``FlopCounterMode``) with the rate the
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

from floodgan_tpu_torch.core.config import MODEL_NAMES, model_is_cycle
from floodgan_tpu_torch.core.device import card_label
from floodgan_tpu_torch.serve_profile import CATEGORIES, busy_us, category
from floodgan_tpu_torch.train.cycle import CycleTrainer
from floodgan_tpu_torch.train.paired import PairedTrainer

# Ahead of the serving categories: first match wins.
TRAIN_CATEGORIES = (
    ("in_bwd (K2)", ("in_bwd_kernel",)),
    ("attention_compose_bwd (K4)", ("compose_bwd_kernel",)),
    ("cuDNN layout transform", ("nchwtonhwc", "nhwctonchw")),
    ("Adam", ("multi_tensor_apply",)),
    ("copies and casts", ("copy_kernel",)),
) + CATEGORIES


def profile_trainer(batch: int, size: int, iters: int, dtype: str, seed: int = 47,
                    model: str = "pairedattention") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("train_profile needs a CUDA card")
    if model_is_cycle(model):
        trainer = CycleTrainer(model, 9, (size, size), compute_dtype=dtype, seed=seed)
    else:
        trainer = PairedTrainer(model, 9, compute_dtype=dtype, seed=seed)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1.0, 1.0, (batch, size, size, 9)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.uniform(-1.0, 1.0, (batch, size, size, 3)).astype(np.float32)).cuda()
    lr = 2e-4
    for _ in range(2):  # steady state: the library, cuDNN and Adam's state are warm
        trainer.train_step(x, y, lr)
    with FlopCounterMode(display=False) as flops:
        trainer.train_step(x, y, lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            trainer.train_step(x, y, lr)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_cat = collections.Counter()
    by_name = collections.Counter()
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_cat[category(e.name, TRAIN_CATEGORIES)] += dur
        by_name[e.name] += dur
    conv_flop = flops.get_total_flops()
    return {
        "model": model,
        "batch": batch,
        "size": size,
        "compute_dtype": dtype,
        "iters": iters,
        "wall_ms_per_step": wall_us / iters / 1e3,
        "device_ms_per_step": sum(by_cat.values()) / iters / 1e3,
        "device_busy_share": (
            busy_us((e.time_range.start, e.time_range.end) for e in kernels) / wall_us
            if kernels else None
        ),
        "device_ms_per_step_by_category": {k: v / iters / 1e3 for k, v in by_cat.most_common()},
        "top_kernels_ms_per_step": {k[:120]: v / iters / 1e3 for k, v in by_name.most_common(10)},
        "kernel_events_per_step": len(kernels) / iters,
        "conv_tflop_per_step": conv_flop / 1e12,
        "conv_tflop_per_s": (
            conv_flop * iters / (by_cat["convolution"] * 1e-6) / 1e12
            if by_cat["convolution"] else None
        ),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="pairedattention", choices=MODEL_NAMES)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = p.parse_args(argv)
    out = profile_trainer(args.batch, args.size, args.iters, args.dtype, model=args.model)
    out["device"] = card_label()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
