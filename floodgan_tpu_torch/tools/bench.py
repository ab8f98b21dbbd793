"""Headline benchmark of the port: adversarial training of PairedAttention
at 512x512 with the full 9-channel topography stack (the reference's
headline configuration: train.py --model=PairedAttention --topography=all
--resize=512), and two more modes.

    python -m floodgan_tpu_torch.tools.bench [--mode train|eval|pipeline] [--model pairedattention]
        [--size 512] [--batch 8] [--steps 50] [--warmup 5] [--dtype bfloat16] [--remat]
        [--remat_policy convs] [--raw_size 1024] [--pipeline_images 12] [--pipeline_epochs 4]
        [--device cpu]

The counterpart of the root bench.py, with its flags, its defaults and its
output: ONE JSON line with ``metric``, ``value``, ``unit`` and
``vs_baseline``, and the keys of each mode, plus ``device`` (the card's
name and power limit as ``nvidia-smi`` gives them, or ``cpu``).  bench.py's
``--pallas`` has no counterpart: the port has no switch that turns a
kernel off, and every CUDA tensor launches its kernel.

- ``train``: the train step of ``--model`` (``pairedattention``,
  ``pix2pix``, ``cyclegan``, ``attentiongan``, or ``unet`` /
  ``segmentation`` for the U-Net's BCE step) on a batch already on the
  device, ``--warmup`` steps and then ``--steps`` timed ones (host clock,
  ending in a synchronize).  The first warm-up step runs under
  ``torch.utils.flop_counter.FlopCounterMode``, which counts the step's
  convolutions and matmuls, forward and backward: ``flops_per_sample_tf``.
  On a card of ``_PEAK_TFLOPS`` the line adds the achieved
  ``tflops_per_sec``, ``mfu`` against the card's dense peak for the step's
  precision, ``peak_tflops`` and ``peak_precision``.  On another card and
  on the CPU it prints none of the three: no peak is guessed.
- ``eval``: the metric loop of ``Model.calculate_metrics`` on a batch on
  the device: generator forward, PSNR/SSIM (and MS-SSIM from 176^2),
  the U-Net's masks of output and target, the confusion counts; each
  batch's results fetched to the host.
- ``pipeline``: training end to end through ``data.pipeline.BatchLoader``
  over a dataset of ``--pipeline_images`` raw ``--raw_size``^2 TIFF pairs
  (each original and flipped) written from a seed into a temporary
  directory (``FLOODGAN_PIPELINE_DATA`` names a directory to keep and
  reuse): a warm epoch, ``--pipeline_epochs`` measured epochs, the loader
  alone, the step alone on the same shapes.

``vs_baseline`` divides by the reference-derived anchor of bench.py (13.3
samples/s: the reference's measured 1.765 TFLOP a sample at 15% of an
A100's TF32 peak; see its docstring).  A headline run (PairedAttention,
512^2, batch 8, bf16) on the card below 5x the anchor is flagged
``below_target`` with a warning, and exits 1 under
``FLOODGAN_BENCH_STRICT=1``.  It runs on the card unless ``--device cpu``
is given, and fails where there is none.  ``main`` returns the printed
line, as a dict.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from floodgan_tpu_torch.core.config import model_is_cycle
from floodgan_tpu_torch.core.device import card_label, resolve_device

REF_A100_SAMPLES_PER_SEC_EST = 13.3
REF_CPU_MEASURED_SAMPLES_PER_SEC = 0.042
HEADLINE_TARGET = 5.0  # vs_baseline below which a headline run on the card is flagged

# Dense peak TFLOP/s from NVIDIA's data sheets (no sparsity), by a prefix of
# torch.cuda.get_device_name(): bf16 on the tensor cores, TF32 on the
# tensor cores, f32 outside them.
_PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4, "tf32": 494.7, "f32": 66.9},  # SXM5
    "NVIDIA H100 PCIe": {"bf16": 756.5, "tf32": 378.0, "f32": 51.0},
}


def peak_tflops(device_name: str, precision: str):
    """The dense peak of ``precision`` (``bf16``, ``tf32`` or ``f32``) of the
    card whose name starts with the longest matching key, or None."""
    for prefix in sorted(_PEAK_TFLOPS, key=len, reverse=True):
        if device_name.startswith(prefix):
            return _PEAK_TFLOPS[prefix][precision]
    return None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", default="train", choices=["train", "eval", "pipeline"],
                   help="train = the train step on a device-resident batch; eval = the calculate_metrics "
                        "loop (generator fwd + 2x seg U-Net + PSNR/SSIM/MS-SSIM + confusion counts); "
                        "pipeline = training end to end through BatchLoader over an on-disk dataset, "
                        "next to the loader alone and the step alone")
    p.add_argument("--model", default="pairedattention")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--raw_size", type=int, default=1024,
                   help="pipeline mode: on-disk tile resolution (xBD tiles are 1024^2); the device "
                        "transform resizes to --size")
    p.add_argument("--pipeline_images", type=int, default=12,
                   help="pipeline mode: distinct on-disk images (x2 versions = train samples)")
    p.add_argument("--pipeline_epochs", type=int, default=4,
                   help="pipeline mode: measured epochs after the warm epoch")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"],
                   help="compute dtype (f32 master params either way)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialise generator activations")
    p.add_argument("--remat_policy", default="convs", choices=["full", "convs", "boundaries"],
                   help="convs = save conv outputs, recompute only norms; boundaries = save only "
                        "segment boundaries (least memory); the paired trainer takes full or boundaries")
    p.add_argument("--device", default="cuda", help="cpu for the plain versions; default: the card")
    return p


def device_label(device: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi reports them, or
    ``cpu``."""
    return card_label(device.index or 0) if device.type == "cuda" else "cpu"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _emit(result: dict) -> dict:
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mode == "train" and args.warmup < 1:
        parser.error("--warmup must be at least 1: the first warm-up step counts the FLOPs")
    device = resolve_device(args.device, "bench")
    if args.mode == "eval":
        return run_eval(args, device)
    if args.mode == "pipeline":
        return run_pipeline(args, device)
    return run_train(args, device)


def _train_setup(args, device):
    """(trainer, step(i) -> metrics, is_seg) for ``--model``, on bench.py's
    seeded inputs, already on the device."""
    from floodgan_tpu_torch.train.cycle import CycleTrainer
    from floodgan_tpu_torch.train.paired import PairedTrainer
    from floodgan_tpu_torch.train.seg import SegTrainer

    rng = np.random.default_rng(47)
    b, s = args.batch, args.size
    if args.model.lower() in ("unet", "segmentation"):
        # The U-Net on an RGB image -> 1-channel flood-mask logits, BCE, Adam lr 1e-4.
        x = torch.from_numpy(rng.standard_normal((b, s, s, 3), dtype=np.float32)).to(device)
        y = torch.from_numpy((rng.random((b, s, s, 1)) > 0.5).astype(np.float32)).to(device)
        trainer = SegTrainer(compute_dtype=args.dtype, remat=args.remat, device=device, seed=0)
        return trainer, lambda i: trainer.train_step(x, y, 1e-4), True
    x = torch.from_numpy(rng.standard_normal((b, s, s, 9), dtype=np.float32)).to(device)
    y = torch.from_numpy(rng.standard_normal((b, s, s, 3), dtype=np.float32)).to(device)
    if model_is_cycle(args.model):
        trainer = CycleTrainer(args.model, 9, (s, s), compute_dtype=args.dtype, remat=args.remat,
                               remat_policy=args.remat_policy, device=device, seed=0)
    else:
        trainer = PairedTrainer(args.model, 9, compute_dtype=args.dtype, remat=args.remat,
                                remat_policy="full" if args.remat_policy == "full" else "boundaries",
                                device=device, seed=0)
    return trainer, lambda i: trainer.train_step(x, y, 2e-4, step=i), False


def count_step(step):
    """(step's result, FLOPs, whether cuDNN allowed TF32) of one call of
    ``step``: FlopCounterMode's count of its convolutions and matmuls,
    forward and backward, and ``torch.backends.cudnn.allow_tf32`` as each
    convolution module of the step saw it on entry (the trainers run their
    steps with TF32 off)."""
    from torch.utils.flop_counter import FlopCounterMode

    tf32 = []

    def note(module, args):
        if isinstance(module, torch.nn.modules.conv._ConvNd):
            tf32.append(torch.backends.cudnn.allow_tf32)

    hook = torch.nn.modules.module.register_module_forward_pre_hook(note)
    try:
        with FlopCounterMode(display=False) as counter:
            out = step()
    finally:
        hook.remove()
    return out, counter.get_total_flops(), any(tf32)


def run_train(args, device) -> dict:
    trainer, step, is_seg = _train_setup(args, device)
    _, flops_per_step, tf32 = count_step(lambda: step(0))
    for i in range(1, args.warmup):
        step(i)
    sync(device)

    t0 = time.perf_counter()
    for i in range(args.steps):
        step(100 + i)
    sync(device)
    dt = time.perf_counter() - t0

    steps_per_sec = args.steps / dt
    samples_per_sec = steps_per_sec * args.batch
    workload = "mask train" if is_seg else "topo=all train"
    result = {
        "metric": f"{args.model} {args.size}^2 {workload} samples/sec/chip (batch {args.batch})",
        "value": round(samples_per_sec, 4),
        "unit": "batch-1-equivalent samples/sec/chip",
        # The anchor is derived from the GAN step's FLOPs a sample, so it
        # says nothing of the U-Net.
        "vs_baseline": None if is_seg else round(samples_per_sec / REF_A100_SAMPLES_PER_SEC_EST, 4),
        "baseline": f"reference credited 15% of A100 TF32 peak = {REF_A100_SAMPLES_PER_SEC_EST} "
                    f"samples/s (measured same-host CPU: {REF_CPU_MEASURED_SAMPLES_PER_SEC}/s; "
                    "see bench.py docstring + BENCH_NOTES.md)",
        "flops_per_sample_tf": round(flops_per_step / args.batch / 1e12, 4),
    }
    precision = "bf16" if args.dtype == "bfloat16" else "tf32" if tf32 else "f32"
    peak = peak_tflops(torch.cuda.get_device_name(device), precision) if device.type == "cuda" else None
    if peak is not None:
        tflops = flops_per_step * steps_per_sec / 1e12
        result["tflops_per_sec"] = round(tflops, 2)
        result["mfu"] = round(tflops / peak, 4)
        result["peak_tflops"] = peak
        result["peak_precision"] = precision
    result["device"] = device_label(device)

    is_headline = (args.model.lower() == "pairedattention" and args.size == 512 and args.batch == 8
                   and args.dtype == "bfloat16")
    regressed = is_headline and device.type == "cuda" and result["vs_baseline"] < HEADLINE_TARGET
    if regressed:
        result["below_target"] = True
        print(f"WARNING: headline vs_baseline {result['vs_baseline']} < {HEADLINE_TARGET} "
              "(the >= 5x target) -- this is a REGRESSION", file=sys.stderr)
    _emit(result)
    if regressed and os.environ.get("FLOODGAN_BENCH_STRICT") == "1":
        sys.exit(1)
    return result


def run_eval(args, device) -> dict:
    """The eval loop on device-resident batches (module docstring).
    vs_baseline is null: the anchor is the train step's."""
    from floodgan_tpu_torch.eval.metrics import MS_SSIM_MIN_SIDE, MaskMetricsAccumulator
    from floodgan_tpu_torch.train.cycle import CycleTrainer
    from floodgan_tpu_torch.train.paired import PairedTrainer
    from floodgan_tpu_torch.train.seg import SegTrainer

    rng = np.random.default_rng(47)
    b, s = args.batch, args.size
    x = torch.from_numpy(rng.standard_normal((b, s, s, 9), dtype=np.float32)).to(device)
    y = torch.from_numpy(rng.standard_normal((b, s, s, 3), dtype=np.float32)).to(device)
    if model_is_cycle(args.model):
        trainer = CycleTrainer(args.model, 9, (s, s), compute_dtype=args.dtype, device=device, seed=0)
        gen = lambda xx: trainer.generate(xx, "ab")[0]
    else:
        trainer = PairedTrainer(args.model, 9, compute_dtype=args.dtype, device=device, seed=0)
        gen = lambda xx: trainer.generate(xx)[0]
    seg = SegTrainer(compute_dtype=args.dtype, device=device, seed=1)
    ms_ok = args.size >= MS_SSIM_MIN_SIDE
    masks = MaskMetricsAccumulator()

    def eval_batch():
        # One metric block and one fetch of its results a batch, as
        # Model.calculate_metrics does.
        imgm, counts = seg.eval_batch_metrics(gen(x), y, with_ms_ssim=ms_ok)
        masks.add_counts(counts)
        return {k: v.cpu() for k, v in imgm.items()}

    for _ in range(args.warmup):
        eval_batch()
    masks.compute()

    t0 = time.perf_counter()
    for _ in range(args.steps):
        eval_batch()
    masks.compute()
    dt = time.perf_counter() - t0

    return _emit({
        "metric": f"{args.model} {args.size}^2 eval-metrics images/sec/chip (batch {args.batch})",
        "value": round(args.steps * args.batch / dt, 2),
        "unit": "images/sec/chip",
        "vs_baseline": None,
        "ms_per_image": round(1000 * dt / (args.steps * args.batch), 3),
        "includes": "generator fwd + denorm + PSNR/SSIM"
                    + ("/MS-SSIM" if ms_ok else "")
                    + " + 2x seg U-Net masks + confusion counts",
        "device": device_label(device),
    })


def build_pipeline_fixture(root: str, raw: int, n_images: int) -> str:
    """A dataset at the xBD tile contract under ``root``: float32 TIFF
    stacks (9-channel input, 3-channel output), uniform from seed 47, and
    a dataset_split.csv row pair (original, flipped) for each image, all
    split=train, country=usa, same_DEM=10m: the files the 'usa'/'same'
    loader reads.  Returns the metadata directory."""
    from floodgan_tpu_torch.data import tiff

    meta_dir = os.path.join(root, "metadata")
    for d in ("dataset_input", "dataset_output", "metadata"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rng = np.random.default_rng(47)
    rows = []
    for i in range(n_images):
        image = f"hurricane-harvey_{i:08d}"
        for version in ("original", "flipped"):
            rows.append(dict(image=image, best_DEM="01m", same_DEM="10m", version=version, split="train",
                             disaster="hurricane-harvey", country="usa"))
        tiff.imwrite(os.path.join(root, "dataset_input", f"{image}_10m.tif"),
                     rng.random((raw, raw, 9), dtype=np.float32))
        tiff.imwrite(os.path.join(root, "dataset_output", f"{image}.tif"),
                     rng.random((raw, raw, 3), dtype=np.float32))
    with open(os.path.join(meta_dir, "dataset_split.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return meta_dir


def run_pipeline(args, device) -> dict:
    """Training end to end through the loader (module docstring): TIFF
    decode (the native decoder, then the post-transform cache from the
    second epoch), the transform on the device, H2D and the train step,
    next to the step-only rate, the loader-only rate and the bytes a
    second the host must move at the step rate."""
    from floodgan_tpu_torch.data.pipeline import BatchLoader, FloodDataset, post_transform_cache
    from floodgan_tpu_torch.train.paired import PairedTrainer

    keep = os.environ.get("FLOODGAN_PIPELINE_DATA")
    root = keep or tempfile.mkdtemp(prefix="floodgan_bench_")
    try:
        meta_dir = os.path.join(root, "metadata")
        if not os.path.exists(os.path.join(meta_dir, "dataset_split.csv")):
            meta_dir = build_pipeline_fixture(root, args.raw_size, args.pipeline_images)
        resize = args.size if args.size != args.raw_size else None
        ds = FloodDataset("usa", "same", "train", root, "all", resize, None, metadata_dir=meta_dir)
        n_samples = len(ds)
        loader = BatchLoader(ds, batch_size=args.batch, shuffle=True, drop_remainder=True, device=device)
        steps_per_epoch = len(loader)
        trainer = PairedTrainer(args.model, 9, compute_dtype=args.dtype, remat=args.remat, device=device,
                                seed=0)
        lr = 2e-4

        # The warm epoch fills the decode and post-transform caches.
        step_i = 0
        for batch in loader.epoch_iter(0):
            trainer.train_step(batch["input"], batch["output"], lr, step=step_i)
            step_i += 1
        if step_i == 0:
            raise SystemExit(f"--mode pipeline produced zero batches: batch {args.batch} > {n_samples} "
                             "fixture samples (raise --pipeline_images or lower --batch)")
        sync(device)

        # The steady state: the post-transform cache serves, prefetch
        # overlaps the steps.
        t0 = time.perf_counter()
        n_steps = 0
        feed_bytes_per_sample = None
        for e in range(1, 1 + args.pipeline_epochs):
            for batch in loader.epoch_iter(e):
                if feed_bytes_per_sample is None:
                    feed_bytes_per_sample = sum(
                        t.numel() * t.element_size() for t in (batch["input"], batch["output"])
                    ) // batch["input"].shape[0]
                trainer.train_step(batch["input"], batch["output"], lr, step=step_i)
                step_i += 1
                n_steps += 1
        sync(device)
        pipelined = n_steps * args.batch / (time.perf_counter() - t0)
        # The counters are the last iteration's: read them before the
        # loader-only loop starts another.
        post_cache_hit_rate = loader.post_cache_hits / max(loader.post_cache_total, 1)

        # The loader alone: its ceiling, no train step.
        t0 = time.perf_counter()
        n_feed = 0
        for e in range(100, 100 + args.pipeline_epochs):
            for batch in loader.epoch_iter(e):
                last = batch["input"]
                n_feed += 1
        float(last[0, 0, 0, 0])
        host_feed = n_feed * args.batch / (time.perf_counter() - t0)

        # The step alone on the same shapes, the batch on the device.
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.standard_normal((args.batch, args.size, args.size, 9), dtype=np.float32)).to(device)
        y = torch.from_numpy(rng.standard_normal((args.batch, args.size, args.size, 3), dtype=np.float32)).to(device)
        for i in range(3):
            trainer.train_step(x, y, lr, step=i)
        sync(device)
        t0 = time.perf_counter()
        for i in range(20):
            trainer.train_step(x, y, lr, step=i)
        sync(device)
        step_only = 20 * args.batch / (time.perf_counter() - t0)

        raw_bytes_per_sample = args.raw_size * args.raw_size * (9 + 3) * 4
        # With the post-transform cache serving, the steady epochs ship the
        # transformed feed tensors; else every epoch ships the raw stacks.
        # The measured hit rate decides, not the flag: the cache turns
        # itself off on a split that exceeds its byte bound.
        post_cache = post_transform_cache() and feed_bytes_per_sample is not None and post_cache_hit_rate > 0.5
        wire_bytes = feed_bytes_per_sample if post_cache else raw_bytes_per_sample
        return _emit({
            "metric": f"{args.model} {args.size}^2 end-to-end pipelined train "
                      f"samples/sec/chip (batch {args.batch}, raw {args.raw_size}^2 TIFFs)",
            "value": round(pipelined, 4),
            "unit": "samples/sec/chip end-to-end (post-transform cache + H2D + step)"
                    if post_cache else
                    "samples/sec/chip end-to-end (decode cache + device transform + H2D + step)",
            "vs_baseline": None,
            "step_only_samples_per_sec": round(step_only, 4),
            "host_feed_samples_per_sec": round(host_feed, 4),
            "overlap_ratio": round(pipelined / step_only, 4),
            "raw_mb_per_sample": round(raw_bytes_per_sample / 1e6, 1),
            "steady_wire_mb_per_sample": round(wire_bytes / 1e6, 1),
            "required_gbps_at_step_rate": round(step_only * wire_bytes / 1e9, 3),
            "post_transform_cache": post_cache,
            "post_cache_hit_rate": round(post_cache_hit_rate, 3),
            "dataset": f"{n_samples} samples ({args.pipeline_images} images x2 versions), "
                       f"{steps_per_epoch} steps/epoch, {args.pipeline_epochs} measured epochs",
            "device": device_label(device),
        })
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
