#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (floodgan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --k6-parent DIR   # also time DIR's K6 in turns at each reflect-pad site
    python3 chip_smoke.py --k6-only         # device, build and K6's cases only; no result line

Drives the port's main paths at full width: serving and paired training of
PairedAttention (topography "all", 9 input channels) at 512^2, the
content-head microbench (a ConvT 128->64 to 512^2, reflect pad, the 7x7
64->27 head conv) at batch 8 in bf16, the training and predict CLIs, GAN
evaluation with the segmentation U-Net, the other three families (Pix2Pix
and the cycle step of CycleGAN and AttentionGAN), rematerialisation and the
data-parallel path, two training steps under PyTorch's deterministic
algorithms, the spatial axis (image height over 2 ranks, every
family and the U-Net), the comparison CLI, the offline ETL with a training
epoch on its dataset and the .pth.tar export, serving under load (the
serve bench and HTTP), the headline bench in its three modes, and the
multichip dry run on two ranks of the card.
It fails unless every phase passes:

1. device   - a CUDA card is present; prints its name and power limit.
2. build    - compiles csrc/*.cu with nvcc for sm_90a (ops/_build.py).
3. kernels  - each hand-written kernel against its plain PyTorch version on
              the card, at the shapes the main paths give it (K1 instance
              norm and K3 compose, f32 and bf16, K1 also with its per-plane
              (mean, inv) out: y bit for bit the form without, the
              statistics within TOL_F32_IN of the plain ones; K2
              instance-norm backward at the 4 generator and 3 PatchGAN
              sites, f32 and bf16, from K1's saved statistics (the
              training path's form): within the limits of the plain
              version and bit for bit the form that derives them again; K4
              compose backward, f32 and bf16, with and without the mask
              gradient; K5 row copy at the head's padded input, bf16 and
              f32, bit for bit; K6 reflect-pad backward at each reflect-pad
              site of the paired and AttentionGAN steps, the spatial
              axis's W-only pads (trunk, head and stem) and [remat]'s
              1024^2 AttentionGAN, bf16 and f32, bit for bit its plain
              version and identical over TIMED_RUNS repeated launches),
              with its median time (CUDA events), its bound, the plain
              version's time and, where one PyTorch call computes the same
              function, that call's time (K6: ATen's
              reflection_pad2d_backward; K6's share of its bound, and with
              --k6-parent the parent's time); then odd edge shapes and
              misaligned pointers (K6 also one-sided and W-only pads, pads
              one less than the dimension, 70000 planes, a plane shorter
              than a band, H one row over whole bands, rows of no multiple
              of 16 bytes, g at every byte offset 0-14 and g ending its
              block).
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
              after, launches K1 34 times, K2 34 times, K3 and K4 once, K6
              19 times (18 trunk pads and the content head's): the
              training path.  Five steps give finite losses and change both
              parameter sets; then the median step time over 10 steps,
              samples/s and peak memory.
8. head     - python -m floodgan_tpu_torch.tools.microbench_head, through its
              main(), with the launch counts set to 0 before and read after:
              check (every variant within TOL_HEAD_ULPS of raw, and K5 then
              raw equal to raw bit for bit), the fwd+bwd race of every
              variant that has a backward, and the forward race of all 11;
              K5 launches once per raw_pallasfence forward, K6 once per
              fwd+bwd call.
9. cli      - the paired-training CLI end to end on 1024^2 tiles written
              into a temporary directory (12 train images, each original and
              flipped, 8 validation, 2 test; 9-channel inputs, 3-channel
              outputs, uniform from the seed): python -m
              floodgan_tpu_torch.cli.train through its main(), resized to
              512^2, batch 8, bf16, 3 epochs, a .ckpt each epoch; each of its
              9 steps launches K1 34, K2 34, K3 1, K4 1 times.  Then a resume
              from the epoch-1 file, bit for bit against a snapshot the first
              run took after epoch 1 (parameters, Adam moments and steps,
              starting epoch, loss history), trained on to epoch 3; python -m
              floodgan_tpu_torch.cli.predict on the 2 test inputs from the
              epoch-3 file (two PNGs); InferenceEngine.from_checkpoint against
              the in-memory model's generate (within TOL_CKPT_PREDICT); one
              request through ModelRepository.add_checkpoint.  Prints the
              decoder that served and its rate, each epoch's wall time, the
              loaded samples/s beside [train]'s step-only rate, the share of
              each epoch spent blocked in the loader, checkpoint save and load
              times and size, and predict latency.
10. eval    - GAN evaluation and the segmentation U-Net, beside [cli]'s
              dataset: a masks fixture of 1024^2 tiles (12 train, 2
              validation, 2 test; 3-channel image, 1-channel {0, 1} mask);
              python -m floodgan_tpu_torch.cli.segment --train (the
              full-width U-Net, batch 1, f32, 2 epochs, a .ckpt each; finite
              losses, every tensor moved, no K1-K5 launch); a resume of its
              .ckpt bit for bit and the seg train step's time; python -m
              floodgan_tpu_torch.cli.evaluate --calculate_metrics
              --segmentation_model_path on [cli]'s epoch-3 .ckpt and its 8
              validation images at 512^2, batch 8, LPIPS on the seed-47
              fallback weights (each generator forward launches K1 25 times
              and K3 once, the U-Net and the metrics nothing; PSNR, SSIM,
              MS-SSIM finite; the CSV's 15 columns in JAX's order); the
              loop's stages timed (generator, image metrics, the two U-Net
              forwards, LPIPS), eval images/s and peak memory; the card
              against the CPU on the same .ckpt files at 256^2, batch 2
              (generator, per-image PSNR, SSIM, MS-SSIM, LPIPS, U-Net logits,
              confusion counts away from the threshold); ms_ssim on the card
              against tests/test_metrics.py's float64 goldens (the TF32
              guard); python -m floodgan_tpu_torch.cli.predict
              --segmentation_model_path (gray {0, 1} mask PNGs);
              SegmentationModel.calculate_metrics on the masks' validation
              split; and python -m floodgan_tpu_torch.cli.segment without
              --train (its metric CSV, written whether or not matplotlib is
              there for the figures).
11. families - Pix2Pix (PairedTrainer), AttentionGAN and CycleGAN
              (CycleTrainer) at bench.py --mode train's defaults: 512^2,
              batch 8, bf16, topography all.  One step each, the counts set
              to 0 before and read after, launches exactly
              FAMILY_STEP_LAUNCHES (Pix2Pix none; AttentionGAN K1 112, K2 112,
              K3 4, K4 4, K6 78, and 162/162/6/6/116 with the identity loss;
              CycleGAN K1 104, K2 104, K6 78); five steps give finite losses and move every
              network's weights, and a cycle buffer holds min(50, 8 x steps)
              images; then the median step of 10, samples/s and peak memory.
              The card against the CPU at 64^2 (cycle) and 256^2 (Pix2Pix,
              its least size, dropout rate 0), batch 2, f32: step-1 and step-2
              losses.  Then python -m floodgan_tpu_torch.cli.train for each
              family on [cli]'s tiles (512^2, batch 8, bf16, 1 epoch, a
              .ckpt); the AttentionGAN .ckpt resumed bit for bit against a
              snapshot taken after its epoch (parameters, both Adams, both
              bf16 buffers and their counts, the loss history); and
              InferenceEngine.from_checkpoint on each .ckpt against the
              trained Model's generate (within TOL_CKPT_PREDICT; Pix2Pix's
              dropout on the seed-47 stream on both sides).
12. remat  - rematerialisation: the aten ops a convolution reaches the convs
              policy as on the card (exactly CONV_OPS); AttentionGAN
              (CycleTrainer, [families]' seed and batch: 512^2, batch 8,
              bf16, topography all) under convs, boundaries and full: one
              step launches exactly REMAT_CYCLE_LAUNCHES (K1 212, K2 112, K3
              8, K4 4, K6 78: each of the 4 generator reads runs its forward
              kernels again), step-1 losses equal the plain trainer's bit
              for bit, step-2 within TOL_REMAT_STEP2, five steps finite and
              moving every network, then the median step of 10 and the
              peak, beside [families]' no-remat figures; AttentionGAN at
              1024^2, batch 8, bf16 under the policy with the least peak (3
              steps, finite, exact launches, ms and peak); PairedAttention
              under boundaries and full (REMAT_PAIRED_LAUNCHES, K1 59, K2
              34, K3 2, K4 1, K6 19; ms and peak beside [train]'s); the U-Net at
              1024^2, batch 8, f32 with remat (the JAX segment CLI's case;
              no launch); python -m floodgan_tpu_torch.cli.train --remat on
              [cli]'s tiles (1 epoch, exact launches).
13. dp      - a world-size-1 NCCL process group on the card: Pix2Pix (batch
              norm through the global-statistics all-reduces), PairedAttention
              and AttentionGAN (its buffers gathered and striped), each
              DP_STEPS steps on a DataMesh against the plain trainer, which
              runs twice.  Every collective returns its input bit for bit,
              the launches are the same, step-1 losses are bit for bit;
              where the two plain runs agree bit for bit (the strict
              branch), the mesh's run equals them in every loss and
              parameter; where they do not (an op of the step that sums in
              a run-dependent order, with PyTorch's deterministic
              algorithms off), step 2 within TOL_REMAT_STEP2; each family's
              branch is printed.  The gradient all-reduce's ms a step (CUDA
              events); a .sharded directory of the AttentionGAN state
              written and read back bit for bit.
14. determinism - PairedAttention and AttentionGAN at 512^2, batch 8,
              bf16, DET_STEPS steps twice from one seed under
              torch.use_deterministic_algorithms(True)
              (CUBLAS_WORKSPACE_CONFIG set for this phase only, restored
              after it): no op raises, and the two runs agree bit for bit
              in every loss and parameter (the reflect pad's backward is
              K6, not ATen's atomics); launches exactly a step's each.
              Then one fresh trainer times the step with the mode on and
              off in turns: a warm-up step in each, FAMILY_TIMED steps in
              each, the median of each and their ratio.
15. spatial - the spatial axis of the mesh: the partial IN forms (K1s,
              K1a, K2s, K2a) against their plain versions at every IN site
              of one rank's bf16 S = 2 step (each plane split in rows as the
              mesh splits it, the PatchGAN's 63-row level as 32 + 31), with
              both halves' sums added and applied against fused K1/K2 on the
              whole plane, timed against their bounds; the stem's and the
              trunk's sites in f32.  check_devices refuses two NCCL ranks on
              card 0, and NCCL's own refusal past it is recorded.  Then 2
              gloo ranks on card 0 (halos and sums staged through the host),
              PairedAttention at 512^2, global batch 8, bf16, D = 1, S = 2:
              each rank's first step launches exactly SPATIAL_STEP_LAUNCHES
              (K1s/K1a/K2s/K2a 34 each, K3 and K4 once, K6 19 (the W axis
              of each reflect pad), fused K1/K2 none),
              losses against one process on the card from the same init
              (TOL_SPATIAL_STEP1, TOL_SPATIAL_UPDATED), the ranks' parameters
              equal bit for bit after 6 steps, then one step under remat
              boundaries (SPATIAL_REMAT_LAUNCHES: the forward forms 59 times;
              step 1 bit for bit against the plain step).  Prints each rank's
              step time (one card, host-staged: not a measure of scaling),
              the exchanges' share of an instrumented step and peak memory.
              Then the other networks on the same ranks, at [families]'
              widths, each one-process reference run first on the card and
              freed: AttentionGAN (one rank's step launches exactly
              SPATIAL_FAMILY_LAUNCHES: K1s/K1a/K2s/K2a 112 each, K3 and K4
              4, no fused K1/K2; 162 each and 6/6 with the identity loss;
              under remat convs SPATIAL_CONVS_LAUNCHES, 212/212/112/112 and
              8/4), step-1 losses within TOL_SPATIAL_STEP1 of one process,
              step 2 within TOL_SPATIAL_UPDATED, the two ranks' buffer rows
              after step 1 against one process's buffer, the parameters
              equal bit for bit after 6 steps, its step time, exchange share
              and peak beside [families]'; CycleGAN (104 each, no K3/K4);
              Pix2Pix (no launch; its deep U-Net levels gathered and
              replicated; losses as above, the ranks bit for bit after 3
              steps); the U-Net's predict_logits at 1024^2, batch 1, f32 on
              rows against one process (TOL_EVAL_LOGITS of max |logit|) and
              one train_step; the bilinear U-Net's forward at 128^2 on rows.
              Then python -m floodgan_tpu_torch.cli.train --model=AttentionGAN
              --num_spatial_devices 2 --dist_backend gloo on [cli]'s tiles
              (1 epoch): its .sharded directory holds each buffer as two row
              pieces, and a Model resumed from it on 2 gloo ranks holds
              every leaf bit for bit, each rank its buffer rows.
16. compare - python -m floodgan_tpu_torch.cli.compare --compare models
              --calculate_metrics on [cli]'s epoch-3 PairedAttention .ckpt
              and [families]' three, with [eval]'s seg .ckpt, on [cli]'s 8
              validation images at 512^2 (batch 1, LPIPS on the fallback
              weights): both CSVs, the averaged rows PairedAttention,
              Pix2Pix, AttentionGAN, CycleGAN with the 15 columns and finite
              PSNR, SSIM, MS-SSIM, LPIPS, the grouped rows sorted; each image
              launches K1 73 times and K3 twice, nothing else.  Prints the
              wall time and each model's mean Inference.  Then --compare two
              on the Pix2Pix and CycleGAN files.
17. train card-cpu - the same seeded PairedAttention trainer at 64^2, batch
              2, f32 (TF32 off) on the card and on the CPU (plain versions):
              step-1 and step-2 losses.
18. etl     - the offline ETL (floodgan_tpu_torch.pre_processing) on raw
              rasters written from the seed into a temporary directory: 20
              image sets of one disaster at 1024^2 (a GeoTIFF pre-disaster
              image with ModelPixelScale and ModelTiepoint, the post image, a
              DEM with values below 0, flow, river, an RGBA OSM map, a cloud
              mask).  create_metadata (each row's extent from the tags),
              create_dataset_split_metadata (16/2/2 and 18 flipped copies),
              then per image the renders, create_input_stack, apply_masks,
              create_output and write_dataset_pair; one written stack read
              back through the TIFF decoder holds the channel contract bit
              for bit.  Then python -m floodgan_tpu_torch.cli.train through
              its main() on that dataset (512^2, batch 8, bf16, 1 epoch: each
              of its 4 steps launches K1 34, K2 34, K3 1, K4 1), the .ckpt
              exported with utils.torch_export.export_gan_checkpoint and
              migrated back with python -m floodgan_tpu_torch.ckpt.migrate:
              parameters, Adam moments and counts bit for bit.  Prints the
              seconds of each ETL stage, the epoch, the export and migrate.
19. load    - python -m floodgan_tpu_torch.tools.serve_bench through its
              main(): engine mode (batches 1 and 8, 20 iterations), then
              --frontend at 1/8/32 clients x 20 requests (engine batch 8,
              5 ms delay); every forward launches K1 25 times and K3 once,
              nothing else.  Then serve_http over a ModelRepository of
              [etl]'s .ckpt and a seeded CycleGAN engine: 8 client threads,
              each 5 single-image .npy POSTs and one 4-image POST to
              alternating models, every answer 200 and within TOL_HTTP of
              engine.predict on the same image; GET /v1/models counts them;
              then a burst of 24 POSTs against a max_pending=4 model: 200s
              (each right) and 503s with "retry", nothing else.  Prints the
              bench's lines, the HTTP round trip's p50/p99 and each model's
              batch occupancy.
20. bench   - python -m floodgan_tpu_torch.tools.bench through its main(),
              each run with the launch counts set to 0 before and read
              after: --mode train at its defaults (the headline:
              PairedAttention, 512^2, batch 8, bf16, 5 warm-up steps, the
              first under FlopCounterMode, then 50 timed; K1 34, K2 34, K3 1,
              K4 1, K6 19 a step, exactly), again with --steps 10 (the same FLOPs a
              sample), then --steps 10 for pix2pix, cyclegan, attentiongan
              (FAMILY_STEP_LAUNCHES a step) and unet (none); --mode eval
              --steps 10 (K1 25, K3 1 a batch); --mode pipeline at its
              defaults (12 images of 1024^2 and their flipped copies written
              into a temporary directory, batch 8, a warm epoch and 4
              measured ones through BatchLoader, then 23 steps on a batch on
              the card; a train step's launches each).  Every line has a
              finite value above 0, the card's nvidia-smi name and power
              limit, and where printed an MFU in (0, 1]; the train lines on
              the card print tflops_per_sec, mfu, peak_tflops; the pipeline's
              measured epochs come from the post-transform cache (hit rate
              1.0).  Prints each line and its wall time.
21. dryrun  - tools/dryrun.py: dryrun_multichip(2, "cuda") on NCCL is
              refused on one card before any process starts; then its five
              phases (paired, cycle, seg, eval, spatial) on 2 gloo ranks on
              card 0 pass, each phase's wall time printed.

The line before the verdict is one JSON "kernels" line.  The last line is
{"ok": true, "device": {...}}.  Without a card, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# Reflect-pad sites of the driven steps (NCHW, the pad's input): (label,
# shape, pads (left, right, top, bottom), sites a batch-8 512^2 paired step,
# sites an AttentionGAN step).  Each reflect pad whose input needs a
# gradient runs K6 once.  The rest are on no one-process 512^2 step and
# count 0: the spatial axis's W-only pads (one rank of S = 2: the trunk's
# 64 rows and 2 halo rows, the head's and the reconstructions' stem's 256
# rows and 6) and [remat]'s AttentionGAN at 1024^2.
PAD_SITES = (
    ("trunk 128^2x256 pad 1", (BATCH, 256, S // 4, S // 4), (1, 1, 1, 1), 18, 72),
    ("head 512^2x64 pad 3", (BATCH, 64, S, S), (3, 3, 3, 3), 1, 4),
    ("stem 512^2x9 pad 3", (BATCH, 9, S, S), (3, 3, 3, 3), 0, 2),
    ("spatial trunk W only", (BATCH, 256, S // 8 + 2, S // 4), (1, 1, 0, 0), 0, 0),
    ("spatial head W only", (BATCH, 64, S // 2 + 6, S), (3, 3, 0, 0), 0, 0),
    ("spatial stem W only", (BATCH, 9, S // 2 + 6, S), (3, 3, 0, 0), 0, 0),
    ("remat trunk 256^2x256 pad 1", (BATCH, 256, S // 2, S // 2), (1, 1, 1, 1), 0, 0),
    ("remat head 1024^2x64 pad 3", (BATCH, 64, 2 * S, 2 * S), (3, 3, 3, 3), 0, 0),
    ("remat stem 1024^2x9 pad 3", (BATCH, 9, 2 * S, 2 * S), (3, 3, 3, 3), 0, 0),
)
# K6 off the main paths: (shape, pads).  Odd sizes, pads up to the
# dimension less one, one-sided and W-only pads, 70000 planes; a plane
# shorter than one band; the border zones filling the plane (top = bottom =
# H - 1); rows whose bytes are no multiple of 16 (130 bf16 are 260 bytes);
# rows so wide that two f32 stages do not fit a block (one stage a block).
# pad_band_edges adds the shapes that sit on the band plan's own edges.
PAD_EDGES = (
    ((2, 5, 13, 11), (1, 1, 1, 1)), ((2, 5, 13, 11), (3, 3, 3, 3)), ((2, 5, 13, 11), (2, 0, 1, 3)),
    ((1, 3, 2, 2), (1, 1, 1, 1)), ((1, 2, 7, 1), (0, 0, 3, 3)), ((1, 3, 4, 4), (3, 3, 3, 3)),
    ((3, 4, 9, 33), (1, 1, 0, 0)), ((1, 70000, 3, 4), (1, 1, 1, 1)),
    ((2, 3, 5, 300), (1, 1, 1, 1)), ((2, 3, 4, 9), (2, 3, 3, 3)), ((1, 2, 6, 7), (6, 6, 5, 5)),
    ((2, 3, 9, 17), (0, 3, 0, 2)), ((2, 3, 9, 17), (3, 0, 2, 0)), ((2, 3, 9, 17), (0, 0, 2, 0)),
    ((2, 3, 9, 17), (2, 1, 0, 0)), ((2, 4, 40, 130), (1, 1, 1, 1)), ((1, 2, 33, 131), (3, 3, 3, 3)),
    ((1, 2, 9, 5000), (3, 3, 3, 3)),
)
# A g that ends where its allocation ends: the last 16-byte chunk of g is
# the last of the block, so a widened copy must not reach past it.
PAD_AT_END = ((3, 5, 37, 45), (1, 1, 1, 1))
PAD_AT_END_BYTES = 2 ** 21  # the block g ends: a size the allocator gives as it is


def pad_band_edges(itemsize: int) -> tuple:
    """K6's shapes on the band plan's edges for elements of ``itemsize``
    bytes: H one row more than a whole number of bands, the row a band of
    its own (no bottom pad) or joining the last band (bottom pad 1), over
    600- to 1200-byte padded rows."""
    from floodgan_tpu_torch.ops import kernels

    cases = []
    for w, pads in ((300, (1, 1, 1, 0)), (300, (1, 1, 3, 1))):
        for h in range(2, 4096):
            plan = kernels.reflect_pad_bands(h, w, pads, itemsize)
            if plan.count >= 2 and h % plan.rows == 1:
                cases.append(((2, 3, h, w), pads))
                break
    return tuple(cases)


LR = 2e-4
# The partial IN forms run only on the spatial axis ([spatial]); every other
# path launches none of them.
NO_PARTIAL = {"in_stats": 0, "in_apply": 0, "in_bwd_stats": 0, "in_bwd_apply": 0}
# K6, the reflect pad's backward, runs once for each reflect pad whose input
# needs a gradient: a generator read's 18 trunk convolutions and its head's
# pad 3 (the content head of the attention generators, CycleGAN's RGB
# head), and the stem's pad 3 where the generator reads a synthetic image
# (the two cycle reconstructions).  A paired step reads the generator once
# with a gradient: 19.
GEN_PADS = 18 + 1
TRAIN_STEP_LAUNCHES = {"in_act": 34, "in_bwd": 34, "compose": 1, "compose_bwd": 1, "copy": 0, **NO_PARTIAL,
                       "reflect_pad_bwd": GEN_PADS}
SERVE_LAUNCHES = {"in_act": 25, "in_bwd": 0, "compose": 1, "compose_bwd": 0, "copy": 0, **NO_PARTIAL,
                  "reflect_pad_bwd": 0}
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
# [cli]: the xBD tile size, the split sizes, the epochs; the .ckpt holds the
# f32 weights bit for bit, so the engine of the file and the in-memory model
# run the same function on the same weights.
CLI_TILE = 1024
CLI_SPLITS = (("train", 12), ("validation", BATCH), ("test", 2))
CLI_EPOCHS = 3
TOL_CKPT_PREDICT = 1e-6
# [eval]: the masks fixture at the xBD tile size (3-channel images, 1-channel
# {0, 1} masks), the seg CLI's epochs, and the card against the CPU on the
# same checkpoints at EVAL_CMP_SIZE, batch EVAL_CMP_BATCH.
CARD = "cuda"
MASK_SPLITS = (("train", 12), ("validation", 2), ("test", 2))
SEG_EPOCHS = 2
SEG_LR = 1e-4
EVAL_CMP_SIZE = 256
EVAL_CMP_BATCH = 2
EVAL_RUNS = 5
TOL_EVAL_GEN = 1e-3     # generator outputs, as in [card-cpu]
TOL_EVAL_PSNR = 1e-5    # relative; the metrics below run on the same images on both
TOL_EVAL_METRIC = 1e-4  # SSIM, MS-SSIM, LPIPS, absolute
TOL_EVAL_LOGITS = 1e-3  # U-Net logits, of max |logit| (cuDNN may pick Winograd or FFT for f32 convs)
NEAR_THRESHOLD = 1e-4   # |logit| within which the card and the CPU may fall on
                        # opposite sides of sigmoid > 0.5 (at least; the band
                        # widens to the measured logit difference)
TOL_GOLDEN = 2e-5
# [families]: the three other families at bench.py --mode train's defaults
# (512^2, batch 8, bf16, topography all).  One step of each launches, by the
# structure of the step: Pix2Pix no hand-written kernel (batch norms, no
# compose); a cycle step 4 generator forwards (6 with the identity loss),
# each 25 IN sites for the attention generator and 23 for CycleGAN's, and 4
# PatchGAN reads of 3 IN sites (2 in the G loss, 2 concatenated in the D
# update), each forward and backward; the attention generator one compose
# per forward, each forward and backward; K6 GEN_PADS a generator read and
# the 2 reconstructions' stem pads.
NO_LAUNCHES = {"in_act": 0, "in_bwd": 0, "compose": 0, "compose_bwd": 0, "copy": 0, **NO_PARTIAL,
               "reflect_pad_bwd": 0}
CYCLE_PADS = 4 * GEN_PADS + 2
FAMILY_STEP_LAUNCHES = {
    "pix2pix": NO_LAUNCHES,
    "attentiongan": {"in_act": 112, "in_bwd": 112, "compose": 4, "compose_bwd": 4, "copy": 0, **NO_PARTIAL,
                     "reflect_pad_bwd": CYCLE_PADS},
    "attentiongan+identity": {"in_act": 162, "in_bwd": 162, "compose": 6, "compose_bwd": 6, "copy": 0, **NO_PARTIAL,
                              "reflect_pad_bwd": CYCLE_PADS + 2 * GEN_PADS},
    "cyclegan": {"in_act": 104, "in_bwd": 104, "compose": 0, "compose_bwd": 0, "copy": 0, **NO_PARTIAL,
                 "reflect_pad_bwd": CYCLE_PADS},
}
FAMILY_TIMED = 10
FAMILY_CMP = {"pix2pix": 256, "cyclegan": 64, "attentiongan": 64}  # card against CPU, batch 2, f32
FAMILIES = {"pix2pix": "Pix2Pix", "cyclegan": "CycleGAN", "attentiongan": "AttentionGAN"}
# [compare]: the generator forwards of one image under --compare models.
COMPARE_LAUNCHES_PER_IMAGE = {"in_act": 25 + 25 + 23, "in_bwd": 0, "compose": 2, "compose_bwd": 0, "copy": 0, **NO_PARTIAL,
                              "reflect_pad_bwd": 0}
COMPARE_MODELS = ("PairedAttention", "Pix2Pix", "AttentionGAN", "CycleGAN")
# [remat]: a recomputed generator read launches its forward kernels again
# in the backward: 25 K1 and one K3 per attention-generator read, under every
# policy.  Early stop leaves none out: the last op of each segment that saves
# a tensor for the backward is an IN or the compose, whose autograd Function
# packs its saved inputs after its kernel ran.  4 reads a cycle step, 1 a
# paired step; no backward kernel runs more often (K6 neither: a recomputed
# pad's forward is ATen's).
REMAT_POLICIES = ("convs", "boundaries", "full")
REMAT_CYCLE_LAUNCHES = {"in_act": 112 + 4 * 25, "in_bwd": 112, "compose": 4 + 4, "compose_bwd": 4, "copy": 0, **NO_PARTIAL,
                        "reflect_pad_bwd": CYCLE_PADS}
REMAT_PAIRED_LAUNCHES = {"in_act": 34 + 25, "in_bwd": 34, "compose": 1 + 1, "compose_bwd": 1, "copy": 0, **NO_PARTIAL,
                         "reflect_pad_bwd": GEN_PADS}
REMAT_TIMED = 10
REMAT_BIG = 2 * S          # the xBD tile's native size
REMAT_BIG_STEPS = 3
SEG_REMAT_STEPS = 3        # the U-Net at REMAT_BIG, batch BATCH, f32 (floodgan_tpu/cli/segment.py:27)
TOL_REMAT_STEP2 = 2e-3     # step-2 losses follow an Adam update (TOL_TRAIN_STEP2's reason)
DP_STEPS = 2               # [dp]: steps compared bit for bit at world size 1
DET_STEPS = 3              # [determinism]: steps of each run under deterministic algorithms
# [spatial]: PairedAttention on the mesh's spatial axis, H over 2 ranks on
# card 0 over gloo (NCCL refuses two ranks on one card).  One rank's step
# launches, by the structure of the step: 34 IN sites (25 generator, 3
# PatchGAN levels x 3 reads), each K1s and K1a forward and K2s and K2a
# backward; the compose once each way; no fused K1/K2; K6 for each reflect
# pad's W axis, as in one process.  Under remat boundaries the generator
# read's 25 forward sites and its compose run again.
SPATIAL = 2
SPATIAL_STEP_LAUNCHES = {"in_act": 0, "in_bwd": 0, "compose": 1, "compose_bwd": 1, "copy": 0,
                         "in_stats": 34, "in_apply": 34, "in_bwd_stats": 34, "in_bwd_apply": 34,
                         "reflect_pad_bwd": GEN_PADS}
SPATIAL_REMAT_LAUNCHES = {**SPATIAL_STEP_LAUNCHES, "compose": 2, "in_stats": 34 + 25, "in_apply": 34 + 25}
SPATIAL_TIMED = 3
# The other networks on the same 2 gloo ranks ([families]' widths: 512^2,
# global batch 8, bf16, topography all).  Each IN site of a rank's cycle
# step that runs fused K1/K2 in one process ([families]: AttentionGAN 112,
# 162 with the identity loss, CycleGAN 104) runs as the partial forms, K1s
# and K1a forward, K2s and K2a backward; the compose is pixel-wise and runs
# on rows as in one process.  Under remat convs each of the 4 generator
# reads runs its 25 forward sites and its compose again in the backward.
# Pix2Pix and the U-Net launch nothing, as in one process.


def _as_partial(counts: dict) -> dict:
    """One process's launches of a step as a spatial rank's: the fused IN
    forms' counts moved to the partial forms."""
    return {**counts, "in_act": 0, "in_bwd": 0, "in_stats": counts["in_act"], "in_apply": counts["in_act"],
            "in_bwd_stats": counts["in_bwd"], "in_bwd_apply": counts["in_bwd"]}


SPATIAL_FAMILY_LAUNCHES = {k: _as_partial(v) for k, v in FAMILY_STEP_LAUNCHES.items()}
SPATIAL_CONVS_LAUNCHES = _as_partial(REMAT_CYCLE_LAUNCHES)
SPATIAL_CYCLE_STEPS = 6        # AttentionGAN: 1 counted, 1 compared, SPATIAL_TIMED timed, 1 instrumented
SPATIAL_P2P_STEPS = 3          # Pix2Pix: 1 counted, 1 compared, 1 more before the ranks' parameters are compared
SPATIAL_UNET = 2 * S           # the segment CLI's 1024^2, batch 1, f32
SPATIAL_BILINEAR = 128         # the bilinear U-Net's forward, batch 2, f32
TOL_STATS = 1e-5           # K1s/K2s's sums against the plain version's, of the sums of |.|: another order
# The ranks' losses against one process's.  Those that read no updated
# parameter (step 1's D losses and L1): the shards' convolutions may take
# other cuDNN algorithms and the IN sums are split in two, so a bf16
# activation may round the other way; a mean of millions of such elements
# stays within one bf16 ulp (2^-8 relative) of the other run's.
TOL_SPATIAL_STEP1 = 2.0 ** -8
# Those that read an updated parameter (step 1's G loss reads the updated
# D; all of step 2): Adam's first update is about lr x sign(grad) for every
# element, so each weight whose bf16 gradient takes the other sign in the
# other run moves 2 x lr the other way.  A CPU rehearsal (bf16 autocast,
# 64^2, batch 2) put the G adversarial loss 1.35e-2 apart at step 2.  The
# exact equivalence is held on the CPU in f32 and float64
# (tests/test_torch_spatial_step.py); this is a sanity bound.
TOL_SPATIAL_UPDATED = 5e-2
# [etl]: raw rasters of one disaster at xBD's tile size, built into a
# dataset by the offline ETL (an 80/10/10 split: 16/2/2, and 18 flipped
# copies), then one epoch of the training CLI on it at [cli]'s settings.
ETL_DISASTER = "hurricane-florence"
ETL_IMAGES = 20
ETL_TILE = 1024
ETL_DEM = "01m"            # every tile's best DEM: render_dem clamps its negatives
ETL_PIXEL_DEG = 2.7e-6     # about 0.3 m a pixel at 34 degrees north
# [load]: the serve bench through its main() (engine mode, then the frontend
# at 1/8/32 clients), then HTTP: HTTP_CLIENTS threads each sending
# HTTP_SINGLE single-image .npy bodies and one HTTP_MULTI-image body to
# alternating models, then a burst against a max_pending=BURST_PENDING model.
LOAD_ITERS = 20
LOAD_CLIENTS = (1, 8, 32)
LOAD_REQUESTS = 20
LOAD_DELAY_MS = 5.0
HTTP_CLIENTS = 8
HTTP_SINGLE = 5
HTTP_MULTI = 4
HTTP_POOL = 16             # distinct images the requests draw from
BURST_CLIENTS = 24
BURST_PENDING = 4
# An answer through HTTP against engine.predict of the same image (f32, TF32
# off): the batch it shared differs, and only per-sample work touches it.
TOL_HTTP = 1e-5
# [bench]: python -m floodgan_tpu_torch.tools.bench through its main(), at its
# defaults (--warmup 5 --steps 50; the first warm-up step counts the FLOPs)
# and, for the other models and a second headline run, BENCH_SHORT_STEPS
# timed steps.  Launches a run: a step's (or an eval batch's generator
# forward's) times the steps; the U-Net launches nothing.
BENCH_WARMUP, BENCH_STEPS, BENCH_SHORT_STEPS = 5, 50, 10
BENCH_MODELS = ("pix2pix", "cyclegan", "attentiongan", "unet")
BENCH_PIPELINE_SAMPLES = 2 * 12  # --pipeline_images 12, each original and flipped
# [dryrun]: the five phases of tools/dryrun.py on DRYRUN_RANKS gloo ranks on card 0.
DRYRUN_RANKS = 2
# The metric CSV's columns in the JAX package's order
# (floodgan_tpu/api/model.py:614-619).
JAX_METRIC_COLUMNS = (
    "PSNR", "SSIM", "MS-SSIM", "LPIPS", "MSE", "Accuracy", "F1_Flood", "Precision_Flood", "Recall_Flood",
    "F1_No_Flood", "Precision_No_Flood", "Recall_No_Flood", "IoU_Flood", "IoU_No_Flood", "Inference",
)
# tests/test_metrics.py:110-126: float64 goldens of the 5-scale MS-SSIM on
# three 192^2 pairs; low-precision Gaussian convs (TF32 here) push the deep
# scales' CS over 1.
_MS_SSIM_GOLDENS = {
    "noise_0.05": 0.98805573,
    "noise_0.2": 0.84920936,
    "blurless_shift": 0.99547297,
}


def _ms_ssim_golden_cases():
    rng = np.random.default_rng(47)
    x = rng.random((192, 192, 3)).astype(np.float32)
    return x, {
        "noise_0.05": np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1).astype(np.float32),
        "noise_0.2": np.clip(x + rng.normal(0, 0.2, x.shape), 0, 1).astype(np.float32),
        "blurless_shift": np.clip(x * 0.9 + 0.05, 0, 1).astype(np.float32),
    }


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
        self.lib_ms = 0.0  # None once a site has no library call
        self.by = {"bytes": 0.0, "operations": 0.0}

    def add(self, count, ms, plain_ms, b_ms, b_by, err, lib_ms=None):
        self.ms += count * ms
        self.plain_ms += count * plain_ms
        self.bound_ms += count * b_ms
        self.by[b_by] += count * b_ms
        self.err = max(self.err, err)
        self.lib_ms = None if lib_ms is None or self.lib_ms is None else self.lib_ms + count * lib_ms

    def row(self, name, source, replaces):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": None, "max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": max(self.by, key=self.by.get), "library_ms": self.lib_ms}


def _in_case(gen, label, shape, dtype, relu, has_res, slope, backward):
    """One instance-norm site: K1 (or K2 with ``backward``) against its
    plain version.  K1 also with its statistics out (held against the plain
    statistics); K2 from K1's saved statistics, the training path's form
    (held against the plain version and, bit for bit, against the form
    that derives them again).  Returns (ms, plain_ms, bound_ms, bound_by,
    err, other_ms): ms the main path's form (K1 without statistics, K2 from
    them), other_ms the other form's (K1 with, K2 without)."""
    from floodgan_tpu_torch.ops import kernels

    x = _randn(shape, dtype, gen, mean=0.5)
    other = _randn(shape, dtype, gen) if (has_res or backward) else None
    at_kink = 0
    _, stats = kernels.instance_norm_act_fwd(x, relu=relu, negative_slope=slope, save_stats=True)
    _, stats_plain = kernels.instance_norm_act_plain(x, relu=relu, negative_slope=slope, save_stats=True)
    stats_err = float((stats - stats_plain).abs().max())
    check(stats.dtype == torch.float32 and stats.shape == (shape[0], shape[1], 2) and stats_err <= TOL_F32_IN,
          f"{label}: K1's saved (mean, inv) off the plain ones by {stats_err}")
    if backward:
        other, at_kink = _off_kink(x, other, relu)

        def kern():
            return kernels.instance_norm_act_bwd(x, other, relu=relu, negative_slope=slope, stats=stats)

        def alt():
            return kernels.instance_norm_act_bwd(x, other, relu=relu, negative_slope=slope)

        def plain():
            return kernels.instance_norm_act_bwd_plain(x, other, relu=relu, negative_slope=slope)
    else:
        def kern():
            return kernels.instance_norm_act_fwd(x, relu=relu, residual=other, negative_slope=slope)

        def alt():
            return kernels.instance_norm_act_fwd(x, relu=relu, residual=other, negative_slope=slope,
                                                 save_stats=True)

        def plain():
            return kernels.instance_norm_act_plain(x, relu=relu, residual=other, negative_slope=slope)

    got, want = kern(), plain()
    other_got = alt()
    torch.cuda.synchronize()
    check(got.dtype == dtype and got.shape == x.shape, f"{label}: bad output")
    other_y = other_got if backward else other_got[0]
    check(torch.equal(got.view(-1).view(torch.uint8), other_y.view(-1).view(torch.uint8)),
          f"{label}: K{2 if backward else 1} with and without saved statistics differ")
    err, ok = _close(got, want, dtype, TOL_F32_IN)
    ms, plain_ms, other_ms = median_ms(kern), median_ms(plain), median_ms(alt)
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
    forms = (f"from saved statistics, bit for bit the form without them (ms {other_ms:.4f})" if backward else
             f"stats-out form ms {other_ms:.4f}, y bit for bit, (mean, inv) within {stats_err:.3g}")
    say("kernels", f"{name} {label} {str(dtype)[6:]} {tuple(shape)}: max_abs_err {err:.3g} "
                   f"(tol {_tol_text(dtype, TOL_F32_IN)}{kink}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
                   f"bound_ms {b_ms:.4f} ({b_by}) library_ms {_fmt(lib_ms)}; {forms}")
    check(ok, f"{name} {label} {dtype}: max_abs_err {err} over tolerance")
    del x, other, got, want, other_got, stats
    return ms, plain_ms, b_ms, b_by, err, other_ms


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


# K6 of another checkout (``--k6-parent``): a function (g, pads) -> dx,
# timed in turns beside this tree's K6 at every reflect-pad site.
K6_PARENT = None


def _parent_reflect_pad_bwd(root: str, build_dir: str):
    """K6 of the port's checkout at ``root``: its csrc/reflect_pad.cu built
    alone into ``build_dir`` with this tree's nvcc flags, called through
    its C entry as that checkout's _build.SIGNATURES lists it (without or
    with the band plan, which this tree's ``reflect_pad_bands`` gives)."""
    import ctypes
    import importlib.util
    import os

    from floodgan_tpu_torch.ops import _build, kernels

    spec = importlib.util.spec_from_file_location(
        "k6_parent_build", os.path.join(root, "floodgan_tpu_torch", "ops", "_build.py"))
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)
    lib_path = os.path.join(build_dir, "libk6_parent.so")
    _build._run_all([[_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib_path,
                      os.path.join(root, "floodgan_tpu_torch", "csrc", "reflect_pad.cu")]])
    lib = ctypes.CDLL(lib_path)
    entries = {}
    for dtype, name in ((torch.float32, "floodgan_reflect_pad_bwd_f32"),
                        (torch.bfloat16, "floodgan_reflect_pad_bwd_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = list(theirs.SIGNATURES[name])
        fn.restype = ctypes.c_int
        entries[dtype] = (fn, len(theirs.SIGNATURES[name]) == 14)

    def run(g, pads):
        fn, banded = entries[g.dtype]
        left, right, top, bottom = pads
        n, c, hp, wp = g.shape
        h, w = hp - top - bottom, wp - left - right
        dx = torch.empty((n, c, h, w), device=g.device, dtype=g.dtype)
        plan = tuple(kernels.reflect_pad_bands(h, w, tuple(pads), g.element_size())) if banded else ()
        err = fn(g.data_ptr(), dx.data_ptr(), n * c, h, w, left, right, top, bottom, *plan,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the parent's reflect_pad_bwd: cudaError {err}")
        return dx

    return run


def _pad_case(gen, label, shape, pads, dtype):
    """K6 at one reflect-pad site (``shape`` the pad's input, ``pads`` in
    F.pad's order) against its plain version, bit for bit, and against
    itself over TIMED_RUNS launches; timed in turns with the plain version,
    ATen's ``reflection_pad2d_backward`` at the same site and, with
    ``--k6-parent``, the parent's K6 (bit for bit this one).  Returns
    (ms, plain_ms, bound_ms, bound_by, err, library_ms, the parent's ms or
    None)."""
    from floodgan_tpu_torch.ops import kernels

    left, right, top, bottom = pads
    n, c, h, w = shape
    g = _randn((n, c, h + top + bottom, w + left + right), dtype, gen)
    x = torch.empty(shape, dtype=dtype, device="cuda")  # ATen's backward reads only its shape
    got, want = kernels.reflect_pad_bwd(g, pads), kernels.reflect_pad_bwd_plain(g, pads)
    aten = torch.ops.aten.reflection_pad2d_backward(g, x, list(pads))
    torch.cuda.synchronize()
    label = f"reflect_pad_bwd {label} {str(dtype)[6:]} {tuple(shape)} pads {tuple(pads)}"
    check(got.shape == shape and _same_bits(got, want), f"{label}: not bit for bit the plain version")
    same = all(_same_bits(kernels.reflect_pad_bwd(g, pads), got) for _ in range(TIMED_RUNS))
    check(same, f"{label}: {TIMED_RUNS} repeated launches gave other bits")
    aten_err = float((aten.float() - got.float()).abs().max())
    fns = {"kernel": lambda: kernels.reflect_pad_bwd(g, pads),
           "plain": lambda: kernels.reflect_pad_bwd_plain(g, pads),
           "library": lambda: torch.ops.aten.reflection_pad2d_backward(g, x, list(pads))}
    if K6_PARENT is not None:
        check(_same_bits(K6_PARENT(g, pads), got), f"{label}: the parent's K6 gave other bits")
        fns["parent"] = lambda: K6_PARENT(g, pads)
    t = _in_turns(fns)
    b_ms, b_by = bound_ms((g.numel() + got.numel()) * g.element_size(), g.numel() - got.numel())
    parent = f", the parent's K6 ms {t['parent']:.4f}" if "parent" in t else ""
    say("kernels", f"{label}: bitwise, identical over {TIMED_RUNS} repeats, max_abs_err 0; ms {t['kernel']:.4f} "
                   f"plain_ms {t['plain']:.4f} bound_ms {b_ms:.4f} ({b_by}, {b_ms / t['kernel']:.2f} of it) "
                   f"library_ms (ATen's reflection_pad2d_backward) {t['library']:.4f}, |ATen - K6| max "
                   f"{aten_err:.3g}{parent}")
    del g, x, got, want, aten
    return t["kernel"], t["plain"], b_ms, b_by, 0.0, t["library"], t.get("parent")


def phase_pads(gen) -> tuple:
    """K6 at each reflect-pad site of the paired and AttentionGAN steps
    (f32, then bf16), then its edge shapes.  Returns the bf16 totals of a
    paired and of an AttentionGAN step."""
    pads_paired, pads_cycle = _Total(), _Total()
    parent = {"paired": 0.0, "AttentionGAN": 0.0}
    for label, shape, pads, n_paired, n_cycle in PAD_SITES:
        _pad_case(gen, label, shape, pads, torch.float32)
        *r, parent_ms = _pad_case(gen, label, shape, pads, torch.bfloat16)
        pads_paired.add(n_paired, *r)
        pads_cycle.add(n_cycle, *r)
        if parent_ms is not None:
            parent["paired"] += n_paired * parent_ms
            parent["AttentionGAN"] += n_cycle * parent_ms
    for what, t in (("paired", pads_paired), ("AttentionGAN", pads_cycle)):
        of_parent = f" (the parent's K6 {parent[what]:.4f})" if K6_PARENT is not None else ""
        say("kernels", f"reflect_pad_bwd, the bf16 sites of one batch-{BATCH} {S}^2 {what} step: ms {t.ms:.4f}"
                       f"{of_parent} plain_ms {t.plain_ms:.4f} bound_ms {t.bound_ms:.4f} "
                       f"({t.bound_ms / t.ms:.2f} of it) library_ms {_fmt(t.lib_ms)}")
    phase_pad_edges(gen)
    return pads_paired, pads_cycle


def phase_pad_edges(gen) -> None:
    """K6 bit for bit its plain version at every edge shape, f32 and bf16,
    with g at every byte offset 0-14 into its storage that its element
    allows (the copies' widened windows, the shifted reads), and once
    ending at the last byte of its block."""
    from floodgan_tpu_torch.ops import kernels

    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.empty((), dtype=dtype).element_size()
        for shape, pads in PAD_EDGES + pad_band_edges(es):
            left, right, top, bottom = pads
            n, c, h, w = shape
            padded = (n, c, h + top + bottom, w + left + right)
            numel = n * c * padded[2] * padded[3]
            big = _randn((numel + 16 // es,), dtype, gen)
            check(big.data_ptr() % 16 == 0, "a fresh block is not 16-byte aligned")
            for off in range(0, 15, es):
                g = big[off // es:off // es + numel].view(padded)
                plan = kernels.reflect_pad_bands(h, w, pads, es)
                check(_same_bits(kernels.reflect_pad_bwd(g, pads), kernels.reflect_pad_bwd_plain(g, pads)),
                      f"reflect_pad_bwd {shape} pads {pads} {dtype} at byte {off} ({plan}): not bit for bit")
                cases += 1
        shape, pads = PAD_AT_END
        left, right, top, bottom = pads
        padded = (shape[0], shape[1], shape[2] + top + bottom, shape[3] + left + right)
        nbytes = padded[0] * padded[1] * padded[2] * padded[3] * es
        block = torch.empty(PAD_AT_END_BYTES, dtype=torch.uint8, device="cuda")
        g = block[PAD_AT_END_BYTES - nbytes:].view(dtype).view(padded)
        g.copy_(_randn(padded, dtype, gen))
        check(g.data_ptr() + nbytes == block.data_ptr() + PAD_AT_END_BYTES, "g does not end its block")
        check(_same_bits(kernels.reflect_pad_bwd(g, pads), kernels.reflect_pad_bwd_plain(g, pads)),
              f"reflect_pad_bwd {shape} pads {pads} {dtype} at the end of its block: not bit for bit")
        cases += 1
        del big, block, g
    torch.cuda.synchronize()
    say("kernels", f"reflect_pad_bwd bit for bit at {cases} edge cases: {len(PAD_EDGES)} shapes and the band "
                   "plan's edges (H one row over whole bands, the row its own band or the last's), f32 and "
                   "bf16, g at every byte offset 0-14 its element allows; and g ending its block")


def phase_kernels() -> dict:
    """Every kernel at the main paths' shapes.  Returns the JSON rows by
    kernel name: in_act and attention_compose over one f32 serving
    forward (as in the first slice), in_bwd (from saved statistics),
    attention_compose_bwd and reflect_pad_bwd over one bf16 train step,
    row_copy at the head's bf16 input."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    serve_in, train_in, train_in_stats, train_bwd, train_bwd_again = _Total(), _Total(), _Total(), _Total(), _Total()

    for label, shape, relu, res, n in IN_SITES:
        serve_in.add(n, *_in_case(gen, label, shape, f32, relu, res, 0.0, False)[:5])
    for label, shape, relu, res, n in IN_SITES:
        r = _in_case(gen, label, shape, bf16, relu, res, 0.0, False)
        train_in.add(n, *r[:5])
        train_in_stats.add(n, r[5], *r[1:5])
    for label, shape in D_SITES:
        r = _in_case(gen, label, shape, bf16, True, False, 0.2, False)
        train_in.add(D_READS, *r[:5])
        train_in_stats.add(D_READS, r[5], *r[1:5])
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
                train_bwd.add(n, *r[:5])
                train_bwd_again.add(n, r[5], *r[1:5])
        for label, shape in D_SITES:
            r = _in_case(gen, label, shape, dtype, True, False, 0.2, True)
            if dtype == bf16:
                train_bwd.add(D_READS, *r[:5])
                train_bwd_again.add(D_READS, r[5], *r[1:5])

    compose = _compose_case(gen, f32, False)
    _compose_case(gen, bf16, False)
    for dtype in (f32, bf16):
        _compose_case(gen, dtype, True, with_gmask=True, rgb_grad=True)
    _compose_case(gen, f32, True)
    compose_bwd = _compose_case(gen, bf16, True)  # the train step's case
    copy_ms, copy_plain, copy_bound, copy_by, copy_err, copy_lib = _row_copy_case(gen, bf16)  # the head's
    copy_err = max(copy_err, _row_copy_case(gen, f32)[4])

    pads_paired, _ = phase_pads(gen)

    say("kernels", f"in_act, the 25 f32 sites of one batch-{BATCH} {S}^2 forward: ms {serve_in.ms:.4f} "
                   f"plain_ms {serve_in.plain_ms:.4f} bound_ms {serve_in.bound_ms:.4f}")
    say("kernels", f"in_act, the 34 bf16 sites of one batch-{BATCH} {S}^2 train step: ms {train_in.ms:.4f} "
                   f"(with the statistics out, the training path's form, {train_in_stats.ms:.4f}) "
                   f"plain_ms {train_in.plain_ms:.4f} bound_ms {train_in.bound_ms:.4f}")
    say("kernels", f"in_bwd, the 34 bf16 sites of one batch-{BATCH} {S}^2 train step: ms {train_bwd.ms:.4f} "
                   f"from saved statistics ({train_bwd_again.ms:.4f} deriving them again) "
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
        # No Pallas kernel: the XLA adjoint of the JAX package's reflect pad.
        "reflect_pad_bwd": pads_paired.row("reflect_pad_bwd", "floodgan_tpu_torch/csrc/reflect_pad.cu",
                                           "floodgan_tpu/ops/fused_grads.py:256"),
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
                y_stats, stats = kernels.instance_norm_act_fwd(x, relu=relu, residual=r, negative_slope=slope,
                                                               save_stats=True)
                pairs = ((y_stats, kernels.instance_norm_act_fwd(x, relu=relu, residual=r, negative_slope=slope)),
                         (kernels.instance_norm_act_bwd(x, g, relu=relu, negative_slope=slope, stats=stats),
                          kernels.instance_norm_act_bwd(x, g, relu=relu, negative_slope=slope)))
                check(all(torch.equal(a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8)) for a, b in pairs),
                      f"K1/K2 {shape} {dtype} relu={relu}: the saved-statistics forms differ from the others")
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
                   "max_abs_err " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
                   + "; K1 and K2 with saved statistics bit for bit the forms without")


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
    return counts, BATCH / (step_ms / 1e3), (step_ms, peak / 2**30)


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
    # one raw_pallasfence forward in check, and a warm-up plus HEAD_ITERS in
    # the forward race; the reflect pad's backward K6 in each call of the
    # fwd+bwd race: a warm-up plus HEAD_ITERS for each variant with a backward
    backward = set(microbench_head.HEADS) - set(microbench_head.FORWARD_ONLY)
    want = {k: 0 for k in counts} | {"copy": 2 + HEAD_ITERS, "reflect_pad_bwd": (1 + HEAD_ITERS) * len(backward)}
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


class _Launches:
    """The kernels' launch counters around runs of a main path: ``zero``
    before a run, ``read`` after it (checked against the expected counts and
    added to ``total``)."""

    def __init__(self):
        from floodgan_tpu_torch.ops import kernels

        self.counters = kernels.LAUNCHES
        self.total = {k: 0 for k in self.counters}

    def zero(self) -> None:
        for k in self.counters:
            self.counters[k] = 0

    def read(self, what: str, want: dict) -> dict:
        torch.cuda.synchronize()
        got = dict(self.counters)
        check(got == want, f"{what} launched {got}, expected {want}")
        for k in self.total:
            self.total[k] += got[k]
        return got


def _write_cli_fixture(root: str, rng) -> list:
    """The [cli] dataset on disk, in the reference layout: dataset_input/,
    dataset_output/ and metadata/dataset_split.csv (best_DEM == same_DEM,
    so one input file per image).  Returns the test input paths."""
    import csv
    import os

    from floodgan_tpu_torch.data import tiff

    for d in ("dataset_input", "dataset_output", "metadata"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rows, tests = [], []
    for split, n in CLI_SPLITS:
        for i in range(n):
            image = f"hurricane-harvey_{split[:3]}{i:05d}"
            for version in ("original", "flipped") if split == "train" else ("original",):
                rows.append({"image": image, "best_DEM": "01m", "same_DEM": "01m", "version": version,
                             "split": split, "disaster": "hurricane-harvey", "country": "usa"})
            path = os.path.join(root, "dataset_input", f"{image}_01m.tif")
            tiff.imwrite(path, rng.random((CLI_TILE, CLI_TILE, 9), dtype=np.float32))
            tiff.imwrite(os.path.join(root, "dataset_output", f"{image}.tif"),
                         rng.random((CLI_TILE, CLI_TILE, 3), dtype=np.float32))
            if split == "test":
                tests.append(path)
    with open(os.path.join(root, "metadata", "dataset_split.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return tests


def _train_snapshot(model) -> dict:
    """Host copies of everything a resume must restore."""
    t = model.trainer
    snap = {"all_losses": json.loads(json.dumps(model.all_losses)), "epoch": model.current_epoch}
    for net, opt in (("generator", t.gen_opt), ("discriminator", t.disc_opt)):
        module = getattr(t, net)
        for name, p in module.named_parameters():
            st = opt.state[p]
            snap[f"{net}.{name}"] = p.detach().cpu().clone()
            for k in ("exp_avg", "exp_avg_sq", "step"):
                snap[f"{net}.{name}:{k}"] = st[k].detach().cpu().clone()
    return snap


def _epoch_line(st: dict) -> str:
    sec, wait = st["seconds"], st["loader_wait_seconds"]
    stages = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in st["stage_seconds"].items())
    return (f"epoch {st['epoch']}: {sec:.3f} s, {st['samples']} samples, {st['samples'] / sec:.2f} samples/s, "
            f"blocked in the loader {wait:.3f} s ({wait / sec:.3f} of the epoch), post-cache hits "
            f"{st['post_cache_hits']}/{st['batches']}; loader worker ms: {stages}")


def phase_cli(smi, step_rate: float, root: str) -> tuple:
    """The paired-training CLI end to end on 1024^2 tiles written under
    ``root`` (module docstring, phase 9).  Returns the launch counts of its
    runs, the epoch-3 ``.ckpt`` and the test inputs."""
    import os
    import re

    from floodgan_tpu_torch.api import model as api_model
    from floodgan_tpu_torch.ckpt import load_checkpoint
    from floodgan_tpu_torch.cli import predict as cli_predict
    from floodgan_tpu_torch.cli import train as cli_train
    from floodgan_tpu_torch.data import native, tiff
    from floodgan_tpu_torch.data.transforms import denormalize
    from floodgan_tpu_torch.serve import InferenceEngine, ModelRepository

    launches = _Launches()
    zero, read, total = launches.zero, launches.read, launches.total
    snaps, timings, models = {}, [], []

    class Recorder(api_model.Model):
        """The CLI's Model, with a snapshot after epoch 1 and the save time."""

        def save_checkpoint(self, epoch):
            t0 = time.perf_counter()
            path = super().save_checkpoint(epoch)
            timings.append((time.perf_counter() - t0, os.path.getsize(path)))
            return path

        def save_results(self, epoch, losses, epoch_start_time):
            super().save_results(epoch, losses, epoch_start_time)
            if epoch == 1 and not snaps:
                snaps["epoch1"] = _train_snapshot(self)
            if not models or models[-1] is not self:
                models.append(self)

    t0 = time.perf_counter()
    tests = _write_cli_fixture(root, np.random.default_rng(SEED + 5))
    on_disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    say("cli", f"fixture: {sum(n for _, n in CLI_SPLITS)} images of {CLI_TILE}^2 (9 + 3 channels, f32), "
               f"{on_disk / 2**30:.2f} GiB, written in {time.perf_counter() - t0:.2f} s")
    flags = ["--model=PairedAttention", "--topography=all", "--dataset_subset=usa", "--dataset_dem=best",
             f"--data_path={root}", f"--metadata_dir={root}/metadata", f"--resize={S}",
             f"--batch_size={BATCH}", "--compute_dtype=bfloat16", f"--num_epochs={CLI_EPOCHS}",
             "--save_model_interval=1", "--verbose"]
    n_train = 2 * dict(CLI_SPLITS)["train"]
    steps = CLI_EPOCHS * -(-n_train // BATCH)
    decoded = dict(native.BATCHES)
    saved_model = api_model.Model
    api_model.Model = Recorder
    try:
        zero()
        t0 = time.perf_counter()
        first = cli_train.main(flags)
        wall = time.perf_counter() - t0
        read(f"the CLI's {steps} steps", {k: v * steps for k, v in TRAIN_STEP_LAUNCHES.items()})
    finally:
        api_model.Model = saved_model
    served = {k: native.BATCHES[k] - decoded[k] for k in decoded}
    losses = {k: v[-1] for k, v in first.all_losses.items()}
    check(all(len(v) == CLI_EPOCHS and all(np.isfinite(v)) for v in first.all_losses.values()),
          f"CLI losses {first.all_losses}")
    ckpts = sorted(os.listdir(os.path.join(root, "models")))
    pattern = (r"PairedAttention_epoch(\d)_allTopography_usaData_bestDEM_resize%d_cropNone_"
               r"date\d{4}(-\d\d){5}\.ckpt" % S)
    check(len(ckpts) == CLI_EPOCHS and all(re.fullmatch(pattern, c) for c in ckpts)
          and sorted(int(re.fullmatch(pattern, c).group(1)) for c in ckpts) == [1, 2, 3],
          f"checkpoints {ckpts}")
    first_dir = os.path.join(root, "first_run")
    shutil.move(os.path.join(root, "models"), first_dir)
    by_epoch = {int(re.fullmatch(pattern, c).group(1)): os.path.join(first_dir, c) for c in ckpts}

    stats = first.epoch_stats
    decode_s = stats[0]["stage_seconds"]["decode"]
    decode_mb = n_train * CLI_TILE * CLI_TILE * 12 * 4 / 1e6
    say("cli", f"python -m floodgan_tpu_torch.cli.train {' '.join(flags[:3] + flags[6:])}: {wall:.2f} s; "
               f"{steps} steps launched {total}; final losses {json.dumps(losses)}")
    say("cli", f"decoder: native {served['native']} batches, python {served['python']} batches; epoch 1 "
               f"decoded {decode_mb:.0f} MB in {decode_s:.3f} worker-seconds ({decode_mb / decode_s:.0f} MB/s)")
    for st in stats:
        say("cli", _epoch_line(st))
    cached = stats[1:]
    rate = sum(s["samples"] for s in cached) / sum(s["seconds"] for s in cached)
    say("cli", f"epochs 2-{CLI_EPOCHS} (post-transform cache): {rate:.2f} samples/s against [train]'s "
               f"step-only {step_rate:.2f} ({rate / step_rate:.3f}); blocked in the loader "
               f"{sum(s['loader_wait_seconds'] for s in cached) / sum(s['seconds'] for s in cached):.3f} "
               f"of those epochs ({smi})")
    save_s = [t for t, _ in timings]
    say("cli", f"checkpoint save ms {', '.join(f'{t * 1e3:.1f}' for t in save_s)} "
               f"({timings[0][1]} bytes, {timings[0][1] / 2**20:.1f} MiB each)")
    check(all(np.isfinite([s["seconds"] for s in stats])), "epoch times")

    # ---- resume from the epoch-1 file, bit for bit ----
    t0 = time.perf_counter()
    load_checkpoint(by_epoch[1])
    load_ms = (time.perf_counter() - t0) * 1e3
    snap = snaps["epoch1"]
    t0 = time.perf_counter()
    resumed = Recorder(load_pretrained_model=True, pretrained_model_path=by_epoch[1], dataset_subset="usa",
                       dataset_dem="best", data_path=root, metadata_dir=f"{root}/metadata", resize=S,
                       batch_size=BATCH, compute_dtype="bfloat16", save_model_interval=1)
    resume_s = time.perf_counter() - t0
    check(resumed.starting_epoch == 2, f"resumed at epoch {resumed.starting_epoch}")
    check(resumed.all_losses == snap["all_losses"], f"loss history {resumed.all_losses} != {snap['all_losses']}")
    now = _train_snapshot(resumed)
    differ = [k for k in snap if k not in ("all_losses", "epoch") and not (
        now[k].dtype == snap[k].dtype and now[k].shape == snap[k].shape and torch.equal(now[k], snap[k]))]
    check(not differ and set(now) == set(snap), f"resume differs from the epoch-1 snapshot in {differ[:5]}")
    zero()
    resumed.train_paired()
    resume_steps = (CLI_EPOCHS - 1) * -(-n_train // BATCH)
    read(f"the resumed {resume_steps} steps", {k: v * resume_steps for k, v in TRAIN_STEP_LAUNCHES.items()})
    check(all(len(v) == CLI_EPOCHS and all(np.isfinite(v)) for v in resumed.all_losses.values()),
          f"resumed losses {resumed.all_losses}")
    say("cli", f"resume from the epoch-1 .ckpt: load_checkpoint {load_ms:.1f} ms, Model set-up {resume_s:.2f} s; "
               f"starting epoch 2, loss history and {len(snap) - 2} tensors (parameters, exp_avg, exp_avg_sq, "
               f"step) bit for bit; epochs 2-{CLI_EPOCHS} losses "
               f"{json.dumps({k: v[1:] for k, v in resumed.all_losses.items()})}")
    del resumed

    # ---- predict from the epoch-3 file ----
    out_dir = os.path.join(root, "predictions")
    zero()
    t0 = time.perf_counter()
    pngs = cli_predict.main(["--pretrained_model_path", by_epoch[3], "--inputs", *tests,
                             "--output_dir", out_dir, "--resize", str(S)])
    cli_s = time.perf_counter() - t0
    read("the predict CLI (its warm-up forward and one batch)", {k: v * 2 for k, v in SERVE_LAUNCHES.items()})
    check(len(pngs) == len(tests) and all(os.path.getsize(p) > 0 for p in pngs), f"PNGs {pngs}")

    engine = InferenceEngine.from_checkpoint(by_epoch[3], batch_size=len(tests), image_size=S)
    stacks = np.stack([np.asarray(tiff.imread(f), np.float32) for f in tests])
    x = engine.preprocess(stacks, resize=S)
    zero()
    got = engine.predict(x)
    read("one engine forward", SERVE_LAUNCHES)
    model3 = models[0]
    want = denormalize(model3.generate(x)[0])
    torch.cuda.synchronize()
    diff = float((got - want).abs().max())
    check(tuple(got.shape) == (len(tests), S, S, 3) and bool(torch.isfinite(got).all()),
          f"engine output {tuple(got.shape)}")
    check(diff <= TOL_CKPT_PREDICT, f"engine of the epoch-3 .ckpt against the trained model: {diff}")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        engine.predict(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    repo = ModelRepository()
    try:
        repo.add_checkpoint("paired", by_epoch[3], batch_size=1, image_size=S)
        answer = repo.predict("paired", x[0].cpu().numpy())
    finally:
        repo.close()
    check(answer.shape == (S, S, 3) and np.abs(answer - got[0].cpu().numpy()).max() <= 1e-3,
          "repository answer")
    say("cli", f"python -m floodgan_tpu_torch.cli.predict on {len(tests)} {CLI_TILE}^2 inputs: {len(pngs)} PNGs "
               f"in {cli_s:.2f} s; InferenceEngine.from_checkpoint(epoch 3) against the trained model's "
               f"generate: max_abs_diff {diff:.3g} (tol {TOL_CKPT_PREDICT:g}); predict latency "
               f"{statistics.median(times) * 1e3:.3f} ms per batch of {len(tests)} at {S}^2 (median of 5); "
               f"ModelRepository.add_checkpoint answered one request ({smi})")
    del engine, first, model3
    models.clear()
    torch.cuda.empty_cache()
    return total, by_epoch[3], tests


def _write_masks_fixture(root: str, rng) -> None:
    """The [eval] masks dataset on disk, in the reference layout:
    masks_input/ (3-channel f32 tiles), masks_output/ (1-channel {0, 1}
    masks, here the first channel above 0.5, so the U-Net can learn them) and
    metadata/masks_metadata.csv."""
    import csv
    import os

    from floodgan_tpu_torch.data import tiff

    for d in ("masks_input", "masks_output", "metadata"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rows = []
    for split, n in MASK_SPLITS:
        for i in range(n):
            name = f"original_hurricane-harvey_{split[:3]}{i:05d}_0.tif"
            img = rng.random((CLI_TILE, CLI_TILE, 3), dtype=np.float32)
            tiff.imwrite(os.path.join(root, "masks_input", name), img)
            tiff.imwrite(os.path.join(root, "masks_output", name), (img[..., 0] > 0.5).astype(np.float32))
            rows.append({"image": name, "split": split, "version": "original", "country": "usa"})
    with open(os.path.join(root, "metadata", "masks_metadata.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def _read_png_rgba(path: str) -> np.ndarray:
    """The pixels of a PNG that utils/png.py wrote (8-bit RGBA, filter 0)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    pos, idat, (w, h) = 8, b"", (0, 0)
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    check(bool((rows[:, 0] == 0).all()), f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 4)


def _conv_flops(module, x) -> float:
    """2 x the multiply-adds of ``module``'s convolutions on ``x``, counted
    by forward hooks (a transposed conv counts its input pixels)."""
    macs = []

    def hook(m, inp, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        if isinstance(m, torch.nn.ConvTranspose2d):
            macs.append(inp[0].numel() * m.out_channels * k)
        else:
            macs.append(out.numel() * m.in_channels // m.groups * k)

    convs = [m for m in module.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    hooks = [m.register_forward_hook(hook) for m in convs]
    try:
        with torch.no_grad():
            module(x)
    finally:
        for h in hooks:
            h.remove()
    return 2.0 * sum(macs)


def _seg_snapshot(model) -> dict:
    """Host copies of what a seg resume must restore."""
    t = model.trainer
    snap = {}
    for name, p in t.model.named_parameters():
        snap[name] = p.detach().cpu().clone()
        for k in ("exp_avg", "exp_avg_sq", "step"):
            snap[f"{name}:{k}"] = t.opt.state[p][k].detach().cpu().clone()
    return snap


def phase_eval(smi, root: str, gan_ckpt: str, tests: list) -> dict:
    """GAN evaluation and the segmentation U-Net end to end (module
    docstring, phase 10).  Returns the launch counts of its runs and the
    seg ``.ckpt``."""
    import csv
    import glob
    import importlib.util
    import os
    import re

    from floodgan_tpu_torch.api.model import Model
    from floodgan_tpu_torch.api.segmentation import SegmentationModel
    from floodgan_tpu_torch.cli import evaluate as cli_evaluate
    from floodgan_tpu_torch.cli import predict as cli_predict
    from floodgan_tpu_torch.cli import segment as cli_segment
    from floodgan_tpu_torch.data.transforms import denormalize
    from floodgan_tpu_torch.eval.metrics import confusion_counts_per_image, image_pair_metrics, ms_ssim
    from floodgan_tpu_torch.models.layers import init_weights
    from floodgan_tpu_torch.models.unet import UNet

    launches = _Launches()
    zero, read, total = launches.zero, launches.read, launches.total
    none = {k: 0 for k in total}
    meta = os.path.join(root, "metadata")
    saved_env = os.environ.get("FLOODGAN_LPIPS_FALLBACK")
    os.environ["FLOODGAN_LPIPS_FALLBACK"] = "1"  # LPIPS's AlexNet on seed-47 weights, on the card
    try:
        t0 = time.perf_counter()
        _write_masks_fixture(root, np.random.default_rng(SEED + 6))
        say("eval", f"masks fixture: {sum(n for _, n in MASK_SPLITS)} tiles of {CLI_TILE}^2 "
                    f"({', '.join(f'{n} {s}' for s, n in MASK_SPLITS)}; 3-channel image, 1-channel mask), "
                    f"written in {time.perf_counter() - t0:.2f} s")

        # ---- the segmentation CLI trains the U-Net ----
        seg_flags = ["--dataset_subset=usa", f"--data_path={root}", f"--metadata_dir={meta}"]
        zero()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        seg_model = cli_segment.main(["--train", *seg_flags, f"--num_epochs={SEG_EPOCHS}", "--save_model_interval=1",
                                      "--batch_size=1", "--verbose"])
        seg_wall = time.perf_counter() - t0
        seg_peak = torch.cuda.max_memory_allocated() / 2**30
        read("the segmentation CLI's training", none)
        check(len(seg_model.all_losses) == SEG_EPOCHS and all(np.isfinite(seg_model.all_losses))
              and all(np.isfinite(seg_model.all_accuracies)), f"seg losses {seg_model.all_losses}")
        unet = init_weights(UNet(), torch.Generator().manual_seed(SEED))
        start = unet.state_dict()
        # Conv FLOPs scale with the pixels: count at 64^2 on the CPU, scale up.
        flops_per_px = _conv_flops(unet, torch.zeros(1, 3, 64, 64)) / 64 ** 2
        now = {k: v.detach().cpu() for k, v in seg_model.trainer.model.state_dict().items()}
        moved = [k for k in start if not torch.equal(start[k], now[k])]
        check(len(moved) == len(start), f"the U-Net left {len(start) - len(moved)} of {len(start)} tensors unchanged")
        pattern = r"SegmentationModel_epoch(\d)_usaData_date\d{4}(-\d\d){5}\.ckpt"
        seg_ckpts = {int(re.fullmatch(pattern, os.path.basename(p)).group(1)): p
                     for p in glob.glob(os.path.join(root, "models", "SegmentationModel_*.ckpt"))}
        check(sorted(seg_ckpts) == list(range(1, SEG_EPOCHS + 1)), f"seg checkpoints {sorted(seg_ckpts)}")
        seg_ckpt = seg_ckpts[SEG_EPOCHS]
        n_steps = SEG_EPOCHS * dict(MASK_SPLITS)["train"]
        say("eval", f"python -m floodgan_tpu_torch.cli.segment --train (full-width U-Net, {CLI_TILE}^2, batch 1, f32, "
                    f"{SEG_EPOCHS} epochs, {n_steps} steps): {seg_wall:.2f} s, peak {seg_peak:.2f} GiB, launches "
                    f"{none}; losses {seg_model.all_losses}, accuracies {seg_model.all_accuracies}; "
                    f"all {len(start)} tensors moved ({smi})")

        # ---- a resume of the seg .ckpt, bit for bit ----
        snap = _seg_snapshot(seg_model)
        again = SegmentationModel(pretrained_model_path=seg_ckpt, skip_data=True, verbose=False)
        check((again.current_epoch, again.all_losses, again.all_accuracies)
              == (SEG_EPOCHS + 1, seg_model.all_losses, seg_model.all_accuracies),
              f"resumed at epoch {again.current_epoch}, losses {again.all_losses}")
        back = _seg_snapshot(again)
        differ = [k for k in snap if not (back[k].dtype == snap[k].dtype and torch.equal(back[k], snap[k]))]
        check(not differ and set(back) == set(snap), f"seg resume differs in {differ[:5]}")

        # ---- the seg train step, timed on the resumed trainer ----
        batch = next(iter(seg_model.train_loader.epoch_iter(1)))
        step_s = []
        for _ in range(EVAL_RUNS + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = again.trainer.train_step(batch["input"], batch["output"], SEG_LR)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        check(np.isfinite(float(m["loss"])), "seg step loss")
        seg_step_ms = statistics.median(step_s[2:]) * 1e3
        step_flops = 3 * flops_per_px * CLI_TILE ** 2  # the forward and about twice it backward
        say("eval", f"seg resume from the epoch-{SEG_EPOCHS} .ckpt: epoch, loss and accuracy history and {len(snap)} "
                    f"tensors (parameters, exp_avg, exp_avg_sq, step) bit for bit; seg train step at {CLI_TILE}^2 "
                    f"batch 1 f32: {seg_step_ms:.2f} ms (median of {EVAL_RUNS}, host clock), "
                    f"{step_flops / 1e12:.3f} TFLOP (3x the forward's convs), "
                    f"{step_flops / seg_step_ms / 1e9:.1f} TFLOP/s ({smi})")
        del again, seg_model

        # ---- the evaluate CLI on [cli]'s epoch-3 GAN ----
        eval_flags = ["--model=PairedAttention", "--dataset_subset=usa", "--dataset_dem=best", f"--data_path={root}",
                      f"--metadata_dir={meta}", "--topography=all", f"--resize={S}", f"--batch_size={BATCH}",
                      f"--pretrained_model_path={gan_ckpt}", "--calculate_metrics",
                      f"--segmentation_model_path={seg_ckpt}"]
        n_val = dict(CLI_SPLITS)["validation"]
        forwards = -(-n_val // BATCH)
        zero()
        t0 = time.perf_counter()
        model = cli_evaluate.main(eval_flags)
        eval_wall = time.perf_counter() - t0
        read(f"the evaluate CLI's loop ({forwards} generator forwards)",
             {k: v * forwards for k, v in SERVE_LAUNCHES.items()})
        check(model.lpips is not None, "LPIPS did not load with FLOODGAN_LPIPS_FALLBACK=1")
        (metric_csv,) = glob.glob(os.path.join(root, "metrics", "PairedAttention_*.csv"))
        with open(metric_csv, newline="") as f:
            header, row = list(csv.reader(f))
        check(header == [""] + list(JAX_METRIC_COLUMNS), f"metric CSV columns {header}")
        cells = dict(zip(header[1:], row[1:]))
        check(all(np.isfinite(float(cells[k])) for k in ("PSNR", "SSIM", "MS-SSIM", "LPIPS")),
              f"image metrics {cells}")
        check(all(0.0 <= float(cells[k]) <= 1.0 for k in JAX_METRIC_COLUMNS[4:-1]), f"mask metrics {cells}")
        say("eval", f"python -m floodgan_tpu_torch.cli.evaluate --calculate_metrics --segmentation_model_path "
                    f"({n_val} validation images, {S}^2, batch {BATCH}): {eval_wall:.2f} s with set-up; launches "
                    f"{total}; CSV {json.dumps({k: float(v) for k, v in cells.items()})}")

        # ---- the eval loop's stages at batch 8, device time ----
        t0 = time.perf_counter()
        batch = next(iter(model.val_loader.epoch_iter(0)))
        x, y = batch["input"], batch["output"]
        torch.cuda.synchronize()
        loader_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        seg = SegmentationModel(pretrained_model_path=seg_ckpt, skip_data=True, verbose=False)
        torch.cuda.synchronize()
        seg_setup_s = time.perf_counter() - t0
        out01, y01 = denormalize(model.generate(x)[0]), denormalize(y)
        stages = {
            "generator": lambda: model.generate(x),
            "image metrics": lambda: image_pair_metrics(out01, y01),
            "U-Net (output)": lambda: seg.predict_mask(out01),
            "U-Net (truth)": lambda: seg.predict_mask(y01),
            "LPIPS": lambda: model.lpips(out01, y01),
        }
        stage_ms = {k: median_ms(fn, runs=EVAL_RUNS) for k, fn in stages.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero()
        t0 = time.perf_counter()
        model.calculate_metrics(seg_model_path=seg_ckpt)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        read("calculate_metrics, again", {k: v * forwards for k, v in SERVE_LAUNCHES.items()})
        eval_peak = torch.cuda.max_memory_allocated() / 2**30
        batch_ms = sum(stage_ms.values())
        unet_flops = flops_per_px * x.shape[0] * x.shape[1] * x.shape[2]
        unet_ms = stage_ms["U-Net (output)"]
        say("eval", f"eval loop at batch {x.shape[0]}, {S}^2, ms a batch (CUDA events, median of {EVAL_RUNS}): "
                    + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
                    + f"; sum {batch_ms:.3f} ms = {x.shape[0] / batch_ms * 1e3:.2f} images/s; calculate_metrics "
                    f"again (seg .ckpt load, loader and loop): {loop_s:.3f} s = {n_val / loop_s:.2f} images/s; "
                    f"peak {eval_peak:.2f} GiB; of its set-up, SegmentationModel from the .ckpt {seg_setup_s:.3f} s, "
                    f"the first batch from the loader {loader_s:.3f} s; a U-Net forward is "
                    f"{unet_flops / 1e12:.3f} TFLOP of convs, {unet_flops / unet_ms / 1e9:.1f} TFLOP/s ({smi})")
        del seg, model, out01, y01, x, y

        # ---- the card against the CPU, the same checkpoints ----
        runs = {}
        for dev in (CARD, "cpu"):
            m = Model(load_pretrained_model=True, pretrained_model_path=gan_ckpt, training_model=False,
                      dataset_subset="usa", dataset_dem="best", data_path=root, metadata_dir=meta,
                      resize=EVAL_CMP_SIZE, batch_size=EVAL_CMP_BATCH, device=dev)
            b = next(iter(m.val_loader.epoch_iter(0)))
            runs[dev] = {"model": m, "out": m.generate(b["input"])[0].cpu(), "y": b["output"].cpu(),
                         "seg": SegmentationModel(pretrained_model_path=seg_ckpt, skip_data=True, verbose=False,
                                                  device=dev)}
        gen_diff = float((runs[CARD]["out"] - runs["cpu"]["out"]).abs().max())
        check(gen_diff <= TOL_EVAL_GEN, f"generator outputs: card and CPU differ by {gen_diff}")
        out01, y01 = denormalize(runs["cpu"]["out"]), denormalize(runs["cpu"]["y"])  # the same images on both
        res = {}
        for dev, r in runs.items():
            o, t = out01.to(dev), y01.to(dev)
            res[dev] = {k: v.cpu() for k, v in image_pair_metrics(o, t).items()}
            res[dev]["LPIPS"] = r["model"].lpips(o, t).cpu()
            res[dev]["logits"] = torch.stack([r["seg"].predict_logits(o), r["seg"].predict_logits(t)]).cpu()
        cpu, card = res["cpu"], res[CARD]
        errs = {"PSNR": float(((card["PSNR"] - cpu["PSNR"]) / cpu["PSNR"]).abs().max())}
        errs.update({k: float((card[k] - cpu[k]).abs().max()) for k in ("SSIM", "MS-SSIM", "LPIPS")})
        logit_diff = float((card["logits"] - cpu["logits"]).abs().max())
        logit_max = float(cpu["logits"].abs().max())
        band = max(NEAR_THRESHOLD, logit_diff)
        near = (cpu["logits"].abs() <= band).sum(dim=(0, 2, 3, 4))  # per image, output or truth side
        counts = {dev: confusion_counts_per_image((r["logits"][0] > 0).float(), (r["logits"][1] > 0).float())
                  for dev, r in res.items()}
        count_l1 = (counts[CARD] - counts["cpu"]).abs().sum(dim=1)
        say("eval", f"card against CPU at {EVAL_CMP_SIZE}^2 batch {EVAL_CMP_BATCH}, the same .ckpt files: generator "
                    f"{gen_diff:.3g} (tol {TOL_EVAL_GEN:g}); on the CPU's output: PSNR rel {errs['PSNR']:.3g} (tol "
                    f"{TOL_EVAL_PSNR:g}), SSIM {errs['SSIM']:.3g}, MS-SSIM {errs['MS-SSIM']:.3g}, LPIPS "
                    f"{errs['LPIPS']:.3g} (tol {TOL_EVAL_METRIC:g}); U-Net logits {logit_diff:.3g} of max "
                    f"{logit_max:.3g} (tol {TOL_EVAL_LOGITS:g} of max); confusion counts card {counts[CARD].tolist()} "
                    f"cpu {counts['cpu'].tolist()}, L1 {count_l1.tolist()} against 2 x the "
                    f"{near.tolist()} pixels within {band:.3g} of the threshold")
        check(errs["PSNR"] <= TOL_EVAL_PSNR, f"PSNR: card and CPU differ by {errs['PSNR']} relative")
        check(all(errs[k] <= TOL_EVAL_METRIC for k in ("SSIM", "MS-SSIM", "LPIPS")), f"metrics differ: {errs}")
        check(logit_diff <= TOL_EVAL_LOGITS * logit_max, f"U-Net logits differ by {logit_diff} of {logit_max}")
        check(bool((count_l1 <= 2 * near).all()), f"confusion counts differ by {count_l1.tolist()}")
        del runs, res

        # ---- MS-SSIM on the card against the float64 goldens (TF32 guard) ----
        gx, cases = _ms_ssim_golden_cases()
        golden = {}
        for name, gy in cases.items():
            golden[name] = float(ms_ssim(torch.from_numpy(gx[None]).to(CARD), torch.from_numpy(gy[None]).to(CARD))[0])
        gerr = {k: abs(v - _MS_SSIM_GOLDENS[k]) for k, v in golden.items()}
        say("eval", f"ms_ssim on the card, tests/test_metrics.py's 192^2 cases: {json.dumps(golden)}; against the "
                    f"float64 goldens {json.dumps(gerr)} (tol {TOL_GOLDEN:g}, and <= 1)")
        check(all(e <= TOL_GOLDEN for e in gerr.values()) and all(v <= 1.0 for v in golden.values()),
              f"MS-SSIM goldens: {golden}")

        # ---- predict with flood masks ----
        out_dir = os.path.join(root, "predictions_masks")
        zero()
        t0 = time.perf_counter()
        pngs = cli_predict.main(["--pretrained_model_path", gan_ckpt, "--inputs", *tests, "--output_dir", out_dir,
                                 "--resize", str(S), "--segmentation_model_path", seg_ckpt])
        predict_s = time.perf_counter() - t0
        read("the predict CLI with masks (its warm-up forward and one batch)",
             {k: v * 2 for k, v in SERVE_LAUNCHES.items()})
        masks = [p for p in pngs if p.endswith("_floodmask.png")]
        check(len(masks) == len(tests) and len(pngs) == 2 * len(tests), f"PNGs {pngs}")
        flooded = []
        for p in masks:
            px = _read_png_rgba(p)
            check(px.shape == (S, S, 4) and bool((px[..., 3] == 255).all())
                  and set(np.unique(px[..., :3]).tolist()) <= {0, 255}
                  and bool((px[..., 0] == px[..., 1]).all() and (px[..., 1] == px[..., 2]).all()),
                  f"{p}: not a gray {{0, 1}} mask of {S}^2")
            flooded.append(float((px[..., 0] == 255).mean()))
        say("eval", f"python -m floodgan_tpu_torch.cli.predict --segmentation_model_path on {len(tests)} inputs: "
                    f"{len(pngs)} PNGs in {predict_s:.2f} s, masks {S}^2 gray {{0, 1}}, flooded shares {flooded}")

        # ---- SegmentationModel.calculate_metrics on the masks' validation split ----
        zero()
        segm = SegmentationModel(dataset_subset="usa", data_path=root, metadata_dir=meta,
                                 pretrained_model_path=seg_ckpt, verbose=False)
        t0 = time.perf_counter()
        seg_metrics = segm.calculate_metrics()
        seg_eval_s = time.perf_counter() - t0
        read("SegmentationModel.calculate_metrics", none)
        check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in seg_metrics.values()), f"seg metrics {seg_metrics}")
        check(len(glob.glob(os.path.join(root, "metrics", "SegmentationModel_*.csv"))) == 1, "seg metric CSV")
        say("eval", f"SegmentationModel.calculate_metrics on {dict(MASK_SPLITS)['validation']} {CLI_TILE}^2 "
                    f"validation tiles: {seg_eval_s:.2f} s, launches {none}; "
                    f"{json.dumps({k: round(v, 6) for k, v in seg_metrics.items()})}")
        del segm

        # ---- the segmentation CLI's evaluate mode: the CSV with or without matplotlib ----
        for p in glob.glob(os.path.join(root, "metrics", "SegmentationModel_*.csv")):
            os.remove(p)  # a CSV written in the same second would carry the same name
        zero()
        t0 = time.perf_counter()
        cli_segment.main([*seg_flags, f"--pretrained_model_path={seg_ckpt}"])
        seg_cli_s = time.perf_counter() - t0
        read("the segmentation CLI's evaluate mode", none)
        seg_csvs = glob.glob(os.path.join(root, "metrics", "SegmentationModel_*.csv"))
        check(len(seg_csvs) == 1, f"seg metric CSVs after the CLI's evaluate mode: {seg_csvs}")
        with open(seg_csvs[0], newline="") as f:
            header, row = list(csv.reader(f))
        check(header[1:] == list(JAX_METRIC_COLUMNS[4:-1]) and all(0.0 <= float(v) <= 1.0 for v in row[1:]),
              f"the seg CLI's CSV: {header} {row}")
        say("eval", f"python -m floodgan_tpu_torch.cli.segment (evaluate mode) on the epoch-{SEG_EPOCHS} .ckpt: "
                    f"{seg_cli_s:.2f} s, the metric CSV written (matplotlib "
                    f"{'present' if importlib.util.find_spec('matplotlib') else 'absent: the figures skipped'})")
    finally:
        if saved_env is None:
            os.environ.pop("FLOODGAN_LPIPS_FALLBACK", None)
        else:
            os.environ["FLOODGAN_LPIPS_FALLBACK"] = saved_env
    torch.cuda.empty_cache()
    return total, seg_ckpt


def _cycle_snapshot(model) -> dict:
    """Host copies of everything a cycle resume must restore: the four
    networks' parameters, both Adams' moments and steps, both buffers with
    their counts, and the loss history."""
    t = model.trainer
    snap = {"all_losses": json.loads(json.dumps(model.all_losses)), "epoch": model.current_epoch}
    for opt, nets in ((t.gen_opt, ("gen_ab", "gen_ba")), (t.disc_opt, ("disc_post", "disc_pre"))):
        for net in nets:
            for name, p in getattr(t, net).named_parameters():
                snap[f"{net}.{name}"] = p.detach().cpu().clone()
                for k in ("exp_avg", "exp_avg_sq", "step"):
                    snap[f"{net}.{name}:{k}"] = opt.state[p][k].detach().cpu().clone()
    for buf in ("pre_buffer", "post_buffer"):
        snap[buf] = getattr(t, buf).images.detach().cpu().clone()
        snap[f"{buf}:count"] = torch.tensor(getattr(t, buf).count)
    return snap


def _check_cycle_resume(root: str, ckpt: str, snap: dict) -> None:
    """A Model resumed from the AttentionGAN .ckpt holds, bit for bit, what
    the snapshot took after the epoch that wrote it."""
    from floodgan_tpu_torch.api.model import Model

    t0 = time.perf_counter()
    resumed = Model(load_pretrained_model=True, pretrained_model_path=ckpt, dataset_subset="usa",
                    dataset_dem="best", data_path=root, metadata_dir=f"{root}/metadata", resize=S,
                    batch_size=BATCH, compute_dtype="bfloat16")
    resume_s = time.perf_counter() - t0
    check(resumed.starting_epoch == 2 and resumed.all_losses == snap["all_losses"],
          f"AttentionGAN resumed at epoch {resumed.starting_epoch}, losses {resumed.all_losses}")
    now = _cycle_snapshot(resumed)
    differ = [k for k in snap if k not in ("all_losses", "epoch") and not (
        now[k].dtype == snap[k].dtype and now[k].shape == snap[k].shape and torch.equal(now[k], snap[k]))]
    check(not differ and set(now) == set(snap), f"AttentionGAN resume differs from the snapshot in {differ[:5]}")
    say("families", f"AttentionGAN resume from its .ckpt: Model set-up {resume_s:.2f} s; loss history and "
                    f"{len(snap) - 2} tensors (4 networks' parameters, both Adams' exp_avg, exp_avg_sq and step, both "
                    f"bf16 buffers and their counts {snap['pre_buffer:count'].item()}, "
                    f"{snap['post_buffer:count'].item()}) bit for bit")


def _family_trainer(model: str, device, size: int, dtype: str, **kw):
    from floodgan_tpu_torch.train.cycle import CycleTrainer
    from floodgan_tpu_torch.train.paired import PairedTrainer

    if model == "pix2pix":
        return PairedTrainer("pix2pix", 9, compute_dtype=dtype, device=device, seed=SEED, **kw)
    return CycleTrainer(model, 9, (size, size), compute_dtype=dtype, device=device, seed=SEED, **kw)


def _family_nets(trainer) -> tuple:
    names = ("generator", "discriminator") if hasattr(trainer, "generator") else (
        "gen_ab", "gen_ba", "disc_post", "disc_pre")
    return tuple((n, getattr(trainer, n)) for n in names)


def phase_families(smi, root: str, tests: list, paired_rate: float) -> tuple:
    """Pix2Pix, CycleGAN and AttentionGAN at full width (module docstring,
    phase 11).  Returns the launch counts of its runs, the three families'
    ``.ckpt`` files and each family's (step ms, peak GiB)."""
    import glob
    import os

    from floodgan_tpu_torch.api import model as api_model
    from floodgan_tpu_torch.cli import train as cli_train
    from floodgan_tpu_torch.data import tiff
    from floodgan_tpu_torch.data.transforms import denormalize
    from floodgan_tpu_torch.serve import InferenceEngine

    launches = _Launches()
    zero, read, total = launches.zero, launches.read, launches.total
    x, y = _train_inputs(np.random.default_rng(SEED + 7), BATCH, S)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    rates, figures = {}, {}

    # ---- the train steps of each family, from seeded inits ----
    for model in FAMILIES:
        t0 = time.perf_counter()
        trainer = _family_trainer(model, None, S, "bfloat16")
        setup = time.perf_counter() - t0
        nets = _family_nets(trainer)
        start = {n: {k: v.clone() for k, v in m.state_dict().items()} for n, m in nets}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero()
        trainer.train_step(x, y, LR, epoch=1, step=0)
        counts = read(f"one {model} step", FAMILY_STEP_LAUNCHES[model])
        extra = ""
        if model == "attentiongan":
            trainer.add_identity_loss = True
            zero()
            m = trainer.train_step(x, y, LR, epoch=1, step=1)
            counts_id = read("one attentiongan step with the identity loss", FAMILY_STEP_LAUNCHES["attentiongan+identity"])
            check({"losses_identity_post", "losses_identity_pre"} <= set(m), f"identity losses {sorted(m)}")
            trainer.add_identity_loss = False
            extra = f"; with the identity loss {counts_id}"
        steps = 2 if model == "attentiongan" else 1
        while steps < 5:
            metrics = trainer.train_step(x, y, LR, epoch=1, step=steps)
            steps += 1
        losses = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in losses.values()), f"{model}: non-finite losses after 5 steps: {losses}")
        moved = {n: _changed(mod, start[n]) for n, mod in nets}
        for n, (w_moved, w_all, _, _) in moved.items():
            check(w_moved == w_all, f"{model} {n}: only {w_moved} of {w_all} weight tensors changed in 5 steps")
        if model != "pix2pix":
            for buf in ("pre_buffer", "post_buffer"):
                count = getattr(trainer, buf).count
                check(count == min(50, BATCH * steps), f"{model} {buf} count {count} after {steps} steps")
        times = []
        for i in range(FAMILY_TIMED):
            t0 = time.perf_counter()
            trainer.train_step(x, y, LR, epoch=2, step=i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        step_ms = statistics.median(times) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        rates[model] = BATCH / (step_ms / 1e3)
        figures[model] = (step_ms, peak)
        say("families", f"{FAMILIES[model]} {S}^2 batch {BATCH} bf16, seed {SEED}: one step launched {counts}{extra}; "
                        f"set-up {setup:.2f} s; after 5 steps losses {json.dumps(losses)}; weights moved: "
                        + ", ".join(f"{n} {mv[0]}/{mv[1]}" for n, mv in moved.items()))
        say("families", f"{FAMILIES[model]} step ms median {step_ms:.3f} over {FAMILY_TIMED} after 5 (min {min(times) * 1e3:.3f}, "
                        f"max {max(times) * 1e3:.3f}), {rates[model]:.3f} samples/s against the PairedAttention "
                        f"step's {paired_rate:.3f}, peak memory {peak:.3f} GiB ({smi})")
        del trainer, nets, start
        torch.cuda.empty_cache()

    # ---- the card against the CPU, f32, TF32 off ----
    for model in FAMILIES:
        size = FAMILY_CMP[model]
        xs, ys = _train_inputs(np.random.default_rng(SEED + 8), 2, size)
        runs = {}
        for dev in (CARD, "cpu"):
            kw = {"dropout_rate": 0.0} if model == "pix2pix" else {}
            trainer = _family_trainer(model, dev, size, "float32", **kw)
            runs[dev] = [{k: float(v) for k, v in trainer.train_step(xs, ys, LR, epoch=1, step=i).items()}
                         for i in range(2)]
        rel = [max(abs(card[k] - cpu[k]) / abs(cpu[k]) for k in cpu) for card, cpu in zip(runs[CARD], runs["cpu"])]
        say("families", f"{FAMILIES[model]} card against CPU at {size}^2 batch 2 f32 (TF32 off"
                        f"{', dropout rate 0' if model == 'pix2pix' else ''}): step-1 max rel diff {rel[0]:.3g} "
                        f"(tol {TOL_TRAIN_STEP1:g}), step-2 {rel[1]:.3g} (tol {TOL_TRAIN_STEP2:g})")
        check(rel[0] <= TOL_TRAIN_STEP1 and rel[1] <= TOL_TRAIN_STEP2,
              f"{model}: card and CPU losses differ: {runs}")

    # ---- each family through the training CLI, a resume and the engine ----
    snaps, models = {}, {}

    class Recorder(api_model.Model):
        def save_results(self, epoch, losses, epoch_start_time):
            super().save_results(epoch, losses, epoch_start_time)
            models[self.model] = self
            if self.model == "attentiongan":
                snaps["attentiongan"] = _cycle_snapshot(self)

    n_train = 2 * dict(CLI_SPLITS)["train"]
    steps = -(-n_train // BATCH)
    ckpts = {}
    saved_model = api_model.Model
    api_model.Model = Recorder
    try:
        for model, pretty in FAMILIES.items():
            before = set(glob.glob(os.path.join(root, "models", f"{pretty}_*.ckpt")))
            zero()
            t0 = time.perf_counter()
            cli_train.main([f"--model={pretty}", "--topography=all", "--dataset_subset=usa", "--dataset_dem=best",
                            f"--data_path={root}", f"--metadata_dir={root}/metadata", f"--resize={S}",
                            f"--batch_size={BATCH}", "--compute_dtype=bfloat16", "--num_epochs=1",
                            "--save_model_interval=1"])
            wall = time.perf_counter() - t0
            read(f"the training CLI's {steps} {model} steps",
                 {k: v * steps for k, v in FAMILY_STEP_LAUNCHES[model].items()})
            (ckpts[pretty],) = set(glob.glob(os.path.join(root, "models", f"{pretty}_*.ckpt"))) - before
            losses = models[model].all_losses
            check(all(len(v) == 1 and np.isfinite(v[0]) for v in losses.values()), f"{model} CLI losses {losses}")
            say("families", f"python -m floodgan_tpu_torch.cli.train --model={pretty} ({CLI_TILE}^2 tiles resized to "
                            f"{S}^2, batch {BATCH}, bf16, 1 epoch of {steps} steps): {wall:.2f} s with set-up, "
                            f"{os.path.getsize(ckpts[pretty]) / 2**20:.1f} MiB .ckpt")
    finally:
        api_model.Model = saved_model

    if "attentiongan" in FAMILIES:
        _check_cycle_resume(root, ckpts["AttentionGAN"], snaps["attentiongan"])

    stacks = np.stack([np.asarray(tiff.imread(f), np.float32) for f in tests])
    diffs = {}
    for model, pretty in FAMILIES.items():
        engine = InferenceEngine.from_checkpoint(ckpts[pretty], batch_size=len(tests), image_size=S)
        xin = engine.preprocess(stacks, resize=S)
        zero()
        got = engine.predict(xin)
        read(f"one {model} engine forward", _serve_launches(model))
        want = denormalize(models[model].generate(xin)[0])
        torch.cuda.synchronize()
        diffs[model] = float((got - want).abs().max())
        check(tuple(got.shape) == (len(tests), S, S, 3) and bool(torch.isfinite(got).all()),
              f"{model} engine output {tuple(got.shape)}")
        check(diffs[model] <= TOL_CKPT_PREDICT, f"{model}: engine of the .ckpt against the trained model: {diffs[model]}")
        del engine
    say("families", f"InferenceEngine.from_checkpoint against the trained Model's generate ({len(tests)} test inputs, "
                    f"Pix2Pix's dropout on the seed-47 stream on both sides): max_abs_diff "
                    + ", ".join(f"{FAMILIES[m]} {d:.3g}" for m, d in diffs.items()) + f" (tol {TOL_CKPT_PREDICT:g})")
    models.clear()
    torch.cuda.empty_cache()
    return total, ckpts, figures


def _serve_launches(model: str) -> dict:
    """One generator forward of ``model``: 25 IN sites and a compose for
    the attention generator, 23 IN sites for CycleGAN's, none for Pix2Pix."""
    if model == "pix2pix":
        return dict(NO_LAUNCHES)
    if model == "cyclegan":
        return {**NO_LAUNCHES, "in_act": 23}
    return dict(SERVE_LAUNCHES)


def phase_compare(smi, root: str, ckpts: dict, seg_ckpt: str) -> dict:
    """The comparison CLI on one .ckpt of each family (module docstring,
    phase 16).  Returns the launch counts of its runs."""
    import csv
    import glob
    import os

    from floodgan_tpu_torch.cli import compare as cli_compare

    launches = _Launches()
    zero, read, total = launches.zero, launches.read, launches.total
    n_val = dict(CLI_SPLITS)["validation"]
    flags = ["--dataset_subset=usa", "--dataset_dem=best", f"--data_path={root}", f"--metadata_dir={root}/metadata",
             "--topography=all", f"--resize={S}", "--calculate_metrics", f"--segmentation_model_path={seg_ckpt}"]
    saved_env = os.environ.get("FLOODGAN_LPIPS_FALLBACK")
    os.environ["FLOODGAN_LPIPS_FALLBACK"] = "1"
    try:
        zero()
        t0 = time.perf_counter()
        cli_compare.main(["--compare=models", *flags] + [f"--{m.lower()}_path={ckpts[m]}" for m in COMPARE_MODELS])
        wall = time.perf_counter() - t0
        counts = read(f"--compare models on {n_val} images", {k: v * n_val for k, v in COMPARE_LAUNCHES_PER_IMAGE.items()})
        averaged = glob.glob(os.path.join(root, "metrics", "models_comparison_allTopography_*.csv"))
        grouped = glob.glob(os.path.join(root, "metrics", "models_comparison_grouped_*.csv"))
        check(len(averaged) == 1 and len(grouped) == 1, f"compare CSVs {averaged} {grouped}")
        with open(averaged[0], newline="") as f:
            header, *rows = list(csv.reader(f))
        columns = list(JAX_METRIC_COLUMNS[:4]) + ["Inference"] + list(JAX_METRIC_COLUMNS[4:-1])
        check(header == ["Model"] + columns and [r[0] for r in rows] == list(COMPARE_MODELS),
              f"averaged table {header} {[r[0] for r in rows]}")
        table = {r[0]: dict(zip(columns, r[1:])) for r in rows}
        check(all(np.isfinite(float(table[m][k])) for m in COMPARE_MODELS for k in columns[:4]),
              f"image metrics {table}")
        with open(grouped[0], newline="") as f:
            g_header, *g_rows = list(csv.reader(f))
        keys = [r[0] for r in g_rows]
        check(g_header[0] == "Metric_Model" and keys == sorted(keys) and len(keys) == 14 * len(COMPARE_MODELS),
              f"grouped table {g_header} {keys[:4]}")
        say("compare", f"python -m floodgan_tpu_torch.cli.compare --compare models --calculate_metrics "
                       f"({n_val} validation images, {S}^2, batch 1): {wall:.2f} s with set-up; launches "
                       f"{counts}; mean Inference s per image "
                       + ", ".join(f"{m} {table[m]['Inference']}" for m in COMPARE_MODELS)
                       + f" (the first model's first 5 dropped); PSNR "
                       + ", ".join(f"{m} {float(table[m]['PSNR']):.4f}" for m in COMPARE_MODELS) + f" ({smi})")

        zero()
        t0 = time.perf_counter()
        cli_compare.main(["--compare=two", *flags, f"--model_1_path={ckpts['Pix2Pix']}",
                          f"--model_2_path={ckpts['CycleGAN']}"])
        wall2 = time.perf_counter() - t0
        counts_two = read(f"--compare two on {n_val} images", {**NO_LAUNCHES, "in_act": 23 * n_val})
        two = glob.glob(os.path.join(root, "metrics", "two_comparison_allTopography_*.csv"))
        check(len(two) == 1, f"--compare two CSVs {two}")
        with open(two[0], newline="") as f:
            check([r[0] for r in list(csv.reader(f))[1:]] == ["Model 1", "Model 2"], "--compare two rows")
        say("compare", f"--compare two (Pix2Pix, CycleGAN): {wall2:.2f} s with set-up; launches {counts_two}")
    finally:
        if saved_env is None:
            os.environ.pop("FLOODGAN_LPIPS_FALLBACK", None)
        else:
            os.environ["FLOODGAN_LPIPS_FALLBACK"] = saved_env
    torch.cuda.empty_cache()
    return total


def _losses(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _timed_steps(step, n: int) -> tuple:
    """(median ms, min ms, max ms) of ``n`` calls of ``step(i)``, each to a
    synchronise of the card."""
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


def _conv_ops_at_the_policy() -> list:
    """The aten ops with "conv" in their name that reach ``convs``'s policy
    in one bf16 AttentionGAN generator read and its backward on the card."""
    from floodgan_tpu_torch.train import remat as remat_lib
    from floodgan_tpu_torch.train.cycle import CycleTrainer

    seen, policy = set(), remat_lib._convs_policy

    def recording(ctx, op, *args, **kwargs):
        seen.add(str(op))
        return policy(ctx, op, *args, **kwargs)

    remat_lib._convs_policy = recording
    try:
        t = CycleTrainer("attentiongan", 9, (64, 64), compute_dtype="bfloat16", remat=True,
                         remat_policy="convs", seed=SEED)
        x = torch.from_numpy(_train_inputs(np.random.default_rng(SEED), 2, 64)[0]).cuda()
        t.gen_apply(t.gen_ab, x.permute(0, 3, 1, 2).contiguous()).sum().backward()
        torch.cuda.synchronize()
    finally:
        remat_lib._convs_policy = policy
    return sorted(op for op in seen if "conv" in op)


def phase_remat(smi, root: str, cycle_figures: tuple, train_figures: tuple) -> dict:
    """Rematerialisation on the card (module docstring, phase 12).  Returns
    the launch counts of its runs."""
    from floodgan_tpu_torch.cli import train as cli_train
    from floodgan_tpu_torch.train import remat as remat_lib
    from floodgan_tpu_torch.train.paired import PairedTrainer
    from floodgan_tpu_torch.train.seg import SegTrainer

    launches = _Launches()
    zero, read, total = launches.zero, launches.read, launches.total
    gib = 2.0 ** 30

    conv_ops = _conv_ops_at_the_policy()
    check(conv_ops == sorted(str(op) for op in remat_lib.CONV_OPS),
          f"the convolution ops reaching the convs policy on the card: {conv_ops}, CONV_OPS "
          f"{sorted(map(str, remat_lib.CONV_OPS))}")
    say("remat", f"ops with 'conv' in their name that reach the convs policy (bf16 autocast, card): {conv_ops}")

    # ---- AttentionGAN, each policy against the same trainer without remat ----
    x, y = _train_inputs(np.random.default_rng(SEED + 7), BATCH, S)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    plain = _family_trainer("attentiongan", None, S, "bfloat16")
    ref = [_losses(plain.train_step(x, y, LR, epoch=1, step=i)) for i in range(2)]
    del plain
    torch.cuda.empty_cache()
    figures = {}
    for policy in REMAT_POLICIES:
        trainer = _family_trainer("attentiongan", None, S, "bfloat16", remat=True, remat_policy=policy)
        nets = _family_nets(trainer)
        start = {n: {k: v.clone() for k, v in m.state_dict().items()} for n, m in nets}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero()
        first = _losses(trainer.train_step(x, y, LR, epoch=1, step=0))
        counts = read(f"one AttentionGAN step under remat {policy}", REMAT_CYCLE_LAUNCHES)
        check(first == ref[0], f"{policy}: step-1 losses {first} differ from the plain step's {ref[0]}")
        second = _losses(trainer.train_step(x, y, LR, epoch=1, step=1))
        rel2 = max(abs(second[k] - ref[1][k]) / abs(ref[1][k]) for k in ref[1])
        check(rel2 <= TOL_REMAT_STEP2, f"{policy}: step-2 losses {second} against {ref[1]}: {rel2}")
        for i in range(2, 5):
            last = _losses(trainer.train_step(x, y, LR, epoch=1, step=i))
        check(all(np.isfinite(v) for v in last.values()), f"{policy}: non-finite losses after 5 steps: {last}")
        for n, m in nets:
            moved, weights, _, _ = _changed(m, start[n])
            check(moved == weights, f"{policy} {n}: only {moved} of {weights} weight tensors changed in 5 steps")
        ms, lo, hi = _timed_steps(lambda i: trainer.train_step(x, y, LR, epoch=2, step=i), REMAT_TIMED)
        peak = torch.cuda.max_memory_allocated() / gib
        figures[policy] = (ms, peak)
        say("remat", f"AttentionGAN {S}^2 batch {BATCH} bf16 remat {policy}: one step launched {counts}; step-1 "
                     f"losses equal the plain step's bit for bit; step-2 max rel diff {rel2:.3g} "
                     f"(tol {TOL_REMAT_STEP2:g}); step ms median {ms:.3f} over {REMAT_TIMED} after 5 (min "
                     f"{lo:.3f}, max {hi:.3f}), peak {peak:.3f} GiB, against no remat's {cycle_figures[0]:.3f} ms "
                     f"and {cycle_figures[1]:.3f} GiB ({smi})")
        del trainer, nets, start
        torch.cuda.empty_cache()
    del x, y

    # ---- the xBD tile's native size under the policy with the least memory ----
    least = min(figures, key=lambda p: figures[p][1])
    xb, yb = _train_inputs(np.random.default_rng(SEED + 9), BATCH, REMAT_BIG)
    xb, yb = torch.from_numpy(xb).cuda(), torch.from_numpy(yb).cuda()
    trainer = _family_trainer("attentiongan", None, REMAT_BIG, "bfloat16", remat=True, remat_policy=least)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    big = []
    ms, lo, hi = _timed_steps(lambda i: big.append(_losses(trainer.train_step(xb, yb, LR, epoch=1, step=i))),
                              REMAT_BIG_STEPS)
    counts = read(f"{REMAT_BIG_STEPS} AttentionGAN {REMAT_BIG}^2 steps under {least}",
                  {k: v * REMAT_BIG_STEPS for k, v in REMAT_CYCLE_LAUNCHES.items()})
    peak = torch.cuda.max_memory_allocated() / gib
    check(all(np.isfinite(v) for m in big for v in m.values()), f"{REMAT_BIG}^2 losses {big}")
    say("remat", f"AttentionGAN {REMAT_BIG}^2 batch {BATCH} bf16 remat {least} (the least peak at {S}^2): "
                 f"{REMAT_BIG_STEPS} steps launched {counts}, finite losses {json.dumps(big[-1])}; step ms median "
                 f"{ms:.3f} (min {lo:.3f}, max {hi:.3f}; the first compiles nothing but allocates), "
                 f"peak {peak:.3f} GiB ({smi})")
    del trainer, xb, yb
    torch.cuda.empty_cache()

    # ---- PairedAttention under the paired policies ----
    x, y = _train_inputs(np.random.default_rng(SEED + 3), BATCH, S)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    for policy in ("boundaries", "full"):
        trainer = PairedTrainer("pairedattention", 9, compute_dtype="bfloat16", seed=SEED, remat=True,
                                remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero()
        trainer.train_step(x, y, LR)
        counts = read(f"one PairedAttention step under remat {policy}", REMAT_PAIRED_LAUNCHES)
        for _ in range(4):
            last = _losses(trainer.train_step(x, y, LR))
        check(all(np.isfinite(v) for v in last.values()), f"paired {policy}: losses {last}")
        ms, lo, hi = _timed_steps(lambda i: trainer.train_step(x, y, LR), REMAT_TIMED)
        peak = torch.cuda.max_memory_allocated() / gib
        say("remat", f"PairedAttention {S}^2 batch {BATCH} bf16 remat {policy}: one step launched {counts}; "
                     f"step ms median {ms:.3f} over {REMAT_TIMED} after 5 (min {lo:.3f}, max {hi:.3f}), peak "
                     f"{peak:.3f} GiB, against [train]'s {train_figures[0]:.3f} ms and {train_figures[1]:.3f} GiB "
                     f"({smi})")
        del trainer
        torch.cuda.empty_cache()
    del x, y

    # ---- the U-Net at the xBD tile's size, batch 8, f32, with remat ----
    r = np.random.default_rng(SEED + 10)
    images = torch.from_numpy(r.random((BATCH, REMAT_BIG, REMAT_BIG, 3), dtype=np.float32)).cuda()
    masks = torch.from_numpy((r.random((BATCH, REMAT_BIG, REMAT_BIG, 1)) > 0.5).astype(np.float32)).cuda()
    seg = SegTrainer(compute_dtype="float32", remat=True, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    first = _losses(seg.train_step(images, masks, SEG_LR))
    read("one U-Net step under remat", NO_LAUNCHES)
    ms, lo, hi = _timed_steps(lambda i: seg.train_step(images, masks, SEG_LR), SEG_REMAT_STEPS)
    peak = torch.cuda.max_memory_allocated() / gib
    check(np.isfinite(first["loss"]), f"U-Net loss {first}")
    say("remat", f"U-Net {REMAT_BIG}^2 batch {BATCH} f32 remat (floodgan_tpu/cli/segment.py's case): first loss "
                 f"{first['loss']:.6f}; step ms median {ms:.3f} over {SEG_REMAT_STEPS} after 1 (min {lo:.3f}, "
                 f"max {hi:.3f}), peak {peak:.3f} GiB; [eval]'s seg step is batch 1 ({smi})")
    del seg, images, masks
    torch.cuda.empty_cache()

    # ---- the training CLI's --remat on [cli]'s tiles ----
    n_train = 2 * dict(CLI_SPLITS)["train"]
    steps = -(-n_train // BATCH)
    zero()
    t0 = time.perf_counter()
    model = cli_train.main(["--model=PairedAttention", "--topography=all", "--dataset_subset=usa", "--dataset_dem=best",
                            f"--data_path={root}", f"--metadata_dir={root}/metadata", f"--resize={S}",
                            f"--batch_size={BATCH}", "--compute_dtype=bfloat16", "--num_epochs=1", "--remat"])
    wall = time.perf_counter() - t0
    counts = read(f"the training CLI's {steps} --remat steps",
                  {k: v * steps for k, v in REMAT_PAIRED_LAUNCHES.items()})
    check(model.trainer.remat and model.trainer.remat_policy == "boundaries"
          and all(len(v) == 1 and np.isfinite(v[0]) for v in model.all_losses.values()),
          f"--remat CLI: {model.trainer.remat_policy} {model.all_losses}")
    say("remat", f"python -m floodgan_tpu_torch.cli.train --model=PairedAttention --remat ({CLI_TILE}^2 tiles "
                 f"resized to {S}^2, batch {BATCH}, bf16, 1 epoch of {steps} steps, policy boundaries): "
                 f"{wall:.2f} s with set-up; launches {counts}")
    del model
    torch.cuda.empty_cache()
    return total


class _CheckedMesh:
    """A ``DataMesh`` that holds each collective of a world-size-1 run to
    the identity, bit for bit, and brackets the gradient all-reduces with
    CUDA events."""

    def __init__(self, mesh):
        self._mesh = mesh
        self.brackets, self.calls, self.changed = [], {}, []

    def __getattr__(self, name):
        return getattr(self._mesh, name)

    def _count(self, what: str) -> None:
        self.calls[what] = self.calls.get(what, 0) + 1

    def all_reduce_grads_(self, params):
        params = list(params)
        before = [p.grad.clone() for p in params if p.grad is not None]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        self._mesh.all_reduce_grads_(params)
        end.record()
        self.brackets.append((start, end))
        after = [p.grad for p in params if p.grad is not None]
        if not all(torch.equal(a, b) for a, b in zip(before, after)):
            self.changed.append("all_reduce_grads_")
        self._count("all_reduce_grads_")

    def all_reduce_sum_(self, t):
        before = t.clone()
        self._mesh.all_reduce_sum_(t)
        if not torch.equal(before, t):
            self.changed.append("all_reduce_sum_")
        self._count("all_reduce_sum_")
        return t

    def mean(self, values):
        out = self._mesh.mean(values)
        if any(not torch.equal(out[k], values[k].float()) for k in values):
            self.changed.append("mean")
        self._count("mean")
        return out

    def data_reduce_sum_(self, t):
        before = t.clone()
        self._mesh.data_reduce_sum_(t)
        if not torch.equal(before, t):
            self.changed.append("data_reduce_sum_")
        self._count("data_reduce_sum_")
        return t

    def all_gather(self, t):
        out = self._mesh.all_gather(t)
        if not torch.equal(out, t):
            self.changed.append("all_gather")
        self._count("all_gather")
        return out


def _dp_run(make, x, y) -> tuple:
    """DP_STEPS steps of ``make()``'s trainer: (the losses of each, the
    parameters after, the launches, the trainer)."""
    from floodgan_tpu_torch.ops import kernels

    trainer = make()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    losses = [_losses(trainer.train_step(x, y, LR, epoch=1, step=i)) for i in range(DP_STEPS)]
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    params = {f"{n}.{k}": p.detach().clone() for n, m in _family_nets(trainer) for k, p in m.named_parameters()}
    return losses, params, counts, trainer


def phase_dp(smi) -> dict:
    """The data-parallel path at world size 1 (module docstring, phase 13).
    Returns the launch counts of its runs through the mesh."""
    import os

    import torch.distributed as dist

    from floodgan_tpu_torch.ckpt.sharded import load_checkpoint_sharded, save_checkpoint_sharded
    from floodgan_tpu_torch.ops import kernels
    from floodgan_tpu_torch.parallel import mesh as mesh_lib
    from floodgan_tpu_torch.train.cycle import CycleTrainer
    from floodgan_tpu_torch.train.paired import PairedTrainer
    from floodgan_tpu_torch.utils.jax_params import cycle_state_to_jax, load_cycle_state

    total = {k: 0 for k in kernels.LAUNCHES}
    mesh_lib.init_process_group(1, 0, "cuda", mesh_lib.free_port(), timeout_s=300)
    try:
        x, y = _train_inputs(np.random.default_rng(SEED + 11), BATCH, S)
        x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
        makers = {
            "pix2pix": lambda m: _family_trainer("pix2pix", None, S, "bfloat16", mesh=m),
            "pairedattention": lambda m: PairedTrainer("pairedattention", 9, compute_dtype="bfloat16", seed=SEED,
                                                       mesh=m),
            "attentiongan": lambda m: _family_trainer("attentiongan", None, S, "bfloat16", mesh=m),
        }
        cycle_trainer = None
        for name, make in makers.items():
            plain_losses, plain_params, plain_counts, _ = _dp_run(lambda: make(None), x, y)
            again_losses, again_params, _, _ = _dp_run(lambda: make(None), x, y)
            plain_spread = [k for k in plain_params if not torch.equal(plain_params[k], again_params[k])]
            deterministic = again_losses == plain_losses and not plain_spread
            del again_params
            torch.cuda.empty_cache()
            mesh = _CheckedMesh(mesh_lib.make_mesh(1))
            dp_losses, dp_params, dp_counts, trainer = _dp_run(lambda: make(mesh), x, y)
            torch.cuda.synchronize()
            reduce_ms = sum(s.elapsed_time(e) for s, e in mesh.brackets) / DP_STEPS
            for k in total:
                total[k] += dp_counts[k]
            check(not mesh.changed, f"{name}: world-size-1 collectives changed their input: {mesh.changed}")
            check(dp_counts == plain_counts, f"{name}: launches {dp_counts} through the mesh, {plain_counts} plain")
            check(dp_losses[0] == plain_losses[0], f"{name}: step-1 losses {dp_losses[0]} against {plain_losses[0]}")
            differ = [k for k in plain_params if not torch.equal(plain_params[k], dp_params[k])]
            if deterministic:
                # Two plain runs agree bit for bit, so the mesh's run must too.
                check(dp_losses == plain_losses and not differ,
                      f"{name}: {len(differ)} parameters and losses {dp_losses} against {plain_losses}")
                held = (f"strict branch: two plain runs agree bit for bit, and the mesh's {DP_STEPS} steps equal "
                        f"them (losses and all {len(plain_params)} parameter tensors)")
            else:
                # Two plain runs part after step 1 where an op of the step sums in
                # an order that changes from run to run (a cuDNN algorithm
                # with atomics; [determinism] holds the steps with those off).
                rel = max(abs(dp_losses[1][k] - plain_losses[1][k]) / abs(plain_losses[1][k]) for k in plain_losses[1])
                check(rel <= TOL_REMAT_STEP2, f"{name}: step-2 losses {dp_losses[1]} against {plain_losses[1]}")
                held = (f"tolerance branch: two plain runs differ in {len(plain_spread)} of {len(plain_params)} "
                        f"tensors after "
                        f"{DP_STEPS} steps (their step-1 losses agree); the mesh's step-1 losses equal the plain "
                        f"step's bit for bit, step-2 max rel diff {rel:.3g} (tol {TOL_REMAT_STEP2:g}), "
                        f"{len(differ)} tensors differ")
            say("dp", f"{name} {S}^2 batch {BATCH} bf16 on a world-size-1 NCCL mesh: {held}; every collective "
                      f"returned its input bit for bit ({json.dumps(mesh.calls)}); launches {dp_counts} both ways; "
                      f"gradient all-reduce {reduce_ms:.3f} ms a step ({smi})")
            if name == "attentiongan":
                cycle_trainer = trainer
            del trainer, plain_params, dp_params
            torch.cuda.empty_cache()

        # ---- a .sharded directory written and read back ----
        state = cycle_state_to_jax(cycle_trainer)
        d = os.path.join(tempfile.mkdtemp(prefix="floodgan_dp_"), "attentiongan.sharded")
        try:
            t0 = time.perf_counter()
            save_checkpoint_sharded(d, {"model": "attentiongan"}, state, 0, 1)
            t1 = time.perf_counter()
            meta, raw = load_checkpoint_sharded(d)
            t2 = time.perf_counter()
            size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
            again = CycleTrainer("attentiongan", 9, (S, S), compute_dtype="bfloat16", seed=SEED + 1)
            load_cycle_state(again, raw)
            a = {f"{n}.{k}": v for n, m in _family_nets(cycle_trainer) for k, v in m.state_dict().items()}
            b = {f"{n}.{k}": v for n, m in _family_nets(again) for k, v in m.state_dict().items()}
            same = all(torch.equal(a[k], b[k]) for k in a)
            bufs = all(torch.equal(getattr(cycle_trainer, k).images, getattr(again, k).images)
                       and getattr(cycle_trainer, k).count == getattr(again, k).count
                       for k in ("pre_buffer", "post_buffer"))
            check(meta == {"model": "attentiongan"} and same and bufs, "the .sharded round trip differs")
            say("dp", f".sharded directory of the AttentionGAN state ({sorted(os.listdir(d))}, {size / 2**20:.1f} MiB): "
                      f"saved in {t1 - t0:.2f} s, read in {t2 - t1:.2f} s, every parameter and both bf16 buffers "
                      f"bit for bit")
        finally:
            shutil.rmtree(os.path.dirname(d), ignore_errors=True)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return total


def _det_run(make, x, y) -> tuple:
    """DET_STEPS steps of a fresh ``make()`` trainer under PyTorch's
    deterministic algorithms: (the losses of each step, the parameters
    after, the launches)."""
    from floodgan_tpu_torch.ops import kernels

    torch.use_deterministic_algorithms(True)
    try:
        trainer = make()
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0
        losses = [_losses(trainer.train_step(x, y, LR, epoch=1, step=i)) for i in range(DET_STEPS)]
        counts = dict(kernels.LAUNCHES)
        params = {f"{n}.{k}": p.detach().clone() for n, m in _family_nets(trainer) for k, p in m.named_parameters()}
    finally:
        torch.use_deterministic_algorithms(False)
    del trainer
    torch.cuda.empty_cache()
    return losses, params, counts


def _det_timing(make, x, y) -> tuple:
    """The step's ms with the deterministic mode on and off, on one fresh
    ``make()`` trainer: a warm-up step in each mode (cuDNN picks its
    algorithms for each), then FAMILY_TIMED rounds of one step in each,
    the order turned every round.  Returns ({mode: [ms, ...]}, the
    launches of all its steps, the steps' losses)."""
    from floodgan_tpu_torch.ops import kernels

    trainer = make()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    times, losses = {True: [], False: []}, []
    try:
        for r in range(FAMILY_TIMED + 1):
            for mode in (True, False) if r % 2 == 0 else (False, True):
                torch.use_deterministic_algorithms(mode)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(_losses(trainer.train_step(x, y, LR, epoch=1, step=len(losses))))
                torch.cuda.synchronize()
                if r:  # round 0 is the warm-up
                    times[mode].append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.use_deterministic_algorithms(False)
    counts = dict(kernels.LAUNCHES)
    del trainer
    torch.cuda.empty_cache()
    return times, counts, losses


def phase_determinism(smi) -> dict:
    """PairedAttention and AttentionGAN under torch.use_deterministic_algorithms
    (module docstring, phase 14).  Returns the launch counts of its runs."""
    import os

    from floodgan_tpu_torch.train.paired import PairedTrainer

    x, y = _train_inputs(np.random.default_rng(SEED + 13), BATCH, S)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    runs = {
        "pairedattention": (lambda: PairedTrainer("pairedattention", 9, compute_dtype="bfloat16", seed=SEED),
                            TRAIN_STEP_LAUNCHES),
        "attentiongan": (lambda: _family_trainer("attentiongan", None, S, "bfloat16"),
                         FAMILY_STEP_LAUNCHES["attentiongan"]),
    }
    total = {k: 0 for k in NO_LAUNCHES}
    # cuBLAS refuses deterministic mode without a fixed workspace; the steps'
    # convolutions go to cuDNN, but a matrix product anywhere would need it.
    # Set for this phase only: later phases and their children run without.
    before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    try:
        for name, (make, per_step) in runs.items():
            first = _det_run(make, x, y)
            again = _det_run(make, x, y)
            times, timed_counts, timed_losses = _det_timing(make, x, y)
            timed_steps = 2 * (FAMILY_TIMED + 1)
            for losses, counts, steps in ((first[0], first[2], DET_STEPS), (again[0], again[2], DET_STEPS),
                                          (timed_losses, timed_counts, timed_steps)):
                want = {k: v * steps for k, v in per_step.items()}
                check(counts == want, f"{name}: {steps} steps launched {counts}, expected {want}")
                check(all(np.isfinite(v) for step in losses for v in step.values()), f"{name}: losses {losses}")
                for k in total:
                    total[k] += counts[k]
            differ = [k for k in first[1] if not torch.equal(first[1][k], again[1][k])]
            check(first[0] == again[0] and not differ,
                  f"{name}: two deterministic runs differ in {len(differ)} parameter tensors, losses {first[0]} "
                  f"against {again[0]}")
            on_ms, off_ms = statistics.median(times[True]), statistics.median(times[False])
            say("determinism", f"{name} {S}^2 batch {BATCH} bf16, {DET_STEPS} steps twice from seed {SEED} under "
                               f"torch.use_deterministic_algorithms(True): losses and all {len(first[1])} parameter "
                               f"tensors bit for bit; launches {first[2]} each run; step ms over {FAMILY_TIMED} "
                               f"steps in each mode, in turns after a warm-up step in each, with the mode on "
                               f"{[round(t, 3) for t in times[True]]} (median {on_ms:.3f}), off "
                               f"{[round(t, 3) for t in times[False]]} (median {off_ms:.3f}), on/off "
                               f"{on_ms / off_ms:.4f} ({smi})")
            del first, again
            torch.cuda.empty_cache()
    finally:
        if before is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = before
    return total


# ---------------------------------------------------------------- [spatial]

def _plane_rows(height: int) -> tuple:
    """Rank 0's and rank 1's rows of a plane of ``height`` rows at S = 2:
    the mesh's split (the PatchGAN's 63-row level is 32 and 31)."""
    top = -(-height // SPATIAL)
    return top, height - top


def _scaled_err(got, want, scale) -> float:
    return float(((got.double() - want.double()).abs() / scale.double().clamp_min(1e-30)).max())


def _partial_case(gen, label, shape, dtype, relu, has_res, slope, backward, timed=True):
    """The partial forms at one IN site of the S = 2 step: ``shape`` is the
    whole plane, split in rows as the mesh splits it.  K1s and K1a (K2s and
    K2a with ``backward``), each against its plain version on rank 0's
    rows; both halves' sums added, then the apply, against fused K1 (K2)
    on the whole plane.  Returns {form: (ms, plain_ms, bound_ms, bound_by,
    err)} at rank 0's rows (empty unless ``timed``)."""
    from floodgan_tpu_torch.ops import kernels

    n, c, h, w = shape
    x = _randn(shape, dtype, gen, mean=0.5)
    other = _randn(shape, dtype, gen) if (has_res or backward) else None
    if backward:
        other, _ = _off_kink(x, other, relu)
    top, _ = _plane_rows(h)
    halves = [x[:, :, :top].contiguous(), x[:, :, top:].contiguous()]
    parts = [None, None] if other is None else [other[:, :, :top].contiguous(), other[:, :, top:].contiguous()]
    stats = sum(kernels.instance_norm_stats(p) for p in halves)
    x0, o0 = halves[0], parts[0]
    s0 = kernels.instance_norm_stats(x0)
    x32 = x0.float()
    scale = torch.stack([x32.abs().sum(dim=(2, 3)), (x32 * x32).sum(dim=(2, 3))], -1).reshape(-1)
    plain_s0 = kernels.instance_norm_stats_plain(x0)
    err_stats = _scaled_err(s0[:-1], plain_s0[:-1], scale)
    abs_stats = float((s0[:-1] - plain_s0[:-1]).abs().max())
    check(float(s0[-1]) == top and float(stats[-1]) == h, f"{label}: row counts {float(s0[-1])}, {float(stats[-1])}")
    out = {}
    if not backward:
        res0 = o0 if has_res else None
        got = kernels.instance_norm_apply(x0, stats, relu, res0, slope)
        err_apply, ok = _close(got, kernels.instance_norm_apply_plain(x0, stats, relu, res0, slope), dtype, TOL_F32_IN)
        whole = torch.cat([kernels.instance_norm_apply(p, stats, relu, q if has_res else None, slope)
                           for p, q in zip(halves, parts)], 2)
        err_whole, ok_whole = _close(whole, kernels.instance_norm_act_fwd(x, relu, other if has_res else None, slope),
                                     dtype, TOL_F32_IN)
        checks = {"in_stats": (abs_stats, err_stats <= TOL_STATS), "in_apply": (err_apply, ok)}
        forms = {"in_stats": (lambda: kernels.instance_norm_stats(x0), lambda: kernels.instance_norm_stats_plain(x0),
                              x0.numel() * x0.element_size() + 8 * n * c + 4, 3 * x0.numel()),
                 "in_apply": (lambda: kernels.instance_norm_apply(x0, stats, relu, res0, slope),
                              lambda: kernels.instance_norm_apply_plain(x0, stats, relu, res0, slope),
                              x0.numel() * x0.element_size() * (3 if has_res else 2) + 8 * n * c,
                              (4 + int(relu) + int(has_res)) * x0.numel())}
        what = "K1s + K1a"
    else:
        gsums = sum(kernels.instance_norm_bwd_stats(p, q, stats, relu, slope) for p, q in zip(halves, parts))
        g0 = kernels.instance_norm_bwd_stats(x0, o0, stats, relu, slope)
        mean = (stats[:-1].view(n, c, 2)[..., 0] / (h * w)).view(n, c, 1, 1)
        yh = (x32 - mean) * torch.rsqrt((stats[:-1].view(n, c, 2)[..., 1] / (h * w)).view(n, c, 1, 1)
                                        - mean * mean + kernels.EPS)
        g32 = o0.float()
        gscale = torch.stack([g32.abs().sum(dim=(2, 3)), (g32 * yh).abs().sum(dim=(2, 3))], -1).reshape(-1)
        plain_g0 = kernels.instance_norm_bwd_stats_plain(x0, o0, stats, relu, slope)
        err_bstats = _scaled_err(g0, plain_g0, gscale)
        abs_bstats = float((g0 - plain_g0).abs().max())
        got = kernels.instance_norm_bwd_apply(x0, o0, stats, gsums, relu, slope)
        err_apply, ok = _close(got, kernels.instance_norm_bwd_apply_plain(x0, o0, stats, gsums, relu, slope),
                               dtype, TOL_F32_IN)
        whole = torch.cat([kernels.instance_norm_bwd_apply(p, q, stats, gsums, relu, slope)
                           for p, q in zip(halves, parts)], 2)
        err_whole, ok_whole = _close(whole, kernels.instance_norm_act_bwd(x, other, relu, slope), dtype, TOL_F32_IN)
        checks = {"in_bwd_stats": (abs_bstats, err_bstats <= TOL_STATS), "in_bwd_apply": (err_apply, ok)}
        forms = {"in_bwd_stats": (lambda: kernels.instance_norm_bwd_stats(x0, o0, stats, relu, slope),
                                  lambda: kernels.instance_norm_bwd_stats_plain(x0, o0, stats, relu, slope),
                                  2 * x0.numel() * x0.element_size() + 16 * n * c + 4, (6 + int(relu)) * x0.numel()),
                 "in_bwd_apply": (lambda: kernels.instance_norm_bwd_apply(x0, o0, stats, gsums, relu, slope),
                                  lambda: kernels.instance_norm_bwd_apply_plain(x0, o0, stats, gsums, relu, slope),
                                  3 * x0.numel() * x0.element_size() + 16 * n * c + 4, (7 + int(relu)) * x0.numel())}
        what = "K2s + K2a"
    torch.cuda.synchronize()
    for name, (err, ok_) in checks.items():
        check(ok_, f"{name} {label} {dtype}: error {err} against its plain version")
    check(ok_whole, f"{what} over two shards {label} {dtype}: max_abs_err {err_whole} against the fused kernel")
    text = []
    for name, (kern, plain, nbytes, ops) in forms.items():
        err = checks[name][0]
        if timed:
            ms, plain_ms = median_ms(kern), median_ms(plain)
            b_ms, b_by = bound_ms(nbytes, ops)
            out[name] = (ms, plain_ms, b_ms, b_by, err)
            text.append(f"{name} max_abs_err {err:.3g} ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by})")
        else:
            text.append(f"{name} max_abs_err {err:.3g}")
    tol = f"sums within {TOL_STATS:g} of the sums of |.|, apply " + _tol_text(dtype, TOL_F32_IN)
    say("spatial", f"{what} {label} {str(dtype)[6:]} {tuple(shape)} rows {top}+{h - top}: " + "; ".join(text)
                   + f"; over two shards against the fused kernel max_abs_err {err_whole:.3g} (tol {tol})")
    del x, other, halves, parts
    return out


def _spatial_kernels() -> dict:
    """The four partial forms at every IN site of one rank's bf16 S = 2 step
    (timed, summed over its 34 sites), and at the stem's and the trunk's
    sites in f32.  Returns their JSON rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    f32, bf16 = torch.float32, torch.bfloat16
    totals = {k: _Total() for k in ("in_stats", "in_apply", "in_bwd_stats", "in_bwd_apply")}
    for label, shape, relu, res, count in IN_SITES:
        for backward in (False, True):
            lab = label.replace("residual", "no act (residual)") if backward else label
            for k, r in _partial_case(gen, lab, shape, bf16, relu, res and not backward, 0.0, backward).items():
                totals[k].add(count, *r)
    for label, shape in D_SITES:
        for backward in (False, True):
            for k, r in _partial_case(gen, label, shape, bf16, True, False, 0.2, backward).items():
                totals[k].add(D_READS, *r)
    for label, shape, relu, res, _ in (IN_SITES[0], IN_SITES[3]):
        for backward in (False, True):
            _partial_case(gen, label, shape, f32, relu, res and not backward, 0.0, backward, timed=False)
    for k, t in totals.items():
        say("spatial", f"{k}, the 34 bf16 sites of one rank's S = {SPATIAL} batch-{BATCH} {S}^2 step: ms {t.ms:.4f} "
                       f"plain_ms {t.plain_ms:.4f} bound_ms {t.bound_ms:.4f}")
    src = "floodgan_tpu_torch/csrc/instance_norm.cu"
    return {k: t.row(k, src, "floodgan_tpu/ops/pallas_kernels.py:" + ("53" if k in ("in_stats", "in_apply") else "109"))
            for k, t in totals.items()}


def _spatial_inputs():
    return _train_inputs(np.random.default_rng(SEED + 13), BATCH, S)


class _ExchangeClock:
    """Host time of a spatial group's exchanges and reductions, each between
    two synchronises of the card."""

    def __init__(self, group):
        self.group, self.seconds, self.calls = group, 0.0, 0
        self._exchange, self._reduce = group.exchange, group.all_reduce_sum_
        group.exchange = self._timed(self._exchange)
        group.all_reduce_sum_ = self._timed(self._reduce)

    def _timed(self, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        return run

    def stop(self) -> None:
        self.group.exchange, self.group.all_reduce_sum_ = self._exchange, self._reduce


def _spatial_rank(rank: int, device, out_dir: str) -> None:
    """One of the [spatial] phase's two gloo ranks on card 0: its rows of
    the global batch, two steps (launches counted over the first), timed
    steps, one step with its exchanges timed, and one step under remat
    ``boundaries``; the results to ``spatial_rank{r}.pt``."""
    import os

    from floodgan_tpu_torch.ops import kernels
    from floodgan_tpu_torch.parallel import mesh as mesh_lib
    from floodgan_tpu_torch.train.paired import PairedTrainer

    mesh = mesh_lib.make_mesh(SPATIAL, spatial=SPATIAL, device=device)
    x, y = (torch.from_numpy(np.ascontiguousarray(mesh.shard_images(a))).to(device) for a in _spatial_inputs())
    res = {"rows": x.shape[1]}

    def make(**kw):
        return PairedTrainer("pairedattention", 9, compute_dtype="bfloat16", seed=SEED, mesh=mesh, **kw)

    trainer = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    res["losses"] = [_losses(trainer.train_step(x, y, LR, epoch=1, step=0))]
    torch.cuda.synchronize()
    res["counts"] = dict(kernels.LAUNCHES)
    res["losses"].append(_losses(trainer.train_step(x, y, LR, epoch=1, step=1)))
    res["step_ms"] = _timed_steps(lambda i: trainer.train_step(x, y, LR, epoch=1, step=2 + i), SPATIAL_TIMED)
    clock = _ExchangeClock(mesh.spatial)
    t0 = time.perf_counter()
    trainer.train_step(x, y, LR, epoch=1, step=2 + SPATIAL_TIMED)
    torch.cuda.synchronize()
    res["instrumented_ms"] = (time.perf_counter() - t0) * 1e3
    clock.stop()
    res["exchange_ms"], res["exchange_calls"] = clock.seconds * 1e3, clock.calls
    res["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    res["params"] = torch.cat([p.detach().reshape(-1).float().cpu() for m in (trainer.generator, trainer.discriminator)
                               for p in m.parameters()])
    del trainer
    torch.cuda.empty_cache()
    trainer = make(remat=True, remat_policy="boundaries")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    res["remat_losses"] = _losses(trainer.train_step(x, y, LR, epoch=1, step=0))
    torch.cuda.synchronize()
    res["remat_counts"] = dict(kernels.LAUNCHES)
    res["remat_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    del trainer
    res["families"] = _spatial_families(mesh, device, x, y)
    torch.save(res, os.path.join(out_dir, f"spatial_rank{rank}.pt"))


def _spatial_seg_inputs(size: int, batch: int):
    """A seeded NHWC (image, {0, 1} mask) pair for the U-Net."""
    rng = np.random.default_rng(SEED + 17)
    return (rng.standard_normal((batch, size, size, 3), dtype=np.float32) * 0.5,
            (rng.random((batch, size, size, 1)) > 0.6).astype(np.float32))


def _bilinear_unet():
    from floodgan_tpu_torch.models.layers import init_weights
    from floodgan_tpu_torch.models.unet import UNet

    return init_weights(UNet(bilinear=True), torch.Generator().manual_seed(SEED)).to(CARD)


def _spatial_baselines() -> dict:
    """The one-process references of the other networks on the card, each
    freed before the next: AttentionGAN's and Pix2Pix's first two steps
    (and AttentionGAN's buffers after step 1), the U-Net's logits at
    SPATIAL_UNET and the bilinear U-Net's forward at SPATIAL_BILINEAR."""
    from floodgan_tpu_torch.core.device import full_f32
    from floodgan_tpu_torch.train.seg import SegTrainer
    from floodgan_tpu_torch.train.paired import to_nchw

    x, y = (torch.from_numpy(a).to(CARD) for a in _spatial_inputs())
    out = {}
    for model in ("attentiongan", "pix2pix"):
        t = _family_trainer(model, CARD, S, "bfloat16")
        out[model] = [_losses(t.train_step(x, y, LR, epoch=1, step=0))]
        if model == "attentiongan":
            out["buffers"] = {k: getattr(t, k).images[:BATCH].float().cpu() for k in ("pre_buffer", "post_buffer")}
        out[model].append(_losses(t.train_step(x, y, LR, epoch=1, step=1)))
        del t
        torch.cuda.empty_cache()
    del x, y
    image, _ = _spatial_seg_inputs(SPATIAL_UNET, 1)
    seg = SegTrainer(seed=SEED, device=CARD)
    out["logits"] = seg.predict_logits(image).cpu()
    del seg
    torch.cuda.empty_cache()
    image, _ = _spatial_seg_inputs(SPATIAL_BILINEAR, 2)
    with torch.no_grad(), full_f32():
        out["bilinear"] = _bilinear_unet()(to_nchw(image, CARD)).cpu()
    torch.cuda.empty_cache()
    return out


def _spatial_families(mesh, device, x, y) -> dict:
    """One rank's share of the other networks on the spatial axis: the
    cycle families, Pix2Pix and the U-Net, each trainer freed before the
    next (module docstring, phase 15)."""
    from floodgan_tpu_torch.core.device import full_f32
    from floodgan_tpu_torch.models.layers import set_data_mesh, set_spatial_mesh
    from floodgan_tpu_torch.ops import kernels
    from floodgan_tpu_torch.train.paired import to_nchw
    from floodgan_tpu_torch.train.seg import SegTrainer

    def zero():
        torch.cuda.synchronize()
        for k in kernels.LAUNCHES:
            kernels.LAUNCHES[k] = 0

    def counted():
        torch.cuda.synchronize()
        return dict(kernels.LAUNCHES)

    def free():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    res = {}
    free()
    t = _family_trainer("attentiongan", device, S, "bfloat16", mesh=mesh)
    zero()
    losses = [_losses(t.train_step(x, y, LR, epoch=1, step=0))]
    res["attentiongan_counts"] = counted()
    res["buffers"] = {k: getattr(t, k).images[:BATCH].float().cpu() for k in ("pre_buffer", "post_buffer")}
    losses.append(_losses(t.train_step(x, y, LR, epoch=1, step=1)))
    res["cycle_step_ms"] = _timed_steps(lambda i: t.train_step(x, y, LR, epoch=1, step=2 + i), SPATIAL_TIMED)
    clock = _ExchangeClock(mesh.spatial)
    t0 = time.perf_counter()
    t.train_step(x, y, LR, epoch=1, step=2 + SPATIAL_TIMED)
    torch.cuda.synchronize()
    res["cycle_instrumented_ms"] = (time.perf_counter() - t0) * 1e3
    clock.stop()
    res["cycle_exchange_ms"], res["cycle_exchange_calls"] = clock.seconds * 1e3, clock.calls
    res["cycle_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    res["attentiongan_losses"] = losses
    res["cycle_params"] = torch.cat([p.detach().reshape(-1).float().cpu() for _, m in _family_nets(t)
                                     for p in m.parameters()])
    del t
    for name, kw in (("identity", {"add_identity_loss": True}), ("convs", {"remat": True, "remat_policy": "convs"}),
                     ("cyclegan", {})):
        free()
        t = _family_trainer("cyclegan" if name == "cyclegan" else "attentiongan", device, S, "bfloat16", mesh=mesh, **kw)
        zero()
        res[f"{name}_losses"] = _losses(t.train_step(x, y, LR, epoch=1, step=0))
        res[f"{name}_counts"] = counted()
        res[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        del t
    free()
    t = _family_trainer("pix2pix", device, S, "bfloat16", mesh=mesh)
    zero()
    losses = [_losses(t.train_step(x, y, LR, epoch=1, step=0))]
    res["pix2pix_counts"] = counted()
    losses.append(_losses(t.train_step(x, y, LR, epoch=1, step=1)))
    res["pix2pix_step_ms"] = _timed_steps(lambda i: t.train_step(x, y, LR, epoch=1, step=2 + i),
                                          SPATIAL_P2P_STEPS - 2)
    res["pix2pix_losses"] = losses
    res["pix2pix_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    res["pix2pix_params"] = torch.cat([p.detach().reshape(-1).float().cpu() for _, m in _family_nets(t)
                                       for p in m.parameters()])
    del t
    free()
    image, mask = (mesh.shard_images(a) for a in _spatial_seg_inputs(SPATIAL_UNET, 1))
    seg = SegTrainer(seed=SEED, mesh=mesh)
    zero()
    res["logits"] = seg.predict_logits(image).cpu()
    res["seg_metrics"] = _losses(seg.train_step(image, mask, SEG_LR))
    res["seg_counts"] = counted()
    res["seg_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    del seg
    free()
    image, _ = _spatial_seg_inputs(SPATIAL_BILINEAR, 2)
    net = _bilinear_unet()
    set_data_mesh(net, mesh)
    set_spatial_mesh(net, mesh.spatial)
    with torch.no_grad(), full_f32():
        res["bilinear"] = net(to_nchw(mesh.shard_images(image), device)).cpu()
    del net
    torch.cuda.empty_cache()
    return res


def _spatial_resume_rank(rank: int, device, out_dir: str, ckpt: str, root: str) -> None:
    """A ``Model`` resumed on one of 2 gloo ranks from the spatial CLI's
    ``.sharded`` directory: a digest of each leaf of its state (its buffers
    hold this rank's rows) and those rows, to ``resume_rank{r}.pt``."""
    import hashlib
    import os

    from floodgan_tpu_torch.api.model import Model
    from floodgan_tpu_torch.utils.jax_params import cycle_state_to_jax

    model = Model(load_pretrained_model=True, pretrained_model_path=ckpt, dataset_subset="usa", dataset_dem="best",
                  data_path=root, metadata_dir=f"{root}/metadata", resize=S, batch_size=BATCH,
                  compute_dtype="bfloat16", num_spatial_devices=SPATIAL, device=str(device))
    digests = {}
    for path, leaf in _flat_leaves(cycle_state_to_jax(model.trainer)):
        digests[path] = hashlib.sha256(np.ascontiguousarray(getattr(leaf, "bits", leaf)).tobytes()).hexdigest()
    torch.save({"digests": digests, "rows": model.trainer.buffer_rows, "epoch": model.starting_epoch},
               os.path.join(out_dir, f"resume_rank{rank}.pt"))


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _nccl_two_ranks_one_card(rank: int, port: int, out_dir: str) -> None:
    """Two NCCL ranks on card 0, past ``check_devices``: the error NCCL
    raises at the first collective, to ``nccl_rank{r}.txt``."""
    import datetime
    import os

    import torch.distributed as dist

    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        dist.all_reduce(torch.ones(1, device="cuda:0"))
        torch.cuda.synchronize()
        msg = "no error"
    except Exception as e:  # the refusal is what this records
        msg = f"{type(e).__name__}: {e}"
    with open(os.path.join(out_dir, f"nccl_rank{rank}.txt"), "w") as f:
        f.write(msg)
    os._exit(0)  # a refused NCCL communicator is not torn down


def phase_spatial(smi, train_figures, family_figures, root) -> tuple:
    """The spatial axis (module docstring, phase 15).  Returns (the launch
    counts of the two ranks' counted steps, the partial forms' JSON rows)."""
    import os

    import torch.multiprocessing as mp

    from floodgan_tpu_torch.parallel import mesh as mesh_lib
    from floodgan_tpu_torch.train.paired import PairedTrainer

    t_phase = time.perf_counter()
    rows = _spatial_kernels()
    torch.cuda.empty_cache()

    # The baselines: one process on the card, the whole batch, the same init.
    x, y = (torch.from_numpy(a).cuda() for a in _spatial_inputs())
    base = PairedTrainer("pairedattention", 9, compute_dtype="bfloat16", seed=SEED)
    base_losses = [_losses(base.train_step(x, y, LR, epoch=1, step=i)) for i in range(2)]
    del base, x, y
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    family_base = _spatial_baselines()
    say("spatial", f"the one-process references of the other networks: {time.perf_counter() - t0:.1f} s")

    out = tempfile.mkdtemp(prefix="floodgan_spatial_")
    try:
        # NCCL refuses two ranks on one card; the port's check_devices says so first.
        try:
            mesh_lib.check_devices(2, "cuda", backend="nccl", devices=[0, 0])
            refused = "not refused"
        except ValueError as e:
            refused = str(e)
        check(refused.startswith("NCCL takes one rank per card"), f"check_devices: {refused}")
        ctx = mp.start_processes(_nccl_two_ranks_one_card, args=(mesh_lib.free_port(), out), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + 120
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise SmokeFailure("two NCCL ranks on one card did not return within 120 s")
        nccl = [open(os.path.join(out, f"nccl_rank{r}.txt")).read() for r in range(2)]
        say("spatial", f"check_devices refuses two NCCL ranks on card 0: {refused!r}; past it, NCCL's first "
                       f"collective raised on rank 0: {nccl[0][:300]!r}; rank 1: {nccl[1][:300]!r}")
        check(all(m != "no error" for m in nccl), f"two NCCL ranks on one card ran a collective: {nccl}")

        t0 = time.perf_counter()
        mesh_lib.spawn(_spatial_rank, SPATIAL, args=(out,), device_type="cuda", backend="gloo",
                       cards=[0] * SPATIAL, timeout_s=300, join_timeout_s=900)
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out, f"spatial_rank{r}.pt")) for r in range(SPATIAL)]
    finally:
        shutil.rmtree(out, ignore_errors=True)

    total = {k: 0 for k in NO_LAUNCHES}
    for r, res in enumerate(ranks):
        check(res["rows"] == S // SPATIAL, f"rank {r} holds {res['rows']} rows")
        check(res["counts"] == SPATIAL_STEP_LAUNCHES, f"rank {r}: one step launched {res['counts']}, "
                                                      f"expected {SPATIAL_STEP_LAUNCHES}")
        check(res["remat_counts"] == SPATIAL_REMAT_LAUNCHES, f"rank {r}: one remat step launched "
                                                             f"{res['remat_counts']}, expected {SPATIAL_REMAT_LAUNCHES}")
        for k in total:
            total[k] += res["counts"][k] + res["remat_counts"][k]
    a, b = ranks
    check(a["losses"] == b["losses"] and a["remat_losses"] == b["remat_losses"], "the ranks report other losses")
    check(torch.equal(a["params"], b["params"]), "the ranks' parameters differ after the steps")
    check(all(np.isfinite(v) for step in a["losses"] for v in step.values()), f"losses {a['losses']}")
    rel = [{k: abs(a["losses"][i][k] - base_losses[i][k]) / abs(base_losses[i][k]) for k in base_losses[i]}
           for i in range(2)]
    say("spatial", f"PairedAttention {S}^2 global batch {BATCH} bf16, D = 1, S = {SPATIAL}: 2 gloo ranks on card 0, "
                   f"{S // SPATIAL} rows each; in {wall:.1f} s of spawn (start-up, 2 trainers, "
                   f"{3 + SPATIAL_TIMED} plain steps and a remat step each)")
    for i in range(2):
        tols = {k: TOL_SPATIAL_STEP1 if i == 0 and k != "losses_generator_synthetic" else TOL_SPATIAL_UPDATED
                for k in rel[i]}
        say("spatial", f"step {i + 1}: the ranks {json.dumps(a['losses'][i])}, one process {json.dumps(base_losses[i])}; "
                       "rel diff " + ", ".join(f"{k} {rel[i][k]:.3g} (tol {tols[k]:.3g})" for k in rel[i]))
        check(all(rel[i][k] <= tols[k] for k in rel[i]), f"step {i + 1}: the ranks' losses against one process's: "
                                                         f"{rel[i]}")
    check(a["remat_losses"] == a["losses"][0], f"remat boundaries step 1 {a['remat_losses']} against "
                                               f"{a['losses'][0]}")
    say("spatial", f"launches of one step on each rank {a['counts']} (no fused K1/K2); under remat boundaries "
                   f"{a['remat_counts']}; step 1 under remat equals the plain step's bit for bit; the ranks hold "
                   f"equal parameters bit for bit after {3 + SPATIAL_TIMED} steps")
    for r, res in enumerate(ranks):
        med, lo, hi = res["step_ms"]
        say("spatial", f"rank {r}: step ms median {med:.1f} over {SPATIAL_TIMED} (min {lo:.1f}, max {hi:.1f}) -- "
                       f"one card, two processes sharing it, halos and sums staged through the host over gloo: "
                       f"not a measure of scaling; an instrumented step {res['instrumented_ms']:.1f} ms, of it "
                       f"{res['exchange_ms']:.1f} ms in {res['exchange_calls']} exchanges and reductions (each "
                       f"between two synchronises); peak memory {res['peak_gib']:.3f} GiB, under remat "
                       f"{res['remat_peak_gib']:.3f} GiB ({smi})")
    say("spatial", f"one process at the whole batch ([train]): step ms {train_figures[0]:.1f}, peak "
                   f"{train_figures[1]:.3f} GiB ({smi})")
    for r, res in enumerate(ranks):
        for k in total:
            total[k] += sum(res["families"][f"{name}_counts"][k]
                            for name in ("attentiongan", "identity", "convs", "cyclegan", "pix2pix", "seg"))
    _check_spatial_families(smi, [res["families"] for res in ranks], family_base, family_figures)
    _spatial_cli(smi, root)
    say("spatial", f"the phase took {time.perf_counter() - t_phase:.1f} s")
    return total, rows


def _rel(got: dict, want: dict) -> dict:
    return {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}


def _check_spatial_families(smi, ranks, base, family_figures) -> None:
    """The other networks' results from the two ranks against the
    one-process references (module docstring, phase 15)."""
    a, b = ranks
    expected = {"attentiongan": SPATIAL_FAMILY_LAUNCHES["attentiongan"],
                "identity": SPATIAL_FAMILY_LAUNCHES["attentiongan+identity"], "convs": SPATIAL_CONVS_LAUNCHES,
                "cyclegan": SPATIAL_FAMILY_LAUNCHES["cyclegan"], "pix2pix": SPATIAL_FAMILY_LAUNCHES["pix2pix"],
                "seg": NO_LAUNCHES}
    for r, res in enumerate(ranks):
        for name, want in expected.items():
            check(res[f"{name}_counts"] == want, f"rank {r}: one {name} step launched {res[f'{name}_counts']}, "
                                                  f"expected {want}")
    for key in ("attentiongan_losses", "identity_losses", "convs_losses", "cyclegan_losses", "pix2pix_losses",
                "seg_metrics"):
        check(a[key] == b[key], f"the ranks report other {key}: {a[key]} and {b[key]}")
        values = a[key] if isinstance(a[key], list) else [a[key]]
        check(all(np.isfinite(v) for step in values for v in step.values()), f"{key}: {a[key]}")
    check(torch.equal(a["cycle_params"], b["cycle_params"]), "AttentionGAN: the ranks' parameters differ")
    check(torch.equal(a["pix2pix_params"], b["pix2pix_params"]), "Pix2Pix: the ranks' parameters differ")
    # Step 1 of the cycle step reads no updated parameter (G first, the D
    # losses on the reals and the pre-update synthetics); Pix2Pix's G loss
    # reads the D that Adam has just moved.
    for model, updated in (("attentiongan", ()), ("pix2pix", ("losses_generator_synthetic",))):
        for i in range(2):
            rel = _rel(a[f"{model}_losses"][i], base[model][i])
            tols = {k: TOL_SPATIAL_STEP1 if i == 0 and k not in updated else TOL_SPATIAL_UPDATED for k in rel}
            say("spatial", f"{FAMILIES[model]} step {i + 1}: the ranks against one process, rel diff "
                           + ", ".join(f"{k} {rel[k]:.3g} (tol {tols[k]:.3g})" for k in rel))
            check(all(rel[k] <= tols[k] for k in rel), f"{model} step {i + 1}: the ranks against one process: {rel}")
    diffs = {}
    for key, want in base["buffers"].items():
        got = torch.cat([a["buffers"][key], b["buffers"][key]], 2)
        check(got.shape == want.shape, f"{key}: rows {tuple(got.shape)} against {tuple(want.shape)}")
        diffs[key] = (float((got - want).abs().mean() / want.abs().mean()), float((got - want).abs().max()))
    say("spatial", "AttentionGAN buffers after step 1, the two ranks' rows against one process's "
                   f"{BATCH} images: " + ", ".join(f"{k} mean |diff| / mean |image| {m:.3g} (tol "
                                                   f"{TOL_SPATIAL_STEP1:.3g}), max |diff| {x:.3g}"
                                                   for k, (m, x) in diffs.items()))
    check(all(m <= TOL_SPATIAL_STEP1 for m, _ in diffs.values()), f"AttentionGAN buffers: {diffs}")
    for key, want in (("logits", base["logits"]), ("bilinear", base["bilinear"])):
        axis = 1 if key == "logits" else 2  # NHWC logits, NCHW forward
        got = torch.cat([a[key], b[key]], axis)
        err = float((got - want).abs().max())
        tol = TOL_EVAL_LOGITS * float(want.abs().max())
        check(got.shape == want.shape and err <= tol, f"U-Net {key} on rows: {tuple(got.shape)}, max_abs_diff {err}")
        say("spatial", f"U-Net {'predict_logits at ' + str(SPATIAL_UNET) + '^2, batch 1' if key == 'logits' else 'bilinear forward at ' + str(SPATIAL_BILINEAR) + '^2, batch 2'}, "
                       f"f32, on rows against one process: max_abs_diff {err:.3g} (tol {tol:.3g}, "
                       f"{TOL_EVAL_LOGITS:g} of max |logit|)")
    say("spatial", f"AttentionGAN launches of one rank's step {a['attentiongan_counts']}; with the identity loss "
                   f"{a['identity_counts']}; under remat convs {a['convs_counts']}; CycleGAN {a['cyclegan_counts']}; "
                   f"Pix2Pix and the U-Net none; the ranks hold equal parameters bit for bit after "
                   f"{SPATIAL_CYCLE_STEPS} AttentionGAN and {SPATIAL_P2P_STEPS} Pix2Pix steps")
    one = family_figures["attentiongan"]
    for r, res in enumerate(ranks):
        med, lo, hi = res["cycle_step_ms"]
        say("spatial", f"rank {r}: AttentionGAN step ms median {med:.1f} over {SPATIAL_TIMED} (min {lo:.1f}, max "
                       f"{hi:.1f}) -- one card, two processes sharing it, halos and sums staged through the host over "
                       f"gloo: not a measure of scaling; an instrumented step {res['cycle_instrumented_ms']:.1f} ms, "
                       f"of it {res['cycle_exchange_ms']:.1f} ms in {res['cycle_exchange_calls']} exchanges and "
                       f"reductions ({res['cycle_exchange_ms'] / res['cycle_instrumented_ms']:.3f}); peak memory "
                       f"{res['cycle_peak_gib']:.3f} GiB, with the identity loss {res['identity_peak_gib']:.3f}, "
                       f"under remat convs {res['convs_peak_gib']:.3f}, CycleGAN {res['cyclegan_peak_gib']:.3f}, "
                       f"Pix2Pix {res['pix2pix_peak_gib']:.3f} (step ms {res['pix2pix_step_ms'][0]:.1f}), the U-Net "
                       f"at {SPATIAL_UNET}^2 {res['seg_peak_gib']:.3f} ({smi})")
    say("spatial", f"one process at the whole batch ([families]): AttentionGAN step ms {one[0]:.1f}, peak "
                   f"{one[1]:.3f} GiB; Pix2Pix step ms {family_figures['pix2pix'][0]:.1f}, peak "
                   f"{family_figures['pix2pix'][1]:.3f} GiB ({smi})")


def _spatial_cli(smi, root: str) -> None:
    """python -m floodgan_tpu_torch.cli.train --model=AttentionGAN
    --num_spatial_devices 2 --dist_backend gloo on [cli]'s tiles (1 epoch):
    its .sharded directory holds each buffer as two row pieces, and a
    Model resumed from it on 2 gloo ranks holds its state bit for bit,
    each rank its rows of the buffers."""
    import glob
    import hashlib
    import os

    from floodgan_tpu_torch.ckpt import _msgpack
    from floodgan_tpu_torch.ckpt.sharded import load_checkpoint_sharded
    from floodgan_tpu_torch.cli import train as cli_train
    from floodgan_tpu_torch.parallel import mesh as mesh_lib

    before = set(glob.glob(os.path.join(root, "models", "AttentionGAN_*.sharded")))
    t0 = time.perf_counter()
    done = cli_train.main(["--model=AttentionGAN", "--topography=all", "--dataset_subset=usa", "--dataset_dem=best",
                           f"--data_path={root}", f"--metadata_dir={root}/metadata", f"--resize={S}",
                           f"--batch_size={BATCH}", "--compute_dtype=bfloat16", "--num_epochs=1",
                           "--save_model_interval=1", f"--num_spatial_devices={SPATIAL}", "--dist_backend=gloo",
                           "--device=cuda"])
    wall = time.perf_counter() - t0
    (ckpt,) = set(glob.glob(os.path.join(root, "models", "AttentionGAN_*.sharded"))) - before
    check(done is None and sorted(os.listdir(ckpt)) == ["meta.json", "shards_p0.msgpack", "shards_p1.msgpack"],
          f"the spatial CLI's directory: {sorted(os.listdir(ckpt))}")
    h = S // SPATIAL
    for r in range(SPATIAL):
        with open(os.path.join(ckpt, f"shards_p{r}.msgpack"), "rb") as f:
            pieces = _msgpack.unpackb(f.read())
        for key in ("pre_buffer/images", "post_buffer/images"):
            index = [e["index"] for e in pieces.get(key, [])]
            check(index == [[[0, 50], [r * h, (r + 1) * h], [0, S], [0, 9]]], f"rank {r}'s {key} pieces: {index}")
    meta, state = load_checkpoint_sharded(ckpt)
    check(meta["starting_epoch"] == 2 and all(np.isfinite(v[0]) for v in meta["all_losses"].values()),
          f"the spatial CLI's meta: {meta['starting_epoch']}, {meta['all_losses']}")
    out = tempfile.mkdtemp(prefix="floodgan_resume_")
    try:
        t1 = time.perf_counter()
        mesh_lib.spawn(_spatial_resume_rank, SPATIAL, args=(out, ckpt, root), device_type="cuda", backend="gloo",
                       cards=[0] * SPATIAL, timeout_s=300, join_timeout_s=400)
        resume_s = time.perf_counter() - t1
        resumed = [torch.load(os.path.join(out, f"resume_rank{r}.pt")) for r in range(SPATIAL)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for r, res in enumerate(resumed):
        lo, hi = res["rows"]
        want = {}
        for path, leaf in _flat_leaves(state):
            arr = getattr(leaf, "bits", leaf)
            if path.endswith("_buffer/images"):
                arr = arr[:, lo:hi]
            want[path] = hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()
        differ = sorted(k for k in want if res["digests"].get(k) != want[k])
        check((lo, hi) == (r * h, (r + 1) * h) and res["epoch"] == 2 and not differ
              and set(res["digests"]) == set(want), f"rank {r} resumed: rows {lo}-{hi}, differs in {differ[:5]}")
    size = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt)) / 2**20
    say("spatial", f"python -m floodgan_tpu_torch.cli.train --model=AttentionGAN --num_spatial_devices {SPATIAL} "
                   f"--dist_backend gloo ({CLI_TILE}^2 tiles resized to {S}^2, batch {BATCH}, bf16, 1 epoch): "
                   f"{wall:.2f} s with start-up, a .sharded directory of {size:.1f} MiB whose buffers are "
                   f"row pieces [0, {h}) and [{h}, {S}); resumed on {SPATIAL} gloo ranks in {resume_s:.2f} s, "
                   f"{len(want)} leaves bit for bit on each rank (its rows of the buffers) ({smi})")


def _write_geotiff(path: str, array: np.ndarray, x_min: float, y_max: float, px_w: float, px_h: float) -> None:
    """``array`` as a TIFF (the port's writer) with the two GeoTIFF tags
    that ``tiff.geotransform`` reads appended: ModelPixelScale (33550,
    (px_w, px_h, 0)) and ModelTiepoint (33922, raster (0, 0, 0) at model
    (x_min, y_max, 0)), both doubles.  A new first IFD holds the old
    entries and the two tags, after the file's bytes."""
    import struct

    from floodgan_tpu_torch.data import tiff

    tiff.imwrite(path, array)
    with open(path, "r+b") as f:
        data = f.read()
        (ifd,) = struct.unpack_from("<I", data, 4)
        (n,) = struct.unpack_from("<H", data, ifd)
        entries = data[ifd + 2:ifd + 2 + 12 * n]
        start = len(data) + len(data) % 2
        scale = struct.pack("<3d", px_w, px_h, 0.0)
        tie = struct.pack("<6d", 0.0, 0.0, 0.0, x_min, y_max, 0.0)
        entries += struct.pack("<HHII", 33550, 12, 3, start) + struct.pack("<HHII", 33922, 12, 6, start + 24)
        f.write(b"\0" * (start - len(data)) + scale + tie + struct.pack("<H", n + 2) + entries + b"\0\0\0\0")
        f.seek(4)
        f.write(struct.pack("<I", start + 72))


def _write_raw_rasters(raw: dict, images: list, rng) -> dict:
    """The raw inputs of each image under ``raw``'s directories: the
    pre-disaster GeoTIFF (uint8 RGB), the post-disaster image, a DEM in
    metres (f32, some below 0), log flow accumulation (f32), river distance
    and OSM map (uint8; the map RGBA) and a {0, 1} cloud mask.  Returns each
    image's (x_min, y_max)."""
    import os

    from floodgan_tpu_torch.data import tiff

    t = ETL_TILE
    corners = {}
    for i, image in enumerate(images):
        x_min, y_max = -78.0 + 0.004 * (i % 5), 34.25 - 0.004 * (i // 5)
        corners[image] = (x_min, y_max)
        _write_geotiff(os.path.join(raw["pre"], f"{image}.tif"), rng.integers(0, 256, (t, t, 3), dtype=np.uint8),
                       x_min, y_max, ETL_PIXEL_DEG, ETL_PIXEL_DEG)
        tiff.imwrite(os.path.join(raw["post"], f"{image}.tif"), rng.integers(0, 256, (t, t, 3), dtype=np.uint8))
        tiff.imwrite(os.path.join(raw["dem"], f"{image}.tif"), rng.normal(4.0, 3.0, (t, t)).astype(np.float32))
        tiff.imwrite(os.path.join(raw["flow"], f"{image}.tif"), rng.uniform(0.0, 5.5, (t, t)).astype(np.float32))
        tiff.imwrite(os.path.join(raw["river"], f"{image}.tif"), rng.integers(0, 256, (t, t), dtype=np.uint8))
        tiff.imwrite(os.path.join(raw["osm"], f"{image}.tif"), rng.integers(0, 256, (t, t, 4), dtype=np.uint8))
        tiff.imwrite(os.path.join(raw["cloud"], f"{image}.tif"), (rng.random((t, t)) > 0.1).astype(np.uint8))
    return corners


def _tree_differences(a, b, where="") -> list:
    """The paths at which two state trees (as ``load_checkpoint`` reads
    them) differ in keys, dtype, shape or any bit."""
    if isinstance(b, dict):
        if not isinstance(a, dict) or set(a) != set(b):
            return [where or "/"]
        return [d for k in b for d in _tree_differences(a[k], b[k], f"{where}/{k}")]
    x, y = (np.asarray(getattr(v, "bits", v)) for v in (a, b))
    same = x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
    return [] if same else [where]


def phase_etl(smi, root: str) -> tuple:
    """The offline ETL, then a training epoch on its dataset, the export to
    the reference's .pth.tar and the migration back (module docstring,
    phase 18).  Returns the launch counts of its runs and the .ckpt."""
    import os

    from floodgan_tpu_torch.ckpt import load_checkpoint, migrate
    from floodgan_tpu_torch.cli import train as cli_train
    from floodgan_tpu_torch.data import tiff
    from floodgan_tpu_torch.models.registry import build_discriminator, build_generator
    from floodgan_tpu_torch.pre_processing import metadata, stack
    from floodgan_tpu_torch.utils import torch_export

    launches = _Launches()
    base = os.path.join(root, "etl")
    raw = {k: os.path.join(base, "raw", k) for k in ("pre", "post", "dem", "flow", "river", "osm", "cloud")}
    for d in raw.values():
        os.makedirs(d)
    meta_dir, data_dir = os.path.join(base, "metadata"), os.path.join(base, "dataset")
    os.makedirs(meta_dir)
    images = [f"{ETL_DISASTER}_{i:08d}" for i in range(ETL_IMAGES)]
    t0 = time.perf_counter()
    corners = _write_raw_rasters(raw, images, np.random.default_rng(SEED + 20))
    raw_s = time.perf_counter() - t0
    raw_bytes = sum(os.path.getsize(os.path.join(d, f)) for d in raw.values() for f in os.listdir(d))

    # ---- stage 1: metadata and the split ----
    t0 = time.perf_counter()
    extents = metadata.create_metadata(raw["pre"], os.path.join(meta_dir, "metadata.csv"))
    t1 = time.perf_counter()
    split = metadata.create_dataset_split_metadata([r["image"] for r in extents],
                                                   {img: (ETL_DEM, ETL_DEM) for img in images},
                                                   os.path.join(meta_dir, "dataset_split.csv"))
    meta_s, split_s = t1 - t0, time.perf_counter() - t1
    check([r["image"] for r in extents] == images, f"metadata rows {[r['image'] for r in extents]}")
    span = ETL_TILE * ETL_PIXEL_DEG
    for r in extents:
        x_min, y_max = corners[r["image"]]
        check((r["x_min"], r["y_max"], r["x_max"], r["y_min"], r["disaster"])
              == (x_min, y_max, x_min + span, y_max - span, ETL_DISASTER), f"metadata row {r}")
    counts = {}
    for r in split:
        counts[(r["version"], r["split"])] = counts.get((r["version"], r["split"]), 0) + 1
    want = {("original", "train"): 16, ("original", "validation"): 2, ("original", "test"): 2,
            ("flipped", "train"): 16, ("flipped", "validation"): 2}
    check(counts == want, f"split counts {counts}, expected {want}")

    # ---- stages 2-3: the stacks, masked, and the dataset pairs ----
    read_s = stack_s = write_s = 0.0
    for image in images:
        t0 = time.perf_counter()
        r = {k: tiff.imread(os.path.join(d, f"{image}.tif")) for k, d in raw.items()}
        t1 = time.perf_counter()
        x = stack.apply_masks(stack.create_input_stack(
            r["pre"], stack.render_dem(r["dem"], ETL_DEM), stack.render_flow_accumulation(r["flow"]),
            stack.render_river_distance(r["river"]), r["osm"]), r["cloud"])
        y = stack.apply_masks(stack.create_output(r["post"]), r["cloud"])
        t2 = time.perf_counter()
        stack.write_dataset_pair(data_dir, image, ETL_DEM, x, y)
        t3 = time.perf_counter()
        read_s, stack_s, write_s = read_s + t1 - t0, stack_s + t2 - t1, write_s + t3 - t2
    data_bytes = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(data_dir) for f in fs)

    # The channel contract on one written stack, read back through the decoder.
    r = {k: tiff.imread(os.path.join(d, f"{images[0]}.tif")) for k, d in raw.items()}
    got = tiff.imread(os.path.join(data_dir, "dataset_input", f"{images[0]}_{ETL_DEM}.tif"))
    check(got.shape == (ETL_TILE, ETL_TILE, 9) and got.dtype == np.float32, f"stack {got.shape} {got.dtype}")
    m = r["cloud"].astype(np.float32)
    dem = np.maximum(r["dem"], 0.0)
    channels = {
        "rgb": r["pre"].astype(np.float32) / 255.0 * m[:, :, None],
        "dem": (dem - dem.min()) / 100.0 * m,
        "flow": r["flow"] / 5.5 * m,
        "river": r["river"].astype(np.float32) / 255.0 * m,
        "map": r["osm"][:, :, :3].astype(np.float32) / 255.0 * m[:, :, None],
    }
    for name, want_c in channels.items():
        check(np.array_equal(got[:, :, stack.CHANNELS[name]], want_c), f"stack channel {name} differs")
    say("etl", f"{ETL_IMAGES} raw {ETL_TILE}^2 image sets of {ETL_DISASTER} (a GeoTIFF pre image, post image, "
               f"DEM, flow, river, OSM map, cloud mask: {raw_bytes / 2**20:.0f} MiB) written in {raw_s:.2f} s")
    say("etl", f"ETL seconds: metadata (GeoTIFF tags) {meta_s:.4f}, split {split_s:.4f}, raster reads "
               f"{read_s:.3f}, stacks and masks {stack_s:.3f}, dataset writes {write_s:.3f} "
               f"({data_bytes / 2**20:.0f} MiB); split {json.dumps({f'{v} {k}': n for (v, k), n in counts.items()})}; "
               f"the channel contract held bit for bit on {images[0]}")

    # ---- one epoch of the training CLI on the ETL's dataset ----
    flags = ["--model=PairedAttention", "--topography=all", f"--dataset_subset={ETL_DISASTER}",
             "--dataset_dem=best", f"--data_path={data_dir}", f"--metadata_dir={meta_dir}", f"--resize={S}",
             f"--batch_size={BATCH}", "--compute_dtype=bfloat16", "--num_epochs=1", "--save_model_interval=1"]
    steps = -(-want[("original", "train")] * 2 // BATCH)
    launches.zero()
    t0 = time.perf_counter()
    trained = cli_train.main(flags)
    epoch_s = time.perf_counter() - t0
    launches.read(f"the epoch's {steps} steps", {k: v * steps for k, v in TRAIN_STEP_LAUNCHES.items()})
    check(all(len(v) == 1 and np.isfinite(v[0]) for v in trained.all_losses.values()),
          f"epoch losses {trained.all_losses}")
    (ckpt,) = [os.path.join(data_dir, "models", f) for f in os.listdir(os.path.join(data_dir, "models"))]
    say("etl", f"python -m floodgan_tpu_torch.cli.train on the ETL's dataset ({S}^2, batch {BATCH}, bf16, 1 "
               f"epoch of {steps} steps): {epoch_s:.2f} s, launches {launches.total}, losses "
               f"{json.dumps({k: v[0] for k, v in trained.all_losses.items()})}")
    del trained
    torch.cuda.empty_cache()

    # ---- export to the reference's .pth.tar, and the migrate CLI back ----
    names = {"generator": [n for n, _ in build_generator("pairedattention", 9).named_parameters()],
             "discriminator": [n for n, _ in build_discriminator("pairedattention", 12).named_parameters()]}
    t0 = time.perf_counter()
    pth = torch_export.export_gan_checkpoint(ckpt, os.path.join(base, "exported.pth.tar"), names)
    t1 = time.perf_counter()
    back = migrate.main(["gan", pth, os.path.join(base, "migrated.ckpt"), "--resize", str(S)])
    t2 = time.perf_counter()
    meta0, raw0 = load_checkpoint(ckpt)
    meta1, raw1 = load_checkpoint(back)
    keys = ("gen_params", "disc_params", "gen_opt", "disc_opt")
    differ = [d for k in keys for d in _tree_differences(raw1[k], raw0[k], k)]
    check(not differ and meta1 == meta0, f"export -> migrate differs at {differ[:5]} (meta {meta1 == meta0})")
    count = int(np.asarray(raw0["gen_opt"]["count"]))
    check(count == steps, f"the .ckpt's Adam count {count}, expected {steps}")
    say("etl", f"export_gan_checkpoint {(t1 - t0) * 1e3:.1f} ms ({os.path.getsize(pth) / 2**20:.1f} MiB .pth.tar), "
               f"python -m floodgan_tpu_torch.ckpt.migrate gan {(t2 - t1) * 1e3:.1f} ms: parameters, Adam moments "
               f"and counts ({count}) of both networks bit for bit, meta equal ({smi})")
    return launches.total, ckpt


def _direct(engine, stacks: np.ndarray) -> np.ndarray:
    """engine.predict of each image, in zero-padded batches of its shape."""
    bs, out = engine.batch_size, []
    for lo in range(0, len(stacks), bs):
        chunk = stacks[lo:lo + bs]
        pad = np.zeros((bs - len(chunk),) + engine.input_shape, np.float32)
        out.append(engine.predict(np.concatenate([chunk, pad])).cpu().numpy()[:len(chunk)])
    return np.concatenate(out)


def _in_threads(fn, n: int, timeout: float = 600) -> None:
    """``fn(i)`` on ``n`` threads released together; fails on any exception
    or a thread still running after ``timeout``."""
    errors, barrier = [], threading.Barrier(n)

    def body(i):
        try:
            barrier.wait(timeout=timeout)
            fn(i)
        except Exception as e:  # reported below; the phase then fails
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    check(not errors and not any(t.is_alive() for t in threads), f"client threads failed: {errors[:3]}")


def _served_batch_ms(engine, image: np.ndarray, runs: int = 5) -> dict:
    """Host-clock medians of what the frontend's worker does in turn for a
    batch holding one request (``BatchingFrontend._flush``): stack and
    zero-pad on the host, the copy to the card, the forward, the copy back;
    and the whole of ``engine.predict(batch).cpu().numpy()``, which the
    worker runs after the stack.  Each call launches one forward."""
    parts = {"stack and pad": [], "host to card": [], "forward": [], "card to host": [],
             "predict and copy back": []}
    for _ in range(runs):
        t0 = time.perf_counter()
        batch = np.concatenate([np.stack([image]),
                                np.zeros((engine.batch_size - 1,) + engine.input_shape, np.float32)])
        t1 = time.perf_counter()
        x = torch.from_numpy(batch).to(engine.device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = engine.predict(x)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.cpu().numpy()
        t4 = time.perf_counter()
        engine.predict(batch).cpu().numpy()
        t5 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            parts[k].append(dt * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def _http_post(url: str, arr: np.ndarray) -> tuple:
    """(status, the answer's array or JSON, round-trip seconds) of one .npy
    POST."""
    import io
    import urllib.error
    import urllib.request

    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            out = np.load(io.BytesIO(r.read()))
            return r.status, out, time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def phase_load(smi, ckpt: str) -> dict:
    """Serving under load: the serve bench through its main(), then HTTP
    over a repository of two models (module docstring, phase 19).  Returns
    the launch counts of its runs."""
    import urllib.request

    from floodgan_tpu_torch import serve
    from floodgan_tpu_torch.models.layers import init_weights
    from floodgan_tpu_torch.models.registry import build_generator
    from floodgan_tpu_torch.tools import serve_bench

    launches = _Launches()
    closed = []

    class Recording(serve.BatchingFrontend):
        """The bench's frontend, its stats kept when it closes."""

        def close(self):
            super().close()
            closed.append(self.stats())

    saved = serve_bench.BatchingFrontend
    serve_bench.BatchingFrontend = Recording
    try:
        launches.zero()
        t0 = time.perf_counter()
        engine_lines = serve_bench.main(["--model", "pairedattention", "--size", str(S), "--batches", "1", str(BATCH),
                                         "--iters", str(LOAD_ITERS)])
        engine_s = time.perf_counter() - t0
        # Each engine: its warm-up at construction, benchmark()'s warm-up, LOAD_ITERS calls.
        forwards = 2 * (2 + LOAD_ITERS)
        launches.read(f"the engine bench's {forwards} forwards", {k: v * forwards for k, v in SERVE_LAUNCHES.items()})
        launches.zero()
        t0 = time.perf_counter()
        frontend_lines = serve_bench.main(["--frontend", "--model", "pairedattention", "--size", str(S),
                                           "--batches", str(BATCH), "--clients",
                                           *map(str, LOAD_CLIENTS), "--requests_per_client", str(LOAD_REQUESTS),
                                           "--max_delay_ms", str(LOAD_DELAY_MS)])
        frontend_s = time.perf_counter() - t0
        forwards = 1 + sum(st["batches"] for st in closed)  # the engine's warm-up, then every batch
        launches.read(f"the frontend bench's {forwards} forwards", {k: v * forwards for k, v in SERVE_LAUNCHES.items()})
    finally:
        serve_bench.BatchingFrontend = saved
    check([ln["metric"] for ln in engine_lines] == [f"pairedattention {S}^2 serve batch {b}" for b in (1, BATCH)]
          and all(ln["latency_ms"] > 0 for ln in engine_lines), f"engine lines {engine_lines}")
    check([ln["requests"] for ln in frontend_lines] == [n * LOAD_REQUESTS for n in LOAD_CLIENTS]
          and [st["requests"] for st in closed] == [1 + n * LOAD_REQUESTS for n in LOAD_CLIENTS]
          and all(0 < ln["mean_batch_occupancy"] <= 1 and 0 < ln["p50_ms"] <= ln["p99_ms"] for ln in frontend_lines),
          f"frontend lines {frontend_lines}, stats {closed}")
    for ln in engine_lines:
        say("load", f"{ln['metric']}: {ln['latency_ms']} ms, {ln['images_per_sec']} images/s ({smi})")
    for ln, st in zip(frontend_lines, closed):
        say("load", f"{ln['metric']}: p50 {ln['p50_ms']} ms, p99 {ln['p99_ms']} ms, {ln['images_per_sec']} images/s, "
                    f"occupancy {ln['mean_batch_occupancy']} over {st['batches']} batches ({smi})")
    say("load", f"serve bench: engine mode {engine_s:.1f} s, frontend mode {frontend_s:.1f} s (set-ups included)")

    # ---- HTTP: the ETL's .ckpt and a CycleGAN engine, then a burst ----
    launches.zero()
    repo = serve.ModelRepository()
    repo.add_checkpoint("paired", ckpt, batch_size=BATCH, image_size=S)
    g = init_weights(build_generator("cyclegan", 9), torch.Generator().manual_seed(SEED + 21))
    repo.add("cycle", serve.InferenceEngine("cyclegan", g.state_dict(), "all", batch_size=BATCH, image_size=S))
    repo.add("burst", serve.InferenceEngine.from_checkpoint(ckpt, batch_size=BATCH, image_size=S),
             max_pending=BURST_PENDING)
    pool = np.random.default_rng(SEED + 22).uniform(-1.0, 1.0, (HTTP_POOL, S, S, 9)).astype(np.float32)
    engines = {name: repo.frontend(name).engine for name in ("paired", "cycle")}
    want = {name: _direct(eng, pool) for name, eng in engines.items()}
    parts = _served_batch_ms(engines["paired"], pool[0])
    cycle_ms = engines["cycle"].benchmark(iters=5)["latency_ms"]  # a warm-up and 5 forwards
    per_model = {"paired": _serve_launches("pairedattention"), "cycle": _serve_launches("cyclegan")}
    direct = -(-HTTP_POOL // BATCH)
    launches.read("three engines' warm-ups, the direct forwards and the served-batch breakdown's", {
        k: per_model["paired"][k] * (2 + direct + 2 * 5) + per_model["cycle"][k] * (1 + direct + 6) for k in NO_LAUNCHES})

    server = serve.serve_http(repo, host="127.0.0.1", port=0)
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    server_thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}/v1/models"
    lock = threading.Lock()
    answers, single_s = [], []
    try:
        launches.zero()

        def client(i):
            for j in range(HTTP_SINGLE + 1):
                name = ("paired", "cycle")[(i + j) % 2]
                n = 1 if j < HTTP_SINGLE else HTTP_MULTI
                idx = [(i * (HTTP_SINGLE + 1) + j + k) % HTTP_POOL for k in range(n)]
                status, out, sec = _http_post(f"{base}/{name}:predict", pool[idx[0]] if n == 1 else pool[idx])
                with lock:
                    answers.append((name, idx, status, out))
                    if n == 1:
                        single_s.append(sec)

        t0 = time.perf_counter()
        _in_threads(client, HTTP_CLIENTS)
        http_s = time.perf_counter() - t0
        with urllib.request.urlopen(base, timeout=60) as r:
            models = json.load(r)
        bad = [(name, status) for name, _, status, _ in answers if status != 200]
        check(not bad, f"HTTP answers other than 200: {bad[:5]}")
        worst = max(float(np.abs(out.reshape((-1, S, S, 3)) - want[name][idx]).max())
                    for name, idx, _, out in answers)
        check(worst <= TOL_HTTP, f"HTTP answers differ from engine.predict by {worst} (tol {TOL_HTTP})")
        sent = {name: sum(len(idx) for n, idx, _, _ in answers if n == name) for name in ("paired", "cycle")}
        check({k: models[k]["requests"] for k in sent} == sent, f"GET /v1/models counted {models}, sent {sent}")

        burst = []

        def burst_client(i):
            idx = [(i + k) % HTTP_POOL for k in range(1 + i % HTTP_MULTI)]
            status, out, _ = _http_post(f"{base}/burst:predict", pool[idx])
            with lock:
                burst.append((idx, status, out))

        _in_threads(burst_client, BURST_CLIENTS)
        with urllib.request.urlopen(base, timeout=60) as r:
            after = json.load(r)
        statuses = [status for _, status, _ in burst]
        check(set(statuses) <= {200, 503} and 200 in statuses and 503 in statuses,
              f"burst statuses {statuses}: expected 200s and 503s only, some of each")
        check(all(out["retry"] is True for _, status, out in burst if status == 503), "a 503 without retry")
        worst_burst = max(float(np.abs(out - want["paired"][idx]).max()) for idx, status, out in burst if status == 200)
        check(worst_burst <= TOL_HTTP, f"burst answers differ from engine.predict by {worst_burst}")
        served = sum(len(idx) for idx, status, _ in burst if status == 200)
        check(after["burst"]["requests"] == served, f"burst frontend counted {after['burst']['requests']}, served {served}")
    finally:
        server.shutdown()
        server.server_close()
        repo.close()
        server_thread.join(timeout=60)
    batches = {name: after[name]["batches"] for name in after}
    launches.read(f"HTTP's batches {batches}", {
        k: per_model["paired"][k] * (batches["paired"] + batches["burst"]) + per_model["cycle"][k] * batches["cycle"]
        for k in NO_LAUNCHES})
    ms = np.sort(np.array(single_s)) * 1e3
    say("load", f"one served batch of 1 request at batch {BATCH}, as the frontend's worker runs it (host clock, "
                f"median of 5): " + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
                + f"; the forward is {parts['forward'] / (parts['stack and pad'] + parts['predict and copy back']):.3f}"
                f" of the worker's batch (stack and pad, then predict and copy back); the CycleGAN "
                f"engine's batch-{BATCH} forward {cycle_ms:.3f} ms ({smi})")
    say("load", f"HTTP, {HTTP_CLIENTS} clients x ({HTTP_SINGLE} single-image + one {HTTP_MULTI}-image .npy POST) to "
                f"alternating models in {http_s:.2f} s: all {len(answers)} answers 200, max |HTTP - engine.predict| "
                f"{worst:.3g} (tol {TOL_HTTP:g}); single-image round trip p50 {np.percentile(ms, 50):.2f} ms, "
                f"p99 {np.percentile(ms, 99):.2f} ms; GET /v1/models: " + ", ".join(
                    f"{k} {models[k]['requests']} requests in {models[k]['batches']} batches, occupancy "
                    f"{models[k]['mean_occupancy']:.3f}" for k in sent) + f" ({smi})")
    say("load", f"burst of {BURST_CLIENTS} POSTs (1-{HTTP_MULTI} images) against max_pending={BURST_PENDING}: "
                f"{statuses.count(200)} answered 200 (max diff {worst_burst:.3g}), {statuses.count(503)} refused 503 "
                f"with retry; launches {launches.total}")
    return launches.total


def _bench_line(line: dict, what: str, smi: str) -> None:
    """The checks every bench line passes: a finite value above 0, an MFU in
    (0, 1] where one is printed, the card named."""
    check(np.isfinite(line["value"]) and line["value"] > 0, f"bench {what}: value {line['value']}")
    check("mfu" not in line or 0 < line["mfu"] <= 1, f"bench {what}: mfu {line.get('mfu')}")
    check(line["device"] == smi, f"bench {what}: device {line['device']!r}, nvidia-smi says {smi!r}")


def phase_bench(smi) -> dict:
    """The headline bench through its main() in each mode (module docstring,
    phase 20).  Returns the launch counts of its runs."""
    from floodgan_tpu_torch.tools import bench

    launches = _Launches()
    lines, walls = {}, {}

    def run(what: str, argv: list, per_step: dict, steps: int) -> dict:
        launches.zero()
        t0 = time.perf_counter()
        line = bench.main(argv)
        walls[what] = time.perf_counter() - t0
        launches.read(f"bench {what}", {k: v * steps for k, v in per_step.items()})
        _bench_line(line, what, smi)
        lines[what] = line
        return line

    short = ["--steps", str(BENCH_SHORT_STEPS)]
    head = run("train", [], TRAIN_STEP_LAUNCHES, BENCH_WARMUP + BENCH_STEPS)
    need = ("value", "tflops_per_sec", "mfu", "flops_per_sample_tf", "peak_tflops", "device")
    check(all(k in head for k in need), f"the headline line lacks one of {need}: {head}")
    again = run("train again", short, TRAIN_STEP_LAUNCHES, BENCH_WARMUP + BENCH_SHORT_STEPS)
    check(again["flops_per_sample_tf"] == head["flops_per_sample_tf"],
          f"two PairedAttention runs counted {head['flops_per_sample_tf']} and {again['flops_per_sample_tf']} "
          "TFLOP a sample")
    for model in BENCH_MODELS:
        first = run(model, ["--model", model] + short, FAMILY_STEP_LAUNCHES.get(model, NO_LAUNCHES),
                    BENCH_WARMUP + BENCH_SHORT_STEPS)
        check("mfu" in first, f"bench {model}: no mfu on {smi}: {first}")
    run("eval", ["--mode", "eval"] + short, SERVE_LAUNCHES, BENCH_WARMUP + BENCH_SHORT_STEPS)
    # The warm epoch, the measured epochs, then 3 + 20 steps on a batch on the card.
    epoch = BENCH_PIPELINE_SAMPLES // BATCH
    pipe = run("pipeline", ["--mode", "pipeline"], TRAIN_STEP_LAUNCHES, epoch * 5 + 3 + 20)
    check(pipe["post_cache_hit_rate"] == 1.0 and pipe["post_transform_cache"] is True,
          f"the measured epochs were not served from the post-transform cache: {pipe}")
    for what, line in lines.items():
        keys = {k: line[k] for k in line if k not in ("metric", "unit", "baseline", "device", "includes")}
        say("bench", f"{what}: {line['metric']}: {json.dumps(keys)} ({walls[what]:.1f} s wall)")
    say("bench", f"{smi}; launches {launches.total}")
    return launches.total


def phase_dryrun(smi) -> None:
    """tools/dryrun.py's five phases on DRYRUN_RANKS gloo ranks on card 0,
    after NCCL on as many ranks is refused (module docstring, phase 21)."""
    from floodgan_tpu_torch.tools import dryrun

    try:
        dryrun.dryrun_multichip(DRYRUN_RANKS, "cuda")
    except ValueError as e:
        refusal = str(e)
    else:
        raise SmokeFailure(f"dryrun_multichip({DRYRUN_RANKS}, 'cuda') ran on NCCL with one card")
    check(torch.cuda.device_count() == 1 and f"requested {DRYRUN_RANKS} devices" in refusal,
          f"NCCL refused with {refusal!r}")
    say("dryrun", f"NCCL on {DRYRUN_RANKS} ranks with {torch.cuda.device_count()} card refused before any "
                  f"process started: {refusal}")
    seconds = dryrun.dryrun_multichip(DRYRUN_RANKS, "cuda", backend="gloo")
    say("dryrun", f"{DRYRUN_RANKS} gloo ranks on card 0, every phase passed: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in seconds.items()) + f" wall ({smi})")


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


def main(argv=None) -> int:
    import argparse

    global K6_PARENT
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k6-parent", metavar="DIR",
                    help="a checkout of the port whose K6 is timed in turns beside this tree's at every "
                         "reflect-pad site ([kernels])")
    ap.add_argument("--k6-only", action="store_true",
                    help="stop after K6's sites and edge shapes (device, build, K6); prints no result line")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    parent_build = tempfile.mkdtemp(prefix="k6_parent_") if args.k6_parent else None
    try:
        if args.k6_parent:
            K6_PARENT = _parent_reflect_pad_bwd(args.k6_parent, parent_build)
        if args.k6_only:
            phase_pads(torch.Generator(device="cuda").manual_seed(SEED))
            say("done", f"K6 only: device, build and K6 passed in {time.perf_counter() - t_start:.1f} s")
            return 0
        rows = phase_kernels()
    finally:
        K6_PARENT = None
        if parent_build:
            shutil.rmtree(parent_build, ignore_errors=True)
    sd = _state_dict()
    engine = phase_engine(sd, smi)
    serve_counts = phase_requests(engine)
    del engine
    phase_card_vs_cpu(sd)
    train_counts, step_rate, train_figures = phase_train(smi)
    head_counts = phase_head(smi)
    root = tempfile.mkdtemp(prefix="floodgan_cli_")
    try:
        cli_counts, gan_ckpt, tests = phase_cli(smi, step_rate, root)
        eval_counts, seg_ckpt = phase_eval(smi, root, gan_ckpt, tests)
        families_counts, family_ckpts, family_figures = phase_families(smi, root, tests, step_rate)
        remat_counts = phase_remat(smi, root, family_figures["attentiongan"], train_figures)
        dp_counts = phase_dp(smi)
        det_counts = phase_determinism(smi)
        spatial_counts, spatial_rows = phase_spatial(smi, train_figures, family_figures, root)
        rows.update(spatial_rows)
        compare_counts = phase_compare(smi, root, {"PairedAttention": gan_ckpt, **family_ckpts}, seg_ckpt)
        etl_counts, etl_ckpt = phase_etl(smi, root)
        load_counts = phase_load(smi, etl_ckpt)
        bench_counts = phase_bench(smi)
        phase_dryrun(smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    runs = {"serving": serve_counts, "training": train_counts, "head": head_counts, "cli": cli_counts,
            "eval": eval_counts, "families": families_counts, "remat": remat_counts, "dp": dp_counts,
            "determinism": det_counts, "spatial": spatial_counts,
            "compare": compare_counts, "etl": etl_counts, "load": load_counts, "bench": bench_counts}
    for k, row in rows.items():
        row["launches"] = sum(c[k] for c in runs.values())
    check(all(row["launches"] > 0 for row in rows.values()), f"a kernel of the main paths never ran: {runs}")
    phase_train_card_vs_cpu()
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
