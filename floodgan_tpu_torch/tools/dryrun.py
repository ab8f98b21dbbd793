"""Entry points of the port: a forward of the flagship generator, and a dry
run of every trainer family on an n-rank ``(data, spatial)`` mesh.

    python -m floodgan_tpu_torch.tools.dryrun N [--device cpu|cuda] [--backend gloo|nccl]

The counterpart of the root ``__graft_entry__.py``:

- ``entry()`` returns ``(fn, args)``: ``fn(generator, x)`` is the
  PairedAttention generator's output image for a 512x512, 9-channel input
  (the reference's headline configuration), with zero weights and a zero
  input, NCHW;
- ``dryrun_multichip(n)`` runs ONE step of each phase of ``PHASES``, each
  in its own ``parallel.mesh.spawn`` of ``n`` ranks, at tiny shapes with
  zero inputs, and prints ``dryrun: <phase> ok`` after each:
  - ``paired``: the PairedAttention adversarial step at 64^2 on a D x S
    mesh (S = 2 when n is even, else 1; D = n / S; one sample per data
    row): the batch striped over ``data``, the image height over
    ``spatial`` (halo exchanges, cross-shard instance-norm statistics);
  - ``cycle``: the CycleGAN step at 32^2 on the same layout (the replay
    buffers gathered over the data ranks), its height raised to
    ``CYCLE_SHARD_ROWS`` a rank where S > 1: the port's PatchGAN takes a
    shard of no fewer rows (``parallel.spatial.check_patchgan_rows``),
    where GSPMD reshards JAX's 16;
  - ``seg``: the U-Net's step at 64^2, the batch of n over all n ranks as
    data;
  - ``eval``: ``image_pair_metrics`` without MS-SSIM on each rank's
    images, then the U-Net's ``predict_mask`` and the confusion counts
    summed over the mesh before ``MaskMetricsAccumulator.compute``;
  - ``spatial``: PairedAttention under remat ``boundaries`` on a
    spatial-major mesh (S = 4 when 4 divides n, else 2), H = 64·S rows,
    W = 32, so every halo'd layer exchanges rows at each shard boundary.

Ranks use NCCL on the card and gloo on the CPU (``backend_for``); an
explicit ``backend="gloo"`` puts several ranks on one card.  More NCCL
ranks than cards are refused before any process starts, never run on
gloo instead.  Each phase checks what the JAX dry run checks: finite,
non-negative losses, an accuracy in [0, 1].
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Dict, Optional

import torch

PHASES = ("paired", "cycle", "seg", "eval", "spatial")
CYCLE_SHARD_ROWS = 24  # the least shard height of the PatchGAN: h, h/2, h/4 even and h/8 >= 3


def entry(device=None):
    """(fn, (generator, x)): the PairedAttention generator (9 input
    channels) with every parameter zero and a zero (1, 9, 512, 512)
    input, on ``device`` (None: the card); ``fn`` returns the output
    image, (1, 3, 512, 512)."""
    from floodgan_tpu_torch.core.device import resolve_device
    from floodgan_tpu_torch.models.registry import build_generator

    device = resolve_device(device, "entry")
    generator = build_generator("pairedattention", 9).to(device)
    with torch.no_grad():
        for p in generator.parameters():
            p.zero_()
    x = torch.zeros((1, 9, 512, 512), device=device)

    def fn(generator, x):
        out, _mask = generator(x)
        return out

    return fn, (generator, x)


def phase_layout(phase: str, n_devices: int) -> Dict[str, int]:
    """The mesh and the global batch of ``phase`` on ``n_devices`` ranks:
    ``D`` data stripes of ``S`` spatial ranks each, ``batch`` images of
    ``H`` x ``W``."""
    if phase in ("paired", "cycle"):
        spatial = 2 if n_devices % 2 == 0 else 1
        size = 64 if phase == "paired" else 32
        height = size if phase == "paired" else max(size, CYCLE_SHARD_ROWS * spatial)
        return dict(D=n_devices // spatial, S=spatial, batch=n_devices // spatial, H=height, W=size)
    if phase in ("seg", "eval"):
        return dict(D=n_devices, S=1, batch=n_devices, H=64, W=64)
    if phase == "spatial":
        spatial = 4 if n_devices % 4 == 0 else 2
        return dict(D=n_devices // spatial, S=spatial, batch=n_devices // spatial, H=64 * spatial, W=32)
    raise ValueError(f"unknown dryrun phase {phase!r}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _nonnegative(metrics: Dict[str, torch.Tensor], key: str, phase: str) -> None:
    value = float(metrics[key])
    _require(math.isfinite(value) and value >= 0.0, f"dryrun {phase}: {key} = {value}")


def _zeros(layout: Dict[str, int], channels: int) -> torch.Tensor:
    return torch.zeros((layout["batch"], layout["H"], layout["W"], channels))


def _phase_rank(rank: int, device: torch.device, phase: str, n_devices: int) -> None:
    """One step of ``phase`` on this rank (``parallel.mesh.spawn``'s rank
    function)."""
    from floodgan_tpu_torch.parallel.mesh import make_mesh

    layout = phase_layout(phase, n_devices)
    mesh = make_mesh(n_devices, spatial=layout["S"], device=device)
    x = mesh.shard_images(_zeros(layout, 9)).to(device)
    y = mesh.shard_images(_zeros(layout, 3)).to(device)
    if phase in ("paired", "spatial"):
        from floodgan_tpu_torch.train.paired import PairedTrainer

        remat = dict(remat=True, remat_policy="boundaries") if phase == "spatial" else {}
        trainer = PairedTrainer("pairedattention", 9, mesh=mesh, seed=0, **remat)
        _nonnegative(trainer.train_step(x, y, 2e-4, step=1), "l1_losses_generator_synthetic", phase)
    elif phase == "cycle":
        from floodgan_tpu_torch.train.cycle import CycleTrainer

        trainer = CycleTrainer("cyclegan", 9, (layout["H"], layout["W"]), mesh=mesh, seed=2)
        _nonnegative(trainer.train_step(x, y, 2e-4, step=3), "losses_generator_post", phase)
    elif phase == "seg":
        from floodgan_tpu_torch.train.seg import SegTrainer

        rgb, mask = mesh.shard_images(_zeros(layout, 3)).to(device), mesh.shard_images(_zeros(layout, 1)).to(device)
        _nonnegative(SegTrainer(mesh=mesh, seed=4).train_step(rgb, mask, 1e-4), "accuracy", phase)
    else:
        from floodgan_tpu_torch.eval.metrics import MaskMetricsAccumulator, confusion_counts, image_pair_metrics
        from floodgan_tpu_torch.train.seg import SegTrainer

        imgm = image_pair_metrics((y + 1.0) * 0.5, torch.clamp(y * 0.5 + 0.5, 0, 1), with_ms_ssim=False)
        _require(all(v.shape == (y.shape[0],) for v in imgm.values()), f"dryrun eval: {imgm}")
        rgb, mask = mesh.shard_images(_zeros(layout, 3)).to(device), mesh.shard_images(_zeros(layout, 1)).to(device)
        counts = confusion_counts(SegTrainer(mesh=mesh, seed=4).predict_mask(rgb), mask)
        acc = MaskMetricsAccumulator()
        acc.add_counts(mesh.all_reduce_sum_(counts))
        pixels = layout["batch"] * layout["H"] * layout["W"]
        _require(int(acc.counts.sum()) == pixels, f"dryrun eval: counts {acc.counts} over {pixels} pixels")
        accuracy = acc.compute()["Accuracy"]
        _require(0.0 <= accuracy <= 1.0, f"dryrun eval: Accuracy = {accuracy}")


def _cards(n_devices: int, device_type: str, backend: str):
    """The card of each rank: one each under NCCL (None), round the cards
    under gloo."""
    if device_type != "cuda" or backend == "nccl":
        return None
    have = torch.cuda.device_count()
    return [r % have for r in range(n_devices)] if have else None


def dryrun_multichip(n_devices: int, device_type: str = "cuda", backend: Optional[str] = None,
                     timeout_s: float = 1800.0) -> Dict[str, float]:
    """Every phase of ``PHASES`` on ``n_devices`` ranks of ``device_type``
    over ``backend`` (None: NCCL on the card, gloo on the CPU), each phase
    in its own processes; returns each phase's wall seconds.  Raises when
    a rank fails, when a phase outlasts ``timeout_s``, and before any
    process starts when the ranks do not fit the cards."""
    from floodgan_tpu_torch.parallel import mesh

    backend = backend or mesh.backend_for(device_type)
    cards = _cards(n_devices, device_type, backend)
    mesh.check_devices(n_devices, device_type, backend=backend, devices=cards)
    seconds = {}
    for phase in PHASES:
        t0 = time.perf_counter()
        mesh.spawn(_phase_rank, n_devices, args=(phase, n_devices), device_type=device_type,
                   join_timeout_s=timeout_s, backend=backend, cards=cards)
        seconds[phase] = time.perf_counter() - t0
        print(f"dryrun: {phase} ok", flush=True)
    return seconds


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                   help="default: NCCL on the card, gloo on the CPU")
    args = p.parse_args(argv)
    seconds = dryrun_multichip(args.n_devices, args.device, args.backend)
    print("dryrun: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()), flush=True)
    return seconds


if __name__ == "__main__":
    main()
