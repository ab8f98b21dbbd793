"""GAN training CLI of the port: the flag surface of floodgan_tpu/cli/train.py
(reference train.py:7-22 plus --batch_size, --num_data_devices,
--metadata_dir and the rest), with the same checks, plus --device.

    python -m floodgan_tpu_torch.cli.train --model=PairedAttention \\
        --dataset_subset=usa --dataset_dem=best --data_path=DATA \\
        --topography=all --resize=512 --batch_size=8 --compute_dtype=bfloat16 \\
        --num_epochs=3 --save_model_interval=1 --verbose

It trains any of the four families (Pix2Pix and PairedAttention with the
paired step, CycleGAN and AttentionGAN with the cycle step) on the card
unless ``--device cpu`` is given.

``--remat [--remat_policy P]`` recomputes the generator reads in the
backward.  ``--num_data_devices D --num_spatial_devices S`` trains on a
``D x S`` mesh of cards of this host: the batch is split over D stripes
and each image's height over S ranks (any family).
The command starts D x S processes, one per card, in one NCCL group over
localhost (gloo processes with ``--device cpu``), and fails as soon as one
of them does.  ``--dist_backend gloo`` on the card puts rank r on card r
modulo the card count instead, so that several ranks may share a card
(NCCL refuses two ranks on one), their collectives staged through the
host.  Started by torchrun (``WORLD_SIZE`` = D x S and ``RANK`` set), it
joins that group instead.  ``--batch_size`` is the global batch.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Adversarial training for the flood-prediction generators, on an NVIDIA card"
    )
    parser.add_argument("--model", required=True, help="Architecture to use: pix2pix, cyclegan, attentiongan, or pairedattention (case-insensitive)")
    parser.add_argument("--dataset_subset", required=True, help="Dataset slice to load: a country (usa, india), a disaster name, 'all', or one of the special splits (harveyflorence, harveyonflorence, testing)")
    parser.add_argument("--dataset_dem", required=True, help="DEM resolution policy: 'best' picks each tile's finest available DEM, 'same' uses a uniform resolution everywhere")
    parser.add_argument("--data_path", required=True, help="Root directory of the on-disk dataset (contains dataset_input/, dataset_output/, ...)")
    parser.add_argument("--num_epochs", type=int, default=1, help="Total number of training epochs")
    parser.add_argument("--topography", default=None, help="Extra input channels beyond RGB: all, dem, map, flow, or river (omit for RGB-only)")
    parser.add_argument("--resize", type=int, default=None, help="Bicubic-resize images to this size first (runs before any crop)")
    parser.add_argument("--crop", type=int, default=None, help="Tile each (possibly resized) image into this many equal quadrant crops, each treated as a separate sample")
    parser.add_argument("--save_model_interval", type=int, default=0, help="Checkpoint every N epochs (0 disables checkpointing)")
    parser.add_argument("--save_images_interval", type=int, default=0, help="Write a grid of sample generator outputs every N epochs (0 disables; needs matplotlib)")
    parser.add_argument("--verbose", default=False, action="store_true", help="Log per-epoch losses and timings to stdout")
    parser.add_argument("--load_pretrained_model", default=False, action="store_true", help="Resume training from an existing checkpoint (see --pretrained_model_path)")
    parser.add_argument("--pretrained_model_path", default=None, help="Checkpoint file to resume from (required with --load_pretrained_model); a .ckpt of either package, or a reference .pth.tar")
    parser.add_argument("--add_identity_loss", action="store_true", default=False, help="Include the 5x identity L1 term in the cycle objective (cycle models only)")
    parser.add_argument("--seed", type=int, default=47, help="Seed for parameter initialisation (per-epoch data order is keyed by the epoch number alone)")
    parser.add_argument("--batch_size", type=int, default=1, help="Per-step global batch size (the reference hardcodes 1)")
    parser.add_argument("--num_data_devices", type=int, default=1, help="Data-parallel mesh size (shards the batch over cards, one process per card)")
    parser.add_argument("--num_spatial_devices", type=int, default=1, help="Spatial mesh size (shards the image height axis over cards; total cards = data x spatial; every model)")
    parser.add_argument("--metadata_dir", default=None, help="Directory holding dataset_split.csv (defaults to ./metadata like the reference)")
    parser.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"], help="Activation/flop dtype (f32 master params either way)")
    parser.add_argument("--remat", action="store_true", default=False, help="Rematerialise generator activations (lets cycle models train at 512^2 with batch > 1 in 16GB HBM)")
    parser.add_argument("--remat_policy", default=None, choices=["convs", "boundaries", "full"], help="With --remat: what to save across the backward. Default = the trainer's measured default (paired: boundaries, cycle: convs). 'full' saves nothing (replays the whole forward) — the high-resolution/big-batch choice (1024^2 batch 8 on one 16GB chip)")
    parser.add_argument("--async_checkpoint", action="store_true", default=False, help="Write checkpoints on a background thread (training continues while the file lands)")
    parser.add_argument("--profile_dir", default=None, help="Write a torch.profiler Chrome trace of training into this directory")
    parser.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"], help="Process-group backend of a mesh: nccl on the card and gloo on the CPU by default; gloo on the card lets ranks share a card, with collectives staged through the host")
    parser.add_argument("--device", default=None, help="Where to train: the card by default (cuda); 'cpu' runs the kernels' plain PyTorch versions")
    return parser


def _train(args):
    from floodgan_tpu_torch.api import model as api_model
    from floodgan_tpu_torch.utils.profiling import trace

    args = argparse.Namespace(**vars(args))
    profile_dir = args.profile_dir
    del args.profile_dir, args.dist_backend
    args.training_model = True
    train_model = api_model.Model(**vars(args))
    with trace(profile_dir):
        if train_model.model_is_cycle:
            train_model.train_cycle()
        else:
            train_model.train_paired()
    return train_model


def _rank_train(rank: int, device, args) -> None:
    """One rank of the ``D x S`` mesh: the model on its own device."""
    args.device = str(device)
    _train(args)


def main(argv=None):
    """Train as the flags say; returns the trained ``Model`` (None when
    the training ran in N started processes)."""
    args = build_parser().parse_args(argv)
    args.model = args.model.lower()

    if args.load_pretrained_model:
        if not args.pretrained_model_path:
            raise ValueError("Provide a saved model.")
        if not os.path.exists(args.pretrained_model_path):  # a .ckpt file or a .sharded directory
            raise FileNotFoundError("Saved model not found. Check the path to the model.")

    world = args.num_data_devices * args.num_spatial_devices
    if world > 1:
        from floodgan_tpu_torch.parallel import mesh

        device_type = torch_device_type(args.device)
        backend = args.dist_backend
        device = mesh.join_environment(device_type, backend=backend)
        if device is not None:  # torchrun started this rank
            args.device = str(device)
            return _train(args)
        cards = None
        if backend == "gloo" and device_type == "cuda":
            import torch

            cards = [r % torch.cuda.device_count() for r in range(world)]
        mesh.spawn(_rank_train, world, args=(args,), device_type=device_type, backend=backend, cards=cards)
        return None
    return _train(args)


def torch_device_type(device) -> str:
    """The device type ``--device`` names: the card by default."""
    return "cuda" if device is None else device.split(":")[0]


if __name__ == "__main__":
    main()
