"""Segmentation CLI of the port: the flags of floodgan_tpu/cli/segment.py
(reference segment.py:7-19 plus --batch_size, --metadata_dir,
--compute_dtype and --remat), plus --device.

    python -m floodgan_tpu_torch.cli.segment --train --dataset_subset=usa \\
        --data_path=DATA --num_epochs=2 --save_model_interval=1 --verbose

    python -m floodgan_tpu_torch.cli.segment --dataset_subset=usa \\
        --data_path=DATA --pretrained_model_path=seg.ckpt

``--train`` trains the U-Net on ``DATA/masks_input`` / ``masks_output`` and
writes ``.ckpt`` files to ``DATA/models/``.  Without it the CLI evaluates a
checkpoint: the loss figure and the sample masks (both need matplotlib;
without it they are skipped with one notice) and the metric CSV, or with
``--plot_mask_image`` one image's mask PNG.  It runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import importlib.util
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Training and evaluation for the flood-mask segmentation U-Net, on an NVIDIA card")
    parser.add_argument("--train", action="store_true", default=False, help="Run training; without this flag the CLI evaluates an existing checkpoint")
    parser.add_argument("--dataset_subset", required=True, help="Mask dataset slice: usa or india")
    parser.add_argument("--train_on_all", action="store_true", default=False, help="Train on every mask sample with no held-out splits (deployment runs)")
    parser.add_argument("--data_path", required=True, help="Root directory of the on-disk dataset (contains masks_input/, masks_output/, ...)")
    parser.add_argument("--num_epochs", type=int, default=1, help="Total number of training epochs")
    parser.add_argument("--save_model_interval", type=int, default=0, help="Checkpoint every N epochs (0 disables checkpointing)")
    parser.add_argument("--save_images_interval", type=int, default=0, help="Write a grid of sample masks every N epochs (0 disables; needs matplotlib)")
    parser.add_argument("--verbose", default=False, action="store_true", help="Log per-epoch losses and timings to stdout")
    parser.add_argument("--pretrained_model_path", default=None, help="Segmentation checkpoint to evaluate (required without --train); a .ckpt of either package, or a reference .pth.tar")
    parser.add_argument("--plot_mask_image", default=None, help="Run mask inference on one image file and save the thresholded result (reading the image needs matplotlib)")
    parser.add_argument("--seed", type=int, default=47, help="Seed for parameter initialisation")
    parser.add_argument("--use_test_data", action="store_true", default=False, help="Evaluate on the held-out test split rather than the validation split")
    parser.add_argument("--batch_size", type=int, default=1, help="Per-step batch size (the reference hardcodes 1)")
    parser.add_argument("--metadata_dir", default=None, help="Directory holding masks_metadata.csv (defaults to ./metadata like the reference)")
    parser.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"], help="Activation/flop dtype (f32 master params either way)")
    parser.add_argument("--remat", action="store_true", default=False, help="Rematerialise U-Net activations in the backward (not ported yet)")
    parser.add_argument("--device", default=None, help="Where to run: the card by default (cuda); 'cpu' runs the plain PyTorch path")
    return parser


def main(argv=None):
    """Train or evaluate as the flags say; returns the ``SegmentationModel``."""
    args = build_parser().parse_args(argv)

    if not args.train:
        if not args.pretrained_model_path:
            raise ValueError("Provide a saved model.")
        if not os.path.isfile(args.pretrained_model_path):
            raise FileNotFoundError("Saved model not found. Check the path to the model.")

    from floodgan_tpu_torch.api.segmentation import SegmentationModel

    model = SegmentationModel(**vars(args))

    if args.train:
        model.train_model()
    elif args.plot_mask_image:
        model.plot_mask_image(args.plot_mask_image)
    else:
        if importlib.util.find_spec("matplotlib") is None:
            print("matplotlib is not installed: skipping the loss figure and the sample masks")
        else:
            model.plot_loss()
            model.plot_sample_images(10, args.use_test_data)
        model.calculate_metrics(args.use_test_data)
    return model


if __name__ == "__main__":
    main()
