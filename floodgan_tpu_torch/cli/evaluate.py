"""GAN evaluation CLI of the port: the flags of floodgan_tpu/cli/evaluate.py
(reference evaluate.py:7-26 plus --metadata_dir and --lpips_weights), plus
--batch_size (1, the reference's, by default) and --device.

    python -m floodgan_tpu_torch.cli.evaluate --model=PairedAttention \\
        --dataset_subset=usa --dataset_dem=best --data_path=DATA \\
        --topography=all --resize=512 --pretrained_model_path=gan.ckpt \\
        --calculate_metrics --segmentation_model_path=seg.ckpt

It evaluates on the card unless ``--device cpu`` is given.  The metric CSV
goes to ``DATA/metrics/``; single-image PNGs to ``DATA/images/``.  Loss and
sample figures and ``--plot_image_set`` need matplotlib.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Plots and metrics for a trained flood-prediction generator checkpoint, on an NVIDIA card"
    )
    parser.add_argument("--model", required=True, help="Architecture to use: pix2pix, cyclegan, attentiongan, or pairedattention (case-insensitive)")
    parser.add_argument("--dataset_subset", default="all", help="Dataset slice to load: a country (usa, india), a disaster name, 'all', or one of the special splits (harveyflorence, harveyonflorence, testing)")
    parser.add_argument("--dataset_dem", required=True, help="DEM resolution policy: 'best' picks each tile's finest available DEM, 'same' uses a uniform resolution everywhere")
    parser.add_argument("--use_test_data", action="store_true", default=False, help="Evaluate on the held-out test split rather than the validation split")
    parser.add_argument("--data_path", required=True, help="Root directory of the on-disk dataset (contains dataset_input/, dataset_output/, ...)")
    parser.add_argument("--resize", type=int, default=None, help="Bicubic-resize images to this size first (runs before any crop)")
    parser.add_argument("--crop", type=int, default=None, help="Tile each (possibly resized) image into this many equal quadrant crops, each treated as a separate sample")
    parser.add_argument("--crop_index", type=int, default=0, help="Quadrant index to select when plotting a cropped image")
    parser.add_argument("--topography", default=None, help="Extra input channels beyond RGB: all, dem, map, flow, or river (omit for RGB-only)")
    parser.add_argument("--pretrained_model_path", required=True, help="Checkpoint file of the trained generator to evaluate")
    parser.add_argument("--plot_losses", action="store_true", default=False, help="Render the stored loss history to a figure (needs matplotlib)")
    parser.add_argument("--plot_sample_images", action="store_true", default=False, help="Render sample input/ground-truth/output grids from the train and eval splits (needs matplotlib)")
    parser.add_argument("--num_images", type=int, default=5, help="How many samples to include in the sample-image grids")
    parser.add_argument("--seed", type=int, default=47, help="Seed for the stochastic-eval generator passes")
    parser.add_argument("--image_name", default=None, help="Dataset image name to run through the generator")
    parser.add_argument("--plot_single_image", default=None, help="Save one panel only: input, ground truth, output, or attention mask")
    parser.add_argument("--plot_image_set", action="store_true", default=False, help="Save the full panel set (input / ground truth / output, plus attention mask for attention models; needs matplotlib)")
    parser.add_argument("--calculate_metrics", action="store_true", default=False, help="Compute the image + flood-mask metric suite and write it to CSV")
    parser.add_argument("--segmentation_model_path", default=None, help="U-Net segmentation checkpoint used to derive flood masks for the mask metrics")
    parser.add_argument("--metadata_dir", default=None, help="Directory holding dataset_split.csv (defaults to ./metadata like the reference)")
    parser.add_argument("--lpips_weights", default=None, help="Path to LPIPS weights npz (the JAX package's layout)")
    parser.add_argument("--batch_size", type=int, default=1, help="Images per generator call in --calculate_metrics (1 as in the reference; the Inference column is per image either way)")
    parser.add_argument("--device", default=None, help="Where to evaluate: the card by default (cuda); 'cpu' runs the kernels' plain PyTorch versions")
    return parser


def main(argv=None):
    """Evaluate as the flags say; returns the ``Model``."""
    args = build_parser().parse_args(argv)
    args.model = args.model.lower()

    if not os.path.isfile(args.pretrained_model_path):
        raise FileNotFoundError("Saved model not found. Check the path to the model.")

    from floodgan_tpu_torch.api import model as api_model

    evaluate_model = api_model.Model(
        model=args.model,
        dataset_subset=args.dataset_subset,
        dataset_dem=args.dataset_dem,
        data_path=args.data_path,
        resize=args.resize,
        crop=args.crop,
        load_pretrained_model=True,
        pretrained_model_path=args.pretrained_model_path,
        training_model=False,
        seed=args.seed,
        topography=args.topography,
        verbose=True,
        metadata_dir=args.metadata_dir,
        lpips_weights=args.lpips_weights,
        batch_size=args.batch_size,
        device=args.device,
    )

    if args.plot_losses:
        evaluate_model.plot_losses()

    if args.plot_sample_images:
        evaluate_model.plot_sample_images(args.num_images, args.use_test_data)

    if args.plot_single_image or args.plot_image_set:
        if not args.image_name:
            raise FileNotFoundError("Please specify an image to plot")
        evaluate_model.plot_image(
            image_name=args.image_name,
            plot_single_image=args.plot_single_image,
            plot_image_set=args.plot_image_set,
            crop_index=args.crop_index,
        )

    if args.calculate_metrics:
        if not args.segmentation_model_path:
            raise ValueError("To calculate metrics, a pre-trained flood segmentation model must be provided.")
        evaluate_model.calculate_metrics(
            use_test_data=args.use_test_data, seg_model_path=args.segmentation_model_path
        )
    return evaluate_model


if __name__ == "__main__":
    main()
