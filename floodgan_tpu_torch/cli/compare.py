"""Comparison CLI of the port: the flags of floodgan_tpu/cli/compare.py
(reference compare.py:5-35 plus --metadata_dir and --lpips_weights), plus
--device.

    python -m floodgan_tpu_torch.cli.compare --compare=models \\
        --dataset_subset=usa --dataset_dem=best --data_path=DATA \\
        --topography=all --resize=512 --pix2pix_path=p.ckpt \\
        --cyclegan_path=c.ckpt --attentiongan_path=a.ckpt \\
        --pairedattention_path=pa.ckpt --calculate_metrics \\
        --segmentation_model_path=seg.ckpt

``--compare models`` takes the four families' checkpoints, ``topography``
the six ablations', ``two`` any pair.  ``--calculate_metrics`` writes the
averaged and the per-disaster metric CSVs to ``DATA/metrics/``;
``--image_names`` draws the comparison grid (needs matplotlib).  It runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Side-by-side outputs and metric tables for several trained generator checkpoints, on an NVIDIA card"
    )
    parser.add_argument("--dataset_subset", required=True, help="Dataset slice the compared models were trained on")
    parser.add_argument("--dataset_dem", required=True, help="DEM resolution policy: 'best' picks each tile's finest available DEM, 'same' uses a uniform resolution everywhere")
    parser.add_argument("--use_test_data", action="store_true", default=False, help="Evaluate on the held-out test split rather than the validation split")
    parser.add_argument("--data_path", required=True, help="Root directory of the on-disk dataset (contains dataset_input/, dataset_output/, ...)")
    parser.add_argument("--resize", type=int, default=None, help="Bicubic-resize images to this size first (runs before any crop)")
    parser.add_argument("--crop", type=int, default=None, help="Tile each (possibly resized) image into this many equal quadrant crops, each treated as a separate sample")
    parser.add_argument("--crop_index", type=int, default=0, help="Quadrant index to select when plotting a cropped image")
    parser.add_argument("--topography", default=None, help="Extra input channels beyond RGB: all, dem, map, flow, or river (omit for RGB-only)")

    parser.add_argument("--segmentation_model_path", default=None, help="U-Net segmentation checkpoint used to derive flood masks for the mask metrics")

    parser.add_argument("--pix2pix_path", default=None, help="Pix2Pix checkpoint (--compare models)")
    parser.add_argument("--cyclegan_path", default=None, help="CycleGAN checkpoint (--compare models)")
    parser.add_argument("--attentiongan_path", default=None, help="AttentionGAN checkpoint (--compare models)")
    parser.add_argument("--pairedattention_path", default=None, help="PairedAttention checkpoint (--compare models)")

    parser.add_argument("--all_topography_path", default=None, help="Checkpoint of the all-topography ablation (--compare topography)")
    parser.add_argument("--none_topography_path", default=None, help="Checkpoint of the RGB-only ablation (--compare topography)")
    parser.add_argument("--dem_topography_path", default=None, help="Checkpoint of the DEM-only ablation (--compare topography)")
    parser.add_argument("--river_topography_path", default=None, help="Checkpoint of the river-distance-only ablation (--compare topography)")
    parser.add_argument("--flow_topography_path", default=None, help="Checkpoint of the flow-accumulation-only ablation (--compare topography)")
    parser.add_argument("--map_topography_path", default=None, help="Checkpoint of the map-only ablation (--compare topography)")

    parser.add_argument("--model_1_path", default=None, help="First checkpoint (--compare two)")
    parser.add_argument("--model_2_path", default=None, help="Second checkpoint (--compare two)")

    parser.add_argument("--compare", required=True, help="Comparison mode: models (4 architectures), topography (6 ablations), or two (any pair)")
    parser.add_argument(
        "--image_names", default=None, nargs="+",
        help="Dataset image names to render side by side; append '_<n>' to an "
        "image name to pick crop quadrant n",
    )
    parser.add_argument("--calculate_metrics", action="store_true", default=False, help="Compute the metric suite for every model, averaged and grouped by disaster, and write CSVs")
    parser.add_argument("--metadata_dir", default=None, help="Directory holding dataset_split.csv (defaults to ./metadata like the reference)")
    parser.add_argument("--lpips_weights", default=None, help="Path to LPIPS weights npz (exported from torchvision's AlexNet and the LPIPS heads)")
    parser.add_argument("--device", default=None, help="Where to run: the card by default (cuda); 'cpu' runs the kernels' plain PyTorch versions")
    return parser


def main(argv=None):
    """Compare as the flags say; returns the ``ModelsGroup``."""
    args = build_parser().parse_args(argv)

    if args.compare == "models":
        if not (args.pix2pix_path and args.cyclegan_path and args.attentiongan_path and args.pairedattention_path):
            raise ValueError("Paths to Pix2Pix, CycleGAN, AttentionGAN and PairedAttention models must be provided.")
        paths = {
            "PairedAttention": args.pairedattention_path,
            "Pix2Pix": args.pix2pix_path,
            "AttentionGAN": args.attentiongan_path,
            "CycleGAN": args.cyclegan_path,
        }
    elif args.compare == "topography":
        if not (args.all_topography_path and args.none_topography_path and args.dem_topography_path
                and args.river_topography_path and args.flow_topography_path and args.map_topography_path):
            raise ValueError("Paths to all, none, DEM, river distance, flow accumulation and map topography models must be provided.")
        paths = {
            "All": args.all_topography_path,
            "DEM": args.dem_topography_path,
            "Flow accumulation": args.flow_topography_path,
            "Distance to rivers": args.river_topography_path,
            "Map": args.map_topography_path,
            "None": args.none_topography_path,
        }
    elif args.compare == "two":
        if not (args.model_1_path and args.model_2_path):
            raise ValueError("Paths to both models must be provided.")
        paths = {"Model 1": args.model_1_path, "Model 2": args.model_2_path}
    else:
        raise NotImplementedError("Comparisons must be made between 'models' 'topography' or 'two'")

    from floodgan_tpu_torch.api.group import ModelsGroup

    all_models = ModelsGroup(
        paths=paths,
        compare=args.compare,
        dataset_subset=args.dataset_subset,
        dataset_dem=args.dataset_dem,
        data_path=args.data_path,
        resize=args.resize,
        crop=args.crop,
        crop_index=args.crop_index,
        topography=args.topography,
        metadata_dir=args.metadata_dir,
        lpips_weights=args.lpips_weights,
        device=args.device,
    )

    if args.calculate_metrics:
        if not args.segmentation_model_path:
            raise ValueError("To calculate metrics, a pre-trained flood segmentation model must be provided.")
        all_models.compare_metrics(args.use_test_data, args.segmentation_model_path)

    if args.image_names:
        all_models.compare_output_images(args.image_names)
    return all_models


if __name__ == "__main__":
    main()
