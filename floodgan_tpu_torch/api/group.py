"""Side-by-side comparison of several trained generators: ``ModelsGroup``,
the port of floodgan_tpu/api/group.py (the reference's models/group.py).

Each checkpoint loads into its own ``api.model.Model`` (the architecture
comes from the file), on the card unless ``device="cpu"``.
``compare_metrics`` scores every model on the same split and writes two
CSVs in pandas' layout: the averaged table (one row per model, index
``Model``) and the per-disaster table (rows ``<metric>_<model>``, sorted,
one column per disaster, the disaster being an image name's prefix before
its first ``_``).  ``compare_output_images`` draws input | ground truth |
each model's output (matplotlib, imported there).

Three modes, as the CLI names them: ``models`` (the four families),
``topography`` (six ablations, each fed its channel slice of the full
9-channel stack) and ``two`` (any pair).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from floodgan_tpu_torch.api import paths as pathlib_
from floodgan_tpu_torch.api.model import Model, to_display_image
from floodgan_tpu_torch.core.device import resolve_device
from floodgan_tpu_torch.data.pipeline import create_flood_dataset
from floodgan_tpu_torch.data.transforms import denormalize, slice_topography
from floodgan_tpu_torch.eval.metrics import MASK_METRICS, MS_SSIM_MIN_SIDE, MaskMetricsAccumulator
from floodgan_tpu_torch.utils.tables import print_rows, write_indexed_csv, write_records_csv

# Display name -> topography key of the ablation comparison
# (floodgan_tpu/api/group.py:30-37).
DISPLAY_TOPOGRAPHY = {
    "All": "all",
    "DEM": "dem",
    "Flow accumulation": "flow",
    "Distance to rivers": "river",
    "Map": "map",
    "None": None,
}
IMAGE_METRICS = ("PSNR", "SSIM", "MS-SSIM", "LPIPS")
WARMUP_TIMINGS = 5  # the first model's first timings dropped (reference group.py:198-200)


class ModelsGroup:
    def __init__(
        self,
        paths: Dict[str, str],
        compare: str,
        dataset_subset: str,
        dataset_dem: str,
        data_path: str,
        resize: Optional[int],
        crop: Optional[int],
        crop_index: int,
        topography: Optional[str],
        metadata_dir: Optional[str] = None,
        lpips_weights: Optional[str] = None,
        device=None,
    ):
        self.device = resolve_device(device, "ModelsGroup")
        self.paths = paths
        self.compare = compare
        self.dataset_subset = dataset_subset
        self.dataset_dem = dataset_dem
        self.data_path = data_path
        self.resize = resize
        self.crop = crop
        self.crop_index = crop_index
        self.topography = topography
        self.metadata_dir = metadata_dir
        self.lpips_weights = lpips_weights
        self.models: Dict[str, Model] = {}

        for model_name, path in self.paths.items():
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"Saved {model_name} model not found. Check the path to the {model_name} model."
                )
            model_topography = DISPLAY_TOPOGRAPHY[model_name] if compare == "topography" else topography
            self.models[model_name] = Model(
                dataset_subset=dataset_subset, dataset_dem=dataset_dem, data_path=data_path,
                resize=resize, crop=crop, load_pretrained_model=True, pretrained_model_path=path,
                training_model=False, topography=model_topography, verbose=True,
                metadata_dir=metadata_dir, lpips_weights=lpips_weights, device=self.device,
            )

        overall_topography = "all" if compare == "topography" else topography
        self.train_loader, self.val_loader, self.test_loader = create_flood_dataset(
            dataset_subset, dataset_dem, data_path, overall_topography, resize, crop,
            metadata_dir=metadata_dir, device=self.device,
        )

    # ------------------------------------------------------------- helpers

    def extract_input_topography(self, input_image) -> Dict[str, torch.Tensor]:
        """Each ablation's channel slice of the full 9-channel NHWC stack."""
        return {name: slice_topography(input_image, key) for name, key in DISPLAY_TOPOGRAPHY.items()}

    def create_path(self, save_type: str, info: str = "") -> str:
        topography = "different" if self.compare == "topography" else self.topography
        return pathlib_.group_artifact_path(
            self.data_path, save_type, self.compare, info, topography,
            self.dataset_subset, self.dataset_dem, self.resize, self.crop,
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- metrics

    def compare_metrics(self, use_test_data: bool, seg_model_path: str):
        """(floodgan_tpu/api/group.py:124-249)  Returns the averaged table
        as {model: {metric: value}}."""
        from floodgan_tpu_torch.api.segmentation import SegmentationModel

        seg = SegmentationModel(data_path=self.data_path, pretrained_model_path=seg_model_path, train=False,
                                metadata_dir=self.metadata_dir, skip_data=True, device=self.device)
        lpips = next(iter(self.models.values())).lpips
        metrics = seg.trainer.eval_batch_metrics

        per_image = {k: defaultdict(list) for k in IMAGE_METRICS + ("Inference",)}
        mask_acc = defaultdict(MaskMetricsAccumulator)
        mask_acc_grouped = defaultdict(MaskMetricsAccumulator)
        image_names: List[str] = []

        print("\nCalculating metrics...")
        loader = self.test_loader if use_test_data else self.val_loader
        for batch in loader.epoch_iter(epoch=0):
            x, y = batch["input"], batch["output"]
            image_names.extend(batch["names"])
            disasters = [n.split("_")[0] for n in batch["names"]]
            inputs = self.extract_input_topography(x) if self.compare == "topography" else None
            # The truth side's mask is the same for every model: one U-Net
            # forward a batch, finished before the first model's timed call.
            true_mask = metrics.true_mask(y)
            self._sync()

            for name, model in self.models.items():
                xin = inputs[name] if inputs is not None else x
                start = time.time()
                out, _ = model.generate(xin)
                self._sync()
                inference_time = time.time() - start

                n = out.shape[0]
                ms_ok = min(out.shape[1], out.shape[2]) >= MS_SSIM_MIN_SIDE
                imgm, counts = metrics.with_true_mask(out, y, true_mask, with_ms_ssim=ms_ok)
                per_image["PSNR"][name].extend(imgm["PSNR"].cpu().tolist())
                per_image["SSIM"][name].extend(imgm["SSIM"].cpu().tolist())
                per_image["MS-SSIM"][name].extend(imgm["MS-SSIM"].cpu().tolist() if ms_ok else [float("nan")] * n)
                if lpips is not None:
                    per_image["LPIPS"][name].extend(lpips(denormalize(out), denormalize(y)).cpu().tolist())
                else:
                    per_image["LPIPS"][name].extend([float("nan")] * n)
                # Per-image time: the batch's call divided over its images.
                per_image["Inference"][name].extend([inference_time / n] * n)
                counts = counts.cpu()
                mask_acc[name].add_counts(counts)
                for b, disaster in enumerate(disasters):
                    mask_acc_grouped[f"{name}_{disaster}"].add_counts(counts[b])

        first = next(iter(self.models))
        per_image["Inference"][first] = per_image["Inference"][first][WARMUP_TIMINGS:]

        rows = {}
        for name in self.models:
            row = {k: float(np.mean(v[name])) for k, v in per_image.items()}
            row.update({k: mask_acc[name].compute()[k] for k in MASK_METRICS})
            rows[name] = row
        print_rows(rows, "Model")
        write_indexed_csv(self.create_path("metric"), rows, "Model")

        # The per-disaster table (floodgan_tpu/api/group.py:230-248).
        disaster_of = np.array([n.split("_")[0] for n in image_names])
        disaster_names = sorted(set(disaster_of.tolist()))
        grouped = []
        for metric in IMAGE_METRICS:
            for name in self.models:
                vals = np.asarray(per_image[metric][name], np.float64)
                grouped.append({"Metric_Model": f"{metric}_{name}",
                                **{d: _nanmean(vals[disaster_of == d]) for d in disaster_names}})
        for name in self.models:
            for metric in MASK_METRICS:
                row = {"Metric_Model": f"{metric}_{name}"}
                for d in disaster_names:
                    acc = mask_acc_grouped.get(f"{name}_{d}")
                    row[d] = acc.compute()[metric] if acc else float("nan")
                grouped.append(row)
        grouped.sort(key=lambda r: r["Metric_Model"])
        write_records_csv(self.create_path("metric", info="grouped"), grouped)
        return rows

    # --------------------------------------------------------------- plots

    def compare_output_images(self, image_names: List[str]) -> None:
        """(floodgan_tpu/api/group.py:253-304)  A grid of input | ground
        truth | each model's output, one row per image; a name ending in
        ``_<n>`` picks crop quadrant n."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        n_rows, n_cols = len(image_names), len(self.models) + 2
        fig, axes = plt.subplots(nrows=n_rows, ncols=n_cols, figsize=(n_cols * 5, n_rows * 5 + 0.5 * n_rows))
        axes = np.atleast_2d(axes)
        for ax in axes.ravel():
            ax.set_axis_off()

        any_model = next(iter(self.models.values()))
        for i, image_name in enumerate(image_names):
            if len(image_name) > 1 and image_name[-2] == "_":
                crop_index, image_name = int(image_name[-1]), image_name[:-2]
            else:
                crop_index = self.crop_index
            # Loaded through a model of the full stack, so each ablation
            # can take its slice.
            loader_model = self.models.get("All", any_model) if self.compare == "topography" else any_model
            x, y, display_name = loader_model._load_named_image(image_name, crop_index)
            inputs = self.extract_input_topography(x) if self.compare == "topography" else None
            axes[i, 0].imshow(to_display_image(x), vmin=0, vmax=1)
            axes[i, 0].set_title(f"Input ({display_name})")
            axes[i, 1].imshow(to_display_image(y), vmin=0, vmax=1)
            axes[i, 1].set_title("Ground truth")
            for j, (name, model) in enumerate(self.models.items(), start=2):
                out, _ = model.generate(inputs[name] if inputs is not None else x)
                axes[i, j].imshow(to_display_image(out), vmin=0, vmax=1)
                axes[i, j].set_title(name)

        fig.tight_layout()
        images_path = self.create_path(save_type="image", info=image_names[0] if len(image_names) == 1 else "")
        print(f"\nSaving comparison of {self.compare} images to {images_path}")
        fig.savefig(images_path, bbox_inches="tight")
        plt.close(fig)


def _nanmean(v: np.ndarray) -> float:
    """pandas' groupby mean: the mean of the values that are not NaN, NaN
    where there is none."""
    v = v[~np.isnan(v)]
    return float(v.mean()) if v.size else float("nan")
