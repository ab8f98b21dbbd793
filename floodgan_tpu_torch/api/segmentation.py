"""The flood-segmentation model of the port: ``SegmentationModel``.

The port of floodgan_tpu/api/segmentation.py:26-283 (the reference's
models/segmentation_model.py): the U-Net trainer and evaluator on the card
(``device=None``) or wherever the caller asks, with BCE training and pixel
accuracy, the mask metric suite over the pixel concatenation of a split,
resume from a ``.ckpt`` of either package (a reference ``.pth.tar``
migrates on load), and the mask and loss plots.  The metric CSV is written
with ``csv`` in pandas' layout; the mask PNG of ``plot_mask_image`` goes
through ``utils/png.py``; the figures need matplotlib, imported inside the
plot functions.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from floodgan_tpu_torch.api import paths as pathlib_
from floodgan_tpu_torch.ckpt import load_checkpoint, save_checkpoint
from floodgan_tpu_torch.ckpt.migrate import maybe_migrate
from floodgan_tpu_torch.core.config import TrainConfig, lambda_rule
from floodgan_tpu_torch.core.device import resolve_device
from floodgan_tpu_torch.data.pipeline import create_masks_dataset
from floodgan_tpu_torch.eval.metrics import MASK_METRICS, MaskMetricsAccumulator, confusion_counts_per_image
from floodgan_tpu_torch.train.seg import SegTrainer
from floodgan_tpu_torch.utils.jax_params import load_seg_state, seg_state_to_jax
from floodgan_tpu_torch.utils.png import imsave_gray
from floodgan_tpu_torch.utils.tables import print_table, write_metric_csv


class SegmentationModel:
    def __init__(
        self,
        dataset_subset: str = "usa",
        data_path: Optional[str] = None,
        num_epochs: int = 100,
        train_on_all: bool = False,
        save_model_interval: int = 0,
        save_images_interval: int = 0,
        verbose: bool = True,
        pretrained_model_path: Optional[str] = None,
        train: bool = False,
        plot_mask_image: Optional[str] = None,
        use_test_data: bool = False,
        seed: int = 47,
        batch_size: int = 1,
        metadata_dir: Optional[str] = None,
        compute_dtype: str = "float32",
        remat: bool = False,
        train_cfg: TrainConfig = TrainConfig(),
        skip_data: bool = False,
        device=None,
    ):
        if verbose:
            print("\nSetting up the flood segmentation model...")
        self.device = resolve_device(device, "SegmentationModel")
        self.num_epochs = num_epochs
        self.verbose = verbose
        self.save_model_interval = save_model_interval
        self.save_images_interval = save_images_interval
        self.data_path = data_path
        self.dataset_subset = dataset_subset
        self.train_on_all = train_on_all
        self.train = train
        self.pretrained_model_path = pretrained_model_path
        self.seed = seed
        self.batch_size = batch_size
        self.metadata_dir = metadata_dir
        self.train_cfg = train_cfg
        self.starting_epoch = 1
        self.current_epoch = 1
        self.all_losses: List[float] = []
        self.all_accuracies: List[float] = []

        self.trainer = SegTrainer(cfg=train_cfg, compute_dtype=compute_dtype, remat=remat,
                                  device=self.device, seed=seed)
        if self.pretrained_model_path:
            self.pretrained_model_path = maybe_migrate(self.pretrained_model_path, "seg")
            meta, raw = load_checkpoint(self.pretrained_model_path)
            self.current_epoch = meta["current_epoch"]
            self.num_epochs = meta["num_epochs"]
            self.all_losses = list(meta["all_losses"])
            self.all_accuracies = list(meta["all_accuracies"])
            load_seg_state(self.trainer, raw)

        if skip_data:
            self.train_loader = self.val_loader = self.test_loader = None
        else:
            self.train_loader, self.val_loader, self.test_loader = create_masks_dataset(
                dataset_subset=self.dataset_subset, path=self.data_path, train_on_all=self.train_on_all,
                batch_size=self.batch_size, metadata_dir=self.metadata_dir, device=self.device,
            )

    # ------------------------------------------------------------- helpers

    def create_path(self, save_type: str) -> str:
        return pathlib_.seg_artifact_path(
            self.data_path, save_type, self.current_epoch if self.train else self.current_epoch - 1,
            self.dataset_subset,
        )

    def predict_logits(self, image) -> torch.Tensor:
        return self.trainer.predict_logits(image)

    def predict_mask(self, image) -> torch.Tensor:
        """sigmoid > 0.5 float mask, NHWC (reference :244-248)."""
        return self.trainer.predict_mask(image)

    def tensor_to_mask(self, tensor, predicted: bool = True) -> torch.Tensor:
        if predicted:
            return (torch.sigmoid(tensor) > 0.5).float()
        return (tensor > 0.5).float()

    # ------------------------------------------------------------ training

    def train_model(self) -> None:
        """(reference models/segmentation_model.py:250-277)  Each epoch's
        losses stay on the device until its end."""
        for epoch in range(self.starting_epoch, self.num_epochs + 1):
            epoch_start_time = time.time()
            lr = self.train_cfg.seg_lr * lambda_rule(epoch - 1, self.num_epochs)
            steps = [self.trainer.train_step(b["input"], b["output"], lr)
                     for b in self.train_loader.epoch_iter(epoch)]
            host = torch.stack([torch.stack([m["loss"], m["accuracy"]]) for m in steps]).cpu().numpy()
            self.save_results(epoch, host[:, 0].tolist(), host[:, 1].tolist(), epoch_start_time)

    def save_results(self, epoch, losses, accuracies, epoch_start_time) -> None:
        """(reference :107-134)"""
        self.current_epoch = epoch
        self.all_losses.append(float(np.mean(losses)))
        self.all_accuracies.append(float(np.mean(accuracies)))
        if self.verbose:
            print(f"Epoch {epoch} ({time.time() - epoch_start_time:.2f} seconds) | "
                  f"Loss = {self.all_losses[-1]:.2f} | Accuracy = {self.all_accuracies[-1]:.2f}")
        if self.save_model_interval != 0 and epoch % self.save_model_interval == 0:
            self.save_checkpoint(epoch)
        if self.save_images_interval != 0 and epoch % self.save_images_interval == 0:
            self.plot_sample_images(num_images=10, use_test_data=False)
            self.plot_loss()

    def save_checkpoint(self, epoch: int) -> str:
        meta = {
            "current_epoch": epoch + 1,
            "num_epochs": self.num_epochs,
            "all_losses": self.all_losses,
            "all_accuracies": self.all_accuracies,
        }
        model_path = self.create_path(save_type="model")
        print(f"Saving flood segmentation model to {model_path}")
        save_checkpoint(model_path, meta, seg_state_to_jax(self.trainer))
        return model_path

    # ------------------------------------------------------------- metrics

    def calculate_metrics(self, use_test_data: bool = False):
        """(reference :136-177)  Metrics over the pixel concatenation of the
        split: one U-Net forward and the confusion counts per batch."""
        loader = self.test_loader if use_test_data else self.val_loader
        acc = MaskMetricsAccumulator()
        print("\nCalculating metrics...")
        for batch in loader.epoch_iter(epoch=0):
            pred = self.trainer.predict_mask(batch["input"])
            acc.add_counts(confusion_counts_per_image(pred, self.tensor_to_mask(batch["output"], predicted=False)))
        results = acc.compute()
        row = {k: results[k] for k in MASK_METRICS}
        print_table(row)
        write_metric_csv(self.create_path("metric"), row)
        return results

    # --------------------------------------------------------------- plots

    def plot_loss(self) -> None:
        """(reference :179-194)"""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(nrows=1, ncols=1, figsize=(10, 7))
        ax.tick_params(axis="both", which="major", labelsize=14)
        ax.set_xlabel("Epoch", fontsize=14)
        ax.set_ylabel("Loss", fontsize=14)
        ax.set_title("Training loss", fontsize=15)
        ax.plot(range(1, len(self.all_losses) + 1), self.all_losses, c="black", linewidth=2)
        losses_path = self.create_path(save_type="figure")
        print(f"Saving losses figure to {losses_path}")
        fig.savefig(losses_path, bbox_inches="tight")
        plt.close(fig)

    def plot_mask_image(self, path_to_image: str) -> None:
        """(reference :196-207)  An image file -> its binary mask PNG.  The
        image is read with matplotlib's ``imread``; the mask is written
        through ``utils/png.py``."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        image_name = path_to_image.split("/")[-1][:-4]
        img = plt.imread(path_to_image)[:, :, :3].astype(np.float32)[None]
        mask = self.predict_mask(img)[0, :, :, 0].cpu().numpy()
        out = pathlib_.ensure_parent(
            f"{self.data_path}/images/SegmentationMask_{image_name}_{pathlib_.timestamp()}.png"
        )
        print(f"\nSaving segmentation mask for '{image_name}' to {out}")
        imsave_gray(out, mask)

    def plot_sample_images(self, num_images: int, use_test_data: bool = False) -> None:
        """(reference :209-242)"""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        loader = self.test_loader if use_test_data else self.val_loader
        fig, axes = plt.subplots(nrows=num_images, ncols=3, figsize=(15, num_images * 5))
        axes = np.atleast_2d(axes)
        for ax in axes.ravel():
            ax.set_axis_off()
        plotted = 0
        for batch in loader.epoch_iter(epoch=self.seed):
            for b in range(batch["input"].shape[0]):
                img = np.clip(batch["input"][b].cpu().numpy(), 0, 1)
                true_mask = self.tensor_to_mask(batch["output"][b:b + 1], predicted=False)[0, :, :, 0].cpu().numpy()
                pred_mask = self.predict_mask(batch["input"][b:b + 1])[0, :, :, 0].cpu().numpy()
                axes[plotted, 0].imshow(img, vmin=0, vmax=1)
                axes[plotted, 1].imshow(true_mask, vmin=0, vmax=1, cmap="gray")
                axes[plotted, 2].imshow(pred_mask, vmin=0, vmax=1, cmap="gray")
                axes[plotted, 0].set_title(f"Input ({batch['names'][b]})")
                axes[plotted, 1].set_title("Ground Truth Mask")
                axes[plotted, 2].set_title("Predicted Mask")
                plotted += 1
                if plotted >= num_images:
                    break
            if plotted >= num_images:
                break
        fig.tight_layout()
        images_path = self.create_path("image")
        print("Saving sample images to", images_path)
        fig.savefig(images_path, bbox_inches="tight")
        plt.close(fig)
