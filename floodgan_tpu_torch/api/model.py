"""The GAN train object of the port: ``Model``, for all four families.

The port of floodgan_tpu/api/model.py:107-518, on the card
(``device=None``) or wherever the caller asks.  Pix2Pix and PairedAttention
train with ``train.paired.PairedTrainer``, CycleGAN and AttentionGAN with
``train.cycle.CycleTrainer``.  What it keeps:
- self-describing checkpoints: resuming reads model, num_epochs,
  topography and the identity-loss flag from the file, and the state is
  the JAX ``PairedState`` or ``CycleState`` tree, so either package resumes
  the other's ``.ckpt`` (and reference ``.pth.tar`` files migrate on load);
- the per-step draws (Pix2Pix's dropout masks, the replay buffers'
  choices) of step ``s`` of epoch ``e`` depend on (e, s) alone, as the JAX
  package's ``fold_in(epoch_key(e), s)``, so a resumed run draws what an
  unbroken run draws; ``generate`` draws Pix2Pix's dropout from the fixed
  seed-47 inference stream;
- the per-epoch data order of the loader, the LambdaLR schedule applied
  per epoch, the loss schema and per-epoch means in ``all_losses``, the
  verbose print format, and the metadata-encoded artifact names;
- a SIGTERM during training becomes a ``KeyboardInterrupt`` that writes a
  resume checkpoint first.

Losses stay on the device within an epoch, with one transfer at its end.
``epoch_stats`` records, per epoch, its wall time, the seconds the loop
spent blocked in the loader's ``next()``, the samples, and the loader's
stage seconds and post-transform cache hits.

Evaluation (floodgan_tpu/api/model.py:522-761): ``calculate_metrics``
scores a split per image (PSNR, SSIM, MS-SSIM, LPIPS, the generator's time
per image) and over the split's pixels (the flood-mask metrics of a
segmentation U-Net), and writes the metric CSV in pandas' layout;
``plot_image`` renders one named image of the dataset.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP.md
Queue 1 item: multi-device meshes (12) and ``remat`` (1).
"""

from __future__ import annotations

import csv
import importlib.util
import os
import signal
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from floodgan_tpu_torch.api import paths as pathlib_
from floodgan_tpu_torch.ckpt import AsyncCheckpointer, load_checkpoint, save_checkpoint
from floodgan_tpu_torch.ckpt.migrate import maybe_migrate
from floodgan_tpu_torch.core.config import (
    TOPOGRAPHY_CHANNELS,
    TrainConfig,
    _check_model,
    lambda_rule,
    model_is_attention,
    model_is_cycle,
    prettify_model_name,
)
from floodgan_tpu_torch.core.device import full_f32, resolve_device
from floodgan_tpu_torch.data.pipeline import create_flood_dataset
from floodgan_tpu_torch.data.transforms import apply_transformations_batch, denormalize
from floodgan_tpu_torch.eval.lpips import load_lpips
from floodgan_tpu_torch.eval.metrics import MASK_METRICS, MS_SSIM_MIN_SIDE, MaskMetricsAccumulator
from floodgan_tpu_torch.train.cycle import CycleTrainer
from floodgan_tpu_torch.train.paired import PairedTrainer
from floodgan_tpu_torch.utils.jax_params import (
    cycle_state_to_jax,
    load_cycle_state,
    load_paired_state,
    paired_state_to_jax,
)
from floodgan_tpu_torch.utils.png import imsave_gray, imsave_rgb
from floodgan_tpu_torch.utils.tables import print_table, write_metric_csv

# The metric CSV's columns (floodgan_tpu/api/model.py:614-619).
METRIC_COLUMNS = ("PSNR", "SSIM", "MS-SSIM", "LPIPS", *MASK_METRICS, "Inference")

# The per-step loss keys of each family (floodgan_tpu/api/model.py:291-314).
PAIRED_LOSS_KEYS = (
    "losses_discriminator_real",
    "losses_discriminator_synthetic",
    "losses_generator_synthetic",
    "l1_losses_generator_synthetic",
)
CYCLE_LOSS_KEYS = (
    "losses_generator_post",
    "losses_generator_pre",
    "losses_pre_to_post_cycle",
    "losses_post_to_pre_cycle",
    "losses_discriminator_pre_real",
    "losses_discriminator_post_real",
    "losses_discriminator_pre_synthetic",
    "losses_discriminator_post_synthetic",
)
IDENTITY_LOSS_KEYS = ("losses_identity_post", "losses_identity_pre")


def loss_keys(model: str, add_identity_loss: bool = False) -> tuple:
    """The keys of the losses one train step of ``model`` returns."""
    if not model_is_cycle(model):
        return PAIRED_LOSS_KEYS
    return CYCLE_LOSS_KEYS + (IDENTITY_LOSS_KEYS if add_identity_loss else ())


def _safe_print(msg: str) -> None:
    """print that survives a closed or orphaned stdout: losing a log line
    must never cost a checkpoint."""
    try:
        print(msg)
    except (BrokenPipeError, ValueError, OSError):
        pass


def to_display_image(x) -> np.ndarray:
    """NHWC/HWC tensor or array in [-1, 1] -> HWC numpy RGB in [0, 1]."""
    arr = x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.ndim == 3:
        arr = np.clip((arr[:, :, :3] + 1.0) * 0.5, 0.0, 1.0)
    return arr


def _not_ported(what: str, item: int, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to floodgan_tpu_torch yet: it waits for ROADMAP.md Queue 1 item {item} ({name})"
    )


class Model:
    def __init__(
        self,
        model: str = "pix2pix",
        dataset_subset: str = "all",
        dataset_dem: str = "best",
        data_path: Optional[str] = None,
        num_epochs: int = 1,
        topography: Optional[str] = "all",
        resize: Optional[int] = 256,
        crop: Optional[int] = None,
        save_model_interval: int = 0,
        save_images_interval: int = 0,
        verbose: bool = False,
        load_pretrained_model: bool = False,
        pretrained_model_path: Optional[str] = None,
        add_identity_loss: bool = False,
        training_model: bool = True,
        seed: int = 47,
        batch_size: int = 1,
        num_data_devices: int = 1,
        num_spatial_devices: int = 1,
        metadata_dir: Optional[str] = None,
        lpips_weights: Optional[str] = None,
        compute_dtype: str = "float32",
        remat: bool = False,
        remat_policy: Optional[str] = None,
        async_checkpoint: bool = False,
        train_cfg: TrainConfig = TrainConfig(),
        device=None,
    ):
        if verbose:
            print(f"\nSetting up the {prettify_model_name(model)} model...")
        if num_data_devices > 1 or num_spatial_devices > 1:
            raise _not_ported("multi-device training", 12, "Multi-GPU")
        if remat:  # remat_policy only matters with remat
            raise _not_ported("--remat", 1, "--remat")
        if save_images_interval and importlib.util.find_spec("matplotlib") is None:
            raise RuntimeError("save_images_interval > 0 plots sample images, which needs matplotlib")
        self.device = resolve_device(device, "Model")

        # -- config, possibly from a self-describing checkpoint --
        saved_meta = saved_state = None
        if load_pretrained_model:
            pretrained_model_path = maybe_migrate(pretrained_model_path, "gan", resize=resize, crop=crop)
            saved_meta, saved_state = load_checkpoint(pretrained_model_path)
            self.model = saved_meta["model"]
            self.num_epochs = saved_meta["num_epochs"]
            self.topography = saved_meta["topography"]
            self.add_identity_loss = saved_meta["add_identity_loss"]
        else:
            self.model = model.lower()
            self.num_epochs = num_epochs
            self.topography = topography.lower() if isinstance(topography, str) else topography
            if self.topography in ("none", ""):
                self.topography = None
            self.add_identity_loss = add_identity_loss
        _check_model(self.model)
        self.verbose = verbose
        self.save_model_interval = save_model_interval
        self.save_images_interval = save_images_interval
        self.load_pretrained_model = load_pretrained_model
        self.data_path = data_path
        self.dataset_subset = dataset_subset
        self.dataset_dem = dataset_dem
        self.resize = resize
        self.crop = crop
        self.training_model = training_model
        self.seed = seed
        self.batch_size = batch_size
        self.metadata_dir = metadata_dir
        self.train_cfg = train_cfg
        self.model_is_cycle = model_is_cycle(self.model)
        self.model_is_attention = model_is_attention(self.model)
        self.loss_keys = loss_keys(self.model, self.add_identity_loss)
        self.input_channels = TOPOGRAPHY_CHANNELS[self.topography]
        self.epoch_stats: List[dict] = []
        self._lpips_weights = lpips_weights
        self._lpips = None
        self._lpips_loaded = False
        self._ms_ssim_warned = False

        # -- data (transforms on the device; reference models/data.py:11-44) --
        self.train_loader, self.val_loader, self.test_loader = create_flood_dataset(
            self.dataset_subset, self.dataset_dem, self.data_path, self.topography,
            self.resize, self.crop, batch_size=self.batch_size,
            metadata_dir=self.metadata_dir, device=self.device,
        )

        # -- trainer and state (floodgan_tpu/api/model.py:206-216) --
        image_hw = self._image_hw()  # and the square-source guard
        if self.model_is_cycle:
            self.trainer = CycleTrainer(
                self.model, self.input_channels, image_hw, cfg=train_cfg,
                add_identity_loss=self.add_identity_loss, compute_dtype=compute_dtype,
                device=self.device, seed=seed,
            )
        else:
            self.trainer = PairedTrainer(
                self.model, self.input_channels, cfg=train_cfg, compute_dtype=compute_dtype,
                device=self.device, seed=seed,
            )
        if load_pretrained_model:
            self.starting_epoch = saved_meta["starting_epoch"]
            self.all_losses = {k: list(v) for k, v in saved_meta["all_losses"].items()}
            (load_cycle_state if self.model_is_cycle else load_paired_state)(self.trainer, saved_state)
        else:
            self.starting_epoch = 1
            self.all_losses = self._initialise_loss_storage(overall=True)
        self.current_epoch = self.starting_epoch
        self._async_ckpt = AsyncCheckpointer() if async_checkpoint else None

        if self.verbose and self.training_model:
            self.print_training_setup()

    # ------------------------------------------------------------- helpers

    def _image_hw(self):
        """The post-transform image size.  With ``resize`` it assumes
        square sources: torchvision's ``Resize(int)`` scales the shorter
        edge, which is h = w = resize only for square images (xBD tiles
        are 1024^2); a non-square dataset fails here."""
        ds = next((d for d in (self.train_loader.dataset, self.val_loader.dataset,
                               self.test_loader.dataset) if len(d)), None)
        if self.resize:
            if ds is not None:
                raw_in, _, _, _ = ds.read_raw(0)
                if raw_in.shape[0] != raw_in.shape[1]:
                    raise ValueError(
                        f"--resize assumes square source images (shorter-edge Resize "
                        f"semantics); got {raw_in.shape[:2]}"
                    )
            h = w = self.resize
        else:
            if ds is None:
                raise ValueError(
                    "dataset is empty for every split and no --resize was given — "
                    "cannot infer the image size"
                )
            raw_in, _, _, _ = ds.read_raw(0)
            h, w = raw_in.shape[:2]
        if self.crop:
            nd = int(np.sqrt(self.crop))
            h, w = h // nd, w // nd
        return h, w

    def _initialise_loss_storage(self, overall: bool) -> Dict[str, List[float]]:
        """Loss-key schema (reference models/model.py:183-205)."""
        pre = "all_" if overall else ""
        return {f"{pre}{k}": [] for k in self.loss_keys}

    def prettify_model_name(self, model_name: Optional[str] = None) -> str:
        return prettify_model_name(model_name or self.model)

    def create_path(self, save_type: str, info: str = "") -> str:
        identity_tag = f"identity{self.add_identity_loss}" if self.model_is_cycle else ""
        return pathlib_.model_artifact_path(
            self.data_path, save_type, self.prettify_model_name(), info,
            self.current_epoch if self.training_model else self.current_epoch - 1,
            self.topography, identity_tag, self.dataset_subset, self.dataset_dem, self.resize, self.crop,
        )

    def print_training_setup(self) -> None:
        """(reference models/model.py:260-273)"""
        print(f"\n{'Continuing' if self.load_pretrained_model else 'Beginning'} "
              f"training {self.prettify_model_name()}:")
        print(f"{self.num_epochs} epochs")
        print(f"Starting from epoch {self.starting_epoch}")
        print(f"{self.topography.title() if self.topography else 'No'} "
              "topographical factors will be input to the model")
        if self.model_is_cycle and self.add_identity_loss:
            print("Using identity mapping loss")
        print(f"Dataset: {len(self.train_loader)} batches of {self.batch_size} from "
              f"'{self.dataset_subset}' with '{self.dataset_dem}' DEM")
        print(f"Data resized to {self.resize} pixels with {self.crop} crops, scaled to [-1, 1]")
        print(f"Model saved every {self.save_model_interval} epochs")
        print(f"Sample generator output images saved every {self.save_images_interval} epochs\n")

    def _epoch_lr(self, epoch: int) -> float:
        """torch LambdaLR counter semantics: factor lambda(epoch - 1) during
        1-indexed training epoch ``epoch`` (reference model.py:123-124)."""
        return self.train_cfg.gan_lr * lambda_rule(epoch - 1, self.num_epochs)

    # ------------------------------------------------------------ training

    def _train_loop(self) -> None:
        # Preemptions arrive as SIGTERM: the same best-effort checkpoint as
        # a ^C.  Handlers install only from the main thread.
        def _preempted(signum, frame):
            raise KeyboardInterrupt

        old_term, installed = None, False
        try:
            old_term = signal.signal(signal.SIGTERM, _preempted)
            installed = True
        except ValueError:
            pass
        try:
            self._train_epochs()
            self.wait_for_checkpoints()
        except KeyboardInterrupt:
            if self.save_model_interval and self.current_epoch >= self.starting_epoch:
                _safe_print("\nInterrupted — saving a resume checkpoint...")
                self.save_checkpoint(self.current_epoch)
                self.wait_for_checkpoints()
            raise
        finally:
            if installed:
                signal.signal(signal.SIGTERM, old_term if old_term is not None else signal.SIG_DFL)

    def _train_epochs(self) -> None:
        for epoch in range(self.starting_epoch, self.num_epochs + 1):
            epoch_start_time = time.time()
            t_start = time.perf_counter()
            lr = self._epoch_lr(epoch)
            # Loss scalars stay on the device during the epoch; one
            # transfer at its end (the reference's per-step .item() syncs
            # every step, models/model.py:648-651).
            step_metrics, samples, wait = [], 0, 0.0
            batches = iter(self.train_loader.epoch_iter(epoch))
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                wait += time.perf_counter() - t0
                if batch is None:
                    break
                # Step s of epoch e draws from the (e, s) stream.
                step_metrics.append(self.trainer.train_step(batch["input"], batch["output"], lr,
                                                            epoch=epoch, step=len(step_metrics)))
                samples += batch["input"].shape[0]

            losses = self._initialise_loss_storage(overall=False)
            if step_metrics:
                keys = self.loss_keys
                host = torch.stack([torch.stack([m[k] for k in keys]) for m in step_metrics]).cpu()
                for j, k in enumerate(keys):
                    losses[k] = host[:, j].tolist()
            loader = self.train_loader
            self.epoch_stats.append({
                "epoch": epoch, "seconds": time.perf_counter() - t_start, "loader_wait_seconds": wait,
                "samples": samples, "post_cache_hits": loader.post_cache_hits,
                "batches": loader.post_cache_total, "stage_seconds": dict(loader.stage_seconds),
            })
            self.save_results(epoch=epoch, losses=losses, epoch_start_time=epoch_start_time)

    # The training entry points (floodgan_tpu/api/model.py:432-436).
    def train_paired(self) -> None:
        self._train_loop()

    def train_cycle(self) -> None:
        self._train_loop()

    # ------------------------------------------------------------- results

    def print_losses(self) -> None:
        """(reference models/model.py:296-319)"""
        L = self.all_losses
        if not self.model_is_cycle:
            print(
                "| "
                f"Discriminator real loss = {L['all_losses_discriminator_real'][-1]:.2f} | "
                f"Discriminator synthetic loss = {L['all_losses_discriminator_synthetic'][-1]:.2f} | "
                f"Generator synthetic loss = {L['all_losses_generator_synthetic'][-1]:.2f} | "
                f"L1 generator loss = {L['all_l1_losses_generator_synthetic'][-1]:.2f}"
            )
            return
        print(
            "| "
            f"Generator post image loss = {L['all_losses_generator_post'][-1]:.2f} | "
            f"Generator pre image loss = {L['all_losses_generator_pre'][-1]:.2f} | "
            f"Pre to post cycle loss = {L['all_losses_pre_to_post_cycle'][-1]:.2f} | "
            f"Post to pre cycle loss = {L['all_losses_post_to_pre_cycle'][-1]:.2f} | "
            f"Discriminator pre real image loss = {L['all_losses_discriminator_pre_real'][-1]:.2f} | "
            f"Discriminator post real image loss = {L['all_losses_discriminator_post_real'][-1]:.2f} | "
            f"Discriminator pre synthetic image loss = {L['all_losses_discriminator_pre_synthetic'][-1]:.2f} | "
            f"Discriminator post synthetic image loss = {L['all_losses_discriminator_post_synthetic'][-1]:.2f}",
            end="" if self.add_identity_loss else "\n",
        )
        if self.add_identity_loss:
            print(
                f" | Identity pre image loss = {L['all_losses_identity_pre'][-1]:.2f} | "
                f"Identity post image loss = {L['all_losses_identity_post'][-1]:.2f}"
            )

    def save_results(self, epoch: int, losses, epoch_start_time: float) -> None:
        """(reference models/model.py:321-361)"""
        self.current_epoch = epoch
        for key in self.all_losses:
            self.all_losses[key].append(float(np.mean(losses[key[4:]])))
        if self.verbose:
            print(f"Epoch {epoch} ({time.time() - epoch_start_time:.2f} seconds) ", end="")
            self.print_losses()
        if self.save_model_interval != 0 and epoch % self.save_model_interval == 0:
            self.save_checkpoint(epoch)
        if self.save_images_interval != 0 and epoch % self.save_images_interval == 0:
            self.plot_sample_images(num_images=5, use_test_data=False)

    def save_checkpoint(self, epoch: int) -> str:
        meta = {
            "model": self.model,
            "starting_epoch": epoch + 1,
            "num_epochs": self.num_epochs,
            "topography": self.topography,
            "all_losses": self.all_losses,
            "add_identity_loss": self.add_identity_loss,
        }
        model_path = self.create_path(save_type="model")
        _safe_print(f"Saving {self.prettify_model_name()} model to {model_path}")
        state = (cycle_state_to_jax if self.model_is_cycle else paired_state_to_jax)(self.trainer)  # host copies
        if self._async_ckpt is not None:
            self._async_ckpt.save(model_path, meta, state)
        else:
            save_checkpoint(model_path, meta, state)
        return model_path

    def wait_for_checkpoints(self) -> None:
        """Join an in-flight async checkpoint write (no-op otherwise)."""
        if self._async_ckpt is not None:
            self._async_ckpt.wait()

    # ----------------------------------------------------------- inference

    def generate(self, input_stack, direction: str = "ab"):
        """The generator's inference forward with the f32 parameters:
        (output NHWC in [-1, 1], background mask (N, H, W) or None).  A cycle
        model runs G_ab, or G_ba for ``direction="ba"``; Pix2Pix draws its
        dropout from the seed-47 inference stream."""
        if self.model_is_cycle:
            return self.trainer.generate(input_stack, direction)
        return self.trainer.generate(input_stack)

    @property
    def lpips(self):
        """The LPIPS metric (``eval.lpips.load_lpips``), loaded at first
        use; None when no weights are found (a NaN column)."""
        if not self._lpips_loaded:
            self._lpips = load_lpips(self._lpips_weights)
            self._lpips_loaded = True
        return self._lpips

    # ------------------------------------------------------------- metrics

    def calculate_metrics(self, use_test_data: bool = False, seg_model_path: Optional[str] = None):
        """(reference models/model.py:363-422)  Image metrics per image, and
        mask metrics over the pixel concatenation of the split through the
        segmentation U-Net of ``seg_model_path``.  The generator is timed
        per batch, up to a synchronise of the card, and the ``Inference``
        column holds that time divided over the batch's images."""
        from floodgan_tpu_torch.api.segmentation import SegmentationModel

        seg = SegmentationModel(data_path=self.data_path, pretrained_model_path=seg_model_path, train=False,
                                metadata_dir=self.metadata_dir, skip_data=True, device=self.device)
        print("\nCalculating metrics...")
        loader = self.test_loader if use_test_data else self.val_loader
        per_image = {k: [] for k in ("PSNR", "SSIM", "MS-SSIM", "LPIPS", "Inference")}
        masks = MaskMetricsAccumulator()
        eval_batch_metrics = seg.trainer.eval_batch_metrics
        for batch in loader.epoch_iter(epoch=0):
            x, y = batch["input"], batch["output"]
            n = x.shape[0]
            start = time.time()
            out, _ = self.generate(x)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            inference_time = time.time() - start
            # The last MS-SSIM scale's 11-tap window must fit (eval/metrics.py):
            # below MS_SSIM_MIN_SIDE the column is NaN, with one warning.
            ms_ok = min(out.shape[1], out.shape[2]) >= MS_SSIM_MIN_SIDE
            if not ms_ok and not self._ms_ssim_warned:
                print(f"WARNING: images are {out.shape[1]}x{out.shape[2]} after resize/crop — MS-SSIM requires "
                      f">={MS_SSIM_MIN_SIDE}px per side (5 dyadic scales x 11-tap kernel); the MS-SSIM column "
                      "will be NaN for this run.")
                self._ms_ssim_warned = True
            imgm, counts = eval_batch_metrics(out, y, with_ms_ssim=ms_ok)
            for k in ("PSNR", "SSIM") + (("MS-SSIM",) if ms_ok else ()):
                per_image[k].extend(imgm[k].cpu().tolist())
            if not ms_ok:
                per_image["MS-SSIM"].extend([float("nan")] * n)
            if self.lpips is not None:
                per_image["LPIPS"].extend(self.lpips(denormalize(out), denormalize(y)).cpu().tolist())
            else:
                per_image["LPIPS"].extend([float("nan")] * n)
            per_image["Inference"].extend([inference_time / n] * n)
            masks.add_counts(counts)

        results = {k: float(np.mean(v)) for k, v in per_image.items()}
        results.update(masks.compute())
        row = {k: results[k] for k in METRIC_COLUMNS}
        print_table(row)
        write_metric_csv(self.create_path("metric"), row)
        return results

    # --------------------------------------------------------------- plots

    def plot_losses(self) -> None:
        """(reference models/model.py:424-473)"""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if self.model_is_cycle:
            plot_parameters = {
                "all_losses_generator_post": {"colour": "#7BA4A9", "label": "Generator (post)", "linestyle": (0, (3, 1)), "plot": 0},
                "all_losses_generator_pre": {"colour": "#7BA4A9", "label": "Generator (pre)", "linestyle": "solid", "plot": 0},
                "all_losses_pre_to_post_cycle": {"colour": "#7BA4A9", "label": "Pre to post cycle loss", "linestyle": "solid", "plot": 1},
                "all_losses_post_to_pre_cycle": {"colour": "#9F799B", "label": "Post to pre cycle loss", "linestyle": "solid", "plot": 1},
                "all_losses_discriminator_pre_real": {"colour": "#5F2959", "label": "Discriminator (pre, real)", "linestyle": "solid", "plot": 0},
                "all_losses_discriminator_post_real": {"colour": "#5F2959", "label": "Discriminator (post, real)", "linestyle": (0, (3, 1)), "plot": 0},
                "all_losses_discriminator_pre_synthetic": {"colour": "#9F799B", "label": "Discriminator (pre, synthetic)", "linestyle": "solid", "plot": 0},
                "all_losses_discriminator_post_synthetic": {"colour": "#9F799B", "label": "Discriminator (post, synthetic)", "linestyle": (0, (3, 1)), "plot": 0},
            }
            if self.add_identity_loss:
                plot_parameters["all_losses_identity_post"] = {"colour": "black", "label": "Identity (post)", "linestyle": (0, (3, 1)), "plot": 2}
                plot_parameters["all_losses_identity_pre"] = {"colour": "black", "label": "Identity (pre)", "linestyle": "solid", "plot": 2}
        else:
            plot_parameters = {
                "all_losses_discriminator_real": {"colour": "#5F2959", "label": "Discriminator (real)", "linestyle": "solid", "plot": 0},
                "all_losses_discriminator_synthetic": {"colour": "#9F799B", "label": "Discriminator (synthetic)", "linestyle": "solid", "plot": 0},
                "all_losses_generator_synthetic": {"colour": "#7BA4A9", "label": "Generator (synthetic)", "linestyle": "solid", "plot": 0},
                "all_l1_losses_generator_synthetic": {"colour": "black", "label": "L1 loss", "linestyle": "solid", "plot": 1},
            }
        num_plots = 3 if self.add_identity_loss else 2
        fig, axes = plt.subplots(nrows=num_plots, ncols=1, figsize=(10, num_plots * 7))
        for ax in axes.ravel():
            ax.tick_params(axis="both", which="major", labelsize=14)
            ax.set_xlabel("Epoch", fontsize=14)
            ax.set_ylabel("Loss", fontsize=14)
            ax.grid(alpha=0.4)
        for loss, values in self.all_losses.items():
            p = plot_parameters[loss]
            axes[p["plot"]].plot(range(1, len(values) + 1), values, c=p["colour"], linestyle=p["linestyle"],
                                 label=p["label"], linewidth=2)
        name = self.prettify_model_name()
        axes[0].set_title(f"{name} Discriminator and Generator Losses", fontsize=15)
        axes[1].set_title(f"{name} {'Cycle Losses' if self.model_is_cycle else 'L1 Losses'}", fontsize=15)
        axes[0].legend(fontsize=14)
        if self.model_is_cycle:
            axes[1].legend(fontsize=14)
        if self.add_identity_loss:
            axes[2].set_title(f"{name} Identity Losses", fontsize=15)
            axes[2].legend(fontsize=14)
        fig.tight_layout()
        losses_path = self.create_path(save_type="figure", info="losses")
        print(f"\nSaving losses figure to {losses_path}")
        fig.savefig(losses_path, bbox_inches="tight")
        plt.close(fig)

    def _load_named_image(self, image_name: str, crop_index: int):
        """One named image pair of the dataset, transformed on the model's
        device (reference models/model.py:481-495): its DEM from the first
        row of ``dataset_split.csv`` that names it."""
        from floodgan_tpu_torch.data import tiff

        with open(os.path.join(self.metadata_dir or "metadata", "dataset_split.csv"), newline="") as f:
            row = next((r for r in csv.DictReader(f) if r["image"] == image_name), None)
        if row is None:
            raise ValueError(f"image {image_name!r} is not in dataset_split.csv")
        dem_string = row[f"{self.dataset_dem}_DEM"]
        inp = np.asarray(tiff.imread(f"{self.data_path}/dataset_input/{image_name}_{dem_string}.tif"),
                         np.float32)[None]
        out = np.asarray(tiff.imread(f"{self.data_path}/dataset_output/{image_name}.tif"), np.float32)[None]
        with full_f32():
            x, y = apply_transformations_batch(
                inp, out, np.zeros(1, bool), np.full(1, crop_index, np.int32),
                topography=self.topography, resize=self.resize, crop=self.crop, device=self.device,
            )
        if self.crop:
            image_name = f"{image_name}_{crop_index}"
        return x, y, image_name

    def plot_image(self, image_name, plot_single_image=None, plot_image_set=False, crop_index=0):
        """(reference models/model.py:475-540)  ``plot_single_image`` writes
        one PNG through ``utils/png.py``; ``plot_image_set`` draws the
        panel set with matplotlib."""
        x, y, image_name = self._load_named_image(image_name, crop_index)
        out, attn_mask = self.generate(x)
        generator_output = to_display_image(out)

        if plot_single_image:
            if plot_single_image == "input":
                p = pathlib_.ensure_parent(f"{self.data_path}/images/{image_name}_input.png")
                print(f"\nSaving input image of image '{image_name}' to {p}")
                imsave_rgb(p, to_display_image(x))
            elif plot_single_image == "ground truth":
                p = pathlib_.ensure_parent(f"{self.data_path}/images/{image_name}_groundTruth.png")
                print(f"\nSaving ground truth of image '{image_name}' to {p}")
                imsave_rgb(p, to_display_image(y))
            elif plot_single_image == "output":
                p = self.create_path(save_type="image", info=image_name)
                print(f"\nSaving generator output of image '{image_name}' to {p}")
                imsave_rgb(p, generator_output)
            elif plot_single_image == "attention mask" and self.model_is_attention:
                p = self.create_path(save_type="image", info=f"{image_name}_attentionMask")
                print(f"\nSaving attention mask of image '{image_name}' to {p}")
                imsave_gray(p, attn_mask[0].cpu().numpy(), reverse=True)
            else:
                raise NotImplementedError(
                    "Type of image must be one of 'input', 'ground truth', 'output', or 'attention mask'"
                )

        if plot_image_set:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            num_cols = 4 if self.model_is_attention else 3
            fig, axes = plt.subplots(nrows=1, ncols=num_cols, figsize=(num_cols * 5, 5))
            for ax in axes.ravel():
                ax.set_axis_off()
            axes[0].imshow(to_display_image(x), vmin=0, vmax=1)
            axes[1].imshow(generator_output, vmin=0, vmax=1)
            axes[num_cols - 1].imshow(to_display_image(y), vmin=0, vmax=1)
            axes[0].set_title(f"Input ({image_name})")
            axes[1].set_title("Generator Output")
            axes[num_cols - 1].set_title("Ground Truth Output")
            if self.model_is_attention:
                axes[2].imshow(attn_mask[0].cpu().numpy(), cmap="gray_r", vmin=0, vmax=1)
                axes[2].set_title("Attention Mask")
            fig.tight_layout()
            images_path = self.create_path(save_type="image", info=image_name)
            print(f"Saving {image_name} image set to {images_path}")
            fig.savefig(images_path, bbox_inches="tight")
            plt.close(fig)

    def plot_sample_images(self, num_images: int, use_test_data: bool) -> None:
        """(reference models/model.py:542-596)  A cycle model also runs its
        post-to-pre generator on the post image with the input's
        conditions."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        generators = ["pre-to-post"] + (["post-to-pre"] if self.model_is_cycle else [])
        splits = [("training", self.train_loader), ("validation", self.val_loader)]
        if use_test_data:
            splits.append(("test", self.test_loader))
        num_cols = 4 if self.model_is_attention else 3
        for generator_label in generators:
            for split, loader in splits:
                fig, axes = plt.subplots(nrows=num_images, ncols=num_cols,
                                         figsize=(num_cols * 5, num_images * 5))
                axes = np.atleast_2d(axes)
                for ax in axes.ravel():
                    ax.set_axis_off()
                plotted = 0
                for batch in loader.epoch_iter(epoch=self.seed):
                    for b in range(batch["input"].shape[0]):
                        x, y = batch["input"][b:b + 1], batch["output"][b:b + 1]
                        if generator_label == "post-to-pre":
                            shown_in, target = torch.cat([y, x[..., 3:]], dim=-1), x[..., :3]
                            out, mask = self.generate(shown_in, direction="ba")
                        else:
                            shown_in, target = x, y
                            out, mask = self.generate(x)
                        i = plotted
                        axes[i, 0].imshow(to_display_image(shown_in), vmin=0, vmax=1)
                        axes[i, 1].imshow(to_display_image(out), vmin=0, vmax=1)
                        axes[i, num_cols - 1].imshow(to_display_image(target), vmin=0, vmax=1)
                        axes[i, 0].set_title(f"Input ({batch['names'][b]})")
                        axes[i, 1].set_title("Generator Output")
                        axes[i, num_cols - 1].set_title("Ground Truth Output")
                        if self.model_is_attention:
                            axes[i, 2].imshow(mask[0].cpu().numpy(), cmap="gray_r")
                            axes[i, 2].set_title("Attention Mask")
                        plotted += 1
                        if plotted >= num_images:
                            break
                    if plotted >= num_images:
                        break
                fig.tight_layout()
                several = len(generators) > 1
                suffix = f"_{generator_label}" if several else ""
                images_path = self.create_path(save_type="image", info=f"{split}{suffix}")
                print(f"Saving {split} {generator_label + ' ' if several else ''}sample images to {images_path}")
                fig.savefig(images_path, bbox_inches="tight")
                plt.close(fig)
