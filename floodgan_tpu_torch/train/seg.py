"""Supervised U-Net segmentation training on the card: the port of
floodgan_tpu/train/seg.py.

One ``train_step`` is BCE with logits on the mask logits, one torch Adam
step (0.5, 0.999) at the LR the caller passes (``TrainConfig.seg_lr``, 1e-4,
times the epoch's LambdaLR factor), and the reference's pixel accuracy:
the share of pixels where sigmoid(logit) > 0.5 agrees with label > 0.5.

Images and masks are NHWC, numpy or tensors, as in the JAX package; the
logits and masks that come back are NHWC too.  ``compute_dtype="float32"``
is true f32 (TF32 off); ``"bfloat16"`` runs the forward in one autocast
region, as ``PairedTrainer`` does, with f32 master weights, f32 batch-norm
statistics and f32 logits.  ``remat=True`` recomputes the whole U-Net
apply in the backward (one checkpoint inside the autocast region, JAX's
``jax.checkpoint(self._apply)``): the skip-connected stem holds 64-channel
full-resolution tensors through the whole decode, which the recompute
trades for one more forward.

With a ``mesh`` (``parallel.mesh.DataMesh``) each rank takes its part of
every batch: its stripe, and on a spatial axis its rows of each image
(``mesh.shard_images`` of the global NHWC batch), which is what
``train_step`` and ``predict_logits`` take and return.  The U-Net runs
shard-wise (``models.layers.set_spatial_mesh``), its batch norms reduce
over the data stripes and the spatial ranks, the BCE and the accuracy are
this rank's shares of the global means (``parallel.spatial.global_mean``)
and come back as the global batch's means, and the gradients are summed
over the spatial ranks and averaged over the stripes (``mean_grads``)
before Adam.  JAX's ``SegTrainer`` does the same when it is handed sharded
arrays: GSPMD infers what the mesh argument says here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from floodgan_tpu_torch.core.config import TrainConfig
from floodgan_tpu_torch.core.device import full_f32, resolve_device
from floodgan_tpu_torch.eval.metrics import make_eval_batch_metrics
from floodgan_tpu_torch.models.layers import init_weights, set_data_mesh, set_spatial_mesh
from floodgan_tpu_torch.models.unet import UNet
from floodgan_tpu_torch.parallel.mesh import mean_grads
from floodgan_tpu_torch.parallel.spatial import global_mean
from floodgan_tpu_torch.train.losses import bce_with_logits
from floodgan_tpu_torch.train.optim import adam, apply_adam
from floodgan_tpu_torch.train.remat import recompute

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SegTrainer:
    """The U-Net, its Adam and the eval closure of one segmentation model.

    The parameters are drawn by ``init_weights`` from
    ``torch.Generator().manual_seed(seed)``.  ``device=None`` means the
    card (the mesh's card with a ``mesh``), and raises when there is
    none.  ``eval_batch_metrics`` is the
    fused eval block of ``eval.metrics.make_eval_batch_metrics`` over this
    trainer's ``predict_mask``, built once here.
    """

    def __init__(self, cfg: TrainConfig = TrainConfig(), compute_dtype: str = "float32",
                 remat: bool = False, device=None, seed: int = 47, mesh=None):
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device, "SegTrainer")
        self.mesh = mesh
        self.spatial = getattr(mesh, "spatial", None)
        self.cfg = cfg
        self.compute_dtype = _DTYPES[compute_dtype]
        self.remat = remat
        self.model = init_weights(UNet(), torch.Generator().manual_seed(seed)).to(self.device)
        if mesh is not None:
            mesh.replicate_(self.model)
            set_data_mesh(self.model, mesh)
            set_spatial_mesh(self.model, self.spatial)
        self.opt = adam(self.model.parameters(), cfg.adam_b1, cfg.adam_b2)
        self.eval_batch_metrics = make_eval_batch_metrics(self.predict_mask)

    def _nchw(self, a) -> torch.Tensor:
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a, np.float32))
        return t.to(self.device, torch.float32).permute(0, 3, 1, 2).contiguous()

    def _cast_apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(self.compute_dtype))

    def _apply(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """NCHW image -> f32 NCHW logits, under the compute policy; with
        ``remat``, recomputed in the backward."""
        if self.compute_dtype == torch.float32:
            return recompute(self.model, x) if remat else self.model(x)
        with torch.autocast(self.device.type, dtype=self.compute_dtype):
            out = recompute(self._cast_apply, x) if remat else self._cast_apply(x)
        return out.float()

    def train_step(self, image, true_mask, lr: float) -> Dict[str, torch.Tensor]:
        """One BCE + Adam step on an NHWC batch (on a mesh, this rank's
        part); returns ``loss`` and ``accuracy`` (from the logits before the
        update) as f32 scalars on the trainer's device, the global batch's
        on a mesh."""
        x, t = self._nchw(image), self._nchw(true_mask)
        with full_f32():
            self.opt.zero_grad(set_to_none=True)
            logits = self._apply(x, self.remat)
            loss = bce_with_logits(logits, t, self.spatial)
            loss.backward()
            mean_grads(self.mesh, self.model)
            apply_adam(self.opt, lr)
        with torch.no_grad():
            accuracy = global_mean(((torch.sigmoid(logits) > 0.5) == (t > 0.5)).float(), self.spatial)
        metrics = {"loss": loss.detach(), "accuracy": accuracy}
        return metrics if self.mesh is None else self.mesh.mean(metrics)

    @torch.no_grad()
    def predict_logits(self, image) -> torch.Tensor:
        """NHWC image -> (N, H, W, 1) f32 logits on the trainer's device (on
        a mesh, of this rank's part)."""
        with full_f32():
            return self._apply(self._nchw(image)).permute(0, 2, 3, 1)

    def predict_mask(self, image) -> torch.Tensor:
        """sigmoid(logit) > 0.5 as an f32 (N, H, W, 1) mask (reference
        segmentation_model.py:244-248)."""
        return (torch.sigmoid(self.predict_logits(image)) > 0.5).float()
