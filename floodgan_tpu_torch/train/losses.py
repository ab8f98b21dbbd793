"""Loss functions of the reference recipe (floodgan_tpu/train/losses.py):
LSGAN MSE against a constant patch target, L1 and BCE with logits,
mean-reduced like their torch counterparts, accumulated in f32 whatever the
activation dtype.

With a ``spatial`` group (the mesh's spatial axis) the tensors hold this
rank's rows, and a mean is this rank's share of it: the local sum over the
global element count (``parallel.spatial.global_mean``), so that the
group's shares, and their gradients, add up to the whole image's."""

from __future__ import annotations

import torch

from floodgan_tpu_torch.parallel.spatial import global_mean


def lsgan_mse(prediction: torch.Tensor, target: float, spatial=None) -> torch.Tensor:
    """``nn.MSELoss()(prediction, full_like(prediction, target))``, the LSGAN
    objective on PatchGAN logit maps."""
    return global_mean(torch.square(prediction.float() - target), spatial)


def l1_loss(a: torch.Tensor, b: torch.Tensor, spatial=None) -> torch.Tensor:
    """Mean absolute error: |a - b| in the activation dtype, the mean in
    f32."""
    return global_mean(torch.abs(a - b).float(), spatial)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, spatial=None) -> torch.Tensor:
    """``nn.BCEWithLogitsLoss()`` (mean reduction) in its stable form,
    max(z, 0) - z t + log1p(exp(-|z|)), in f32."""
    z, t = logits.float(), targets.float()
    return global_mean(torch.clamp(z, min=0.0) - z * t + torch.log1p(torch.exp(-torch.abs(z))), spatial)
