"""Loss functions of the reference recipe (floodgan_tpu/train/losses.py):
LSGAN MSE against a constant patch target, L1 and BCE with logits,
mean-reduced like their torch counterparts, accumulated in f32 whatever the
activation dtype."""

from __future__ import annotations

import torch


def lsgan_mse(prediction: torch.Tensor, target: float) -> torch.Tensor:
    """``nn.MSELoss()(prediction, full_like(prediction, target))``, the LSGAN
    objective on PatchGAN logit maps."""
    return torch.square(prediction.float() - target).mean()


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean absolute error: |a - b| in the activation dtype, the mean in
    f32."""
    return torch.abs(a - b).float().mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``nn.BCEWithLogitsLoss()`` (mean reduction) in its stable form,
    max(z, 0) - z t + log1p(exp(-|z|)), in f32."""
    z, t = logits.float(), targets.float()
    return (torch.clamp(z, min=0.0) - z * t + torch.log1p(torch.exp(-torch.abs(z)))).mean()
