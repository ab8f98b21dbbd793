"""Loss functions of the reference recipe (floodgan_tpu/train/losses.py):
LSGAN MSE against a constant patch target and L1, mean-reduced like their
torch counterparts, accumulated in f32 whatever the activation dtype."""

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
