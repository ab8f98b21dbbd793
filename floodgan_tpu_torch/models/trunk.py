"""The ResNet trunk: 9 reflect-padded residual blocks at 256 channels, the
unrolled form of floodgan_tpu/models/trunk.py (whose parameters are stacked
for a lax.scan)."""

from __future__ import annotations

import torch
from torch import nn

from floodgan_tpu_torch.ops import nn_ops


class ResidualBlock(nn.Module):
    """x + IN(conv(relu(IN(conv(x))))), each conv reflect-padded by 1."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3)
        self.conv2 = nn.Conv2d(dim, dim, 3)
        self.spatial = None  # a spatial group: h holds this rank's rows (models.layers.set_spatial_mesh)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        sp = self.spatial
        y = nn_ops.reflect_conv2d(h, self.conv1.weight, self.conv1.bias, pad=1, spatial=sp, layer="trunk conv1")
        y = nn_ops.instance_norm_act(y, relu=True, spatial=sp)
        y = nn_ops.reflect_conv2d(y, self.conv2.weight, self.conv2.bias, pad=1, spatial=sp, layer="trunk conv2")
        return nn_ops.instance_norm_act(y, residual=h, spatial=sp)


class ResnetTrunk(nn.Module):
    def __init__(self, dim: int = 256, num_blocks: int = 9):
        super().__init__()
        self.blocks = nn.ModuleList(ResidualBlock(dim) for _ in range(num_blocks))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            h = block(h)
        return h
