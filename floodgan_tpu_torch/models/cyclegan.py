"""The CycleGAN ResNet generator (c7s1-64, d128, d256, 9x R256, u128, u64,
c7s1-3) on NCHW: the image-space branch of floodgan_tpu/models/cyclegan.py.

A reflect-padded 7x7 stem, two stride-2 convs, nine residual blocks at 256
channels (``trunk.ResnetTrunk``), two ConvTranspose ups (k3 s2 p1 op1) and
a reflect-padded 7x7 RGB head with tanh.  Every norm is an affine-free
instance norm, 23 per forward, each one ``nn_ops.instance_norm_act`` (K1
forward, K2 backward on the card).  The JAX package's 2x2 phase-space
stem and head re-express the same math for the TPU's layout and are not
ported.

Parameters register in the order of
floodgan_tpu/utils/torch_import.py:cyclegan_generator_spec (conv_in,
down1, down2, the nine blocks' conv1 and conv2, up1, up2, conv_out).
"""

from __future__ import annotations

import torch
from torch import nn

from floodgan_tpu_torch.models.trunk import ResidualBlock, ResnetTrunk
from floodgan_tpu_torch.ops import nn_ops

# floodgan_tpu/models/cyclegan.py:28-41: [reflect pad, conv3, IN, relu,
# reflect pad, conv3, IN] + skip, the trunk's block.
ResnetBlock = ResidualBlock


def _deconv(cin: int, cout: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1)


class CycleGANGenerator(nn.Module):
    def __init__(self, input_channels: int = 3):
        super().__init__()
        self.conv_in = nn.Conv2d(input_channels, 64, 7)
        self.down1 = nn.Conv2d(64, 128, 3, stride=2, padding=1)
        self.down2 = nn.Conv2d(128, 256, 3, stride=2, padding=1)
        self.trunk = ResnetTrunk(256, 9)
        self.up1 = _deconv(256, 128)
        self.up2 = _deconv(128, 64)
        self.conv_out = nn.Conv2d(64, 3, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) input stack -> (N, 3, H, W) image in [-1, 1]."""
        in_act = nn_ops.instance_norm_act
        h = in_act(self.conv_in(nn_ops.reflect_pad2d(x, 3)), relu=True)
        h = in_act(self.down1(h), relu=True)
        h = in_act(self.down2(h), relu=True)
        h = self.trunk(h)
        h = in_act(self.up1(h), relu=True)
        h = in_act(self.up2(h), relu=True)
        return torch.tanh(self.conv_out(nn_ops.reflect_pad2d(h, 3)))
