"""The CycleGAN ResNet generator (c7s1-64, d128, d256, 9x R256, u128, u64,
c7s1-3) on NCHW: the image-space branch of floodgan_tpu/models/cyclegan.py.

A reflect-padded 7x7 stem, two stride-2 convs, nine residual blocks at 256
channels (``trunk.ResnetTrunk``), two ConvTranspose ups (k3 s2 p1 op1) and
a reflect-padded 7x7 RGB head with tanh.  Every norm is an affine-free
instance norm, 23 per forward, each one ``nn_ops.instance_norm_act`` (K1
forward, K2 backward on the card).  The JAX package's 2x2 phase-space
stem and head re-express the same math for the TPU's layout and are not
ported.  ``forward`` runs in five segments whose ends are the JAX module's
``seg_boundary`` marks, for remat's ``"boundaries"`` policy.

With a spatial group (``models.layers.set_spatial_mesh``) x holds this
rank's rows of each image, as in the attention generator: the stem and
the head read 3 halo rows each side (reflecting at the image's edges),
down1/down2 one above, each ConvT one below (its output cropped to 2h
rows), the trunk one each side, and the instance norms reduce over the
group.

Parameters register in the order of
floodgan_tpu/utils/torch_import.py:cyclegan_generator_spec (conv_in,
down1, down2, the nine blocks' conv1 and conv2, up1, up2, conv_out).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from floodgan_tpu_torch.models.trunk import ResidualBlock, ResnetTrunk
from floodgan_tpu_torch.ops import nn_ops
from floodgan_tpu_torch.parallel import spatial

# floodgan_tpu/models/cyclegan.py:28-41: [reflect pad, conv3, IN, relu,
# reflect pad, conv3, IN] + skip, the trunk's block.
ResnetBlock = ResidualBlock


def _call(fn: Callable, *args):
    return fn(*args)


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
        self.spatial = None  # a spatial group: x holds this rank's rows (models.layers.set_spatial_mesh)

    # The segments between JAX's seg_boundary marks
    # (floodgan_tpu/models/cyclegan.py:84, 86, 105, 116).
    def _encoder(self, x: torch.Tensor) -> torch.Tensor:
        sp = self.spatial
        if sp is not None:
            spatial.check_cyclegan_rows(x.shape[2])
        h = self._in_act(self.conv_in(nn_ops.reflect_pad2d(x, 3, sp, "conv_in")))
        h = self._in_act(self._down(self.down1, h, "down1"))
        return self._in_act(self._down(self.down2, h, "down2"))

    def _in_act(self, h: torch.Tensor) -> torch.Tensor:
        return nn_ops.instance_norm_act(h, relu=True, spatial=self.spatial)

    def _down(self, conv: nn.Conv2d, h: torch.Tensor, layer: str) -> torch.Tensor:
        if self.spatial is None:
            return conv(h)
        return spatial.conv2d_rows(h, conv, 1, 0, self.spatial, layer)

    def _up(self, deconv: nn.Module, h: torch.Tensor) -> torch.Tensor:
        if self.spatial is not None:
            return self._in_act(spatial.conv_transpose2d_rows(h, deconv, self.spatial, "up"))
        return self._in_act(deconv(h))

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.conv_out(nn_ops.reflect_pad2d(h, 3, self.spatial, "conv_out")))

    def forward(self, x: torch.Tensor, run: Callable = _call) -> torch.Tensor:
        """(N, C, H, W) input stack -> (N, 3, H, W) image in [-1, 1].
        ``run(segment, *inputs)`` calls each of the five segments (encoder,
        trunk, up1, up2, the RGB head); remat's ``"boundaries"`` passes a
        checkpoint."""
        h = run(self._encoder, x)
        h = run(self.trunk, h)
        h = run(self._up, self.up1, h)
        h = run(self._up, self.up2, h)
        return run(self._head, h)
