"""Attention generator shared by AttentionGAN and PairedAttention, on NCHW.

The image-space branch of floodgan_tpu/models/attention.py:
shared encoder (reflect-pad k7 conv -> 64, k3 s2 -> 128, k3 s2 -> 256, each
IN + relu) -> 9 residual blocks at 256 -> two decoder heads:
  content:   convT -> 128, convT -> 64, reflect-pad k7 conv -> 27, tanh
  attention: convT -> 128, convT -> 64, k1 conv -> 10 logits
-> compose: softmax over the 10 logits, the 9 content images weighted by
the first 9 masks plus the input RGB weighted by the background mask.

``forward`` returns (output (N,3,H,W), background_mask (N,H,W)).  The 25
instance norms and the compose run in the hand-written kernels on the card
(ops/kernels.py); ``tanh`` stays outside the compose kernel, as in the JAX
module.  ``forward`` runs in seven segments whose ends are the JAX
module's ``seg_boundary`` marks, for remat's ``"boundaries"`` policy.

With a spatial group (``models.layers.set_spatial_mesh``) x holds this
rank's rows of each image: the stem and the content head read 3 halo rows
each side (reflecting at the image's edges), conv2/conv3 one above, each
ConvT one below (its output cropped to 2h rows), the trunk one each side,
and the instance norms reduce over the group.  The attention head's k1
conv, ``tanh`` and the compose are pixel-wise and stay local.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from floodgan_tpu_torch.models.trunk import ResnetTrunk
from floodgan_tpu_torch.ops import kernels, nn_ops
from floodgan_tpu_torch.parallel import spatial


def _call(fn: Callable, *args):
    return fn(*args)


def _deconv(cin: int, cout: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1)


class AttentionGenerator(nn.Module):
    def __init__(self, input_channels: int = 3):
        super().__init__()
        # Registration order is the reference's (conv1-3, res0-8, the
        # content head, the attention head), so named_parameters() lines
        # up with floodgan_tpu/utils/torch_import.py:attention_generator_spec.
        self.conv1 = nn.Conv2d(input_channels, 64, 7)
        self.conv2 = nn.Conv2d(64, 128, 3, stride=2, padding=1)
        self.conv3 = nn.Conv2d(128, 256, 3, stride=2, padding=1)
        self.trunk = ResnetTrunk(256, 9)
        self.deconv1_content = _deconv(256, 128)
        self.deconv2_content = _deconv(128, 64)
        self.deconv3_content = nn.Conv2d(64, 27, 7)
        self.deconv1_attention = _deconv(256, 128)
        self.deconv2_attention = _deconv(128, 64)
        self.deconv3_attention = nn.Conv2d(64, 10, 1)
        self.spatial = None  # a spatial group: x holds this rank's rows (models.layers.set_spatial_mesh)

    # The segments between JAX's seg_boundary marks
    # (floodgan_tpu/models/attention.py:83, 86, 121, 123, 170, 178).
    def _encoder(self, x: torch.Tensor) -> torch.Tensor:
        sp = self.spatial
        if sp is not None:
            spatial.check_generator_rows(x.shape[2])
        h = self._in_act(self.conv1(nn_ops.reflect_pad2d(x, 3, sp, "conv1")))
        h = self._in_act(self._down(self.conv2, h, "conv2"))
        return self._in_act(self._down(self.conv3, h, "conv3"))

    def _in_act(self, h: torch.Tensor) -> torch.Tensor:
        return nn_ops.instance_norm_act(h, relu=True, spatial=self.spatial)

    def _down(self, conv: nn.Conv2d, h: torch.Tensor, layer: str) -> torch.Tensor:
        if self.spatial is None:
            return conv(h)
        return spatial.conv2d_rows(h, conv, 1, 0, self.spatial, layer)

    def _up(self, deconv: nn.Module, h: torch.Tensor) -> torch.Tensor:
        if self.spatial is not None:
            return self._in_act(spatial.conv_transpose2d_rows(h, deconv, self.spatial, "deconv"))
        return self._in_act(deconv(h))

    def _heads(self, c: torch.Tensor, a: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        content = torch.tanh(self.deconv3_content(nn_ops.reflect_pad2d(c, 3, self.spatial, "deconv3_content")))
        return kernels.attention_compose(content, self.deconv3_attention(a), x[:, :3])

    def forward(self, x: torch.Tensor, run: Callable = _call) -> Tuple[torch.Tensor, torch.Tensor]:
        """``run(segment, *inputs)`` calls each of the seven segments
        (encoder, trunk, the two heads' deconv1 and deconv2, the head convs
        with the compose); remat's ``"boundaries"`` passes a checkpoint."""
        h = run(self._encoder, x)
        h = run(self.trunk, h)
        c = run(self._up, self.deconv1_content, h)
        c = run(self._up, self.deconv2_content, c)
        a = run(self._up, self.deconv1_attention, h)
        a = run(self._up, self.deconv2_attention, a)
        return run(self._heads, c, a, x)
