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
module.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from floodgan_tpu_torch.models.trunk import ResnetTrunk
from floodgan_tpu_torch.ops import kernels, nn_ops


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

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        in_act = nn_ops.instance_norm_act
        h = in_act(self.conv1(nn_ops.reflect_pad2d(x, 3)), relu=True)
        h = in_act(self.conv2(h), relu=True)
        h = in_act(self.conv3(h), relu=True)
        h = self.trunk(h)

        c = in_act(self.deconv1_content(h), relu=True)
        c = in_act(self.deconv2_content(c), relu=True)
        content = torch.tanh(self.deconv3_content(nn_ops.reflect_pad2d(c, 3)))

        a = in_act(self.deconv1_attention(h), relu=True)
        a = in_act(self.deconv2_attention(a), relu=True)
        attn_logits = self.deconv3_attention(a)

        return kernels.attention_compose(content, attn_logits, x[:, :3])
