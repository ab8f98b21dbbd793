"""70x70 PatchGAN discriminator, InstanceNorm variant, on NCHW
(floodgan_tpu/models/patchgan.py):

  C64(k4 s2 p1, leaky 0.2) - C128(k4 s2 p1, IN, leaky) - C256(k4 s2 p1, IN,
  leaky) - C512(k4 s1 p1, IN, leaky) - C1(k4 s1 p1)     [patch logit map]

Each IN + leaky pair is one ``instance_norm_act(..., relu=True,
negative_slope=0.2)`` (K1 forward, K2 backward on the card).  With
InstanceNorm the normed convs keep their bias, as in the reference.
Conditioning is the caller's concatenation: the conditional D of
PairedAttention reads the input stack and the RGB image, 9 + 3 channels.
"""

from __future__ import annotations

import torch
from torch import nn

from floodgan_tpu_torch.ops import nn_ops

SLOPE = 0.2


class PatchGANDiscriminator(nn.Module):
    def __init__(self, input_channels: int, norm: str = "instance"):
        super().__init__()
        if norm != "instance":
            raise NotImplementedError(
                f"the {norm!r}-norm PatchGAN is not ported to floodgan_tpu_torch yet: it waits "
                "for the Pix2Pix family (ROADMAP.md Queue 1, 'Pix2Pix family')"
            )
        # Module order is floodgan_tpu/utils/torch_import.py:patchgan_spec("instance").
        self.conv0 = nn.Conv2d(input_channels, 64, 4, stride=2, padding=1)
        self.conv1 = nn.Conv2d(64, 128, 4, stride=2, padding=1)
        self.conv2 = nn.Conv2d(128, 256, 4, stride=2, padding=1)
        self.conv3 = nn.Conv2d(256, 512, 4, stride=1, padding=1)
        self.conv4 = nn.Conv2d(512, 1, 4, stride=1, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Three stride-2 levels, then two k4 s1 p1 convs (each -1): below 24
        # pixels the logit map would have no elements.
        h_in, w_in = x.shape[2], x.shape[3]
        if h_in // 8 - 2 < 1 or w_in // 8 - 2 < 1:
            raise ValueError(
                "PatchGAN needs spatial dims >= 24 (three stride-2 levels "
                f"then two k4 s1 p1 convs); got {h_in}x{w_in}.  Use "
                "--resize 256/512 (optionally with --crop) like the "
                "reference configurations."
            )
        h = nn_ops.leaky_relu(self.conv0(x), SLOPE)
        for conv in (self.conv1, self.conv2, self.conv3):
            h = nn_ops.instance_norm_act(conv(h), relu=True, negative_slope=SLOPE)
        return self.conv4(h)
