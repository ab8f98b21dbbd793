"""70x70 PatchGAN discriminator, both norm variants, on NCHW
(floodgan_tpu/models/patchgan.py):

  C64(k4 s2 p1, leaky 0.2) - C128(k4 s2 p1, norm, leaky) - C256(k4 s2 p1,
  norm, leaky) - C512(k4 s1 p1, norm, leaky) - C1(k4 s1 p1)  [patch logit map]

``norm="instance"`` (CycleGAN, AttentionGAN, PairedAttention): each IN +
leaky pair is one ``instance_norm_act(..., relu=True, negative_slope=0.2)``
(K1 forward, K2 backward on the card), and the normed convs keep their
bias, as in the reference.  ``norm="batch"`` (Pix2Pix): the normed convs
have no bias and feed a training-mode ``BatchNorm2d`` (batch statistics)
and a leaky ReLU; it launches no hand-written kernel.  Conditioning is the
caller's concatenation: the conditional D of Pix2Pix and PairedAttention
reads the input stack and the RGB image, 9 + 3 channels.

With a spatial group (``models.layers.set_spatial_mesh``) x holds this
rank's rows: each k4 s2 p1 conv reads one halo row each side, each k4 s1
p1 conv one above and two below, zero-padded at the image's edges, so the
last shard's logit rows are two fewer than the others'; the instance norms
reduce over the group, and the batch norms over the data stripes and the
group, each counting the rows its shard really holds (``norm3`` follows
the first k4 s1 p1 conv, one row short on the last shard).
"""

from __future__ import annotations

import torch
from torch import nn

from floodgan_tpu_torch.models.layers import BatchNorm2d
from floodgan_tpu_torch.ops import nn_ops
from floodgan_tpu_torch.parallel import spatial

SLOPE = 0.2
NORMS = ("instance", "batch")


class PatchGANDiscriminator(nn.Module):
    def __init__(self, input_channels: int, norm: str = "instance"):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"norm must be one of {NORMS}, got {norm!r}")
        self.norm = norm
        bias = norm == "instance"
        # Module order is floodgan_tpu/utils/torch_import.py:patchgan_spec(norm):
        # conv0, then conv{n} (and norm{n} with batch norm) for n = 1..3, conv4.
        self.conv0 = nn.Conv2d(input_channels, 64, 4, stride=2, padding=1)
        self.conv1 = nn.Conv2d(64, 128, 4, stride=2, padding=1, bias=bias)
        if norm == "batch":
            self.norm1 = BatchNorm2d(128)
        self.conv2 = nn.Conv2d(128, 256, 4, stride=2, padding=1, bias=bias)
        if norm == "batch":
            self.norm2 = BatchNorm2d(256)
        self.conv3 = nn.Conv2d(256, 512, 4, stride=1, padding=1, bias=bias)
        if norm == "batch":
            self.norm3 = BatchNorm2d(512)
        self.conv4 = nn.Conv2d(512, 1, 4, stride=1, padding=1)
        self.spatial = None  # a spatial group: x holds this rank's rows (models.layers.set_spatial_mesh)

    def _conv(self, n: int, h: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, f"conv{n}")
        if self.spatial is None:
            return conv(h)
        # k4 s2 p1 reads one row beyond each side; k4 s1 p1 one above and two below.
        return spatial.conv2d_rows(h, conv, 1, 1 if conv.stride[0] == 2 else 2, self.spatial, f"conv{n}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Three stride-2 levels, then two k4 s1 p1 convs (each -1): below 24
        # pixels the logit map would have no elements.
        h_in, w_in = x.shape[2] * (1 if self.spatial is None else self.spatial.size), x.shape[3]
        if h_in // 8 - 2 < 1 or w_in // 8 - 2 < 1:
            raise ValueError(
                "PatchGAN needs spatial dims >= 24 (three stride-2 levels "
                f"then two k4 s1 p1 convs); got {h_in}x{w_in}.  Use "
                "--resize 256/512 (optionally with --crop) like the "
                "reference configurations."
            )
        if self.spatial is not None:
            spatial.check_patchgan_rows(x.shape[2])
        h = nn_ops.leaky_relu(self._conv(0, x), SLOPE)
        for n in (1, 2, 3):
            h = self._conv(n, h)
            if self.norm == "batch":
                h = nn_ops.leaky_relu(getattr(self, f"norm{n}")(h), SLOPE)
            else:
                h = nn_ops.instance_norm_act(h, relu=True, negative_slope=SLOPE, spatial=self.spatial)
        return self._conv(4, h)
