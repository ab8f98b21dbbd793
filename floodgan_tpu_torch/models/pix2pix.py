"""The Pix2Pix 8-level U-Net generator and its 1-logit segmentation
variant, on NCHW: the port of floodgan_tpu/models/pix2pix.py.

  down: conv(in, 64, k4 s2 p1, no bias)                       [no norm]
        leaky 0.2, conv(64, 128), BN ... (128, 256), (256, 512)
        3x leaky, conv(512, 512), BN
  inner down: leaky, conv(512, 512)                           [no norm]
  inner up:   relu, convT(512, 512, k4 s2 p1, no bias), BN
  up:   relu, convT(cat -> 512), BN, dropout  x3
        relu, convT(1024, 256), BN; (512, 128); (256, 64)
  out:  relu, convT(128, out, k4 s2 p1, bias), tanh | sigmoid

Dropout acts on the up-path output *before* the skip concat, as in the
reference.  Every batch norm is in training mode (``layers.BatchNorm2d``),
and dropout stays active at inference, drawing from the generator the
caller passes (``layers.Dropout``): the reference pins it with seed 47.
No hand-written kernel runs here: the convolutions go to cuDNN and the
batch norms to ATen, as the JAX package left them to XLA.

With a spatial group (``models.layers.set_spatial_mesh``) x holds this
rank's rows of each image.  The down convs read one halo row each side
(``parallel.spatial.conv2d_rows``), the up ConvTs too
(``conv_transpose2d_k4_rows``), and the batch norms reduce over the data
stripes and the group.  The deep levels are narrower than a shard: from
the first down level that cannot halve its shard
(``parallel.spatial.pix2pix_gather_level``) the rows are gathered and the
levels down to the innermost and back up run on the whole image,
replicated on every spatial rank, their batch norms reducing over the data
stripes alone; the decoder cuts back to this rank's rows where it meets
the first skip that holds rows.  Dropout draws the rows of the global
mask on rows, the whole mask where the level is replicated.

Parameters register under ``unet`` in the order of
floodgan_tpu/utils/torch_import.py:pix2pix_generator_spec (down0_conv,
down{1..6}_conv + _norm, down7_conv, up7_conv + _norm, up{6..1}_conv +
_norm, up0_conv), so a reference ``.pth.tar`` loads by position.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from floodgan_tpu_torch.models.layers import BatchNorm2d, Dropout, DropoutStream
from floodgan_tpu_torch.ops.nn_ops import leaky_relu
from floodgan_tpu_torch.parallel import spatial

# (inner_channels, use_dropout) per non-outermost level, outermost ->
# innermost (floodgan_tpu/models/pix2pix.py:37-45).
_LEVELS = [(128, False), (256, False), (512, False), (512, True), (512, True), (512, True), (512, None)]


def _down(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 4, stride=2, padding=1, bias=False)


def _up(cin: int, cout: int, bias: bool = False) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1, bias=bias)


class _UNet8(nn.Module):
    """The body shared by Pix2PixGenerator (tanh, 3 channels) and
    Pix2PixUNet (sigmoid, 1 channel)."""

    def __init__(self, input_channels: int, out_channels: int, final_activation: str, dropout_rate: float = 0.5):
        super().__init__()
        if final_activation not in ("tanh", "sigmoid"):
            raise ValueError(f"final_activation must be 'tanh' or 'sigmoid', got {final_activation!r}")
        self.final_activation = final_activation
        n = len(_LEVELS)
        self.down0_conv = _down(input_channels, 64)
        ch = 64
        for i, (inner, _) in enumerate(_LEVELS, start=1):
            setattr(self, f"down{i}_conv", _down(ch, inner))
            if i < n:  # the innermost down block has no norm
                setattr(self, f"down{i}_norm", BatchNorm2d(inner))
            ch = inner
        self.up7_conv = _up(512, 512)
        self.up7_norm = BatchNorm2d(512)
        h_ch = 512
        for i in range(n - 1, 0, -1):
            outer = 64 * 2 ** (i - 1) if i <= 3 else 512
            setattr(self, f"up{i}_conv", _up(_LEVELS[i - 1][0] + h_ch, outer))
            setattr(self, f"up{i}_norm", BatchNorm2d(outer))
            if _LEVELS[i - 1][1]:
                setattr(self, f"up{i}_dropout", Dropout(dropout_rate))
            h_ch = outer
        self.up0_conv = _up(64 + h_ch, out_channels, bias=True)
        self.spatial = None  # a spatial group: x holds this rank's rows (models.layers.set_spatial_mesh)

    def _conv(self, name: str, h: torch.Tensor, rows: bool) -> torch.Tensor:
        """Conv ``name`` on the whole image, or on rows with one halo row
        each side (the down convs and the up ConvTs alike)."""
        conv = getattr(self, name)
        if not rows:
            return conv(h)
        if isinstance(conv, nn.ConvTranspose2d):
            return spatial.conv_transpose2d_k4_rows(h, conv, self.spatial, name)
        return spatial.conv2d_rows(h, conv, 1, 1, self.spatial, name)

    def _dropout(self, i: int, h: torch.Tensor, generator, rows: bool) -> torch.Tensor:
        drop = getattr(self, f"up{i}_dropout")
        if self.spatial is not None and drop.rate > 0:
            if not isinstance(generator, DropoutStream):
                raise ValueError(f"up{i}_dropout on a spatial group draws the global mask from a DropoutStream")
            if not rows:  # a replicated level draws the whole mask
                generator = generator._replace(row_index=0, row_count=1)
        return drop(h, generator)

    def forward(self, x: torch.Tensor, dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        sp = self.spatial
        height = x.shape[2] * (1 if sp is None else sp.size)
        if height % 256 or x.shape[3] % 256:
            raise ValueError(
                f"Pix2Pix U-Net needs spatial dims divisible by 256 (8 "
                f"stride-2 levels); got {height}x{x.shape[3]}.  Use "
                f"--resize 256/512 (optionally with --crop) like the "
                f"reference configurations."
            )
        n = len(_LEVELS)
        gather = n + 1
        if sp is not None:
            spatial.check_pix2pix_rows(x.shape[2])
            gather = spatial.pix2pix_gather_level(x.shape[2])
        rows = sp is not None  # h holds this rank's rows, not the whole image
        h = self._conv("down0_conv", x, rows)
        skips = [h]
        for i in range(1, n + 1):
            h = leaky_relu(h, 0.2)
            if i == gather:
                h, rows = spatial.gather_rows(h, sp), False
            h = self._conv(f"down{i}_conv", h, rows)
            if i < n:
                h = getattr(self, f"down{i}_norm")(h, replicated=not rows)
                skips.append(h)
        h = self.up7_norm(self._conv("up7_conv", torch.relu(h), rows), replicated=not rows)
        for i in range(n - 1, -1, -1):
            if sp is not None and not rows and i < gather:  # the skip holds rows: cut back to them
                h, rows = spatial.slice_rows(h, sp), True
            h = torch.relu(torch.cat([skips[i], h], dim=1))
            h = self._conv(f"up{i}_conv", h, rows)
            if i == 0:
                break
            h = getattr(self, f"up{i}_norm")(h, replicated=not rows)
            if _LEVELS[i - 1][1]:
                h = self._dropout(i, h, dropout_generator, rows)
        return torch.tanh(h) if self.final_activation == "tanh" else torch.sigmoid(h)


class Pix2PixGenerator(nn.Module):
    """The Pix2Pix generator: the input stack -> an RGB image in [-1, 1].
    ``forward(x, dropout_generator)`` returns the image alone."""

    def __init__(self, input_channels: int = 3, dropout_rate: float = 0.5):
        super().__init__()
        self.unet = _UNet8(input_channels, 3, "tanh", dropout_rate)

    def forward(self, x: torch.Tensor, dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.unet(x, dropout_generator)


class Pix2PixUNet(nn.Module):
    """The reference's Pix2Pix-U-Net segmenter (1 channel, sigmoid),
    defined but unused there; kept for the inventory."""

    def __init__(self, input_channels: int = 3, dropout_rate: float = 0.5):
        super().__init__()
        self.unet = _UNet8(input_channels, 1, "sigmoid", dropout_rate)

    def forward(self, x: torch.Tensor, dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.unet(x, dropout_generator)
