"""The flood-segmentation U-Net (milesial variant), on NCHW.

The image-space branch of floodgan_tpu/models/unet.py: a DoubleConv stem
to 64 channels; four max-pool + DoubleConv downs to 1024; four ups (a k2 s2
ConvTranspose, zero-pad to the skip's size, concat skip first, DoubleConv);
a 1x1 conv to one logit channel.  ``bilinear=True`` halves the bottleneck
and upsamples with align-corners bilinear instead of the ConvTranspose.
The JAX package's 2x2 phase-space stem and tail (``FLOODGAN_SEG_PHASE``)
re-express the same math for the TPU's layout and are not ported.

Every batch norm is in training mode (``models.layers.BatchNorm2d``), so a
mask depends on which images share its batch.

With a spatial group (``models.layers.set_spatial_mesh``) x holds this
rank's rows of each image: each zero-padded 3x3 conv reads one halo row
each side (``parallel.spatial.conv2d_rows``), the batch norms reduce over
the data stripes and the group, the bilinear upsample reads one halo row
each side at the image's global coordinates
(``parallel.spatial.bilinear_2x_rows``); the max-pools, the k2 s2
ConvTranspose and the 1x1 ``outc`` are local.  The shard height must
survive the four pools (``parallel.spatial.check_unet_rows``), so the
skips and the upsampled rows meet without padding in H.

The parameters register in the reference's order
(floodgan_tpu/utils/torch_import.py:107-126, ``unet_spec`` and
``unet_bilinear_spec``): inc, down1-4, then up{i}_upconv and up{i}_conv for
i = 1..4, then outc, so that a reference ``.pth.tar`` loads by position.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from floodgan_tpu_torch.models.layers import BatchNorm2d
from floodgan_tpu_torch.ops.nn_ops import max_pool2d, pad_to_match
from floodgan_tpu_torch.parallel import spatial as spatial_lib


class DoubleConv(nn.Module):
    """(3x3 conv without bias -> BN -> ReLU) twice; ``mid`` channels between
    (0: ``cout``)."""

    def __init__(self, cin: int, cout: int, mid: int = 0):
        super().__init__()
        mid = mid or cout
        self.conv1 = nn.Conv2d(cin, mid, 3, padding=1, bias=False)
        self.norm1 = BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, cout, 3, padding=1, bias=False)
        self.norm2 = BatchNorm2d(cout)
        self.spatial = None  # a spatial group: x holds this rank's rows (models.layers.set_spatial_mesh)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor, layer: str) -> torch.Tensor:
        if self.spatial is None:
            return conv(x)
        return spatial_lib.conv2d_rows(x, conv, 1, 1, self.spatial, layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.norm1(self._conv(self.conv1, x, "DoubleConv conv1")))
        return torch.relu(self.norm2(self._conv(self.conv2, h, "DoubleConv conv2")))


def align_corners_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True)``
    (floodgan_tpu/models/unet.py:146-165)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class UNet(nn.Module):
    def __init__(self, n_channels: int = 3, n_classes: int = 1, bilinear: bool = False):
        super().__init__()
        self.bilinear = bilinear
        factor = 2 if bilinear else 1
        self.inc = DoubleConv(n_channels, 64)
        self.down1 = DoubleConv(64, 128)
        self.down2 = DoubleConv(128, 256)
        self.down3 = DoubleConv(256, 512)
        self.down4 = DoubleConv(512, 1024 // factor)
        in_ch = 1024 // factor
        for i, (skip_ch, out_ch) in enumerate(
            [(512, 512 // factor), (256, 256 // factor), (128, 128 // factor), (64, 64)], start=1
        ):
            if bilinear:
                # torch Up(in_channels=2*in_ch) uses mid = in_ch
                # (reference model_architectures.py:569)
                setattr(self, f"up{i}_conv", DoubleConv(skip_ch + in_ch, out_ch, mid=in_ch))
            else:
                setattr(self, f"up{i}_upconv", nn.ConvTranspose2d(in_ch, in_ch // 2, 2, stride=2))
                setattr(self, f"up{i}_conv", DoubleConv(skip_ch + in_ch // 2, out_ch))
            in_ch = out_ch
        self.outc = nn.Conv2d(64, n_classes, 1)
        self.spatial = None  # a spatial group: x holds this rank's rows (models.layers.set_spatial_mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) image -> (N, n_classes, H, W) logits (on a spatial
        group, this rank's rows of each)."""
        sp = self.spatial
        if sp is not None:
            spatial_lib.check_unet_rows(x.shape[2])
        x1 = self.inc(x)
        x2 = self.down1(max_pool2d(x1))
        x3 = self.down2(max_pool2d(x2))
        x4 = self.down3(max_pool2d(x3))
        h = self.down4(max_pool2d(x4))
        for i, skip in enumerate((x4, x3, x2, x1), start=1):
            if self.bilinear and sp is not None:
                h = spatial_lib.bilinear_2x_rows(h, h.shape[2] * sp.size, sp, f"up{i} (bilinear 2x)")
            elif self.bilinear:
                h = align_corners_bilinear_2x(h)
            else:
                h = getattr(self, f"up{i}_upconv")(h)
            h = torch.cat([skip, pad_to_match(h, skip.shape[2], skip.shape[3])], dim=1)
            h = getattr(self, f"up{i}_conv")(h)
        return self.outc(h)
