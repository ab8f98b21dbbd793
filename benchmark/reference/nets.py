"""The plain PyTorch reference of the benchmark's networks, on NCHW.

Written from the published description of the two configurations
(Natasha-R/Flood-Prediction-GAN, models/model_architectures.py: the
attention generator and the instance-norm PatchGAN), as functions of a
dict of parameters keyed by the names the configuration files' layer
tables give.  Nothing here imports the program under test or its kernels:
convolutions are ``F.conv2d`` / ``F.conv_transpose2d``, the reflect pads
``F.pad``, the instance norm its two-pass mean and biased variance, the
compose a softmax and a weighted sum.

``quant``, where given, is applied to both operands of every convolution
(``reference.precision``): the control that computes the same networks in
a lower precision.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

EPS = 1e-5           # InstanceNorm2d's default
D_SLOPE = 0.2        # the PatchGAN's leaky ReLU
TRUNK_BLOCKS = 9
MASKS = 10           # nine content images and the background


def conv(params: Params, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0,
         quant: Quant = None) -> torch.Tensor:
    w, b = params[f"{name}.weight"], params[f"{name}.bias"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv_t(params: Params, name: str, x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """The decoder's k3 s2 transposed convolution, which doubles H and W."""
    w, b = params[f"{name}.weight"], params[f"{name}.bias"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv_transpose2d(x, w, b, stride=2, padding=1, output_padding=1)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def instance_norm(x: torch.Tensor, slope: Optional[float] = None,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """InstanceNorm2d without affine parameters (biased variance), then a
    leaky ReLU of ``slope`` (0 is a ReLU; None is none), then + residual."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (x - mean) * torch.rsqrt(var + EPS)
    if slope is not None:
        y = F.leaky_relu(y, slope)
    if residual is not None:
        y = y + residual
    return y


def generator(params: Params, x: torch.Tensor, quant: Quant = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention generator: (N, C, H, W) input stack -> (image (N, 3, H,
    W), background mask (N, H, W)).  The encoder (reflect k7 stem, two
    stride-2 convs), nine residual blocks, a content head of nine tanh RGB
    images and an attention head of ten logits; the output is the softmax-
    weighted sum of the nine images and the input's RGB."""
    h = instance_norm(conv(params, "conv1", reflect_pad(x, 3), quant=quant), 0.0)
    h = instance_norm(conv(params, "conv2", h, 2, 1, quant), 0.0)
    h = instance_norm(conv(params, "conv3", h, 2, 1, quant), 0.0)
    for i in range(TRUNK_BLOCKS):
        block = f"trunk.blocks.{i}"
        y = instance_norm(conv(params, f"{block}.conv1", reflect_pad(h, 1), quant=quant), 0.0)
        h = instance_norm(conv(params, f"{block}.conv2", reflect_pad(y, 1), quant=quant), residual=h)
    c = instance_norm(conv_t(params, "deconv1_content", h, quant), 0.0)
    c = instance_norm(conv_t(params, "deconv2_content", c, quant), 0.0)
    content = torch.tanh(conv(params, "deconv3_content", reflect_pad(c, 3), quant=quant))
    a = instance_norm(conv_t(params, "deconv1_attention", h, quant), 0.0)
    a = instance_norm(conv_t(params, "deconv2_attention", a, quant), 0.0)
    attention = torch.softmax(conv(params, "deconv3_attention", a, quant=quant), dim=1)
    n, _, height, width = content.shape
    images = content.view(n, MASKS - 1, 3, height, width)
    out = (images * attention[:, :MASKS - 1, None]).sum(1) + x[:, :3] * attention[:, MASKS - 1:]
    return out, attention[:, MASKS - 1]


def discriminator(params: Params, x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """The 70x70 PatchGAN with instance norms: C64 (no norm) - C128 - C256
    (k4 s2 p1) - C512 (k4 s1 p1), each leaky 0.2, then a k4 s1 p1 conv to
    one logit map."""
    h = F.leaky_relu(conv(params, "conv0", x, 2, 1, quant), D_SLOPE)
    for n, stride in ((1, 2), (2, 2), (3, 1)):
        h = instance_norm(conv(params, f"conv{n}", h, stride, 1, quant), D_SLOPE)
    return conv(params, "conv4", h, 1, 1, quant)


def denormalize(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1], clamped: the served image."""
    return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)
