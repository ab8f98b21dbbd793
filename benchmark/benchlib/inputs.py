"""The inputs of a cell, made on the device from the seed.

Each image is a smooth random field per channel (an 8x8 grid of uniform
draws, bilinearly upsampled) with its own contrast, offset and noise
level, clamped to [-1, 1], the range of the program's normalised
stacks.  Images differ from one another as much as tiles of a region do,
so a batch is not a repeat of one image's statistics.  The inputs come
from a generator of their own (seed + 2**40), apart from the weights'.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

INPUT_STREAM = 2 ** 40


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) + INPUT_STREAM)


def images(g: torch.Generator, n: int, channels: int, size: int, device) -> torch.Tensor:
    """(n, size, size, channels) f32 in [-1, 1], NHWC."""
    def u(*shape):
        return torch.rand(shape, generator=g, device=device)

    field = F.interpolate(u(n, channels, 8, 8) * 2 - 1, size=(size, size), mode="bilinear", align_corners=False)
    contrast, offset, noise = u(n, 1, 1, 1) * 0.8 + 0.2, u(n, 1, 1, 1) - 0.5, u(n, 1, 1, 1) * 0.45 + 0.05
    noisy = field.mul_(contrast).add_(offset).add_(torch.randn((n, channels, size, size), generator=g,
                                                               device=device).mul_(noise))
    return noisy.clamp_(-1.0, 1.0).permute(0, 2, 3, 1).contiguous()


def train_pool(config: dict, batches: int, seed: int, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``batches`` distinct (input stack, target RGB) batches, NHWC, drawn
    batch after batch: the first batches do not depend on how many."""
    g = generator(seed, device)
    b, s = config["batch"], config["image_size"]
    return [(images(g, b, config["input_channels"], s, device), images(g, b, 3, s, device))
            for _ in range(batches)]


def tile_pool(config: dict, tiles: int, seed: int, device) -> torch.Tensor:
    """``tiles`` distinct normalised input stacks, (tiles, S, S, C)."""
    return images(generator(seed, device), tiles, config["input_channels"], config["image_size"], device)
