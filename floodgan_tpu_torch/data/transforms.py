"""Batched input transforms, twins of floodgan_tpu/data/transforms.py.

flip -> channel slice -> bicubic-AA resize -> quadrant crop -> normalise to
[-1, 1], on NHWC tensors (the layout of the raw stacks and of the engine's
public API), on whatever device the inputs are on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from floodgan_tpu_torch.ops.resize import resize_bicubic_antialias, shorter_edge_size


def slice_topography(x: torch.Tensor, topography: Optional[str]) -> torch.Tensor:
    """Channel selection on the 9-channel NHWC stack (channel order:
    0-2 RGB, 3 DEM, 4 flow, 5 river, 6-8 map)."""
    if topography == "all":
        return x
    if topography == "dem":
        return x[..., :4]
    if topography == "flow":
        return torch.cat([x[..., :3], x[..., 4:5]], dim=-1)
    if topography == "river":
        return torch.cat([x[..., :3], x[..., 5:6]], dim=-1)
    if topography == "map":
        return torch.cat([x[..., :3], x[..., 6:]], dim=-1)
    if topography is None or topography == "none":
        return x[..., :3]
    raise NotImplementedError(f"unknown topography {topography!r}")


def _quadrant_crops(x: torch.Tensor, crop_index, crop: int) -> torch.Tensor:
    """Per-sample quadrant crop: a sqrt(crop) x sqrt(crop) grid of
    floor-divided cells, indexed row-major."""
    _, h, w, _ = x.shape
    nd = int(np.sqrt(crop))
    rs, cs = h // nd, w // nd
    cells = [divmod(int(i), nd) for i in crop_index]
    return torch.stack(
        [img[r * rs:(r + 1) * rs, c * cs:(c + 1) * cs] for img, (r, c) in zip(x, cells)]
    )


def apply_transformations_batch(
    input_stack,    # (B, H, W, 9)
    output_image,   # (B, H, W, 3)
    flip,           # (B,) bool
    crop_index,     # (B,) int
    *,
    topography: Optional[str],
    resize: Optional[int],
    crop: Optional[int],
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched twin of the reference's apply_transformations plus the
    load-time fliplr.  Arrays or tensors in any float dtype; compute is f32
    on ``device`` (default: the input tensor's device, the CPU for arrays)."""
    input_stack = torch.as_tensor(input_stack, device=device).float()
    device = input_stack.device
    output_image = torch.as_tensor(output_image, device=device).float()
    flip = torch.as_tensor(flip, device=device, dtype=torch.bool)[:, None, None, None]
    input_stack = torch.where(flip, input_stack.flip(2), input_stack)
    output_image = torch.where(flip, output_image.flip(2), output_image)

    input_stack = slice_topography(input_stack, topography)

    if resize:
        oh, ow = shorter_edge_size(input_stack.shape[1], input_stack.shape[2], resize)
        input_stack = resize_bicubic_antialias(input_stack, oh, ow)
        output_image = resize_bicubic_antialias(output_image, oh, ow)

    if crop:
        input_stack = _quadrant_crops(input_stack, crop_index, crop)
        output_image = _quadrant_crops(output_image, crop_index, crop)

    # Normalize(mean=0.5, std=0.5) -> [-1, 1].
    return input_stack * 2.0 - 1.0, output_image * 2.0 - 1.0


def denormalize(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1] with clamping."""
    return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0)
