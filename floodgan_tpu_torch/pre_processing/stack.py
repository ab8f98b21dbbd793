"""Offline ETL stages 2-3: raster normalisation and the 9-channel input stack.

The port of floodgan_tpu/pre_processing/stack.py, in numpy alone, with the
same arithmetic: the reference's DEM render (pre_processing/
data_pre_processing.py:198-205), river and flow renders (:249-296), stack
assembly and cloud masks (:300-420).  It defines the channel order that the
whole runtime reads:

  0-2 pre-flood RGB (/255), 3 DEM, 4 flow accumulation, 5 river distance,
  6-8 OSM map (/255).

TIFFs are written through the port's own codec (``data/tiff.py``).
"""

from __future__ import annotations

import os

import numpy as np

from floodgan_tpu_torch.data import tiff

CHANNELS = {
    "rgb": slice(0, 3),
    "dem": 3,
    "flow": 4,
    "river": 5,
    "map": slice(6, 9),
}


def render_dem(dem: np.ndarray, resolution: str = "30m") -> np.ndarray:
    """(x - min) / 100; a 1 m DEM (``"01m"``) clamps negatives to 0 first."""
    dem = dem.astype(np.float32)
    if resolution == "01m":
        dem = np.maximum(dem, 0.0)
    return (dem - dem.min()) / 100.0


def render_river_distance(raster: np.ndarray) -> np.ndarray:
    """/255."""
    return raster.astype(np.float32) / 255.0


def render_flow_accumulation(raster: np.ndarray) -> np.ndarray:
    """/5.5 of the log-scaled flow accumulation."""
    return raster.astype(np.float32) / 5.5


def _unit_rgb(rgb: np.ndarray) -> np.ndarray:
    """f32; divided by 255 when its maximum is over 1.5 (a uint8-range
    image), else taken as already in [0, 1]."""
    rgb = rgb.astype(np.float32)
    return rgb / 255.0 if rgb.max() > 1.5 else rgb


def create_input_stack(
    pre_rgb: np.ndarray,     # (H, W, 3) uint8 or float
    dem: np.ndarray,         # (H, W) or (H, W, C): the channel mean is taken
    flow: np.ndarray,        # (H, W)
    river: np.ndarray,       # (H, W)
    osm: np.ndarray,         # (H, W, 3+): the first 3 channels are used
) -> np.ndarray:
    """The (H, W, 9) float32 input stack: pre-RGB/255, the DEM's channel
    mean, flow, river, OSM-RGB/255.  Raises ``ValueError`` when the DEM,
    flow or river raster is not the image's height and width."""
    h, w = pre_rgb.shape[:2]
    rgb = _unit_rgb(pre_rgb)
    if dem.ndim == 3:
        dem = dem.mean(axis=2)
    osm_rgb = _unit_rgb(osm[:, :, :3])
    for name, arr in (("dem", dem), ("flow", flow), ("river", river)):
        if arr.shape[:2] != (h, w):
            raise ValueError(f"{name} raster shape {arr.shape[:2]} != image {h, w}")
    return np.concatenate(
        [
            rgb,
            dem.astype(np.float32)[:, :, None],
            flow.astype(np.float32)[:, :, None],
            river.astype(np.float32)[:, :, None],
            osm_rgb,
        ],
        axis=2,
    ).astype(np.float32)


def create_output(post_rgb: np.ndarray) -> np.ndarray:
    """The post-disaster RGB target: float32, /255 for a uint8-range image,
    its first 3 channels."""
    return _unit_rgb(post_rgb)[:, :, :3]


def apply_masks(image: np.ndarray, cloud_mask: np.ndarray) -> np.ndarray:
    """``image`` times a (H, W) or (H, W, 1) 0/1 cloud mask, in every
    channel, in ``image``'s dtype."""
    if cloud_mask.ndim == 2:
        cloud_mask = cloud_mask[:, :, None]
    return (image * cloud_mask.astype(image.dtype)).astype(image.dtype)


def write_dataset_pair(
    out_dir: str,
    image_name: str,
    dem_resolution: str,
    input_stack: np.ndarray,
    output_image: np.ndarray,
) -> None:
    """Write ``dataset_input/{image}_{res}.tif`` and
    ``dataset_output/{image}.tif`` under ``out_dir``, as float32: the names
    the data pipeline reads."""
    os.makedirs(os.path.join(out_dir, "dataset_input"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "dataset_output"), exist_ok=True)
    tiff.imwrite(
        os.path.join(out_dir, "dataset_input", f"{image_name}_{dem_resolution}.tif"),
        input_stack.astype(np.float32),
    )
    tiff.imwrite(
        os.path.join(out_dir, "dataset_output", f"{image_name}.tif"),
        output_image.astype(np.float32),
    )
