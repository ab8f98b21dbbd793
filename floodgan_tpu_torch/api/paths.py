"""Metadata-encoded artifact paths (reference models/model.py:241-258,
models/segmentation_model.py:94-105, models/group.py:96-109): filenames
carry model, epoch, topography, dataset, transform, and timestamp, so
artifacts are self-labelling and ModelsGroup can infer the architecture
from a checkpoint's name prefix.

A copy of floodgan_tpu/api/paths.py (stdlib only)."""

from __future__ import annotations

import os
from datetime import datetime
from typing import Optional

FILE_TYPES = {"image": ".png", "figure": ".png", "model": ".ckpt", "metric": ".csv"}


def timestamp() -> str:
    return str(datetime.now())[:-7].replace(" ", "-").replace(":", "-")


def ensure_parent(path: str) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def model_artifact_path(
    data_path: str,
    save_type: str,
    model_pretty: str,
    info: str,
    epoch: int,
    topography: Optional[str],
    identity_tag: str,
    dataset_subset: str,
    dataset_dem: str,
    resize: Optional[int],
    crop: Optional[int],
) -> str:
    file_type = FILE_TYPES[save_type]
    path = (
        f"{data_path}/{save_type}s/"
        f"{model_pretty}_{info}_epoch{epoch}_"
        f"{topography}Topography_{identity_tag}_"
        f"{dataset_subset}Data_{dataset_dem}DEM_"
        f"resize{resize}_crop{crop}_"
        f"date{timestamp()}{file_type}"
    )
    return ensure_parent(path.replace("__", "_"))


def seg_artifact_path(data_path: str, save_type: str, epoch: int, dataset_subset: str) -> str:
    file_type = FILE_TYPES[save_type]
    path = (
        f"{data_path}/{save_type}s/"
        f"SegmentationModel_epoch{epoch}_"
        f"{dataset_subset}Data_date{timestamp()}{file_type}"
    )
    return ensure_parent(path)


def group_artifact_path(
    data_path: str,
    save_type: str,
    compare: str,
    info: str,
    topography,
    dataset_subset: str,
    dataset_dem: str,
    resize,
    crop,
) -> str:
    file_type = ".png" if save_type == "image" else ".csv"
    path = (
        f"{data_path}/{save_type}s/"
        f"{compare}_comparison_{info}_{topography}Topography_"
        f"{dataset_subset}Data_{dataset_dem}DEM_"
        f"resize{resize}_crop{crop}_"
        f"date{timestamp()}{file_type}"
    )
    return ensure_parent(path.replace("__", "_"))
