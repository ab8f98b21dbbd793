"""Dataset split resolution over the metadata CSVs, without pandas.

The port of floodgan_tpu/data/splits.py on the stdlib ``csv`` module,
sample for sample: the flood subsets (a country, a disaster, ``all``, and
the special ``harveyflorence`` / ``harveyonflorence`` / ``testing``) and
the masks subsets (a country), the same row order, and the same pinned
shuffles.  pandas' ``df.sample(frac=1, random_state=47)`` and
``df.sample(n=50, random_state=47)`` take rows in the order of
``np.random.RandomState(47).permutation(len(df))`` (its first n), and so
does this module.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

_COUNTRIES = ("usa", "india")
_DISASTERS = (
    "hurricane-harvey",
    "hurricane-florence",
    "midwest-flooding",
    "nepal-flooding",
)
SHUFFLE_SEED = 47


@dataclasses.dataclass(frozen=True)
class FloodSample:
    file_name: str      # "{image}_{dem}.tif" under dataset_input/
    version: str        # "original" | "flipped"
    crop_index: int     # 0 when crop is None

    @property
    def image_name(self) -> str:
        return self.file_name[:-8]  # strip "_{res}.tif" (reference data.py:61)


def _metadata_csv(name: str, metadata_dir: Optional[str]) -> str:
    base = metadata_dir if metadata_dir is not None else "metadata"
    return os.path.join(base, name)


def _read_rows(path: str) -> List[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _sample(rows: List[dict], n: int) -> List[dict]:
    """pandas ``df.sample(n=n, random_state=47)`` without replacement."""
    if n > len(rows):
        raise ValueError("Cannot take a larger sample than population when 'replace=False'")
    order = np.random.RandomState(SHUFFLE_SEED).permutation(len(rows))[:n]
    return [rows[i] for i in order]


def _swap_split_for_transfer(rows, train_disasters, eval_disaster, flip_train_tests):
    """Train on some disasters (their test rows, flipped, added to train),
    validate *and* test on another, dropping flipped eval rows.  Row order
    is pandas': the rows, the flipped copies, then the test copies."""
    extra = [dict(r, version="flipped") for r in rows
             if r["disaster"] in flip_train_tests and r["split"] == "test"]
    rows = [dict(r) for r in rows] + extra
    for r in rows:
        if r["disaster"] in train_disasters:
            r["split"] = "train"
    for r in rows:
        if r["disaster"] == eval_disaster:
            r["split"] = "validation"
    as_test = [dict(r, split="test") for r in rows if r["disaster"] == eval_disaster]
    return [r for r in rows + as_test
            if not (r["split"] in ("test", "validation") and r["version"] == "flipped")]


def determine_flood_dataset(
    subset: str,
    dem: str,
    crop: Optional[int] = None,
    metadata_dir: Optional[str] = None,
) -> Dict[str, List[FloodSample]]:
    table = _read_rows(_metadata_csv("dataset_split.csv", metadata_dir))
    key = subset.lower()

    if key in _COUNTRIES:
        rows = [r for r in table if r["country"] == key]
    elif key in _DISASTERS:
        rows = [r for r in table if r["disaster"] == key]
    elif key == "harveyflorence":
        rows = _swap_split_for_transfer(
            [r for r in table if r["country"] == "usa"],
            train_disasters=("hurricane-harvey", "hurricane-florence"),
            eval_disaster="midwest-flooding",
            flip_train_tests=("hurricane-harvey", "hurricane-florence"),
        )
    elif key == "harveyonflorence":
        rows = _swap_split_for_transfer(
            [r for r in table if r["disaster"] in ("hurricane-harvey", "hurricane-florence")],
            train_disasters=("hurricane-harvey",),
            eval_disaster="hurricane-florence",
            flip_train_tests=("hurricane-harvey",),
        )
    elif key == "testing":
        # 50 deterministic Harvey originals (reference data.py:117-120).
        rows = _sample([r for r in table if r["disaster"] == "hurricane-harvey"
                        and r["version"] == "original"], 50)
    elif key == "all":
        rows = list(table)
    else:
        raise NotImplementedError("Unrecognised dataset subset name")

    if dem not in ("best", "same"):
        raise NotImplementedError("Unrecognised DEM name - provide 'best' or 'same'")

    rows = _sample(rows, len(rows))
    n_crops = crop if crop else 1
    out: Dict[str, List[FloodSample]] = {}
    for split_name in ("train", "validation", "test"):
        split_rows = [r for r in rows if r["split"] == split_name]
        # All crop-0 rows, then all crop-1 rows, ... (reference data.py:131-139).
        out[split_name] = [
            FloodSample(f"{r['image']}_{r[f'{dem}_DEM']}.tif", r["version"], ci)
            for ci in range(n_crops)
            for r in split_rows
        ]
    return out


@dataclasses.dataclass(frozen=True)
class MaskSample:
    file_name: str  # the same name under masks_input/ and masks_output/
    version: str


def determine_masks_dataset(subset: str, train_on_all: bool, metadata_dir: Optional[str] = None):
    """(train, validation, test) mask samples of a country, in the CSV's
    row order (the reference does not shuffle them); (all, None, None) with
    ``train_on_all`` (reference models/data.py:203-218)."""
    table = _read_rows(_metadata_csv("masks_metadata.csv", metadata_dir))
    key = subset.lower()
    if key not in _COUNTRIES:
        raise NotImplementedError("Unrecognised dataset subset name")
    rows = [r for r in table if r["country"] == key]

    def to_samples(rs):
        return [MaskSample(r["image"], r["version"]) for r in rs]

    if train_on_all:
        return to_samples(rows), None, None
    return tuple(to_samples([r for r in rows if r["split"] == s]) for s in ("train", "validation", "test"))
