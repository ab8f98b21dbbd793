"""Offline ETL stage 1: the metadata tables, without pandas.

The port of floodgan_tpu/pre_processing/metadata.py on the stdlib: the
geo-extents of the pre-disaster GeoTIFFs (read from their tags, no raster
decoded), the 80/10/10 split per disaster with flipped copies of the
training and validation rows, and the masks split.  Each function returns
its rows as a list of dicts in the JAX package's row and column order, and
writes them, when given a path, byte for byte as pandas'
``to_csv(index=False)`` writes that DataFrame (``utils/tables.py``: each
float as its ``repr``).

pandas' ``df.sample(frac=1, random_state=seed)`` takes the rows in the
order of ``np.random.RandomState(seed).permutation(len(df))``, and
``groupby`` visits its keys sorted; the split does both.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from floodgan_tpu_torch.data import tiff
from floodgan_tpu_torch.utils.tables import write_records_csv

_COUNTRY = {
    "hurricane-harvey": "usa",
    "hurricane-florence": "usa",
    "midwest-flooding": "usa",
    "nepal-flooding": "india",
}

SPLIT_COLUMNS = ("image", "best_DEM", "same_DEM", "version", "split", "disaster", "country")
MASKS_COLUMNS = ("image", "split", "version", "country")


def _write_csv(path: str, rows: List[dict], columns: Sequence[str]) -> None:
    if rows:
        write_records_csv(path, rows)
    else:  # pandas writes an empty frame as its header line alone
        with open(path, "w") as f:
            f.write(",".join(columns) + "\n")


def _wkt_polygon(x_min: float, y_min: float, x_max: float, y_max: float) -> str:
    """The bounding box as a closed WKT ring (the first point repeated
    last), in the double parentheses WKT readers require."""
    return (
        f"POLYGON (({x_min} {y_min}, {x_min} {y_max}, "
        f"{x_max} {y_max}, {x_max} {y_min}, {x_min} {y_min}))"
    )


def _first(value) -> int:
    return int(value[0]) if isinstance(value, (list, tuple)) else int(value)


def create_metadata(image_dir: str, out_csv: str, extend_degrees: float = 0.002) -> List[dict]:
    """The geo-extent row of every ``.tif``/``.tiff`` in ``image_dir``, in
    sorted file order: image, disaster, x_min, y_min, x_max, y_max,
    x_max_extended and the WKT polygon, from the GeoTIFF's ModelPixelScale
    (33550) and ModelTiepoint (33922) and its width and height tags.
    Written to ``out_csv``."""
    rows = []
    for name in sorted(os.listdir(image_dir)):
        if not name.endswith((".tif", ".tiff")):
            continue
        path = os.path.join(image_dir, name)
        info = tiff.read_tags(path)
        w, h = _first(info[256]), _first(info[257])
        x_min, y_max, px_w, px_h = tiff.geotransform(path)
        x_max = x_min + w * px_w
        y_min = y_max - h * px_h
        image = os.path.splitext(name)[0]
        rows.append(dict(
            image=image,
            disaster=image.split("_")[0],
            x_min=x_min,
            y_min=y_min,
            x_max=x_max,
            y_max=y_max,
            x_max_extended=x_max + extend_degrees,
            polygon=_wkt_polygon(x_min, y_min, x_max, y_max),
        ))
    _write_csv(out_csv, rows, ())
    return rows


def _assign_splits(rows: List[dict], seed: int) -> List[dict]:
    """``rows`` shuffled as pandas' ``sample(frac=1, random_state=seed)``
    shuffles them, the first ``int(n * 0.8)`` marked train, the next
    ``int(n * 0.1)`` validation, the rest test."""
    n = len(rows)
    order = np.random.RandomState(seed).permutation(n)
    n_train, n_val = int(n * 0.8), int(n * 0.1)
    out = []
    for pos, i in enumerate(order):
        split = "train" if pos < n_train else "validation" if pos < n_train + n_val else "test"
        out.append(dict(rows[i], split=split))
    return out


def create_dataset_split_metadata(
    images: Sequence[str],
    dems: Optional[Mapping[str, Tuple[str, str]]] = None,
    out_csv: Optional[str] = None,
    seed: int = 47,
) -> List[dict]:
    """The 80/10/10 train/validation/test split of each disaster (the part
    of the image name before the first ``_``), shuffled with ``seed``, and a
    flipped copy of every train and validation row after the originals.

    ``dems`` maps an image name to its ``(best_DEM, same_DEM)``
    resolutions (the JAX package takes a DataFrame indexed by image with
    those two columns); images it does not hold get 30m/30m.  Columns:
    image, best_DEM, same_DEM, version, split, disaster, country."""
    rows = []
    for image in images:
        disaster = image.split("_")[0]
        best, same = dems[image] if dems is not None and image in dems else ("30m", "30m")
        rows.append(dict(image=image, best_DEM=best, same_DEM=same, disaster=disaster,
                         country=_COUNTRY.get(disaster, "usa")))
    groups: Dict[str, List[dict]] = {}
    for r in rows:
        groups.setdefault(r["disaster"], []).append(r)
    originals = [dict(r, version="original") for d in sorted(groups) for r in _assign_splits(groups[d], seed)]
    flipped = [dict(r, version="flipped") for r in originals if r["split"] in ("train", "validation")]
    out = [{c: r[c] for c in SPLIT_COLUMNS} for r in originals + flipped]
    if out_csv:
        _write_csv(out_csv, out, SPLIT_COLUMNS)
    return out


def create_masks_metadata(
    images: Sequence[str], out_csv: Optional[str] = None, seed: int = 47
) -> List[dict]:
    """The masks split: all images shuffled with ``seed`` and split
    80/10/10, with a flipped copy of every train row after the originals.
    The country is india for a name holding "nepal", else usa.  Columns:
    image, split, version, country."""
    rows = [dict(image=img, country="india" if "nepal" in img else "usa") for img in images]
    originals = [dict(r, version="original") for r in _assign_splits(rows, seed)]
    flipped = [dict(r, version="flipped") for r in originals if r["split"] == "train"]
    out = [{c: r[c] for c in MASKS_COLUMNS} for r in originals + flipped]
    if out_csv:
        _write_csv(out_csv, out, MASKS_COLUMNS)
    return out
