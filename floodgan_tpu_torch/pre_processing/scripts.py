"""Offline ETL: the emitters of the external tools' scripts.

A copy of floodgan_tpu/pre_processing/scripts.py, which the port cannot
import.  The reference drives GDAL, osmium, Maperitive and the
OpenTopography API through shell scripts and URLs (reference
pre_processing/data_pre_processing.py:157-243).  These emitters write the
same text without needing the tools (or a network) to emit it; run the
scripts on a machine with GDAL and osmium installed.
"""

from __future__ import annotations

import os
from typing import Iterable, Mapping

OPENTOPO_DATASETS = {"01m": "USGS1m", "10m": "USGS10m", "30m": "COP30"}


def dem_download_url(
    dataset: str, x_min: float, y_min: float, x_max: float, y_max: float, api_key: str
) -> str:
    """OpenTopography globaldem/usgsdem request URL (reference :157-180)."""
    ds = OPENTOPO_DATASETS.get(dataset, dataset)
    endpoint = "usgsdem" if ds.startswith("USGS") else "globaldem"
    return (
        f"https://portal.opentopography.org/API/{endpoint}?datasetName={ds}"
        f"&south={y_min}&north={y_max}&west={x_min}&east={x_max}"
        f"&outputFormat=GTiff&API_Key={api_key}"
    )


def emit_dem_projection_script(
    dem_files: Iterable[str], out_dir: str, script_path: str
) -> str:
    """gdalwarp EPSG:4326 reprojection commands (reference :182-194)."""
    lines = []
    for f in dem_files:
        name = os.path.basename(f)
        lines.append(
            f'gdalwarp -t_srs EPSG:4326 "{f}" "{os.path.join(out_dir, name)}"'
        )
    return _write_script(script_path, lines)


def emit_osm_extract_script(
    extents: Mapping[str, tuple], pbf_path: str, out_dir: str, script_path: str
) -> str:
    """Per-image osmium bbox extraction commands (reference :209-214).
    ``extents`` maps image name -> (x_min, y_min, x_max, y_max)."""
    lines = []
    for image, (x_min, y_min, x_max, y_max) in extents.items():
        out = os.path.join(out_dir, f"{image}.osm.pbf")
        lines.append(
            f'osmium extract -b {x_min},{y_min},{x_max},{y_max} "{pbf_path}" -o "{out}"'
        )
    return _write_script(script_path, lines)


def emit_maperitive_script(
    images: Iterable[str], pbf_dir: str, out_dir: str, script_path: str,
    height: int = 1024,
) -> str:
    """Maperitive render mscript, OSMNoText ruleset (reference :218-229)."""
    lines = ["use-ruleset alias=OSMNoText"]
    for image in images:
        lines += [
            f'load-source "{os.path.join(pbf_dir, image)}.osm.pbf"',
            "zoom-bounds",
            f'export-bitmap file="{os.path.join(out_dir, image)}.png" height={height}',
            "clear-map",
        ]
    return _write_script(script_path, lines)


def emit_georeference_script(
    extents: Mapping[str, tuple], png_dir: str, out_dir: str, script_path: str,
    size: int = 1024,
) -> str:
    """gdal_translate GCP anchoring + gdalwarp with alpha (reference
    :233-243).  ``size`` is the rendered PNG's pixel extent and MUST match
    the height passed to :func:`emit_maperitive_script` (the reference
    renders square 1024px tiles; Maperitive preserves aspect ratio, so
    non-square bboxes need per-image pixel sizes — out of scope here, as
    in the reference)."""
    lines = []
    for image, (x_min, y_min, x_max, y_max) in extents.items():
        png = os.path.join(png_dir, f"{image}.png")
        tmp = os.path.join(out_dir, f"{image}_gcp.tif")
        out = os.path.join(out_dir, f"{image}.tif")
        lines.append(
            f'gdal_translate -of GTiff -a_srs EPSG:4326 '
            f'-gcp 0 0 {x_min} {y_max} -gcp {size} 0 {x_max} {y_max} '
            f'-gcp {size} {size} {x_max} {y_min} "{png}" "{tmp}"'
        )
        lines.append(f'gdalwarp -t_srs EPSG:4326 -dstalpha "{tmp}" "{out}"')
    return _write_script(script_path, lines)


def emit_rasterize_river_script(
    extents: Mapping[str, tuple], gpkg_path: str, out_dir: str, script_path: str,
    size: int = 1024, attribute: str = "distance",
) -> str:
    """gdal_rasterize of the river-distance geopackage per image bbox
    (reference :249-257)."""
    lines = []
    for image, (x_min, y_min, x_max, y_max) in extents.items():
        out = os.path.join(out_dir, f"{image}.tif")
        lines.append(
            f'gdal_rasterize -a {attribute} -ts {size} {size} '
            f'-te {x_min} {y_min} {x_max} {y_max} "{gpkg_path}" "{out}"'
        )
    return _write_script(script_path, lines)


def emit_flow_crop_script(
    extents: Mapping[str, tuple], regional_maps: Mapping[str, str],
    image_regions: Mapping[str, str], out_dir: str, script_path: str,
    size: int = 1024,
) -> str:
    """gdal_translate bbox crops of the per-region flow-accumulation maps
    (reference :271-287).  ``image_regions`` maps image -> region key of
    ``regional_maps``."""
    lines = []
    for image, (x_min, y_min, x_max, y_max) in extents.items():
        src = regional_maps[image_regions[image]]
        out = os.path.join(out_dir, f"{image}.tif")
        lines.append(
            f'gdal_translate -projwin {x_min} {y_max} {x_max} {y_min} '
            f'-outsize {size} {size} "{src}" "{out}"'
        )
    return _write_script(script_path, lines)


def _write_script(path: str, lines: Iterable[str]) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
