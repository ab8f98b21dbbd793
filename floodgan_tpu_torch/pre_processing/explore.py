"""Metadata exploration, without pandas: the port of
floodgan_tpu/pre_processing/explore.py (image counts per disaster, split
and version; an optional map of the image extents, which needs plotly).
"""

from __future__ import annotations

import csv
from typing import List, Optional


def _read_rows(path: str) -> List[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def summarize_dataset_split(csv_path: str = "metadata/dataset_split.csv") -> List[dict]:
    """Image counts per (disaster, split, version), in sorted key order as
    pandas' ``groupby(...).size()`` gives them: a list of dicts with those
    three keys and ``images``.  Prints them as a table."""
    counts: dict = {}
    for r in _read_rows(csv_path):
        key = (r["disaster"], r["split"], r["version"])
        counts[key] = counts.get(key, 0) + 1
    summary = [dict(disaster=d, split=s, version=v, images=n) for (d, s, v), n in sorted(counts.items())]
    columns = ("disaster", "split", "version", "images")
    cells = [columns] + [tuple(str(r[c]) for c in columns) for r in summary]
    widths = [max(len(row[i]) for row in cells) for i in range(len(columns))]
    for row in cells:
        print(" ".join(v.rjust(w) for v, w in zip(row, widths)))
    return summary


def plot_extents_map(metadata_csv: str = "metadata/metadata.csv", out_html: Optional[str] = None):
    """A scatter map of the image centres, coloured by disaster (needs
    plotly); written to ``out_html`` when given."""
    try:
        import plotly.express as px
    except ImportError as e:  # plotly is not a dependency of the runtime
        raise ImportError("plot_extents_map requires plotly (pip install plotly)") from e
    rows = _read_rows(metadata_csv)
    data = {
        "lat": [(float(r["y_min"]) + float(r["y_max"])) / 2 for r in rows],
        "lon": [(float(r["x_min"]) + float(r["x_max"])) / 2 for r in rows],
        "disaster": [r["disaster"] for r in rows],
        "image": [r["image"] for r in rows],
    }
    fig = px.scatter_geo(data, lat="lat", lon="lon", color="disaster", hover_name="image")
    if out_html:
        fig.write_html(out_html)
    return fig
