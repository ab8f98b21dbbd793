"""The one-row metric tables of the evaluators, without pandas.

The JAX package builds ``pd.DataFrame([(k, v), ...]).set_index(0).transpose()``,
prints it and writes it with ``to_csv``.  ``write_metric_csv`` writes the
same file: a header row of an empty cell and the metric names, then the
row label ``1`` and the values, each as Python's ``repr`` of the float and
NaN as an empty cell.
"""

from __future__ import annotations

import csv
import math
from typing import Mapping


def _cell(v: float) -> str:
    v = float(v)
    return "" if math.isnan(v) else repr(v)


def write_metric_csv(path: str, row: Mapping[str, float]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + list(row))
        w.writerow(["1"] + [_cell(v) for v in row.values()])


def print_table(row: Mapping[str, float]) -> None:
    """The row as two aligned lines, names over values."""
    cells = [(k, "NaN" if math.isnan(float(v)) else f"{float(v):.6g}") for k, v in row.items()]
    widths = [max(len(k), len(v)) for k, v in cells]
    print("0  " + "  ".join(k.rjust(n) for (k, _), n in zip(cells, widths)))
    print("1  " + "  ".join(v.rjust(n) for (_, v), n in zip(cells, widths)))
