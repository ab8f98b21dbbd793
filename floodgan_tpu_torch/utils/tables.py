"""The metric tables of the evaluators and the comparison, without pandas.

The JAX package builds pandas DataFrames, prints them and writes them with
``to_csv``.  The writers here write the same files: each float as Python's
``repr``, NaN as an empty cell.

- ``write_metric_csv``: one row, ``pd.DataFrame([(k, v), ...]).set_index(0)
  .transpose()``, a header row of an empty cell and the metric names, then
  the row label ``1`` and the values.
- ``write_indexed_csv``: one row per label under a named index,
  ``pd.DataFrame({label: row}).transpose()`` with ``index.name`` set (the
  comparison's averaged table, index ``Model``).
- ``write_records_csv``: a list of records with no index,
  ``pd.DataFrame(records).to_csv(index=False)`` (the comparison's grouped
  table); a cell may be a string.
"""

from __future__ import annotations

import csv
import math
from typing import Mapping, Sequence


def _cell(v) -> str:
    if isinstance(v, str):
        return v
    v = float(v)
    return "" if math.isnan(v) else repr(v)


def _write(path: str, header: Sequence[str], rows: Sequence[Sequence]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(header))
        w.writerows([_cell(v) for v in row] for row in rows)


def write_metric_csv(path: str, row: Mapping[str, float]) -> None:
    _write(path, [""] + list(row), [["1", *row.values()]])


def write_indexed_csv(path: str, rows: Mapping[str, Mapping[str, float]], index_name: str) -> None:
    columns = list(next(iter(rows.values())))
    _write(path, [index_name] + columns, [[label] + [row[c] for c in columns] for label, row in rows.items()])


def write_records_csv(path: str, records: Sequence[Mapping]) -> None:
    columns = list(records[0])
    _write(path, columns, [[r[c] for c in columns] for r in records])


def print_table(row: Mapping[str, float]) -> None:
    """The row as two aligned lines, names over values."""
    print_rows({"1": row}, "0")


def print_rows(rows: Mapping[str, Mapping[str, float]], corner: str = "") -> None:
    """Labelled rows under one header line, each column right-aligned."""
    columns = list(next(iter(rows.values())))
    text = {label: ["NaN" if math.isnan(float(row[c])) else f"{float(row[c]):.6g}" for c in columns]
            for label, row in rows.items()}
    widths = [max([len(c)] + [len(t[i]) for t in text.values()]) for i, c in enumerate(columns)]
    lw = max([len(corner)] + [len(label) for label in rows])
    print(corner.ljust(lw) + "  " + "  ".join(c.rjust(n) for c, n in zip(columns, widths)))
    for label, cells in text.items():
        print(label.ljust(lw) + "  " + "  ".join(v.rjust(n) for v, n in zip(cells, widths)))
