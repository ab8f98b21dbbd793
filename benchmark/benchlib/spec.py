"""Finds everything of a cell by its name.

``BENCHMARK.json`` at the root of the checkout names the cell's
configuration (whose file it gives) and its traffic mix.  The rest lies
in files of their own under the benchmark's folder:

- ``traffic/<traffic>.json``: the mix's parameters, among them the
  ``loop`` that reads them (``loops/<loop>.py``);
- ``workloads/<cell>.json``: the cell's own parameters (``params``, laid
  over the mix's) and the ``limits`` of the numbers its check compares;
- ``metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(ctx)`` that returns a number or None.

So a cell, a configuration, a mix or a metric is added by adding files
and entries, and no file that is there changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    params: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}; there are {sorted(e['name'] for e in entries)}")


def applies(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: every cell when it lists
    no workloads."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    bench_dir = root / BENCH_DIR.name
    entry = _by_name(bench["workloads"], name, "workload")
    config = _json(root / _by_name(bench["configs"], entry["config"], "config")["file"])
    mix = _json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    own = _json(bench_dir / "workloads" / f"{name}.json")
    return Cell(
        name=name,
        chips=entry["chips"],
        config=config,
        params={**mix, **own.get("params", {})},
        limits=own["limits"],
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        bench_dir=bench_dir,
    )


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    """The module of the file at ``path`` (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name or f"benchmark_{path.stem}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def loop(cell: Cell) -> ModuleType:
    return load_module(cell.bench_dir / "loops" / f"{cell.params['loop']}.py")


def reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable:
    return load_module(bench_dir / "metrics" / f"{metric}.py", f"benchmark_metric_{metric}").read
