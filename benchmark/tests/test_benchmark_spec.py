"""``BENCHMARK.json`` and the files it names: every cell, configuration,
mix, loop and metric reader is found by name; a cell added as files
alone is picked up with no edit; the import guard compares whole
top-level names."""

from __future__ import annotations

import json
import re
import shutil
from types import SimpleNamespace

import pytest

from benchlib import counts, guard, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key], (e["name"], key)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m["name"]
        assert set(m.get("workloads", CELLS)) <= set(CELLS), m["name"]
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}, m["name"]
        for cell in m["workloads"]:
            moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert spec.applies(moved, cell), (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%", m["name"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_is_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    assert (c.bench_dir / "loops" / f"{c.params['loop']}.py").is_file()
    assert spec.loop(c).run
    assert c.config["reduced"] == []
    assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_every_metric_reader_finds_nothing_without_a_run():
    ctx = SimpleNamespace(config=spec.load_cell(CELLS[0]).config, params={}, window={}, counters={}, trace=None,
                          peak_tflops=lambda precision: None, hbm_bytes_per_s=3.35e12)
    for m in BENCH["per_layer"]:
        assert spec.reader(m["name"])(ctx) is None, m["name"]


def test_every_configuration_counts_its_work():
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert counts.work(cfg, "train").flops > counts.work(cfg, "serve").flops > 0


def test_a_cell_added_as_files_is_picked_up(tmp_path):
    """A later cell: a workload entry, its file and a new mix, all data, in a
    copy of the benchmark; no file that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / spec.BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "pairedattention.serve_bursts", "config": "pairedattention",
                               "traffic": "tiles_bursts", "chips": 1, "why": "a fixture"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    bdir = root / spec.BENCH_DIR.name
    mix = json.loads((bdir / "traffic" / "tiles_poisson.json").read_text())
    (bdir / "traffic" / "tiles_bursts.json").write_text(json.dumps(dict(mix, max_delay_ms=20.0)))
    (bdir / "workloads" / "pairedattention.serve_bursts.json").write_text(
        json.dumps({"params": {"rate_per_s": 16.0}, "limits": {"answer": 1e-4, "unanswered": 0}}))
    cell = spec.load_cell("pairedattention.serve_bursts", root)
    assert cell.params["rate_per_s"] == 16.0 and cell.params["max_delay_ms"] == 20.0
    assert cell.params["loop"] == "open_loop" and cell.bench_dir == bdir
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}
    assert spec.loop(cell).window


def test_guard_compares_whole_top_level_names():
    names = ["floodgan_tpu_torch", "floodgan_tpu_torch.serve", "jaxtyping", "flaxen", "numpy"]
    assert guard.offending(names) == []
    assert guard.offending(names + ["floodgan_tpu", "jax.numpy", "jaxlib", "flax.linen", "floodgan_tpu.ops"]) == \
        ["flax.linen", "floodgan_tpu", "floodgan_tpu.ops", "jax.numpy", "jaxlib"]


def test_nothing_of_the_benchmark_imports_jax():
    """Every module of the benchmark and the reference, imported here, loads
    no forbidden module; the reference imports nothing of the program."""
    for path in sorted(spec.BENCH_DIR.rglob("*.py")):
        text = path.read_text()
        assert not re.search(r"^\s*(from|import)\s+(jax|jaxlib|flax|floodgan_tpu)\b(?!_torch)", text, re.M), path
        if path.parent.name == "reference":
            assert "floodgan_tpu_torch" not in text, path
