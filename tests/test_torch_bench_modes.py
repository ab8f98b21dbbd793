"""The port's ``bench --mode eval`` and ``--mode pipeline`` against
bench.py's ``run_eval`` and ``run_pipeline``, on the CPU.

- eval at 64^2, batch 2: bench.py's keys, plus ``device``, and its
  ``metric``, ``unit`` and ``includes`` strings (no MS-SSIM below 176^2).
- pipeline: raw 64^2 TIFFs, resized to 32^2, 4 images (8 samples with
  the flipped copies), batch 2, one measured epoch.  Both write their
  fixture from seed 47 into a temporary directory of their own.  The
  lines hold bench.py's keys, plus ``device``; the same ``metric``,
  ``unit`` and ``dataset`` strings (samples, steps per epoch, epochs), the
  same ``post_cache_hit_rate`` (1.0: the post-transform cache serves the
  measured epoch) and ``raw_mb_per_sample``.
- The port's fixture writer against bench.py's, file for file, the CSV
  read back row for row.
"""

import argparse
import csv
import json
import os

import numpy as np
import pytest

from floodgan_tpu_torch.data import tiff
from floodgan_tpu_torch.tools import bench

from test_torch_bench import load_jax_bench
from torch_seg_fixtures import few_torch_threads

ARGS = dict(model="pairedattention", size=32, batch=2, raw_size=64, pipeline_images=4, pipeline_epochs=1,
            dtype="bfloat16", remat=False)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from few_torch_threads()


def test_eval_line_matches_bench_py(tmp_path, monkeypatch, capsys):
    jax_bench = load_jax_bench()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax_bench.run_eval(argparse.Namespace(model="pairedattention", size=64, batch=2, steps=1, warmup=1,
                                          dtype="bfloat16"))
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = bench.main(["--mode", "eval", "--size", "64", "--batch", "2", "--steps", "1", "--warmup", "1",
                      "--device", "cpu"])
    assert list(got) == list(want) + ["device"]
    for key in ("metric", "unit", "vs_baseline", "includes"):
        assert got[key] == want[key], key
    assert "/MS-SSIM" not in got["includes"]  # 64 < 176
    assert got["value"] > 0 and got["ms_per_image"] > 0 and got["device"] == "cpu"


def test_pipeline_line_matches_bench_py(tmp_path, monkeypatch, capsys):
    jax_bench = load_jax_bench()
    monkeypatch.delenv("FLOODGAN_PIPELINE_DATA", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax_bench.run_pipeline(argparse.Namespace(**ARGS))
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = bench.main(["--mode", "pipeline", "--device", "cpu"] + [
        f"--{k}={v}" for k, v in ARGS.items() if k != "remat"])
    assert list(got) == list(want) + ["device"]
    assert got["dataset"] == want["dataset"] == "8 samples (4 images x2 versions), 4 steps/epoch, 1 measured epochs"
    for key in ("metric", "unit", "vs_baseline", "post_cache_hit_rate", "raw_mb_per_sample",
                "post_transform_cache", "steady_wire_mb_per_sample"):
        assert got[key] == want[key], key
    assert got["post_cache_hit_rate"] == 1.0
    for key in ("value", "step_only_samples_per_sec", "host_feed_samples_per_sec", "overlap_ratio"):
        assert np.isfinite(got[key]) and got[key] > 0, key


def test_fixture_matches_bench_py(tmp_path):
    jax_bench = load_jax_bench()
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    meta = bench.build_pipeline_fixture(str(ours), 16, 3)
    assert meta == os.path.join(str(ours), "metadata")
    jax_bench._build_pipeline_fixture(str(theirs), 16, 3)
    for sub in ("dataset_input", "dataset_output"):
        names = sorted(os.listdir(theirs / sub))
        assert sorted(os.listdir(ours / sub)) == names and len(names) == 3
        for name in names:
            np.testing.assert_array_equal(tiff.imread(str(ours / sub / name)), tiff.imread(str(theirs / sub / name)))
    rows = [list(csv.reader(open(d / "metadata" / "dataset_split.csv"))) for d in (ours, theirs)]
    assert rows[0] == rows[1] and len(rows[0]) == 1 + 2 * 3
