"""On the card: the controls of the cells' checks and the planted faults
fail their limits and sound runs pass them, at the cells' widths and image size with batches a
test run holds (``tools/control.py``'s readings).  Each skips where there
is no card."""

from __future__ import annotations

import copy

import pytest

from benchlib import checks, spec

CONTROL = spec.load_module(spec.BENCH_DIR / "tools" / "control.py", "benchmark_control")
SEED = 2**31 + 1001


def _cell(name: str, **config):
    cell = spec.load_cell(name)
    cell.config = copy.deepcopy(cell.config) | config
    return cell


@pytest.mark.card
@pytest.mark.parametrize("name", ["pairedattention.train", "attentiongan.train"])
def test_train_control_and_fault_fail(name, card):
    cell = _cell(name, batch=4)
    faults = ["control", "half_batch"]
    if cell.config["step"] == "cycle":  # buffers that fill within the checked steps at batch 4
        cell.config["recipe"] = {**cell.config["recipe"], "buffer_size": 20}
        faults.append("no_replay")
    r = CONTROL.train_readings(cell, SEED, True, card)
    assert checks.judge(r["sound"], cell.limits)[0], r["sound"]
    for fault in faults:
        assert not checks.judge(r[fault], cell.limits)[0], (fault, r[fault])


@pytest.mark.card
def test_serve_control_fails(card):
    cell = _cell("pairedattention.serve_tiles")
    cell.params["pool_tiles"] = 16
    r = CONTROL.serve_readings(cell, SEED, True, card)
    assert checks.judge(r["sound"], cell.limits)[0], r["sound"]
    assert r["control"]["answer"] > cell.limits["answer"], r["control"]
