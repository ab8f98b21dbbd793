"""The span readers (benchlib/spans.py, the metrics that read it) on
synthetic records: scoped to the serving slice by ``slice_from`` and
``slice_to``, None where the slice holds nothing or a training slice's
``train.step`` count is not its ``traced_steps``, and their arithmetic."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from benchlib import spans, spec

LO, HI = 100.0, 103.0


def rec(name, start, end, device_ms=None):
    return SimpleNamespace(name=name, start=start, end=end, device_ms=device_ms, id=0, parent=None, ident=None)


def ctx(counters=None, window=None):
    return SimpleNamespace(counters=counters or {}, window=window or {})


def serving_ctx():
    return ctx({"slice_from": LO, "slice_to": HI})


def read(metric, c):
    return spec.reader(metric)(c)


@pytest.fixture
def records(monkeypatch):
    held = []
    monkeypatch.setattr(spans, "_program_records", lambda: list(held))
    return held


def test_serving_records_are_scoped_to_the_slice(records):
    records += [rec("serve.stack", LO - 0.5, LO - 0.4), rec("serve.stack", LO + 1.0, LO + 1.02),
                rec("serve.stack", LO + 2.0, LO + 2.04), rec("serve.stack", HI, HI + 0.1)]
    assert [r.start for r in spans.serving(serving_ctx())] == [LO + 1.0, LO + 2.0]
    for metric in ("stack_ms.tiles", "stack_ms.region"):
        assert read(metric, serving_ctx()) == pytest.approx(30.0)


def test_nothing_in_the_slice_reads_none(records):
    records += [rec("serve.stack", LO - 1.0, LO - 0.9), rec("serve.queue", HI + 1.0, HI + 1.2),
                rec("serve.fill", HI + 0.5, HI + 0.6)]
    for metric in ("queue_wait_ms.tiles", "stack_ms.tiles", "stack_ms.region", "worker_host_share.tiles",
                   "worker_host_share.region"):
        assert read(metric, serving_ctx()) is None, metric
        assert read(metric, ctx()) is None, metric


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.setattr(spans, "_program_records", lambda: None)
    assert spans.serving(serving_ctx()) is None
    assert spans.training(ctx(window={"traced_steps": 1})) is None


def test_the_90th_percentile_of_the_queue_waits(records):
    """100 requests waiting 1, 2, ..., 100 ms: numpy's linear rule puts the
    90th percentile at 90.1 ms; a wait that began outside the slice is
    left out."""
    records += [rec("serve.queue", LO + k * 0.02, LO + k * 0.02 + (k + 1) * 1e-3) for k in range(100)]
    records.append(rec("serve.queue", LO - 0.3, LO + 0.2))
    assert read("queue_wait_ms.tiles", serving_ctx()) == pytest.approx(90.1)
    assert np.percentile(np.arange(1, 101), 90) == pytest.approx(90.1)


def test_the_worker_host_share_clips_its_spans_to_the_slice(records):
    """A fill that straddles the slice's start counts from it, a delivery
    that runs past the end counts to it, and the wait for the batch's head
    and the engine's spans count nothing: 0.5 + 0.25 + 0.25 s of 3 s."""
    records += [rec("serve.gather", LO - 1.0, LO + 0.5), rec("serve.fill", LO - 0.5, LO + 0.5),
                rec("serve.batch", LO + 0.5, LO + 2.0), rec("engine.forward", LO + 0.8, LO + 1.9),
                rec("serve.stack", LO + 0.5, LO + 0.75), rec("serve.deliver", HI - 0.25, HI + 0.4)]
    for metric in ("worker_host_share.tiles", "worker_host_share.region"):
        assert read(metric, serving_ctx()) == pytest.approx(100.0 * 1.0 / 3.0)


def steps(n, replay=False):
    out = []
    for k in range(n):
        out += [rec("train.g_forward", k, k + 0.1, 10.0), rec("train.d_update", k + 0.1, k + 0.5, 20.0),
                rec("train.g_update", k + 0.5, k + 0.9, 30.0)]
        if replay:
            out.append(rec("train.replay", k + 0.9, k + 0.95, 1.5))
        out.append(rec("train.step", k, k + 1.0, 62.0))
    return out


def test_the_training_readers_divide_by_the_traced_steps(records):
    records += steps(4, replay=True)
    c = ctx(window={"traced_steps": 4})
    assert read("g_update_ms.train", c) == pytest.approx(40.0)
    assert read("d_update_ms.train", c) == pytest.approx(20.0)
    assert read("replay_ms.train", c) == pytest.approx(1.5)


def test_a_training_slice_with_another_step_count_reads_none(records):
    records += steps(3)
    for metric in ("g_update_ms.train", "d_update_ms.train", "replay_ms.train"):
        assert read(metric, ctx(window={"traced_steps": 4})) is None, metric
        assert read(metric, ctx(window={"traced_steps": 0})) is None, metric
    assert read("d_update_ms.train", ctx(window={"traced_steps": 3})) == pytest.approx(20.0)
    assert read("replay_ms.train", ctx(window={"traced_steps": 3})) is None  # a paired step has none


def test_a_span_without_its_device_time_reads_none(records):
    records += steps(2)
    records[1].device_ms = None
    assert read("d_update_ms.train", ctx(window={"traced_steps": 2})) is None
