"""A run whose timed path is broken underneath comes out not ``correct``.

Each test skips the harness's look for a card and drives the rest of a
run (``run.measure``) on the CPU at a small size, with one fault planted
in the program:

- training: a step that returns its state unchanged; a step that leaves
  half of its batch out and takes the mean over the rest; replay buffers
  that, once full, never swap an image in;
- serving: every answer altered where the engine produces it; half of
  each batch left out; answers delivered to each other's requests.

(The cells run on one card: there is no exchange between cards to leave
out.)
"""

from __future__ import annotations

import functools

import pytest
import torch

from bench_fixtures import CPU, few_threads, small_cell
from benchlib import spec

few_threads()
RUN = spec.load_module(spec.BENCH_DIR / "run.py", "benchmark_run")
TRAINERS = {"pairedattention.train": "floodgan_tpu_torch.train.paired.PairedTrainer",
            "attentiongan.train": "floodgan_tpu_torch.train.cycle.CycleTrainer"}


def _measure(cell):
    return RUN.measure(cell, 2**31 + 77, 1.0, False, CPU, "cpu", "cpu")


def _unchanged(step):
    @functools.wraps(step)
    def wrapped(self, *args, **kwargs):
        before = [p.detach().clone() for p in self._bench_params()]
        out = step(self, *args, **kwargs)
        with torch.no_grad():
            for p, b in zip(self._bench_params(), before):
                p.copy_(b)
        return out
    return wrapped


def _half_batch(step):
    @functools.wraps(step)
    def wrapped(self, x, y, *args, **kwargs):
        return step(self, x[: x.shape[0] // 2], y[: y.shape[0] // 2], *args, **kwargs)
    return wrapped


@pytest.mark.parametrize("name", sorted(TRAINERS))
@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_a_broken_train_step_is_not_correct(name, fault, monkeypatch):
    cell = small_cell(name)
    sound = _measure(cell)
    module, cls = TRAINERS[name].rsplit(".", 1)
    trainer = getattr(__import__(module, fromlist=[cls]), cls)
    monkeypatch.setattr(trainer, "_bench_params",
                        lambda self: [p for m in vars(self).values() if isinstance(m, torch.nn.Module)
                                      for p in m.parameters()], raising=False)
    monkeypatch.setattr(trainer, "train_step", fault(trainer.train_step))
    broken = _measure(cell)
    assert broken["correct"] is False
    worst = max(broken["checks"], key=lambda k: broken["checks"][k]["value"] / broken["checks"][k]["limit"])
    assert broken["checks"][worst]["value"] > broken["checks"][worst]["limit"]
    assert broken["checks"][worst]["value"] > 3 * sound["checks"][worst]["value"]


def _no_replay(query):
    """Once the buffer is full, every item is returned and none is stored."""
    @functools.wraps(query)
    def wrapped(self, images, draws):
        return query(self, images, [(0.0, slot) for _, slot in draws])
    return wrapped


def test_a_broken_replay_buffer_is_not_correct(monkeypatch):
    cell = small_cell("attentiongan.train")
    cell.config["recipe"]["buffer_size"] = 3  # full within the second step: the checked steps after it swap
    assert cell.params["checked_steps"] * cell.config["batch"] >= 3 * cell.config["recipe"]["buffer_size"]
    sound = _measure(cell)
    assert sound["checks"]["buffer"]["value"] <= sound["checks"]["buffer"]["limit"]
    from floodgan_tpu_torch.train.cycle import ImageBuffer

    monkeypatch.setattr(ImageBuffer, "query_batch", _no_replay(ImageBuffer.query_batch))
    broken = _measure(cell)
    assert broken["correct"] is False
    assert broken["checks"]["buffer"]["value"] > broken["checks"]["buffer"]["limit"]
    assert broken["checks"]["buffer"]["value"] > 3 * sound["checks"]["buffer"]["value"]


def _altered(predict):
    return lambda self, x: predict(self, x) + 1e-3


def _half_left_out(predict):
    def wrapped(self, x):
        out = predict(self, x).clone()
        out[out.shape[0] // 2:] = 0.0
        return out
    return wrapped


def _misdelivered(predict):
    return lambda self, x: predict(self, x).flip(0)


@pytest.mark.parametrize("fault", [None, _altered, _half_left_out, _misdelivered])
def test_a_broken_answer_is_not_correct(fault, monkeypatch):
    cell = small_cell("pairedattention.serve_region")
    if fault is not None:
        from floodgan_tpu_torch.serve import InferenceEngine

        monkeypatch.setattr(InferenceEngine, "predict", fault(InferenceEngine.predict))
    result = _measure(cell)
    assert result["correct"] is (fault is None)
    assert result["attempted"] > 0 and result["failed"] == 0
