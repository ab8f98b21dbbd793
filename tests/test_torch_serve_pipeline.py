"""The micro-batcher's pipeline on the CPU (floodgan_tpu_torch/serve.py):
the next batch is staged while one is in flight, launched behind it when
full and when it completes when not, at most two in flight; answers, errors,
close, cancelled futures and admission under it.  A gated engine holds
each launched batch "on the card" until the test opens its gate, so that
"in flight" can be observed here.  The engine is PairedAttention at 32^2,
batch 4, from a seeded init."""

import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from floodgan_tpu_torch.models.layers import init_weights
from floodgan_tpu_torch.models.registry import build_generator
from floodgan_tpu_torch.serve import BatchingFrontend, FrontendOverloaded, InferenceEngine
from torch_seg_fixtures import few_torch_threads

S, B = 32, 4
WAIT = 30.0


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from few_torch_threads()


@pytest.fixture(scope="module")
def params():
    gen = build_generator("pairedattention", 9)
    return init_weights(gen, torch.Generator().manual_seed(0)).state_dict()


@pytest.fixture(scope="module")
def plain(params):
    return InferenceEngine("pairedattention", params, "all", batch_size=B, image_size=S, aot=False, device="cpu")


class Gate:
    """A launched batch's completion, held until the test opens it; its
    ``error`` surfaces at the wait, as a device error at a CUDA event."""

    def __init__(self, inputs: torch.Tensor):
        self.inputs = inputs.clone()
        self.opened = threading.Event()
        self.error = None

    def synchronize(self) -> None:
        assert self.opened.wait(WAIT)
        if self.error is not None:
            raise self.error


class GatedEngine(InferenceEngine):
    """The CPU engine, each launch returning a Gate; ``fail_launches``
    holds the launch numbers (from 0) that raise instead."""

    def __init__(self, params):
        super().__init__("pairedattention", params, "all", batch_size=B, image_size=S, aot=False, device="cpu")
        self.gates, self.launches, self.fail_launches = [], 0, set()

    def launch(self, x, out):
        n, self.launches = self.launches, self.launches + 1
        if n in self.fail_launches:
            raise RuntimeError(f"launch {n} failed")
        super().launch(x, out)
        self.gates.append(Gate(x))
        return self.gates[-1]


@pytest.fixture
def gated(params):
    engine = GatedEngine(params)
    yield engine
    for g in engine.gates:  # let a failed test's frontend drain
        g.opened.set()


def wait_until(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.001)


def tiles(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, S, S, 9)).astype(np.float32)


def padded(x):
    return np.concatenate([x, np.zeros((B - len(x), S, S, 9), np.float32)])


def test_requests_while_a_batch_runs_form_the_next_batch(gated):
    fe = BatchingFrontend(gated, max_delay_ms=200.0)
    try:
        x = tiles(7)
        first = [fe.submit(t) for t in x[:4]]
        wait_until(lambda: len(gated.gates) == 1, "the first launch")
        second = [fe.submit(t) for t in x[4:]]
        wait_until(lambda: fe.stats()["staged_while_busy"] == 3, "three requests staged while busy")
        assert fe.stats()["pending"] == 0 and len(gated.gates) == 1
        gated.gates[0].opened.set()
        wait_until(lambda: len(gated.gates) == 2, "the second launch")
        np.testing.assert_array_equal(gated.gates[1].inputs.numpy(), padded(x[4:]))
        gated.gates[1].opened.set()
        for f in first + second:
            assert f.result(timeout=WAIT).shape == (S, S, 3)
        st = fe.stats()
        assert (st["requests"], st["batches"], st["staged_while_busy"]) == (7, 2, 3)
    finally:
        fe.close()


def test_a_full_next_batch_is_enqueued_behind_the_running_one(gated):
    fe = BatchingFrontend(gated, max_delay_ms=200.0)
    try:
        x = tiles(8, seed=1)
        futs = [fe.submit(t) for t in x[:4]]
        wait_until(lambda: len(gated.gates) == 1, "the first launch")
        futs += [fe.submit(t) for t in x[4:]]
        wait_until(lambda: len(gated.gates) == 2, "the full second batch's launch")
        assert not gated.gates[0].opened.is_set() and not any(f.done() for f in futs)
        np.testing.assert_array_equal(gated.gates[1].inputs.numpy(), x[4:])
        for g in gated.gates:
            g.opened.set()
        for f in futs:
            f.result(timeout=WAIT)
        assert fe.stats()["staged_while_busy"] == 4
    finally:
        fe.close()


def test_a_partial_next_batch_closes_when_the_running_one_completes(gated):
    fe = BatchingFrontend(gated, max_delay_ms=1.0)
    try:
        x = tiles(6, seed=2)
        futs = [fe.submit(t) for t in x[:4]]
        wait_until(lambda: len(gated.gates) == 1, "the first launch")
        futs += [fe.submit(t) for t in x[4:]]
        wait_until(lambda: fe.stats()["staged_while_busy"] == 2, "two requests staged while busy")
        time.sleep(0.1)  # 100 times the delay: the card is busy, so the batch stays open
        assert len(gated.gates) == 1
        gated.gates[0].opened.set()
        wait_until(lambda: len(gated.gates) == 2, "the partial batch's launch")
        np.testing.assert_array_equal(gated.gates[1].inputs.numpy(), padded(x[4:]))
        gated.gates[1].opened.set()
        for f in futs:
            f.result(timeout=WAIT)
    finally:
        fe.close()


def test_answers_are_the_engines_with_no_stale_slot(gated, plain):
    """A full batch on each buffer set, then a partial batch on each: the
    partial ones' unused slots reach the forward as zeros, not the earlier
    batches' tiles, and every answer is ``predict`` of its zero-padded
    batch."""
    fe = BatchingFrontend(gated, max_delay_ms=200.0)
    try:
        x = tiles(11, seed=3)
        groups = [x[:4], x[4:8], x[8:9], x[9:11]]
        futs = []
        for k, g in enumerate(groups):
            futs.append([fe.submit(t) for t in g])
            wait_until(lambda: len(gated.gates) == k + 1, f"launch {k}")
            gated.gates[k].opened.set()
        for k, (g, fs) in enumerate(zip(groups, futs)):
            np.testing.assert_array_equal(gated.gates[k].inputs.numpy(), padded(g))
            want = plain.predict(padded(g)).numpy()
            got = np.stack([f.result(timeout=WAIT) for f in fs])
            np.testing.assert_allclose(got, want[:len(g)], rtol=0, atol=1e-6)
    finally:
        fe.close()


@pytest.mark.parametrize("where", ["launch", "event"])
def test_an_error_reaches_only_its_batch(gated, where):
    """Batch 1 fails at its launch or at its event; its waiters get the
    error, batch 0 before it and batch 2 after it answer."""
    fe = BatchingFrontend(gated, max_delay_ms=200.0)
    try:
        x = tiles(10, seed=4)
        if where == "launch":
            gated.fail_launches.add(1)
        b0 = [fe.submit(t) for t in x[:4]]
        wait_until(lambda: len(gated.gates) == 1, "the first launch")
        b1 = [fe.submit(t) for t in x[4:8]]
        if where == "launch":
            for f in b1:
                with pytest.raises(RuntimeError, match="launch 1 failed"):
                    f.result(timeout=WAIT)
        else:
            wait_until(lambda: len(gated.gates) == 2, "the second launch")
            gated.gates[1].error = RuntimeError("device fault")
        b2 = [fe.submit(t) for t in x[8:]]
        for g in gated.gates[:2]:
            g.opened.set()
        wait_until(lambda: len(gated.gates) == (2 if where == "launch" else 3), "batch 2's launch")
        gated.gates[-1].opened.set()
        for f in b0 + b2:
            assert f.result(timeout=WAIT).shape == (S, S, 3)
        for f in b1:
            with pytest.raises(RuntimeError, match="launch 1 failed" if where == "launch" else "device fault"):
                f.result(timeout=WAIT)
        assert fe.stats()["batches"] == 2
    finally:
        fe.close()


def test_close_drains_two_batches_in_flight(gated):
    fe = BatchingFrontend(gated, max_delay_ms=200.0)
    x = tiles(8, seed=5)
    futs = [fe.submit(t) for t in x]
    wait_until(lambda: len(gated.gates) == 2, "two batches in flight")
    closer = threading.Thread(target=fe.close)
    closer.start()
    time.sleep(0.05)
    assert closer.is_alive() and not any(f.done() for f in futs)
    for g in gated.gates:
        g.opened.set()
    closer.join(WAIT)
    assert not closer.is_alive()
    assert all(f.result(timeout=0).shape == (S, S, 3) for f in futs)
    assert fe.stats()["batches"] == 2
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit(x[0])


def test_a_cancelled_future_does_not_stop_the_worker(gated):
    fe = BatchingFrontend(gated, max_delay_ms=200.0)
    try:
        x = tiles(5, seed=6)
        futs = [fe.submit(t) for t in x[:4]]
        wait_until(lambda: len(gated.gates) == 1, "the first launch")
        assert futs[1].cancel()  # in flight, never set running: it can be cancelled
        gated.gates[0].opened.set()
        for i, f in enumerate(futs):
            if i == 1:
                with pytest.raises(CancelledError):
                    f.result(timeout=WAIT)
            else:
                f.result(timeout=WAIT)
        last = fe.submit(x[4])
        wait_until(lambda: len(gated.gates) == 2, "the next launch")
        gated.gates[1].opened.set()
        assert last.result(timeout=WAIT).shape == (S, S, 3)
    finally:
        fe.close()


def test_max_pending_reopens_at_staging(gated):
    """Staged requests stop counting: two batches in flight take 8
    requests past ``max_pending=4``; with both buffer sets in flight the
    next 4 are held, still pending, until the first batch completes."""
    fe = BatchingFrontend(gated, max_delay_ms=200.0, max_pending=4)
    try:
        x = tiles(13, seed=7)
        futs = [fe.submit(t) for t in x[:4]]
        wait_until(lambda: len(gated.gates) == 1, "the first launch")
        futs += fe.submit_many(list(x[4:8]))
        wait_until(lambda: len(gated.gates) == 2, "the second launch")
        assert fe.stats()["pending"] == 0
        futs += [fe.submit(t) for t in x[8:12]]
        time.sleep(0.05)
        assert fe.stats()["pending"] == 4
        with pytest.raises(FrontendOverloaded):
            fe.submit(x[12])
        gated.gates[0].opened.set()
        wait_until(lambda: fe.stats()["pending"] == 0 and len(gated.gates) == 3,
                   "the held requests' staging and launch")
        futs.append(fe.submit(x[12]))
        for g in gated.gates:
            g.opened.set()
        wait_until(lambda: len(gated.gates) == 4, "the last launch")
        for g in gated.gates:
            g.opened.set()
        for f in futs:
            f.result(timeout=WAIT)
        assert fe.stats()["requests"] == 13
    finally:
        fe.close()
