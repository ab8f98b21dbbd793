"""The port's spans (floodgan_tpu_torch/utils/profiling.py) on the CPU:
off they record nothing; on (any torch profiler in the process, on any
thread) they land on the profiler's clock, keep the newest records, and
nest as the serving worker and the trainers open them, without changing
what a step or a batch computes.  The serving engine is
test_torch_serve.py's (PairedAttention, batch 4 at 32^2, on the CPU),
from a seeded init rather than JAX's."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from floodgan_tpu_torch.models.layers import init_weights
from floodgan_tpu_torch.models.registry import build_generator
from floodgan_tpu_torch.serve import BatchingFrontend, InferenceEngine
from floodgan_tpu_torch.train.cycle import CycleTrainer
from floodgan_tpu_torch.train.paired import PairedTrainer
from floodgan_tpu_torch.utils import profiling
from floodgan_tpu_torch.utils.profiling import profiler_clock_ns, span, span_records
from torch_seg_fixtures import few_torch_threads

S = 32


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from few_torch_threads()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def named(name, since=float("-inf")):
    return [r for r in span_records() if r.name == name and r.start >= since]


def children(records, parent):
    return sorted((r for r in records if r.parent == parent.id), key=lambda r: r.start)


def assert_nested_in_order(parent, kids, names):
    assert [k.name for k in kids] == names
    assert parent.start <= kids[0].start and kids[-1].end <= parent.end
    for a, b in zip(kids, kids[1:]):
        assert a.end <= b.start


def test_off_a_span_records_nothing():
    assert not profiling.tracing()
    with span("t.off", ident=1, device=torch.device("cpu")) as s:
        assert s is None
    assert named("t.off") == []


def test_a_span_lands_on_the_profilers_clock():
    with cpu_profile() as prof:
        assert profiling.tracing()
        with span("t.clock"):
            time.sleep(0.02)
    assert not profiling.tracing()
    rec, = named("t.clock")
    base = prof.profiler.kineto_results.trace_start_ns()
    ev, = [e for e in prof.events() if e.name == "t.clock"]
    lo = (profiler_clock_ns(rec.start) - base) / 1e3
    hi = (profiler_clock_ns(rec.end) - base) / 1e3
    assert abs(lo - ev.time_range.start) < 2000 and abs(hi - ev.time_range.end) < 2000
    assert hi - lo >= 20000


def test_a_thread_started_before_the_profiler_records():
    """The switch is the process-wide flag: a thread that exists before the
    profiler starts (the serving worker) records under it."""
    go, done = threading.Event(), threading.Event()

    def work():
        go.wait(30)
        with span("t.thread"):
            time.sleep(0.005)
        done.set()

    th = threading.Thread(target=work)
    th.start()
    with cpu_profile():
        go.set()
        assert done.wait(30)
    th.join(30)
    assert not th.is_alive()
    assert len(named("t.thread")) == 1


def test_the_ring_keeps_the_newest_records():
    extra = 10
    with cpu_profile():
        for i in range(profiling.RING_SIZE + extra):
            with span("t.ring", ident=i):
                pass
    recs = span_records()
    assert len(recs) == profiling.RING_SIZE
    assert [r.ident for r in recs] == list(range(extra, profiling.RING_SIZE + extra))


def test_parents_ids_and_the_decision_on_entry():
    """The innermost span open on the thread is the parent unless one is
    named; ids are unique; a span entered before the profiler records
    nothing, one entered under it records though it ends after; a CPU
    device takes no events."""
    outer_off = span("t.late")
    outer_off.__enter__()
    prof = cpu_profile()
    prof.start()
    outer_off.__exit__(None, None, None)
    with span("t.outer", ident=7) as outer:
        with span("t.inner", device=torch.device("cpu")) as inner:
            pass
        with span("t.named", parent=123):
            pass
    early = span("t.early")
    early.__enter__()
    prof.stop()
    early.__exit__(None, None, None)
    assert named("t.late") == []
    (o,), (i,), (n,), (e,) = named("t.outer"), named("t.inner"), named("t.named"), named("t.early")
    assert (o.id, o.parent, o.ident) == (outer.id, None, 7)
    assert (i.id, i.parent, i.device_ms) == (inner.id, outer.id, None)
    assert n.parent == 123 and e.parent is None
    assert len({o.id, i.id, n.id, e.id}) == 4


@pytest.fixture(scope="module")
def engine():
    gen = build_generator("pairedattention", 9)
    sd = init_weights(gen, torch.Generator().manual_seed(0)).state_dict()
    return InferenceEngine("pairedattention", sd, "all", batch_size=4, image_size=S, device="cpu")


def test_serving_spans_nest_per_request_and_per_batch(engine, rng):
    """Six requests through a frontend started before the profiler: a full
    batch of 4, then a padded one of 2; each request's serve.request holds
    its serve.queue, which names its batch; each batch's serve.batch holds
    its stack, copies, forward and delivery in order; a gather ends where
    each batch begins, and its serve.fill runs from its head's arrival to
    its end; the answers are the engine's."""
    stacks = rng.random((6, S, S, 9), dtype=np.float32)
    fe = BatchingFrontend(engine, max_delay_ms=200.0)
    try:
        with cpu_profile():
            t0 = time.perf_counter()
            futs = [fe.submit(s) for s in stacks]
            got = np.stack([f.result(timeout=60) for f in futs])
    finally:
        fe.close()
    padded = np.concatenate([stacks[4:], np.zeros((2, S, S, 9), np.float32)])
    want = np.concatenate([engine.predict(stacks[:4]).numpy(), engine.predict(padded).numpy()[:2]])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    recs = [r for r in span_records() if r.start >= t0]
    requests = sorted((r for r in recs if r.name == "serve.request"), key=lambda r: r.ident)
    batches = sorted((r for r in recs if r.name == "serve.batch"), key=lambda r: r.ident)
    assert [r.ident for r in requests] == list(range(6)) and [b.ident for b in batches] == [0, 1]
    for r in requests:
        q, = children(recs, r)
        assert q.name == "serve.queue" and q.start == r.start and q.end <= r.end
        assert q.ident == (0 if r.ident < 4 else 1)
    gathers = [r for r in span_records() if r.name == "serve.gather"]
    for b in batches:
        assert_nested_in_order(b, children(recs, b),
                               ["serve.stack", "engine.h2d", "engine.forward", "engine.d2h", "serve.deliver"])
        g, = [g for g in gathers if 0 <= b.start - g.end < 0.05]
        fill, = children(span_records(), g)
        assert fill.name == "serve.fill" and g.start <= fill.start and fill.end == g.end
    # The first batch's head came with the first submit, the second's was
    # already queued when its gather began.
    first, second = sorted((g for g in gathers if g.end >= t0), key=lambda g: g.start)[:2]
    assert children(span_records(), first)[0].start >= t0
    assert children(span_records(), second)[0].start - second.start < 0.05


def test_the_engine_alone_opens_root_spans(engine, rng):
    x = rng.random((4, S, S, 9), dtype=np.float32)
    with cpu_profile():
        t0 = time.perf_counter()
        engine.predict(x)
    (h,), (f,) = named("engine.h2d", t0), named("engine.forward", t0)
    assert h.parent is None and f.parent is None and h.end <= f.start


def _batch(seed, channels):
    g = np.random.default_rng(seed)
    return (g.uniform(-1, 1, (2, S, S, 9)).astype(np.float32),
            g.uniform(-1, 1, (2, S, S, channels)).astype(np.float32))


@pytest.mark.parametrize("family", ["paired", "cycle"])
def test_a_traced_step_nests_its_updates_and_computes_the_same(family):
    """One step of two trainers from the same seed, one untraced and one
    under the profiler: the same losses bit for bit, and the traced one's
    train.step, numbered by the step it was passed, holds its updates in
    the step's order."""
    if family == "paired":
        def make():
            return PairedTrainer("pairedattention", 9, compute_dtype="float32", device="cpu")
        order = ["train.g_forward", "train.d_update", "train.g_update"]
    else:
        def make():
            return CycleTrainer("attentiongan", 9, (S, S), compute_dtype="float32", device="cpu")
        order = ["train.g_update", "train.replay", "train.d_update"]
    x, y = _batch(3, 3)
    plain = make().train_step(x, y, 2e-4, epoch=1, step=5)
    with cpu_profile():
        t0 = time.perf_counter()
        traced = make().train_step(x, y, 2e-4, epoch=1, step=5)
    assert plain.keys() == traced.keys()
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k
    recs = [r for r in span_records() if r.start >= t0]
    step, = [r for r in recs if r.name == "train.step"]
    assert step.ident == 5
    assert_nested_in_order(step, children(recs, step), order)
