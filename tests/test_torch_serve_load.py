"""Serving under load on the CPU: the port's serve bench against the JAX
tool's output schema, the three frontend and HTTP behaviours of
tests/test_serve.py that the port's first serving tests left out, and the
micro-batcher, the repository and the HTTP layer driven by more client
threads than cores.

An answer that went through the frontend is held against ``engine.predict``
of the same image within TOL (absolute): the batch it shared differs, and
with it the order of some CPU reductions.
"""

import ast
import argparse
import io
import json
import socket
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from floodgan_tpu_torch.models.layers import init_weights
from floodgan_tpu_torch.models.registry import build_generator
from floodgan_tpu_torch.serve import (
    BatchingFrontend,
    FrontendOverloaded,
    InferenceEngine,
    ModelRepository,
    serve_http,
)
from floodgan_tpu_torch.tools import serve_bench
from torch_seg_fixtures import few_torch_threads

ROOT = Path(__file__).resolve().parents[1]
S = 32
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from few_torch_threads()


def _engine(model: str, batch: int, seed: int) -> InferenceEngine:
    g = init_weights(build_generator(model, 9), torch.Generator().manual_seed(seed))
    return InferenceEngine(model, g.state_dict(), "all", batch_size=batch, image_size=S, device="cpu")


@pytest.fixture(scope="module")
def paired():
    return _engine("pairedattention", 4, 0)


@pytest.fixture(scope="module")
def cycle():
    return _engine("cyclegan", 2, 1)


def _npy(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _post(url: str, body: bytes, timeout: float = 60):
    """(status, the answer's array or JSON)."""
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, np.load(io.BytesIO(r.read()))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _direct(engine: InferenceEngine, stacks: np.ndarray) -> np.ndarray:
    """engine.predict of each image, in batches of the engine's shape."""
    bs, out = engine.batch_size, []
    for lo in range(0, len(stacks), bs):
        chunk = stacks[lo:lo + bs]
        pad = np.zeros((bs - len(chunk),) + engine.input_shape, np.float32)
        out.append(engine.predict(np.concatenate([chunk, pad])).numpy()[:len(chunk)])
    return np.concatenate(out)


def _run_threads(fn, n: int, timeout: float = 120) -> list:
    """``fn(i)`` on ``n`` threads started together; returns the exceptions
    they raised, and fails if one is still running after ``timeout``."""
    errors, barrier = [], threading.Barrier(n)

    def body(i):
        try:
            barrier.wait(timeout=timeout)
            fn(i)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a client thread hung"
    return errors


@pytest.fixture
def short_switch():
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(before)


# ------------------------------------------------------------ the serve bench

def _jax_tool_lines():
    """The JAX tool's printed lines as (keys, metric f-string) pairs, read
    from tools/serve_bench.py: the dict literal inside each json.dumps."""
    src = (ROOT / "tools" / "serve_bench.py").read_text()
    lines = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps" and isinstance(node.args[0], ast.Dict):
            d = node.args[0]
            keys = [k.value for k in d.keys]
            metric = d.values[keys.index("metric")]
            lines.append((keys, compile(ast.Expression(metric), "serve_bench", "eval")))
    return lines


def _jax_metric(code, **names) -> str:
    return eval(code, {}, names)


def test_jax_tool_schema_was_read():
    (engine_keys, _), (frontend_keys, _) = _jax_tool_lines()
    assert engine_keys == ["metric", "latency_ms", "images_per_sec", "dtype", "wire_dtype"]
    assert frontend_keys[:3] == ["metric", "p50_ms", "p99_ms"] and "mean_batch_occupancy" in frontend_keys


def test_serve_bench_engine_mode_prints_the_jax_schema(capsys):
    (keys, metric), _ = _jax_tool_lines()
    argv = ["--size", str(S), "--batches", "1", "2", "--iters", "2", "--device", "cpu"]
    lines = serve_bench.main(argv)
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert printed == lines and len(lines) == 2
    args = argparse.Namespace(model="pairedattention", size=S)
    for b, line in zip((1, 2), lines):
        assert list(line) == keys
        assert line["metric"] == _jax_metric(metric, args=args, b=b)
        assert line["latency_ms"] > 0 and line["images_per_sec"] > 0
        assert (line["dtype"], line["wire_dtype"]) == ("bfloat16", "float32")


def test_serve_bench_frontend_mode_prints_the_jax_schema(capsys):
    _, (keys, metric) = _jax_tool_lines()
    argv = ["--size", str(S), "--batches", "1", "2", "--frontend", "--clients", "1", "2",
            "--requests_per_client", "2", "--device", "cpu", "--model", "AttentionGAN"]
    lines = serve_bench.main(argv)
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert printed == lines and len(lines) == 2
    args = argparse.Namespace(model="AttentionGAN", size=S)
    for n, line in zip((1, 2), lines):
        assert list(line) == keys
        assert line["metric"] == _jax_metric(metric, args=args, engine=types.SimpleNamespace(batch_size=2),
                                             n_clients=n)
        assert line["requests"] == 2 * n and line["max_delay_ms"] == 5.0
        assert 0 < line["p50_ms"] <= line["p99_ms"] and line["images_per_sec"] > 0
        assert 0.5 <= line["mean_batch_occupancy"] <= 1.0


def test_serve_bench_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_bench.main(["--size", str(S), "--batches", "1", "--iters", "1"])


def test_serve_bench_client_failure_fails_the_run(monkeypatch):
    class Failing(BatchingFrontend):
        def predict(self, stack, timeout=None):
            if threading.current_thread() is not threading.main_thread():
                raise ValueError("client failed")
            return super().predict(stack, timeout)

    monkeypatch.setattr(serve_bench, "BatchingFrontend", Failing)
    with pytest.raises(ValueError, match="client failed"):
        serve_bench.main(["--size", str(S), "--batches", "2", "--frontend", "--clients", "3",
                          "--requests_per_client", "1", "--device", "cpu"])


# ------------------------------------- behaviours of tests/test_serve.py

def test_batching_frontend_survives_cancelled_future(paired, rng):
    fe = BatchingFrontend(paired, max_delay_ms=20.0)
    try:
        doomed = fe.submit(rng.random((S, S, 9), dtype=np.float32))
        assert doomed.cancel()  # a future that has not run can be cancelled
        ok = fe.submit(rng.random((S, S, 9), dtype=np.float32))
        assert ok.result(timeout=60).shape == (S, S, 3)
    finally:
        fe.close()


def test_http_negative_content_length_rejected(paired):
    repo = ModelRepository()
    repo.add("flood", paired)
    server = serve_http(repo, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with socket.create_connection(("127.0.0.1", server.server_address[1]), timeout=30) as conn:
            conn.sendall(b"POST /v1/models/flood:predict HTTP/1.1\r\nHost: t\r\nContent-Length: -1\r\n\r\n")
            status = conn.recv(1024).decode(errors="replace").splitlines()[0]
        assert " 400 " in status, status
    finally:
        server.shutdown()
        server.server_close()
        repo.close()


def test_submit_many_all_or_nothing(paired):
    fe = BatchingFrontend(paired, max_delay_ms=200.0, max_pending=3)
    try:
        x = np.zeros(paired.input_shape, np.float32)
        with pytest.raises(FrontendOverloaded):
            fe.submit_many([x] * 4)
        assert fe.stats()["pending"] == 0  # nothing admitted
        futs = fe.submit_many([x, x, x])
        with pytest.raises(FrontendOverloaded):
            fe.submit(x)
        for f in futs:
            f.result(timeout=60)
        with pytest.raises(ValueError):
            fe.submit_many([np.zeros((8, 8, 9), np.float32)])
    finally:
        fe.close()


# ------------------------------------------------------------- under load

def test_frontend_under_many_clients(paired, short_switch):
    """24 client threads (three times the cores) of 4 requests each through
    one frontend, the interpreter switching threads every 10 us: every
    answer is its own image's, and the counters lose no update."""
    n_threads, per = 24, 4
    stacks = np.random.default_rng(3).uniform(-1, 1, (n_threads * per, S, S, 9)).astype(np.float32)
    want = _direct(paired, stacks)
    got = [None] * len(stacks)
    fe = BatchingFrontend(paired, max_delay_ms=2.0)
    try:
        def client(i):
            for j in range(per):
                k = i * per + j
                got[k] = fe.predict(stacks[k], timeout=60)

        assert _run_threads(client, n_threads) == []
        stats = fe.stats()
    finally:
        fe.close()
    np.testing.assert_allclose(np.stack(got), want, rtol=0, atol=TOL)
    assert stats["requests"] == len(stacks) and stats["pending"] == 0
    assert fe.batched_slots == len(stacks)
    assert stats["batches"] >= len(stacks) // paired.batch_size


def test_two_models_under_load_both_progress(paired, cycle):
    """Two engines share the process-wide TF32 lock (``core/device.py``).
    Under load on both, each model's batches keep running while the other's
    do: neither waits for the other to drain."""
    repo = ModelRepository()
    repo.add("paired", paired, max_delay_ms=2.0)
    repo.add("cycle", cycle, max_delay_ms=2.0)
    done = {"paired": [], "cycle": []}
    per = 6
    rng = np.random.default_rng(4)
    stacks = rng.uniform(-1, 1, (8 * per, S, S, 9)).astype(np.float32)
    try:
        def client(i):
            name = ("paired", "cycle")[i % 2]
            for j in range(per):
                out = repo.predict(name, stacks[i * per + j])
                assert out.shape == (S, S, 3)
                done[name].append(time.monotonic())

        assert _run_threads(client, 8) == []
        models = repo.models()
    finally:
        repo.close()
    assert len(done["paired"]) == len(done["cycle"]) == 4 * per
    assert models["paired"]["requests"] == models["cycle"]["requests"] == 4 * per
    # Each model answered some requests before the other's last one.
    assert min(done["paired"]) < max(done["cycle"]) and min(done["cycle"]) < max(done["paired"])


def test_http_answers_a_burst_of_connections():
    """64 clients connecting at once, three times: every one is answered.
    socketserver's listen backlog of 5 left some of them reset or timed
    out; the server now listens with the kernel's cap."""
    server = serve_http(ModelRepository(), host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/healthz"
    statuses, lock = [], threading.Lock()

    def client(_):
        with urllib.request.urlopen(url, timeout=30) as r:
            json.load(r)
            with lock:
                statuses.append(r.status)

    try:
        for _ in range(3):
            assert _run_threads(client, 64) == []
    finally:
        server.shutdown()
        server.server_close()
    assert statuses == [200] * 192


def test_http_under_concurrent_clients(paired, cycle):
    """8 client threads, each 3 single-image POSTs and one 3-image POST to
    alternating models: every answer 200 and its images' own; then a burst
    against a max_pending=2 model: 503s with retry, and every 200 right."""
    repo = ModelRepository()
    repo.add("paired", paired, max_delay_ms=2.0)
    repo.add("cycle", cycle, max_delay_ms=2.0)
    repo.add("burst", paired, max_delay_ms=2.0, max_pending=2)
    server = serve_http(repo, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}/v1/models"
    pool = np.random.default_rng(5).uniform(-1, 1, (6, S, S, 9)).astype(np.float32)
    want = {"paired": _direct(paired, pool), "cycle": _direct(cycle, pool)}
    want["burst"] = want["paired"]
    answers, sent = [], {"paired": 0, "cycle": 0}
    lock = threading.Lock()
    try:
        def client(i):
            for j in range(4):
                name = ("paired", "cycle")[(i + j) % 2]
                idx = [(i + j) % len(pool)] if j < 3 else [(i + j + k) % len(pool) for k in range(3)]
                body = pool[idx[0]] if j < 3 else pool[idx]
                status, out = _post(f"{base}/{name}:predict", _npy(body))
                with lock:
                    sent[name] += len(idx)
                    answers.append((name, idx, status, out))

        assert _run_threads(client, 8) == []
        with urllib.request.urlopen(base, timeout=30) as r:
            models = json.load(r)

        def burst(i):
            status, out = _post(f"{base}/burst:predict", _npy(pool[[i % 6, (i + 1) % 6]]))
            with lock:
                answers.append(("burst", [i % 6, (i + 1) % 6], status, out))

        assert _run_threads(burst, 12) == []
    finally:
        server.shutdown()
        server.server_close()
        repo.close()
    for name, idx, status, out in answers[:32]:
        assert status == 200, (name, status, out)
        np.testing.assert_allclose(out.reshape((-1, S, S, 3)), want[name][idx], rtol=0, atol=TOL)
    assert {k: models[k]["requests"] for k in sent} == sent
    statuses = [a[2] for a in answers[32:]]
    assert set(statuses) <= {200, 503} and 503 in statuses and 200 in statuses
    for name, idx, status, out in answers[32:]:
        if status == 503:
            assert out["retry"] is True
        else:
            np.testing.assert_allclose(out, want[name][idx], rtol=0, atol=TOL)
