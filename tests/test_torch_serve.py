"""The port's serving path on the CPU: the engine against the JAX engine on
the same weights and inputs, then the frontend, repository and HTTP
behaviour of tests/test_serve.py."""

import io
import json
import socket
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu.models.registry import build_generator as jax_build_generator
from floodgan_tpu.serve import InferenceEngine as JaxInferenceEngine
from floodgan_tpu_torch import serve_profile
from floodgan_tpu_torch.models.registry import build_generator
from floodgan_tpu_torch.serve import (
    BatchingFrontend,
    FrontendOverloaded,
    InferenceEngine,
    ModelRepository,
    serve_http,
)
from floodgan_tpu_torch.utils.jax_params import state_dict_from_jax

S = 32


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine on the CPU) over the same fresh
    PairedAttention weights, batch 4 at 32^2."""
    g = jax_build_generator("pairedattention", 9)
    params = g.init(jax.random.key(0), jnp.zeros((1, S, S, 9)))["params"]
    jax_engine = JaxInferenceEngine(
        "pairedattention", params, "all", batch_size=4, image_size=S, compute_dtype="float32"
    )
    sd = state_dict_from_jax(build_generator("pairedattention", 9), jax.tree.map(np.asarray, params))
    port = InferenceEngine("pairedattention", sd, "all", batch_size=4, image_size=S, device="cpu")
    return jax_engine, port


@pytest.fixture(scope="module")
def tiny_engine(engines):
    return engines[1]


def test_preprocess_matches_jax(engines, rng):
    jax_engine, port = engines
    stacks = rng.random((4, 48, 48, 9), dtype=np.float32)
    want = np.asarray(jax_engine.preprocess(stacks))
    got = port.preprocess(stacks)
    assert got.device.type == "cpu" and got.shape == (4, S, S, 9)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_predict_matches_jax(engines, rng):
    jax_engine, port = engines
    x = port.preprocess(rng.random((4, S, S, 9), dtype=np.float32)).numpy()
    want = np.asarray(jax_engine.predict(x))
    got = port.predict(x)
    assert got.shape == (4, S, S, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    # same inputs, same outputs
    torch.testing.assert_close(port.predict(x), got, rtol=0, atol=0)


def test_engine_without_device_needs_the_card(tiny_engine, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine("pairedattention", tiny_engine.gen_params, "all", batch_size=1, image_size=S)


def test_wire_dtype_bf16_quantizes_only_the_wire(tiny_engine, rng):
    bf16 = InferenceEngine(
        "pairedattention", tiny_engine.gen_params, "all", batch_size=4, image_size=S,
        wire_dtype="bfloat16", aot=False, device="cpu",
    )
    x = rng.standard_normal((4, S, S, 9)).astype(np.float32)
    ref = tiny_engine.predict(x)
    out = bf16.predict(x)
    torch.testing.assert_close(out, tiny_engine.predict(torch.from_numpy(x).bfloat16()))
    torch.testing.assert_close(out, ref, rtol=0, atol=5e-2)


def test_batching_frontend_groups_and_matches_engine(tiny_engine, rng):
    fe = BatchingFrontend(tiny_engine, max_delay_ms=200.0)
    stacks = rng.random((4, S, S, 9), dtype=np.float32)
    want = tiny_engine.predict(stacks).numpy()
    futs = [fe.submit(s) for s in stacks]
    got = np.stack([f.result(timeout=60) for f in futs])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    stats = fe.stats()
    assert stats["requests"] == 4 and stats["batches"] >= 1
    fe.close()


def test_batching_frontend_partial_batch_padding(tiny_engine, rng):
    fe = BatchingFrontend(tiny_engine, max_delay_ms=1.0)
    stack = rng.random((S, S, 9), dtype=np.float32)
    padded = np.concatenate([stack[None], np.zeros((3, S, S, 9), np.float32)])
    want = tiny_engine.predict(padded).numpy()[0]
    got = fe.predict(stack, timeout=60)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert fe.stats()["mean_occupancy"] <= 0.5
    fe.close()


def test_batching_frontend_rejects_bad_shape(tiny_engine):
    fe = BatchingFrontend(tiny_engine)
    with pytest.raises(ValueError):
        fe.submit(np.zeros((16, 16, 9), np.float32))
    with pytest.raises(ValueError):
        fe.submit_many([np.zeros((8, 8, 9), np.float32)])
    fe.close()


def test_batching_frontend_close_drains_queue(tiny_engine, rng):
    fe = BatchingFrontend(tiny_engine, max_delay_ms=50.0)
    futs = [fe.submit(s) for s in rng.random((6, S, S, 9), dtype=np.float32)]
    fe.close()
    for f in futs:
        assert f.result(timeout=60).shape == (S, S, 3)
    with pytest.raises(RuntimeError):
        fe.submit(np.zeros((S, S, 9), np.float32))
    fe.close()  # idempotent


def test_frontend_admission_control(tiny_engine):
    fe = BatchingFrontend(tiny_engine, max_delay_ms=200.0, max_pending=2)
    x = np.zeros(tiny_engine.input_shape, np.float32)
    f1, f2 = fe.submit(x), fe.submit(x)
    with pytest.raises(FrontendOverloaded):
        fe.submit(x)
    assert fe.stats()["pending"] == 2
    f1.result(timeout=60)
    f2.result(timeout=60)
    assert fe.stats()["pending"] == 0
    fe.submit(x).result(timeout=60)
    # multi-image admission is all or nothing
    with pytest.raises(FrontendOverloaded):
        fe.submit_many([x] * 3)
    assert fe.stats()["pending"] == 0
    fe.close()


def _post(url: str, body: bytes, timeout: float = 60):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return np.load(io.BytesIO(r.read()))


def _npy(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _raw_status(port: int, request: bytes) -> str:
    with socket.create_connection(("127.0.0.1", port), timeout=30) as conn:
        conn.sendall(request)
        return conn.recv(1024).decode(errors="replace").splitlines()[0]


def test_model_repository_and_http_server(tiny_engine, rng):
    repo = ModelRepository()
    repo.add("flood", tiny_engine, max_delay_ms=1.0)
    with pytest.raises(ValueError):
        repo.add("flood", tiny_engine)
    with pytest.raises(KeyError):
        repo.frontend("nope")
    server = serve_http(repo, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r)["status"] == "ok"
        stack = rng.random((S, S, 9), dtype=np.float32)
        out = _post(f"{base}/v1/models/flood:predict", _npy(stack))
        assert out.shape == (S, S, 3)
        np.testing.assert_allclose(out, repo.predict("flood", stack), rtol=1e-5, atol=1e-6)
        out = _post(f"{base}/v1/models/flood:predict", _npy(rng.random((2, S, S, 9), dtype=np.float32)))
        assert out.shape == (2, S, S, 3)
        with urllib.request.urlopen(f"{base}/v1/models", timeout=30) as r:
            models = json.load(r)
        assert models["flood"]["requests"] >= 3 and models["flood"]["model"] == "pairedattention"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{base}/v1/models/nope:predict", _npy(stack), timeout=30)
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{base}/v1/models/flood:predict", _npy(np.zeros((8, 8, 9))), timeout=30)
        assert ei.value.code == 400
        head = b"POST /v1/models/flood:predict HTTP/1.1\r\nHost: t\r\n"
        assert " 413 " in _raw_status(port, head + b"Content-Length: 68719476736\r\n\r\n")
        assert " 400 " in _raw_status(port, head + b"Content-Length: -1\r\n\r\n")
    finally:
        server.shutdown()
        repo.close()


@pytest.mark.parametrize(
    "name,want",
    [
        ("void (anonymous namespace)::in_act_kernel<float>(float const*)", "in_act (K1)"),
        ("void (anonymous namespace)::compose_kernel(float const*)", "attention_compose (K3)"),
        ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw", "convolution"),
        ("void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>", "convolution"),
        ("void at::native::reflection_pad2d_out_kernel<float>(float const*)", "reflect pad"),
        ("Memcpy HtoD (Pageable -> Device)", "host<->card copy"),
        ("void at::native::elementwise_kernel<128, 2>", "other"),
    ],
)
def test_serve_profile_categories(name, want):
    assert serve_profile.category(name) == want


def test_serve_profile_busy_time_is_the_union_of_intervals():
    assert serve_profile.busy_us([]) == 0.0
    assert serve_profile.busy_us([(5.0, 6.0), (0.0, 2.0), (1.0, 3.0), (3.0, 4.0)]) == 5.0


def test_serve_profile_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        serve_profile.profile_engine(batch=1, size=32, iters=1)


def test_http_overload_returns_503(tiny_engine, monkeypatch):
    """A request counts as pending until the worker stages it: with the
    worker held in its first batch's launch, a second request stays queued
    and fills the one pending slot, and an HTTP request is refused."""
    launching, release = threading.Event(), threading.Event()
    launch = tiny_engine.launch

    def held_launch(*args, **kwargs):
        launching.set()
        assert release.wait(60)
        return launch(*args, **kwargs)

    monkeypatch.setattr(tiny_engine, "launch", held_launch)
    repo = ModelRepository()
    repo.add("flood", tiny_engine, max_delay_ms=0.0, max_pending=1)
    server = serve_http(repo, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        x = np.zeros(tiny_engine.input_shape, np.float32)
        first = repo.frontend("flood").submit(x)
        assert launching.wait(60)
        fut = repo.frontend("flood").submit(x)  # occupies the one pending slot
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"http://127.0.0.1:{server.server_address[1]}/v1/models/flood:predict", _npy(x), timeout=30)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["retry"] is True
        release.set()
        first.result(timeout=60)
        fut.result(timeout=60)
    finally:
        release.set()
        server.shutdown()
        repo.close()
