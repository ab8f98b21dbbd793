"""The port's kernel wrappers against the Pallas kernels.

On CPU tensors the wrappers take their plain versions; the Pallas kernels
run in interpret mode, as tests/test_pallas.py runs them, over its cases.
Inputs come from numpy (seed 47) in NHWC and cross to NCHW at the
boundary.  The kernels themselves are checked on the card by
``chip_smoke.py``.
"""

import os
import stat
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu.ops import pallas_kernels as pk
from floodgan_tpu_torch.ops import _build, kernels


@pytest.fixture(scope="module", autouse=True)
def warm_torch_exp():
    """Seen with the CPU build of torch 2.13 in a process that has JAX
    loaded: the first torch.exp of the process, spread over several
    intra-op threads, can come out up to 4e-5 off, and every later call is
    exact to float rounding (never seen with one thread).  One discarded
    call over enough elements to reach every thread keeps the comparisons
    about the port's arithmetic."""
    torch.exp(torch.randn(1 << 20))


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize(
    "relu,residual,slope",
    [(False, False, 0.0), (True, False, 0.0), (False, True, 0.0), (True, False, 0.2)],
)
@pytest.mark.parametrize("shape", [(1, 32, 32, 256), (2, 16, 16, 128), (1, 8, 8, 64)])
def test_instance_norm_act_matches_pallas(rng, shape, relu, residual, slope):
    x = rng.standard_normal(shape, dtype=np.float32)
    res = rng.standard_normal(shape, dtype=np.float32) if residual else None
    want = pk.fused_instance_norm(
        jnp.asarray(x), residual=None if res is None else jnp.asarray(res),
        relu=relu, negative_slope=slope,
    )
    got = kernels.instance_norm_act(
        nchw(x), relu=relu, residual=None if res is None else nchw(res), negative_slope=slope
    )
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


def test_instance_norm_act_bf16_matches_pallas(rng):
    x = jnp.asarray(rng.standard_normal((1, 16, 16, 128), dtype=np.float32)).astype(jnp.bfloat16)
    want = pk.fused_instance_norm(x, relu=True)
    got = kernels.instance_norm_act(nchw(np.asarray(x, np.float32)).to(torch.bfloat16), relu=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got), np.asarray(want, np.float32), atol=2e-2)


def test_instance_norm_act_odd_channels_matches_pallas_fallback(rng):
    # 96 channels: the Pallas entry takes its jnp fallback; same contract
    x = rng.standard_normal((1, 8, 8, 96), dtype=np.float32)
    want = pk.fused_instance_norm(jnp.asarray(x), relu=True)
    got = kernels.instance_norm_act(nchw(x), relu=True)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("n,h,w", [(1, 32, 64), (1, 16, 16), (2, 8, 8)])
def test_attention_compose_matches_pallas(rng, n, h, w):
    content = np.tanh(rng.standard_normal((n, h, w, 27), dtype=np.float32))
    logits = rng.standard_normal((n, h, w, 10), dtype=np.float32)
    rgb = rng.standard_normal((n, h, w, 3), dtype=np.float32)
    want_out, want_mask = pk.attention_compose(
        jnp.asarray(content), jnp.asarray(logits), jnp.asarray(rgb)
    )
    got_out, got_mask = kernels.attention_compose(nchw(content), nchw(logits), nchw(rgb))
    assert got_out.shape == (n, 3, h, w) and got_mask.shape == (n, h, w)
    np.testing.assert_allclose(nhwc(got_out), np.asarray(want_out), atol=1e-5)
    np.testing.assert_allclose(got_mask.numpy(), np.asarray(want_mask), atol=1e-6)


def test_attention_compose_reads_rgb_through_a_channel_slice(rng):
    """The generator passes x[:, :3] of its 9-channel input: a strided view."""
    x = nchw(rng.standard_normal((2, 8, 8, 9), dtype=np.float32))
    content = nchw(np.tanh(rng.standard_normal((2, 8, 8, 27), dtype=np.float32)))
    logits = nchw(rng.standard_normal((2, 8, 8, 10), dtype=np.float32))
    got = kernels.attention_compose(content, logits, x[:, :3])
    want = kernels.attention_compose(content, logits, x[:, :3].contiguous())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_cpu_tensors_launch_nothing(rng):
    before = dict(kernels.LAUNCHES)
    x = nchw(rng.standard_normal((1, 4, 4, 8), dtype=np.float32))
    kernels.instance_norm_act(x, relu=True)
    kernels.attention_compose(
        torch.zeros(1, 27, 4, 4), torch.zeros(1, 10, 4, 4), torch.zeros(1, 3, 4, 4)
    )
    assert kernels.LAUNCHES == before


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor off the CPU launches the kernel or raises: a meta tensor
    (no kernel for it) must raise, not be computed by the plain version."""
    x = torch.empty((1, 8, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernels.instance_norm_act(x, relu=True)
    with pytest.raises(ValueError, match="no kernel"):
        kernels.attention_compose(
            torch.empty((1, 27, 4, 4), device="meta"),
            torch.empty((1, 10, 4, 4), device="meta"),
            torch.empty((1, 3, 4, 4), device="meta"),
        )


def _fake_nvcc(tmp_path, body: str) -> str:
    """A stand-in compiler under tmp_path/cuda/bin, found through CUDA_HOME."""
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\nargs = sys.argv[1:]\n{body}\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return str(tmp_path / "cuda")


def test_build_reuses_the_library_for_unchanged_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", _fake_nvcc(
        tmp_path,
        "open(args[args.index('-o') + 1], 'w').close()\nprint('ptxas info: fake')",
    ))
    path, log = _build.build()
    assert path.parent == tmp_path / "build" and path.exists()
    assert _build.source_hash() in path.name and "ptxas info" in log
    again, log2 = _build.build()
    assert again == path and log2 == ""
    assert [p.name for p in (tmp_path / "build").iterdir()] == [path.name]


def test_build_hash_follows_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.sources():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    h0 = _build.source_hash()
    assert h0 == _build.source_hash()
    with open(csrc / "instance_norm.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.source_hash() != h0


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", _fake_nvcc(
        tmp_path, "sys.stderr.write('error: fake compile failure\\n')\nsys.exit(2)"
    ))
    with pytest.raises(RuntimeError, match="fake compile failure"):
        _build.build()
    assert not any(os.scandir(tmp_path / "build"))


def test_build_compiles_each_source_in_its_own_call_then_links(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    calls = tmp_path / "calls.txt"
    monkeypatch.setenv("CUDA_HOME", _fake_nvcc(
        tmp_path,
        f"open({str(calls)!r}, 'a').write(' '.join(args) + '\\n')\n"
        "open(args[args.index('-o') + 1], 'w').close()",
    ))
    _build.build()
    lines = [line.split() for line in calls.read_text().splitlines()]
    compiles = [a for a in lines if "-c" in a]
    links = [a for a in lines if "-shared" in a]
    assert sorted(a[-1] for a in compiles) == sorted(str(p) for p in _build.sources())
    assert len(links) == 1 and len(lines) == len(compiles) + 1
    assert sorted(a for a in links[0] if a.endswith(".o")) == sorted(a[a.index("-o") + 1] for a in compiles)
