"""The port's content-head microbench and its row copy (K5) against the JAX
tool, tools/microbench_head.py, loaded unedited.

Inputs come from numpy (seed 47) and both tools take them as they are:
``xp`` (N, H, W, C), ``w`` HWIO.  The JAX tool's variants hard-code a 518^2
padded input, so the cases run at full spatial size with narrow channels,
in f32.  Its Pallas fence runs in interpret mode: its ``pallas_call`` has no
``interpret=`` argument, so the test patches ``pallas_call`` itself, which
the tool looks up when the variant runs.  K5 itself is checked on the card
by ``chip_smoke.py``.
"""

import functools
import importlib.util
import os
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from floodgan_tpu.ops.nn_ops import DIMSPEC, reflect_pad2d
from floodgan_tpu_torch.ops import kernels
from floodgan_tpu_torch.tools import microbench_head as port

ROOT = Path(__file__).resolve().parents[1]
NAMES = sorted(port.HEADS)
DIFFERENTIABLE = [n for n in NAMES if n not in port.FORWARD_ONLY]
# f32 on the CPU.  The variants sum the 7x7x4 taps in other orders; JAX's
# own spread between them is 2.4e-6 here, and the port has matched JAX to
# the bit.  The loss sums 7.1e6 squares, in another order in each package.
TOL_HEAD = 1e-5
RTOL_LOSS = 1e-5
TOL_GRAD = 1e-5   # against max |grad| of 3.8


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_microbench_head", ROOT / "tools" / "microbench_head.py")
    tool = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):  # the tool sets a compilation-cache default at import
        spec.loader.exec_module(tool)
    return tool


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def head_inputs():
    rng = np.random.default_rng(47)
    xp = rng.standard_normal((1, 518, 518, 4), np.float32)
    w = rng.standard_normal((7, 7, 4, 27), np.float32) * 0.05
    return xp, w


@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.default_rng(47)
    h = rng.standard_normal((1, 256, 256, 4), np.float32)
    wt = rng.standard_normal((3, 3, 4, 4), np.float32) * 0.05
    w7 = rng.standard_normal((7, 7, 4, 27), np.float32) * 0.05
    return h, wt, w7


def _jax_loss(tool, name, wt, w7):
    """The JAX tool's ``loss`` of ``main``, for one variant."""
    def loss(h):
        x = lax.conv_general_dilated(h, jnp.flip(wt, (0, 1)), (1, 1), ((1, 2), (1, 2)),
                                     lhs_dilation=(2, 2), dimension_numbers=DIMSPEC)
        out = tool.HEADS[name](reflect_pad2d(x, 3), w7)
        return jnp.sum(out.astype(jnp.float32) ** 2)
    return loss


def test_port_has_the_jax_tools_variants(jax_tool):
    assert list(port.HEADS) == list(jax_tool.HEADS)


@pytest.mark.parametrize("name", NAMES)
def test_head_matches_jax(jax_tool, pallas_interpret, head_inputs, name):
    xp, w = head_inputs
    want = np.asarray(jax.jit(jax_tool.HEADS[name])(xp, w))
    got = port.HEADS[name](torch.from_numpy(xp), torch.from_numpy(w))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_HEAD)


def test_upsample_pad_matches_jax(loss_inputs):
    h, wt, _ = loss_inputs
    x = lax.conv_general_dilated(h, jnp.flip(wt, (0, 1)), (1, 1), ((1, 2), (1, 2)),
                                 lhs_dilation=(2, 2), dimension_numbers=DIMSPEC)
    want = np.asarray(reflect_pad2d(x, 3))
    got = port.upsample_pad(torch.from_numpy(h), torch.from_numpy(wt))
    assert got.shape == want.shape == (1, 518, 518, 4) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", DIFFERENTIABLE)
def test_loss_and_grad_match_jax(jax_tool, loss_inputs, name):
    h, wt, w7 = loss_inputs
    value, grad = jax.jit(jax.value_and_grad(_jax_loss(jax_tool, name, wt, w7)))(h)
    th, twt, tw7 = (torch.from_numpy(a) for a in (h, wt, w7))
    got_value = float(port.make_loss(port.HEADS[name], twt, tw7)(th))
    got_grad = port.make_step(port.HEADS[name], twt, tw7, fwd=False)(th)
    np.testing.assert_allclose(got_value, float(value), rtol=RTOL_LOSS)
    assert got_grad.shape == h.shape
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(grad), rtol=0, atol=TOL_GRAD)
    fwd_value = port.make_step(port.HEADS[name], twt, tw7, fwd=True)(th)
    assert fwd_value.grad_fn is None and float(fwd_value) == got_value


def test_pallasfence_has_no_gradient_in_either_tool(jax_tool, pallas_interpret):
    rng = np.random.default_rng(47)
    xp = rng.standard_normal((1, 16, 16, 4), np.float32)
    w = rng.standard_normal((7, 7, 4, 27), np.float32) * 0.05
    with pytest.raises(ValueError):
        jax.grad(lambda x: jnp.sum(jax_tool.head_raw_pallasfence(x, w) ** 2))(xp)
    x = torch.from_numpy(xp).requires_grad_()
    out = port.head_raw_pallasfence(x, torch.from_numpy(w))
    assert out.grad_fn is not None  # a gradient would not stop without a word
    with pytest.raises(NotImplementedError, match="no reverse rule"):
        (out ** 2).sum().backward()


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """x's values in a contiguous view that starts one element into its storage."""
    view = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 3, 5, 7), (2, 1, 1, 1), (3, 17, 19, 5)])
@pytest.mark.parametrize("start", ["aligned", "inside"])
def test_row_copy_on_the_cpu_is_a_bitwise_copy_in_new_storage(shape, dtype, start):
    gen = torch.Generator().manual_seed(47)
    x = torch.randn(shape, generator=gen).to(dtype)
    if start == "inside":
        x = _misaligned(x)
    before = dict(kernels.LAUNCHES)
    for got in (kernels.row_copy(x), kernels.row_copy_fwd(x), kernels.row_copy_plain(x)):
        assert got.shape == x.shape and got.dtype == dtype and got.is_contiguous()
        assert got.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
        assert torch.equal(got.reshape(-1).view(torch.uint8), x.reshape(-1).view(torch.uint8))
    assert kernels.LAUNCHES == before


def test_row_copy_never_takes_the_plain_version_off_the_cpu():
    with pytest.raises(ValueError, match="no kernel"):
        kernels.row_copy_fwd(torch.empty((8, 518, 518, 64), device="meta"))


@pytest.fixture
def small_tool(monkeypatch):
    """The tool's context cut to batch 2, 8 -> 32 channels, 16^2 -> 32^2."""
    for name, value in (("B", 2), ("SIZE", 16), ("C_IN", 8), ("C_MID", 32)):
        monkeypatch.setattr(port, name, value)


def test_main_check_on_the_cpu(small_tool, capsys):
    out = port.main(["--variant", "check", "--device", "cpu"])
    diffs = out["max_abs_diff"]
    assert set(diffs) == set(port.HEADS)
    ulp = 2.0 ** -7 * out["max_abs_raw"]  # bf16 context
    assert diffs["raw"] == diffs["raw_ob"] == diffs["raw_relayout"] == diffs["raw_pallasfence"] == 0.0
    assert diffs["pad128_ob"] == diffs["pad128"]
    for name in ("pad128", "rowsum", "s2d", "s2d2", "raw_nchw"):
        assert diffs[name] <= 4 * ulp, name
    assert diffs["none"] > 4 * ulp  # no conv: a different function
    printed = capsys.readouterr().out
    assert all(f"{name} max|diff| =" in printed for name in port.HEADS)


@pytest.mark.parametrize("fwd", [False, True], ids=["fwd+bwd", "fwd"])
def test_main_race_on_the_cpu(small_tool, capsys, fwd):
    before = kernels.LAUNCHES["copy"]
    out = port.main(["--variant", "all", "--iters", "1", "--device", "cpu"] + (["--fwd"] if fwd else []))
    timed = set(port.HEADS) if fwd else set(DIFFERENTIABLE)
    assert out["mode"] == ("fwd" if fwd else "fwd+bwd") and set(out["ms"]) == timed
    assert all(t > 0 for t in out["ms"].values())
    assert ("raw_pallasfence fwd+bwd skipped: forward only" in capsys.readouterr().out) != fwd
    assert kernels.LAUNCHES["copy"] == before  # the CPU launches nothing


def test_head_flops_follow_the_jax_tool():
    assert port.head_flops(fwd=False) == 2 * 8 * 512 * 512 * 64 * 27 * 49 * 3
    assert port.head_flops(fwd=True) * 3 == port.head_flops(fwd=False)


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["--variant", "check"])


def test_profile_needs_the_card():
    with pytest.raises(SystemExit):
        port.main(["--variant", "raw", "--device", "cpu", "--profile"])
