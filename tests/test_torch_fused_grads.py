"""The port's ops/fused_grads.py against the JAX package's, on the CPU.

Each function goes through JAX's ``fused_grads`` (``jax.vjp``, f32) and
the port's plain route (CPU tensors take the kernels' plain versions) on
the same inputs, made with numpy from a seed in NHWC and crossed to NCHW
at the boundary.  Limits: the instance norm's forward within 1e-5 and its
gradients within 1e-4 (K1/K2's f32 limit: another summation order of the
plane sums); the reflect pad and its adjoint bit for bit (the same adds
in the same order); the reflect conv's gradients against JAX's band
backward within rtol 1e-4 (other convolution orders); batch norm within
1e-4.  The kernels themselves (K1, K2, K6) are held against these plain
versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu import ops as jops
from floodgan_tpu.ops import fused_grads as jfg
from floodgan_tpu_torch.ops import fused_grads, kernels, nn_ops

from torch_seg_fixtures import few_torch_threads

SEED = 47
IN_CASES = [(False, 0.0), (True, 0.0), (True, 0.2)]
IN_SHAPE = (2, 12, 10, 8)  # NHWC


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from few_torch_threads()


@pytest.fixture
def rng():
    return np.random.default_rng(SEED)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _leaf(a) -> torch.Tensor:
    return nchw(a).requires_grad_()


@pytest.mark.parametrize("relu,slope", IN_CASES)
def test_in_act_matches_jax(rng, relu, slope):
    x = rng.standard_normal(IN_SHAPE, dtype=np.float32) + 0.5
    cot = rng.standard_normal(IN_SHAPE, dtype=np.float32)
    want, vjp = jax.vjp(lambda a: jfg.in_act(a, relu, slope), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))

    xt = _leaf(x)
    got = fused_grads.in_act(xt, relu, slope)
    got.backward(nchw(cot))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(want_dx), atol=1e-4)


@pytest.mark.parametrize("relu,slope", IN_CASES)
def test_in_act_res_matches_jax(rng, relu, slope):
    x = rng.standard_normal(IN_SHAPE, dtype=np.float32) + 0.5
    res = rng.standard_normal(IN_SHAPE, dtype=np.float32)
    cot = rng.standard_normal(IN_SHAPE, dtype=np.float32)
    want, vjp = jax.vjp(lambda a, r: jfg.in_act_res(a, r, relu, slope), jnp.asarray(x), jnp.asarray(res))
    want_dx, want_dres = vjp(jnp.asarray(cot))

    xt, rt = _leaf(x), _leaf(res)
    got = fused_grads.in_act_res(xt, rt, relu, slope)
    got.backward(nchw(cot))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(want_dx), atol=1e-4)
    np.testing.assert_allclose(nhwc(rt.grad), np.asarray(want_dres), atol=1e-4)


@pytest.mark.parametrize("pad", [1, 3])
def test_reflect_pad2d_matches_jax_bit_for_bit(rng, pad):
    x = rng.standard_normal((2, 9, 11, 3), dtype=np.float32)
    padded = (2, 9 + 2 * pad, 11 + 2 * pad, 3)
    cot = rng.standard_normal(padded, dtype=np.float32)
    want, vjp = jax.vjp(lambda a: jfg.reflect_pad2d(a, pad), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))

    xt = _leaf(x)
    got = fused_grads.reflect_pad2d(xt, pad)
    got.backward(nchw(cot))
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    np.testing.assert_array_equal(nhwc(xt.grad), np.asarray(want_dx))


@pytest.mark.parametrize("pad", [1, 3])
def test_reflect_conv2d_matches_jax_band_backward(rng, pad):
    k = 2 * pad + 1
    x = rng.standard_normal((2, 12, 13, 6), dtype=np.float32)
    w = rng.standard_normal((k, k, 6, 5), dtype=np.float32) * 0.1
    b = rng.standard_normal((5,), dtype=np.float32)
    cot = rng.standard_normal((2, 12, 13, 5), dtype=np.float32)
    want, vjp = jax.vjp(lambda a, ww, bb: jfg.reflect_conv2d(a, ww, bb, pad),
                        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want_dx, want_dw, want_db = vjp(jnp.asarray(cot))

    xt = _leaf(x)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    got = fused_grads.reflect_conv2d(xt, wt, bt, pad)
    got.backward(nchw(cot))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(want_dx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0), np.asarray(want_dw), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want_db), rtol=1e-4, atol=1e-5)


def test_reflect_conv2d_refuses_a_kernel_other_than_2_pad_plus_1():
    with pytest.raises(ValueError, match="k = 2\\*pad\\+1"):
        fused_grads.reflect_conv2d(torch.zeros(1, 2, 8, 8), torch.zeros(3, 2, 5, 5), None, 1)


@pytest.mark.parametrize("spatial", [None, object()], ids=["one process", "spatial"])
def test_nn_ops_reflect_conv2d_checks_the_kernel_on_both_paths(spatial):
    # The check comes before the pad, so no group is ever reached.
    with pytest.raises(ValueError, match="k = 2\\*pad\\+1"):
        nn_ops.reflect_conv2d(torch.zeros(1, 2, 8, 8), torch.zeros(3, 2, 5, 5), None, 1, spatial=spatial)


def test_batch_norm_matches_jax(rng):
    x = rng.standard_normal((4, 8, 8, 16), dtype=np.float32)
    scale = (1.0 + 0.02 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.02 * rng.standard_normal(16)).astype(np.float32)
    cot = rng.standard_normal(x.shape, dtype=np.float32)
    want, vjp = jax.vjp(jfg.batch_norm, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want_dx, want_ds, want_db = vjp(jnp.asarray(cot))

    xt = _leaf(x)
    st, bt = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    got = fused_grads.batch_norm(xt, st, bt)
    got.backward(nchw(cot))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(want_dx), atol=1e-4)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_ds), atol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want_db), atol=1e-4)
    assert nn_ops.batch_norm is fused_grads.batch_norm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu,slope", IN_CASES)
def test_saved_stats_plain_k2_equals_the_recompute_form(rng, dtype, relu, slope):
    x = nchw(rng.standard_normal(IN_SHAPE, dtype=np.float32) + 0.5).to(dtype)
    g = nchw(rng.standard_normal(IN_SHAPE, dtype=np.float32)).to(dtype)
    y, stats = kernels.instance_norm_act_plain(x, relu, None, slope, save_stats=True)
    assert stats.shape == (2, 8, 2) and stats.dtype == torch.float32
    assert torch.equal(y, kernels.instance_norm_act_plain(x, relu, None, slope))
    saved = kernels.instance_norm_act_bwd(x, g, relu, slope, stats=stats)
    again = kernels.instance_norm_act_bwd(x, g, relu, slope)
    assert torch.equal(saved, again)


def test_in_act_saves_statistics_only_for_a_gradient(rng):
    """The Function saves (x, stats) where x needs a gradient, and nothing
    for a forward without one (serving's sites move no extra bytes)."""
    x = nchw(rng.standard_normal(IN_SHAPE, dtype=np.float32))
    y = fused_grads.in_act(x.requires_grad_(), True)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 2 and saved[0] is x and saved[1].shape == (2, 8, 2)
    with torch.no_grad():
        assert fused_grads.in_act(x.detach(), True).grad_fn is None


def test_reflect_pad_backward_folds_asymmetric_pads_in_jax_order(rng):
    """The W-only pad of the spatial axis and uneven pads: the plain K6
    against autograd through ``F.pad`` in float64, and one add at a time
    in bf16 (each partial sum rounded) against a float64 fold."""
    for pads in ((1, 1, 0, 0), (3, 3, 0, 0), (2, 0, 1, 3), (0, 0, 0, 0)):
        g = torch.from_numpy(rng.standard_normal((2, 3, 9 + pads[2] + pads[3], 11 + pads[0] + pads[1])))
        x = torch.zeros((2, 3, 9, 11), dtype=torch.float64, requires_grad=True)
        (want,) = torch.autograd.grad(torch.nn.functional.pad(x, pads, mode="reflect"), x, g)
        torch.testing.assert_close(kernels.reflect_pad_bwd_plain(g, pads), want, rtol=0, atol=1e-12)
        got = kernels.reflect_pad_bwd_plain(g.bfloat16(), pads).double()
        torch.testing.assert_close(got, want, rtol=0, atol=4 * 2.0 ** -8 * float(want.abs().max()))


def test_reflect_pad_cpu_launches_nothing_and_off_cpu_raises():
    before = dict(kernels.LAUNCHES)
    x = torch.randn(1, 2, 6, 7, requires_grad=True)
    kernels.reflect_pad(x, (1, 1, 1, 1)).sum().backward()
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel"):
        kernels.reflect_pad_bwd(torch.empty((1, 2, 8, 9), device="meta"), (1, 1, 1, 1))


def test_reflect_pad_bwd_refuses_pads_that_do_not_fit(monkeypatch):
    """The checks run before the kernel: a pad as wide as the plane it pads
    raises (a CUDA-typed tensor is faked by its device attribute)."""

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    g = torch.zeros((1, 1, 4, 4)).as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="do not fit"):
        kernels.reflect_pad_bwd(g, (2, 0, 1, 1))


def test_trunk_block_matches_jax_custom_vjp_route(rng):
    """The slice as a whole: a trunk block (reflect conv, IN + relu, reflect
    conv, IN + residual) through the port's nn_ops and through JAX's ops on
    its default route (custom VJPs), f32; output within 1e-5, the input's
    and both weights' gradients within 1e-4."""
    x = rng.standard_normal((2, 10, 10, 8), dtype=np.float32)
    w1 = rng.standard_normal((3, 3, 8, 8), dtype=np.float32) * 0.2
    w2 = rng.standard_normal((3, 3, 8, 8), dtype=np.float32) * 0.2
    cot = rng.standard_normal(x.shape, dtype=np.float32)

    def jax_block(a, u, v):
        h = jops.instance_norm_act(jops.reflect_conv2d(a, u, None, pad=1), relu=True)
        return jops.instance_norm_act(jops.reflect_conv2d(h, v, None, pad=1), residual=a)

    want, vjp = jax.vjp(jax_block, jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2))
    want_dx, want_dw1, want_dw2 = vjp(jnp.asarray(cot))

    xt = _leaf(x)
    u = torch.from_numpy(w1.transpose(3, 2, 0, 1).copy()).requires_grad_()
    v = torch.from_numpy(w2.transpose(3, 2, 0, 1).copy()).requires_grad_()
    h = nn_ops.instance_norm_act(nn_ops.reflect_conv2d(xt, u, None, 1), relu=True)
    got = nn_ops.instance_norm_act(nn_ops.reflect_conv2d(h, v, None, 1), residual=xt)
    got.backward(nchw(cot))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(want_dx), atol=1e-4)
    np.testing.assert_allclose(u.grad.numpy().transpose(2, 3, 1, 0), np.asarray(want_dw1), atol=1e-4)
    np.testing.assert_allclose(v.grad.numpy().transpose(2, 3, 1, 0), np.asarray(want_dw2), atol=1e-4)
