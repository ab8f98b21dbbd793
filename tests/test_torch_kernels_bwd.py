"""The port's backward kernels (K2, K4) and their autograd Functions
against the Pallas kernels.

On CPU tensors the wrappers take their plain versions; the Pallas kernels
run in interpret mode, as tests/test_pallas.py runs them, over its cases.
Inputs come from numpy (seed 47) in NHWC and cross to NCHW at the
boundary.  A float64 ``gradcheck`` holds each Function's backward against
finite differences.  The kernels themselves are checked on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu.ops import pallas_kernels as pk
from floodgan_tpu_torch.ops import kernels


@pytest.fixture(scope="module", autouse=True)
def warm_torch_exp():
    """The first torch.exp of a process can come out up to 4e-5 off with
    the CPU build of torch 2.13 (see tests/test_torch_kernels.py); discard
    one call."""
    torch.exp(torch.randn(1 << 20))


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


IN_SHAPES = [(1, 32, 32, 256), (2, 16, 16, 128), (1, 8, 8, 64)]
IN_ACTS = [(False, 0.0), (True, 0.0), (True, 0.2)]


@pytest.mark.parametrize("relu,slope", IN_ACTS, ids=["none", "relu", "leaky0.2"])
@pytest.mark.parametrize("shape", IN_SHAPES)
def test_instance_norm_bwd_plain_matches_pallas(rng, shape, relu, slope):
    x = rng.standard_normal(shape, dtype=np.float32)
    g = rng.standard_normal(shape, dtype=np.float32)
    want = pk._in_pallas_bwd_call(jnp.asarray(x), jnp.asarray(g), relu, 1e-5, slope)
    got = kernels.instance_norm_act_bwd(nchw(x), nchw(g), relu=relu, negative_slope=slope)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize(
    "relu,slope,residual",
    [(False, 0.0, False), (True, 0.0, False), (True, 0.2, False), (False, 0.0, True)],
    ids=["none", "relu", "leaky0.2", "residual"],
)
def test_instance_norm_function_matches_pallas_vjp(rng, relu, slope, residual):
    shape = (2, 16, 16, 128)
    x = rng.standard_normal(shape, dtype=np.float32)
    r = rng.standard_normal(shape, dtype=np.float32)
    g = rng.standard_normal(shape, dtype=np.float32)

    def f(x_, r_):
        return pk.fused_instance_norm(x_, residual=r_ if residual else None, relu=relu, negative_slope=slope)

    y_want, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(r))
    dx_want, dr_want = vjp(jnp.asarray(g))

    xt = nchw(x).requires_grad_()
    rt = nchw(r).requires_grad_()
    y = kernels.instance_norm_act(xt, relu=relu, residual=rt if residual else None, negative_slope=slope)
    y.backward(nchw(g))
    np.testing.assert_allclose(nhwc(y), np.asarray(y_want), atol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(dx_want), atol=1e-5)
    if residual:
        np.testing.assert_array_equal(nhwc(rt.grad), g)  # passthrough
    else:
        assert rt.grad is None


def test_instance_norm_bwd_bf16_matches_pallas(rng):
    x = jnp.asarray(rng.standard_normal((1, 16, 16, 128), dtype=np.float32)).astype(jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal((1, 16, 16, 128), dtype=np.float32)).astype(jnp.bfloat16)
    want = pk._in_pallas_bwd_call(x, g, True, 1e-5, 0.2)
    got = kernels.instance_norm_act_bwd(
        nchw(np.asarray(x, np.float32)).to(torch.bfloat16),
        nchw(np.asarray(g, np.float32)).to(torch.bfloat16),
        relu=True, negative_slope=0.2,
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got), np.asarray(want, np.float32), atol=2e-2)


def test_instance_norm_bwd_odd_plane_matches_formula(rng):
    """hw = 63^2, the PatchGAN's last norm at 512^2, where JAX's Pallas
    entry takes its jnp fallback: the port's plain backward against JAX
    autodiff of the same forward."""
    x = rng.standard_normal((1, 63, 63, 8), dtype=np.float32)
    g = rng.standard_normal((1, 63, 63, 8), dtype=np.float32)
    _, vjp = jax.vjp(lambda x_: pk._instance_norm_jnp(x_, None, True, 1e-5, 0.2), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    got = kernels.instance_norm_act_bwd(nchw(x), nchw(g), relu=True, negative_slope=0.2)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


def _compose_inputs(rng, n, h, w):
    content = np.tanh(rng.standard_normal((n, h, w, 27), dtype=np.float32))
    logits = rng.standard_normal((n, h, w, 10), dtype=np.float32)
    rgb = rng.standard_normal((n, h, w, 3), dtype=np.float32)
    gout = rng.standard_normal((n, h, w, 3), dtype=np.float32)
    gmask = rng.standard_normal((n, h, w), dtype=np.float32)
    return content, logits, rgb, gout, gmask


@pytest.mark.parametrize("with_gmask", [True, False], ids=["gmask", "no_gmask"])
@pytest.mark.parametrize("n,h,w", [(1, 32, 64), (1, 16, 16), (2, 8, 8)])
def test_attention_compose_bwd_plain_matches_pallas(rng, n, h, w, with_gmask):
    content, logits, rgb, gout, gmask = _compose_inputs(rng, n, h, w)
    if not with_gmask:
        gmask = np.zeros_like(gmask)
    want = pk._compose_bwd_call(*(jnp.asarray(a) for a in (content, logits, rgb, gout, gmask)))
    got = kernels.attention_compose_bwd(
        nchw(content), nchw(logits), nchw(rgb), nchw(gout),
        torch.from_numpy(gmask) if with_gmask else None,
    )
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(wnt), atol=1e-5)


def test_attention_compose_bwd_skips_drgb(rng):
    content, logits, rgb, gout, _ = _compose_inputs(rng, 1, 8, 8)
    args = (nchw(content), nchw(logits), nchw(rgb), nchw(gout))
    with_rgb = kernels.attention_compose_bwd(*args)
    dcontent, dlogits, drgb = kernels.attention_compose_bwd(*args, rgb_grad=False)
    assert drgb is None
    torch.testing.assert_close(dcontent, with_rgb[0], rtol=0, atol=0)
    torch.testing.assert_close(dlogits, with_rgb[1], rtol=0, atol=0)


@pytest.mark.parametrize("use_mask", [True, False], ids=["mask_in_loss", "mask_unused"])
def test_attention_compose_function_matches_pallas_vjp(rng, use_mask):
    """Autograd through ``attention_compose`` against jax.vjp of the Pallas
    custom VJP.  With the mask out of the loss, autograd hands the backward
    no mask gradient (zero on the JAX side); rgb taken as the channel slice
    of a 9-channel input that needs no gradient gets none."""
    content, logits, _, gout, gmask = _compose_inputs(rng, 2, 16, 16)
    x9 = rng.standard_normal((2, 16, 16, 9), dtype=np.float32)
    if not use_mask:
        gmask = np.zeros_like(gmask)
    (out_w, mask_w), vjp = jax.vjp(
        pk.attention_compose, jnp.asarray(content), jnp.asarray(logits), jnp.asarray(x9[..., :3])
    )
    dc_w, dl_w, _ = vjp((jnp.asarray(gout), jnp.asarray(gmask)))

    ct = nchw(content).requires_grad_()
    lt = nchw(logits).requires_grad_()
    xt = nchw(x9)
    out, mask = kernels.attention_compose(ct, lt, xt[:, :3])
    loss = (out * nchw(gout)).sum()
    if use_mask:
        loss = loss + (mask * torch.from_numpy(gmask)).sum()
    loss.backward()
    np.testing.assert_allclose(nhwc(out), np.asarray(out_w), atol=1e-5)
    np.testing.assert_allclose(mask.detach().numpy(), np.asarray(mask_w), atol=1e-6)
    np.testing.assert_allclose(nhwc(ct.grad), np.asarray(dc_w), atol=1e-5)
    np.testing.assert_allclose(nhwc(lt.grad), np.asarray(dl_w), atol=1e-5)
    assert xt.grad is None


@pytest.mark.parametrize(
    "relu,slope,residual",
    [(False, 0.0, False), (True, 0.0, False), (True, 0.2, False), (False, 0.0, True), (True, 0.2, True)],
    ids=["none", "relu", "leaky0.2", "residual", "leaky0.2+residual"],
)
def test_instance_norm_function_gradcheck(relu, slope, residual):
    gen = torch.Generator().manual_seed(47)
    x = torch.randn((2, 3, 5, 4), generator=gen, dtype=torch.float64, requires_grad=True)
    r = torch.randn((2, 3, 5, 4), generator=gen, dtype=torch.float64, requires_grad=True)

    def f(x_, r_):
        return kernels.InstanceNormAct.apply(x_, r_ if residual else None, relu, slope, kernels.EPS)

    assert torch.autograd.gradcheck(f, (x, r))


@pytest.mark.parametrize("outputs", ["both", "out_only", "mask_only"])
def test_attention_compose_function_gradcheck(outputs):
    gen = torch.Generator().manual_seed(47)
    content = torch.tanh(torch.randn((1, 27, 3, 4), generator=gen, dtype=torch.float64)).requires_grad_()
    logits = torch.randn((1, 10, 3, 4), generator=gen, dtype=torch.float64, requires_grad=True)
    rgb = torch.randn((1, 3, 3, 4), generator=gen, dtype=torch.float64, requires_grad=True)

    def f(c, lg, r):
        out, mask = kernels.AttentionCompose.apply(c, lg, r)
        return {"both": (out, mask), "out_only": out, "mask_only": mask}[outputs]

    assert torch.autograd.gradcheck(f, (content, logits, rgb))


def test_backward_on_cpu_tensors_launches_nothing(rng):
    before = dict(kernels.LAUNCHES)
    x = nchw(rng.standard_normal((1, 4, 4, 8), dtype=np.float32)).requires_grad_()
    kernels.instance_norm_act(x, relu=True).sum().backward()
    c = torch.zeros(1, 27, 4, 4, requires_grad=True)
    out, _ = kernels.attention_compose(c, torch.zeros(1, 10, 4, 4), torch.zeros(1, 3, 4, 4))
    out.sum().backward()
    assert kernels.LAUNCHES == before
    assert set(kernels.LAUNCHES) == {"in_act", "in_bwd", "compose", "compose_bwd", "copy",
                                     "in_stats", "in_apply", "in_bwd_stats", "in_bwd_apply", "reflect_pad_bwd"}


def test_backward_wrappers_never_take_the_plain_version_off_the_cpu():
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="no kernel"):
        kernels.instance_norm_act_bwd(meta(1, 8, 4, 4), meta(1, 8, 4, 4), relu=True)
    with pytest.raises(ValueError, match="no kernel"):
        kernels.attention_compose_bwd(
            meta(1, 27, 4, 4), meta(1, 10, 4, 4), meta(1, 3, 4, 4), meta(1, 3, 4, 4)
        )
