"""The port's segmentation U-Net and its ops against the JAX package's, on
the CPU, on the same weights.

- ``nn_ops.batch_norm`` (training mode), ``max_pool2d`` and ``pad_to_match``
  against their JAX twins, forward and backward, with tied pool windows;
- the U-Net's parameters in ``unet_spec`` order (the reference's), and
  the batch-norm init;
- the forward at 32^2 and 64^2, batch 2, ``bilinear`` False and True: the
  logits within 1e-4 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu.ops import nn_ops as jax_ops
from floodgan_tpu.utils import torch_import as ti
from floodgan_tpu_torch.models.layers import BatchNorm2d, init_weights
from floodgan_tpu_torch.models.unet import UNet
from floodgan_tpu_torch.ops import nn_ops

from torch_seg_fixtures import few_torch_threads, jax_unet_params, port_unet

TOL_LOGITS = 1e-4  # of max |logit|


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    yield from few_torch_threads()


@pytest.fixture(scope="module")
def unets():
    """The JAX U-Net's parameters for both variants, and the port's U-Nets
    carrying them."""
    out = {}
    for bilinear in (False, True):
        model, params = jax_unet_params(bilinear=bilinear, seed=3)
        out[bilinear] = (model, params, port_unet(params, bilinear=bilinear))
    return out


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_batch_norm_matches_jax_forward_and_backward(rng):
    x = rng.normal(0.5, 2.0, (3, 5, 7, 4)).astype(np.float32)  # NHWC
    scale = rng.normal(1.0, 0.1, 4).astype(np.float32)
    bias = rng.normal(0.0, 0.1, 4).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)

    def jax_loss(x, s, b):
        return jnp.sum(jax_ops.batch_norm(x, s, b) * g)

    want = np.asarray(jax_ops.batch_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    gx, gs, gb = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_()
    st, bt = torch.tensor(scale, requires_grad=True), torch.tensor(bias, requires_grad=True)
    y = nn_ops.batch_norm(xt, st, bt)
    (y * torch.tensor(g).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(_nhwc(y), want, atol=1e-5)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), atol=1e-4)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), rtol=1e-5, atol=1e-4)


def test_batch_norm_keeps_bf16_and_takes_f32_statistics(rng):
    x = torch.tensor(rng.normal(3.0, 1.0, (2, 3, 4, 4)).astype(np.float32))
    y = nn_ops.batch_norm(x.bfloat16(), torch.ones(3), torch.zeros(3))
    assert y.dtype == torch.bfloat16
    ref = nn_ops.batch_norm(x.bfloat16().float(), torch.ones(3), torch.zeros(3))
    np.testing.assert_allclose(y.float().numpy(), ref.bfloat16().float().numpy())


def test_max_pool_gradient_goes_to_the_first_of_tied_maxima():
    """All-zero and partly tied windows, as BN + ReLU make them: the JAX
    pool's gradient and the port's go to the same element."""
    x = np.zeros((1, 4, 6, 2), np.float32)
    x[0, 0, 1, 0] = x[0, 1, 0, 0] = 2.0          # a tie between two maxima
    x[0, 2:, 2:4, 1] = 1.0                       # a window of four equal values
    g = np.arange(1, 1 + 1 * 2 * 3 * 2, dtype=np.float32).reshape(1, 2, 3, 2)
    want = jax.grad(lambda v: jnp.sum(jax_ops.max_pool2d(v) * g))(jnp.asarray(x))
    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_()
    y = nn_ops.max_pool2d(xt)
    np.testing.assert_array_equal(_nhwc(y), np.asarray(jax_ops.max_pool2d(jnp.asarray(x))))
    (y * torch.tensor(g).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_array_equal(_nhwc(xt.grad), np.asarray(want))


@pytest.mark.parametrize("shape,target", [((2, 3, 5, 7), (6, 9)), ((1, 2, 4, 4), (4, 5)), ((1, 1, 3, 3), (3, 3))])
def test_pad_to_match_matches_jax(rng, shape, target):
    x = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jax_ops.pad_to_match(jnp.asarray(x.transpose(0, 2, 3, 1)), *target))
    got = nn_ops.pad_to_match(torch.tensor(x), *target)
    np.testing.assert_array_equal(_nhwc(got), want)


@pytest.mark.parametrize("bilinear", [False, True])
def test_parameters_register_in_the_reference_order(bilinear):
    spec = ti.unet_bilinear_spec() if bilinear else ti.unet_spec()
    params = list(UNet(bilinear=bilinear).named_parameters())
    assert len(params) == len(spec)
    for (name, p), (path, kind) in zip(params, spec):
        module, leaf = path.rsplit("/", 1)
        assert name.rsplit(".", 1)[0] == module.replace("/", "."), (name, path)
        assert (name.endswith("weight") and leaf in ("weight", "scale")) or (name.endswith("bias") and leaf == "bias")
        assert p.ndim == {"conv": 4, "convt": 4, "vec": 1}[kind], name
    if not bilinear:
        assert sum(p.numel() for _, p in params) == 31_037_633


def test_batch_norm_init_draws_scale_around_one():
    net = init_weights(UNet(), torch.Generator().manual_seed(0))
    scales = torch.cat([m.weight.detach() for m in net.modules() if isinstance(m, BatchNorm2d)])
    biases = torch.cat([m.bias.detach() for m in net.modules() if isinstance(m, BatchNorm2d)])
    assert abs(float(scales.mean()) - 1.0) < 2e-3 and abs(float(scales.std()) - 0.02) < 2e-3
    assert float(biases.abs().max()) == 0.0
    assert not any(isinstance(b, torch.Tensor) for b in net.buffers())  # no running statistics


@pytest.mark.parametrize("bilinear", [False, True])
@pytest.mark.parametrize("size", [32, 64])
def test_unet_forward_matches_jax(unets, rng, bilinear, size):
    model, params, net = unets[bilinear]
    x = rng.random((2, size, size, 3), dtype=np.float32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(net(torch.tensor(x).permute(0, 3, 1, 2)))
    assert got.shape == want.shape == (2, size, size, 1)
    np.testing.assert_allclose(got, want, atol=TOL_LOGITS * np.abs(want).max())


def test_unet_masks_depend_on_the_batch(unets, rng):
    """Batch norm in training mode: an image's logits change with its
    batch-mates, in both packages alike."""
    model, params, net = unets[False]
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    with torch.no_grad():
        alone = net(torch.tensor(x[:1]).permute(0, 3, 1, 2))
        paired = net(torch.tensor(x).permute(0, 3, 1, 2))[:1]
    assert float((alone - paired).abs().max()) > 1e-3
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x[:1])))
    np.testing.assert_allclose(_nhwc(alone), want, atol=TOL_LOGITS * np.abs(want).max())
