"""The port's InstanceNorm PatchGAN and registry against the JAX package.

The JAX discriminator is initialized at 32^2, batch 2, 12 input channels
(the conditional D of PairedAttention); its params cross into the port
through ``state_dict_from_jax``.  Patch logits agree to atol 1e-4 under
the JAX defaults and with the Pallas route (FLOODGAN_PALLAS=1, interpret
mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu.models import registry as jax_registry
from floodgan_tpu.models.patchgan import PatchGANDiscriminator as JaxPatchGAN
from floodgan_tpu.ops import pallas_kernels as pk
from floodgan_tpu.utils.torch_import import patchgan_spec
from floodgan_tpu_torch.models import registry
from floodgan_tpu_torch.models.layers import init_weights
from floodgan_tpu_torch.models.patchgan import PatchGANDiscriminator
from floodgan_tpu_torch.ops import kernels
from floodgan_tpu_torch.utils.jax_params import state_dict_from_jax


@pytest.fixture(scope="module")
def jax_disc():
    d = JaxPatchGAN(norm="instance")
    params = d.init(jax.random.key(3), jnp.zeros((1, 32, 32, 12)))["params"]
    return d, jax.tree.map(np.asarray, params)


def _port_disc(params):
    d = PatchGANDiscriminator(12)
    d.load_state_dict(state_dict_from_jax(d, params))
    return d


@pytest.mark.parametrize("route", ["jax_defaults", "pallas_interpret"])
def test_patchgan_matches_jax(jax_disc, rng, monkeypatch, route):
    if route == "pallas_interpret":
        monkeypatch.setenv("FLOODGAN_PALLAS", "1")
        monkeypatch.setattr(pk, "_INTERPRET", True)
    jd, params = jax_disc
    x = rng.uniform(-1.0, 1.0, (2, 32, 32, 12)).astype(np.float32)
    want = np.asarray(jd.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_disc(params)(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert got.shape == (2, 1, 2, 2) and want.shape == (2, 2, 2, 1)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, atol=1e-4)


def test_patchgan_input_gradient_matches_jax(jax_disc, rng):
    """The D read of the G update differentiates through the three
    IN + leaky sites down to the input (K2 on the card)."""
    jd, params = jax_disc
    x = rng.uniform(-1.0, 1.0, (2, 32, 32, 12)).astype(np.float32)
    want = np.asarray(jax.grad(lambda x_: jnp.mean(jnp.square(jd.apply({"params": params}, x_) - 1.0)))(jnp.asarray(x)))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_()
    torch.square(_port_disc(params)(xt) - 1.0).mean().backward()
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), want, atol=1e-6)


@pytest.mark.parametrize("size,ok", [(23, False), (24, True), (31, True)])
def test_patchgan_size_guard(size, ok):
    d = PatchGANDiscriminator(12)
    x = torch.zeros((1, 12, size, size))
    if ok:
        assert d(x).shape[2] == size // 8 - 2
    else:
        with pytest.raises(ValueError, match=">= 24"):
            d(x)


def test_patchgan_runs_three_instance_norm_sites(monkeypatch):
    calls = []
    real = kernels.InstanceNormAct.apply

    def spy(x, residual, relu, slope, eps):
        calls.append((tuple(x.shape), relu, slope, residual is None))
        return real(x, residual, relu, slope, eps)

    monkeypatch.setattr(kernels.InstanceNormAct, "apply", spy)
    PatchGANDiscriminator(12)(torch.zeros((2, 12, 64, 64)))
    assert calls == [
        ((2, 128, 16, 16), True, 0.2, True),
        ((2, 256, 8, 8), True, 0.2, True),
        ((2, 512, 7, 7), True, 0.2, True),
    ]


def test_parameters_register_in_reference_order():
    names = [n.replace(".", "/") for n, _ in PatchGANDiscriminator(12).named_parameters()]
    assert names == [path for path, _ in patchgan_spec("instance")]


def test_state_dict_from_jax_rejects_a_wrong_discriminator_shape(jax_disc):
    _, params = jax_disc
    bad = dict(params, conv3={"weight": params["conv3"]["weight"][..., :256], "bias": params["conv3"]["bias"]})
    with pytest.raises(ValueError, match="conv3.weight"):
        state_dict_from_jax(PatchGANDiscriminator(12), bad)


def test_state_dict_from_jax_rejects_a_missing_discriminator_layer(jax_disc):
    _, params = jax_disc
    with pytest.raises(KeyError, match="conv4"):
        state_dict_from_jax(PatchGANDiscriminator(12), {k: v for k, v in params.items() if k != "conv4"})


def test_seeded_init_keeps_normed_conv_biases():
    d = init_weights(PatchGANDiscriminator(12), torch.Generator().manual_seed(47))
    for n in ("conv1", "conv2", "conv3"):
        assert getattr(d, n).bias is not None
        assert torch.count_nonzero(getattr(d, n).bias) == 0
    assert abs(float(d.conv3.weight.detach().std()) - 0.02) < 1e-3


@pytest.mark.parametrize("model", ["pix2pix", "cyclegan", "attentiongan", "pairedattention"])
def test_registry_properties_match_jax(model):
    assert registry.discriminator_is_conditional(model) == jax_registry.discriminator_is_conditional(model)
    assert registry.generator_returns_mask(model) == jax_registry.generator_returns_mask(model)


def test_batchnorm_discriminator_waits_for_the_pix2pix_slice():
    """Pix2Pix's D is the batch-norm PatchGAN, its normed convs without
    bias (tests/test_torch_pix2pix.py holds it against JAX's); the others
    keep instance norm."""
    d = registry.build_discriminator("pix2pix", 12)
    assert isinstance(d, PatchGANDiscriminator) and d.norm == "batch" and d.conv0.in_channels == 12
    assert all(getattr(d, f"conv{n}").bias is None for n in (1, 2, 3))
    d = registry.build_discriminator("pairedattention", 12)
    assert isinstance(d, PatchGANDiscriminator) and d.conv0.in_channels == 12 and d.norm == "instance"
