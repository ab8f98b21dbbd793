"""The port's AttentionGenerator against the JAX one on identical weights.

The JAX generator is initialized at 32^2, batch 2; its params cross into
the port through ``state_dict_from_jax``.  Output and background mask agree
to atol 2e-4 (the architecture tolerance), under the JAX defaults and with
the Pallas route (FLOODGAN_PALLAS=1, interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu.models.registry import build_generator as jax_build_generator
from floodgan_tpu.ops import pallas_kernels as pk
from floodgan_tpu.utils.torch_import import attention_generator_spec
from floodgan_tpu_torch.models.layers import init_weights
from floodgan_tpu_torch.models.registry import build_generator
from floodgan_tpu_torch.utils.jax_params import state_dict_from_jax


@pytest.fixture(scope="module", autouse=True)
def warm_torch_exp():
    """The first torch.exp of a process can come out up to 4e-5 off with
    the CPU build of torch 2.13 (see tests/test_torch_kernels.py); discard
    one call."""
    torch.exp(torch.randn(1 << 20))


@pytest.fixture(scope="module")
def jax_generators():
    """{channels: (module, numpy params)} for the 9- and 3-channel stacks."""
    out = {}
    for ch in (9, 3):
        g = jax_build_generator("pairedattention", ch)
        params = g.init(jax.random.key(0), jnp.zeros((1, 32, 32, ch)))["params"]
        out[ch] = (g, jax.tree.map(np.asarray, params))
    return out


def _port_generator(ch, params):
    g = build_generator("pairedattention", ch)
    g.load_state_dict(state_dict_from_jax(g, params))
    return g.eval()


def _compare(jax_generators, ch, rng):
    jg, params = jax_generators[ch]
    x = rng.standard_normal((2, 32, 32, ch), dtype=np.float32)
    want_out, want_mask = jg.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got_out, got_mask = _port_generator(ch, params)(
            torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
        )
    assert got_out.shape == (2, 3, 32, 32) and got_mask.shape == (2, 32, 32)
    np.testing.assert_allclose(got_out.numpy().transpose(0, 2, 3, 1), np.asarray(want_out), atol=2e-4)
    np.testing.assert_allclose(got_mask.numpy(), np.asarray(want_mask), atol=2e-4)


@pytest.mark.parametrize("route", ["jax_defaults", "pallas_interpret"])
def test_generator_matches_jax(jax_generators, rng, monkeypatch, route):
    if route == "pallas_interpret":
        monkeypatch.setenv("FLOODGAN_PALLAS", "1")
        monkeypatch.setattr(pk, "_INTERPRET", True)
    _compare(jax_generators, 9, rng)


def test_generator_matches_jax_without_topography(jax_generators, rng):
    _compare(jax_generators, 3, rng)


def test_parameters_register_in_reference_order():
    """named_parameters() lines up with the reference spec, so a later
    checkpoint slice can load reference .pth.tar files by position."""
    names = [n for n, _ in build_generator("pairedattention", 9).named_parameters()]
    as_spec = []
    for n in names:
        parts = n.split(".")
        if parts[0] == "trunk":
            parts = [f"res{parts[2]}"] + parts[3:]
        as_spec.append("/".join(parts))
    assert as_spec == [path for path, _ in attention_generator_spec()]


def test_state_dict_from_jax_rejects_a_wrong_shape(jax_generators):
    _, params = jax_generators[9]
    bad = dict(params, conv1={"weight": params["conv1"]["weight"][:, :, :3], "bias": params["conv1"]["bias"]})
    with pytest.raises(ValueError, match="conv1.weight"):
        state_dict_from_jax(build_generator("pairedattention", 9), bad)


def test_seeded_init():
    def draw(seed):
        g = build_generator("pairedattention", 9)
        return init_weights(g, torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = draw(47), draw(47), draw(48)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    assert torch.count_nonzero(a["trunk.blocks.0.conv1.bias"]) == 0
    assert abs(float(a["trunk.blocks.0.conv1.weight"].std()) - 0.02) < 1e-3


@pytest.mark.parametrize("model", ["pix2pix", "cyclegan", "nosuchmodel"])
def test_registry_raises_for_families_not_ported(model):
    """Every family of the JAX package is ported: the registry builds
    Pix2Pix and CycleGAN, and only an unknown name raises."""
    if model == "nosuchmodel":
        with pytest.raises(NotImplementedError):
            build_generator(model, 9)
        return
    g = build_generator(model, 9)
    first = next(m for m in g.modules() if isinstance(m, torch.nn.Conv2d))
    assert first.in_channels == 9
