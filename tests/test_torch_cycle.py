"""The port's cycle family (CycleGAN, AttentionGAN) against the JAX package,
on the CPU.

- ``CycleGANGenerator`` at 32^2 and 64^2 within 2e-4, its parameters in
  ``cyclegan_generator_spec`` order.
- ``ImageBuffer``: JAX's per-item draws taken from its key (floodgan_tpu/
  train/cycle.py:68-70, :90) and fed to the port's buffer: the returned
  images and the buffer bit for bit, through the fill, swaps, and an item
  that reads a slot an earlier item of its batch wrote; f32 and bf16.
- The CycleGAN step with the identity loss against JAX's
  (tests/torch_cycle_steps.py; tests/test_torch_cycle_attention.py runs
  AttentionGAN's).
- The trainer's device and family checks; ``Model`` builds every family
  with JAX's loss schema.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu.api.model import Model as JaxModel
from floodgan_tpu.models.cyclegan import CycleGANGenerator as JaxCycleGANGenerator
from floodgan_tpu.train.cycle import ImageBuffer as JaxImageBuffer
from floodgan_tpu.utils.torch_import import cyclegan_generator_spec
from floodgan_tpu_torch.api.model import Model, loss_keys
from floodgan_tpu_torch.models.cyclegan import CycleGANGenerator
from floodgan_tpu_torch.ops import kernels
from floodgan_tpu_torch.train.cycle import CycleTrainer, ImageBuffer
from floodgan_tpu_torch.train.paired import PairedTrainer
from floodgan_tpu_torch.utils.jax_params import state_dict_from_jax

from fixtures import make_flood_fixture
from torch_cycle_steps import _inputs, step_fixture, threads_and_warm_exp
from torch_cycle_steps import (  # noqa: F401  the step's parity tests, on this file's cases
    test_step1_losses_match_jax,
    test_step1_gradients_match_jax,
    test_generator_backward_leaves_no_gradient_in_the_discriminators,
    test_step2_losses_match_jax,
    test_step1_buffers_hold_jaxs_synthetics,
    test_generate_both_directions_matches_jax,
)

BATCH, CH = 2, 9
LR = 2e-4
TOL_ARCH = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _threads_and_warm_exp():
    yield from threads_and_warm_exp()


step_runs = step_fixture(["cyclegan_identity"])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(np.transpose(a, (0, 3, 1, 2)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------------ generator

@pytest.mark.parametrize("size", [32, 64])
def test_cyclegan_generator_matches_jax(rng, size):
    x = rng.uniform(-1, 1, (BATCH, size, size, CH)).astype(np.float32)
    jax_g = JaxCycleGANGenerator(input_channels=CH)
    shapes = jax.eval_shape(lambda: jax_g.init({"params": jax.random.key(0)}, jnp.asarray(x)))["params"]
    draws = np.random.default_rng(size)
    params = jax.tree.map(lambda a: (0.02 * draws.normal(size=a.shape)).astype(np.float32), shapes)  # biases count
    want = np.asarray(jax_g.apply({"params": params}, jnp.asarray(x)))
    g = CycleGANGenerator(CH)
    g.load_state_dict(state_dict_from_jax(g, params))
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        got = g(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert kernels.LAUNCHES == before  # CPU tensors take the plain versions
    assert got.shape == want.shape == (BATCH, size, size, 3)
    np.testing.assert_allclose(got, want, atol=TOL_ARCH)


def test_cyclegan_parameters_follow_the_reference_spec():
    names = []
    for path, _ in cyclegan_generator_spec():
        parts = path.split("/")
        if parts[0].startswith("res"):
            parts = ["trunk", "blocks", parts[0][3:]] + parts[1:]
        names.append(".".join(parts))
    assert [n for n, _ in CycleGANGenerator(CH).named_parameters()] == names


# -------------------------------------------------------------------- buffer

def _jax_draws(key, n, cap):
    """JAX's (p, slot) draws of one ``query_batch`` over ``n`` items."""
    out = []
    for k in jax.random.split(key, n):
        kp, ki = jax.random.split(k)
        out.append((float(jax.random.uniform(kp)), int(jax.random.randint(ki, (), 0, cap))))
    return out


def _replay(draws_per_batch, cap, n):
    """Which policy each item takes: 'fill', 'swap' (returns the image at
    its slot), or 'keep'; and whether a swap returns an image stored by an
    earlier item of its own batch."""
    count, writer, kinds, same_batch = 0, {}, [], False
    for b, draws in enumerate(draws_per_batch):
        for p, slot in draws:
            if count < cap:
                writer[count] = b
                count += 1
                kinds.append("fill")
            elif p > 0.5:
                same_batch |= writer.get(slot) == b
                writer[slot] = b
                kinds.append("swap")
            else:
                kinds.append("keep")
    return kinds, same_batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_image_buffer_matches_jax_on_its_draws(dtype):
    cap, n, batches = 3, 4, 3
    seed = next(s for s in range(200) if (lambda kinds_same: {"fill", "swap", "keep"} <= set(kinds_same[0])
                                           and kinds_same[1])(
        _replay([_jax_draws(k, n, cap) for k in jax.random.split(jax.random.key(s), batches)], cap, n)))
    keys = jax.random.split(jax.random.key(seed), batches)
    rng = np.random.default_rng(9)
    jbuf = JaxImageBuffer.create(cap, 2, 3, 5, getattr(jnp, dtype))
    buf = ImageBuffer(cap, (5, 2, 3), getattr(torch, dtype))
    for key in keys:
        images = rng.standard_normal((n, 2, 3, 5)).astype(np.float32)
        jbuf, want = jbuf.query_batch(jnp.asarray(images), key)
        got = buf.query_batch(_nchw(images), _jax_draws(key, n, cap))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))
    assert buf.count == int(jbuf.count) == cap
    assert buf.images.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(buf.images.permute(0, 2, 3, 1).float().numpy(),
                                  np.asarray(jbuf.images.astype(jnp.float32)))


def test_image_buffer_draws_do_not_depend_on_its_state():
    """Every item draws (p, slot), full or not: the stream is a function of
    the generator alone."""
    a, b = ImageBuffer(50, (1, 1, 1)), ImageBuffer(2, (1, 1, 1))
    b.count = 2
    da = a.draw(5, torch.Generator().manual_seed(4))
    db = b.draw(5, torch.Generator().manual_seed(4))
    assert [p for p, _ in da] == [p for p, _ in db]
    assert all(0 <= s < 2 for _, s in db) and all(0.0 <= p < 1.0 for p, _ in da)
    with pytest.raises(ValueError, match="draws"):
        a.query_batch(torch.zeros(2, 1, 1, 1), da)


# ------------------------------------------------------------- the trainer

def test_trainer_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CycleTrainer("cyclegan", CH, (32, 32))


@pytest.mark.parametrize("model", ["pix2pix", "pairedattention"])
def test_cycle_trainer_takes_the_cycle_families_only(model):
    with pytest.raises(ValueError, match="paired step"):
        CycleTrainer(model, CH, (32, 32), device="cpu")


def test_bf16_buffers_and_steps_launch_nothing_on_cpu():
    x, y = (a[:, :32, :32] for a in _inputs())
    t = CycleTrainer("cyclegan", CH, (32, 32), compute_dtype="bfloat16", device="cpu")
    before = dict(kernels.LAUNCHES)
    g0 = {k: v.clone() for k, v in t.gen_ab.state_dict().items()}
    m = t.train_step(x, y, LR)
    assert kernels.LAUNCHES == before
    assert all(v.dtype == torch.float32 and v.shape == () and torch.isfinite(v) for v in m.values())
    assert t.pre_buffer.images.dtype == torch.bfloat16 and t.pre_buffer.count == BATCH
    assert all(not torch.equal(v, g0[k]) for k, v in t.gen_ab.state_dict().items())


@pytest.mark.parametrize("model,identity", [("pix2pix", False), ("cyclegan", True), ("attentiongan", False)])
def test_model_builds_every_family_with_jaxs_loss_schema(tmp_path, model, identity):
    data, meta = make_flood_fixture(tmp_path, size=32, n_per_disaster=3)
    m = Model(model=model, dataset_subset="usa", dataset_dem="same", data_path=data, metadata_dir=meta,
              topography="all", resize=None, add_identity_loss=identity, verbose=False, device="cpu")
    assert isinstance(m.trainer, CycleTrainer if model != "pix2pix" else PairedTrainer)
    fake = types.SimpleNamespace(model_is_cycle=m.model_is_cycle, add_identity_loss=identity)
    want = JaxModel._initialise_loss_storage(fake, overall=True)
    assert m.all_losses == want and m._initialise_loss_storage(overall=False) == \
        JaxModel._initialise_loss_storage(fake, overall=False)
    assert tuple(k[4:] for k in want) == loss_keys(model, identity)
    assert ("identityTrue" in m.create_path("model")) == identity
