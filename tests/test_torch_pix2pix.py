"""The port's Pix2Pix family against the JAX package, on the CPU.

- ``Pix2PixGenerator`` at 256^2, batch 2: with dropout rate 0, and with the
  same dropout masks injected on both sides (bit parity of the masks
  across frameworks is impossible), within 2e-4; ``Pix2PixUNet`` likewise;
  the 256-divisibility guard; parameters in ``pix2pix_generator_spec``
  order.
- The batch-norm PatchGAN: logits within 1e-4 of max |logit|, parameters
  in ``patchgan_spec("batch")`` order.
- ``layers.Dropout``: its statistics (kept share, scale), rate 0 the
  identity.
- One ``PairedTrainer("pix2pix")`` step and a second, dropout rate 0, at
  256^2, batch 2, f32, from JAX's init, held by the rule of
  tests/test_torch_train.py: step-1 losses before any update within rtol
  1e-5, the G loss read through JAX's updated D within 1e-5, gradients
  within 1e-4 of each tensor's norm (1e-3 for the batch norms' affine
  parameters, whose f32 gradients both packages round as far from the
  float64 ones), step-2 losses within 2e-3.
- The per-step dropout draws depend on (epoch, step) only; ``generate``
  and the engine draw the seed-47 inference stream.
- A Pix2Pix ``.pth.tar`` migrates like JAX's (the batch-norm D spec).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import floodgan_tpu.ops as jax_ops
from floodgan_tpu.models.patchgan import PatchGANDiscriminator as JaxPatchGAN
from floodgan_tpu.models.pix2pix import Pix2PixGenerator as JaxPix2PixGenerator
from floodgan_tpu.models.pix2pix import Pix2PixUNet as JaxPix2PixUNet
from floodgan_tpu.train.paired import PairedTrainer as JaxPairedTrainer
from floodgan_tpu.utils import migrate as jax_migrate
from floodgan_tpu.utils.torch_export import export_gan_checkpoint
from floodgan_tpu.utils.torch_import import patchgan_spec, pix2pix_generator_spec
from floodgan_tpu.ckpt import load_checkpoint as jax_load_checkpoint
from floodgan_tpu_torch.ckpt import migrate, save_checkpoint
from floodgan_tpu_torch.data.transforms import denormalize
from floodgan_tpu_torch.models import layers
from floodgan_tpu_torch.models.layers import Dropout
from floodgan_tpu_torch.models.patchgan import PatchGANDiscriminator
from floodgan_tpu_torch.models.pix2pix import Pix2PixGenerator, Pix2PixUNet
from floodgan_tpu_torch.models.registry import build_discriminator, build_generator
from floodgan_tpu_torch.serve import InferenceEngine
from floodgan_tpu_torch.train.paired import PairedTrainer
from floodgan_tpu_torch.utils.jax_params import paired_state_to_jax, state_dict_from_jax

from torch_seg_fixtures import big_tmp, few_torch_threads  # noqa: F401

SIZE, BATCH, CH = 256, 2, 9
LR = 2e-4
TOL_ARCH = 2e-4
LOSS_KEYS = (
    "losses_discriminator_real",
    "losses_discriminator_synthetic",
    "losses_generator_synthetic",
    "l1_losses_generator_synthetic",
)
TOL_GRAD_REL, TOL_BN_GRAD_REL, TOL_LOSS, TOL_AFTER_ADAM = 1e-4, 1e-3, 1e-5, 2e-3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    yield from few_torch_threads()


def _drawn_params(module, x, seed):
    """A parameter tree of ``module``'s shapes drawn from numpy: conv
    weights N(0, 0.02), batch-norm scales 1 + 0.02 N(0, 1), biases
    0.02 N(0, 1) (zero in the reference init, drawn so that they count)."""
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, x))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        mean = 1.0 if path[-1].key == "scale" else 0.0
        return (mean + 0.02 * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(np.transpose(a, (0, 3, 1, 2)))


def _spec_names(spec):
    """Spec paths as the port's parameter names (BN ``scale`` is torch's
    ``weight``)."""
    return [p.replace("/", ".").replace(".scale", ".weight") for p, _ in spec]


# ------------------------------------------------------------------ networks

@pytest.mark.parametrize("cls,jax_cls,cin,out_ch", [(Pix2PixGenerator, JaxPix2PixGenerator, CH, 3),
                                                    (Pix2PixUNet, JaxPix2PixUNet, 3, 1)])
def test_pix2pix_networks_match_jax_at_dropout_rate_zero(rng, cls, jax_cls, cin, out_ch):
    x = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, cin)).astype(np.float32)
    jax_net = jax_cls(input_channels=cin, dropout_rate=0.0) if cls is Pix2PixGenerator else jax_cls(dropout_rate=0.0)
    params = _drawn_params(jax_net, jnp.asarray(x), seed=3)
    want = np.asarray(jax_net.apply({"params": params}, jnp.asarray(x)))
    port = cls(cin, dropout_rate=0.0)
    port.load_state_dict(state_dict_from_jax(port, params))
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (BATCH, SIZE, SIZE, out_ch)
    np.testing.assert_allclose(got, want, atol=TOL_ARCH)


def test_pix2pix_generator_matches_jax_with_injected_dropout_masks(rng, monkeypatch):
    """The same Bernoulli(0.5) masks at the three dropout sites (up6, up5,
    up4: 4^2, 8^2, 16^2 at 256^2 input), fed to both packages' dropout."""
    x = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, CH)).astype(np.float32)
    masks = [rng.random((BATCH, s, s, 512)) < 0.5 for s in (4, 8, 16)]
    jax_net = JaxPix2PixGenerator(input_channels=CH, dropout_rate=0.5)
    params = _drawn_params(jax_net, jnp.asarray(x), seed=4)

    jax_masks = iter(masks)

    def jax_dropout(h, rate, rng_, deterministic=False):
        m = next(jax_masks)
        assert h.shape == m.shape
        return jnp.where(m, h / (1.0 - rate), jnp.zeros_like(h))

    port_masks = iter(masks)

    def port_dropout(self, h, generator):
        m = torch.from_numpy(np.ascontiguousarray(np.transpose(next(port_masks), (0, 3, 1, 2))))
        assert generator is not None and h.shape == m.shape
        return torch.where(m, h / (1.0 - self.rate), torch.zeros_like(h))

    monkeypatch.setattr(jax_ops, "dropout", jax_dropout)
    monkeypatch.setattr(Dropout, "forward", port_dropout)
    want = np.asarray(jax_net.apply({"params": params}, jnp.asarray(x), rngs={"dropout": jax.random.key(1)}))
    port = Pix2PixGenerator(CH)
    port.load_state_dict(state_dict_from_jax(port, params))
    with torch.no_grad():
        got = port(_nchw(x), torch.Generator().manual_seed(0)).permute(0, 2, 3, 1).numpy()
    assert next(jax_masks, None) is None and next(port_masks, None) is None
    np.testing.assert_allclose(got, want, atol=TOL_ARCH)


def test_pix2pix_needs_sizes_divisible_by_256():
    for bad in ((1, CH, 128, 256), (1, CH, 256, 384)):
        with pytest.raises(ValueError, match="divisible by 256"):
            Pix2PixGenerator(CH, dropout_rate=0.0)(torch.zeros(bad))
    with pytest.raises(ValueError, match="divisible by 256"):
        JaxPix2PixGenerator(input_channels=CH).init({"params": jax.random.key(0)}, jnp.zeros((1, 128, 256, CH)))


def test_parameters_follow_the_reference_specs():
    assert [n for n, _ in Pix2PixGenerator(CH).named_parameters()] == _spec_names(pix2pix_generator_spec())
    assert [n for n, _ in Pix2PixUNet(3).named_parameters()] == _spec_names(pix2pix_generator_spec())
    d = PatchGANDiscriminator(CH + 3, norm="batch")
    assert [n for n, _ in d.named_parameters()] == _spec_names(patchgan_spec("batch"))
    assert [n for n, _ in PatchGANDiscriminator(CH + 3).named_parameters()] == _spec_names(patchgan_spec("instance"))


@pytest.mark.parametrize("size", [64, 96])
def test_batchnorm_patchgan_matches_jax(rng, size):
    x = rng.uniform(-1, 1, (BATCH, size, size, CH + 3)).astype(np.float32)
    jax_d = JaxPatchGAN(norm="batch")
    params = _drawn_params(jax_d, jnp.asarray(x), seed=5)
    want = np.asarray(jax_d.apply({"params": params}, jnp.asarray(x)))
    d = build_discriminator("pix2pix", CH + 3)
    d.load_state_dict(state_dict_from_jax(d, params))
    with torch.no_grad():
        got = d(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_dropout_statistics():
    x = torch.ones(1_000_000)
    g = torch.Generator().manual_seed(3)
    y = Dropout(0.5)(x, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) < 3e-3
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    again = Dropout(0.5)(x, torch.Generator().manual_seed(3))
    assert torch.equal(y, again)  # the mask is the generator's
    y = Dropout(0.25)(x, g)
    assert abs(float((y != 0).float().mean()) - 0.75) < 3e-3
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75), rtol=0, atol=0)
    state = g.get_state()
    assert Dropout(0.0)(x, g) is x and torch.equal(g.get_state(), state)  # rate 0 draws nothing
    with pytest.raises(ValueError, match="generator"):
        Dropout(0.5)(x, None)


# ------------------------------------------------------------------ the step

def _inputs(size=SIZE, batch=BATCH):
    rng = np.random.default_rng(47)
    x = rng.standard_normal((batch, size, size, CH), dtype=np.float32) * 0.3
    y = rng.standard_normal((batch, size, size, 3), dtype=np.float32) * 0.3
    return x, y


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _lsgan(p, target):
    return torch.mean((p - target) ** 2)


def _step_gradients(gen_sd, disc0_sd, disc1_sd, x, y, dtype):
    """The step-1 gradients of the port's networks in ``dtype``: D's of
    the D update on its initial weights, G's of the G loss read through
    ``disc1_sd`` (the D after its update).  Float64 gives the exact
    gradients that both packages' f32 ones approximate."""
    gen = build_generator("pix2pix", CH, dropout_rate=0.0)
    gen.load_state_dict(gen_sd)
    gen = gen.to(dtype)
    out = {}
    xt = _nchw(x).to(dtype)
    yt = _nchw(y).to(dtype)
    syn = gen(xt)
    for net, sd in (("disc", disc0_sd), ("gen", disc1_sd)):
        d = build_discriminator("pix2pix", CH + 3)
        d.load_state_dict(sd)
        d = d.to(dtype)
        if net == "disc":
            loss = (_lsgan(d(torch.cat([xt, syn.detach()], 1)), 0.0) + _lsgan(d(torch.cat([xt, yt], 1)), 1.0)) * 0.5
            params = dict(d.named_parameters())
        else:
            loss = _lsgan(d(torch.cat([xt, syn], 1)), 1.0) + 100.0 * (syn - yt).abs().mean()
            params = dict(gen.named_parameters())
        out[net] = dict(zip(params, torch.autograd.grad(loss, list(params.values()), retain_graph=True)))
    return out


@pytest.fixture(scope="module")
def step_runs():
    """Two JAX Pix2Pix steps (image space, dropout rate 0) and two port
    steps from the same init; the step-1 gradients of JAX (its Adam's first
    moment after one step is grad / 2), of the port's networks in f32 (G's
    read through JAX's updated D), and in float64."""
    x, y = _inputs()
    jt = JaxPairedTrainer("pix2pix", CH, dropout_rate=0.0, phase_step=False)
    s0 = jt.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
    init = {"gen": _np_tree(s0.gen_params), "disc": _np_tree(s0.disc_params)}
    s1, m1 = jt.train_step(s0, jnp.asarray(x), jnp.asarray(y), jnp.float32(LR), jax.random.key(1))
    jax_grads = {"gen": jax.tree.map(lambda m: np.asarray(m) * 2.0, s1.gen_opt.mu),
                 "disc": jax.tree.map(lambda m: np.asarray(m) * 2.0, s1.disc_opt.mu)}
    disc1 = _np_tree(s1.disc_params)
    s2, m2 = jt.train_step(s1, jnp.asarray(x), jnp.asarray(y), jnp.float32(LR), jax.random.key(1))

    gen_sd = state_dict_from_jax(build_generator("pix2pix", CH), init["gen"])
    disc_sd = state_dict_from_jax(build_discriminator("pix2pix", CH + 3), init["disc"])
    disc1_sd = state_dict_from_jax(build_discriminator("pix2pix", CH + 3), disc1)
    t = PairedTrainer("pix2pix", CH, dropout_rate=0.0, device="cpu", gen_params=gen_sd, disc_params=disc_sd)
    p1 = t.train_step(x, y, LR)
    step_disc_grads = {n: p.grad.clone() for n, p in t.discriminator.named_parameters()}
    disc_adam = {n: t.disc_opt.state[p]["exp_avg"].clone() for n, p in t.discriminator.named_parameters()}
    p2 = t.train_step(x, y, LR, step=1)
    return {
        "x": x, "gen_sd": gen_sd, "jax_disc1": disc1, "step_disc_grads": step_disc_grads, "disc_adam": disc_adam,
        "jax_grads": {net: state_dict_from_jax(build_generator("pix2pix", CH) if net == "gen" else
                                               build_discriminator("pix2pix", CH + 3), g)
                      for net, g in jax_grads.items()},
        "port_grads": _step_gradients(gen_sd, disc_sd, disc1_sd, x, y, torch.float32),
        "exact_grads": _step_gradients(gen_sd, disc_sd, disc1_sd, x, y, torch.float64),
        "jax_losses": [{k: float(m[k]) for k in LOSS_KEYS} for m in (m1, m2)],
        "port_losses": [{k: float(m[k]) for k in LOSS_KEYS} for m in (p1, p2)],
    }


@pytest.mark.parametrize("key", [k for k in LOSS_KEYS if k != "losses_generator_synthetic"])
def test_step1_losses_before_any_update_match_jax(step_runs, key):
    np.testing.assert_allclose(step_runs["port_losses"][0][key], step_runs["jax_losses"][0][key], rtol=TOL_LOSS)


def test_step1_generator_loss_against_jaxs_updated_discriminator(step_runs):
    t = PairedTrainer(
        "pix2pix", CH, dropout_rate=0.0, device="cpu", gen_params=step_runs["gen_sd"],
        disc_params=state_dict_from_jax(build_discriminator("pix2pix", CH + 3), step_runs["jax_disc1"]),
    )
    with torch.no_grad():
        x = t._nchw(step_runs["x"])
        loss = _lsgan(t.disc_apply(torch.cat([x, t.gen_apply(x)], 1)), 1.0)
    np.testing.assert_allclose(float(loss), step_runs["jax_losses"][0]["losses_generator_synthetic"], rtol=TOL_LOSS)


@pytest.mark.parametrize("net", ["gen", "disc"])
def test_step1_gradients_match_jax(step_runs, net):
    """Each gradient within a share of its tensor's norm of JAX's, plus
    twice JAX's own distance from the float64 gradient: 1e-4 for the conv
    weights and biases, 1e-3 for the batch norms' scales and biases.  With
    batch statistics over two images those are sums that cancel (in D the
    synthetic and the real read pull opposite ways), and each package's
    f32 gradient lies, by its own rounding, up to 5.8e-4 of the norm from
    the float64 one (measured at this size: JAX 5.5e-4 on D's norm3.bias,
    the port 5.7e-4 on G's up3_norm.bias).  G's gradient is read through
    JAX's updated D, the function JAX differentiated: Adam's first update
    is about lr * sign(grad), so the two packages' updated Ds differ where
    a D gradient is near 0."""
    want, got, exact = (step_runs[k][net] for k in ("jax_grads", "port_grads", "exact_grads"))
    assert set(got) == set(want) == set(exact)
    for name, g in got.items():
        share = TOL_BN_GRAD_REL if "_norm." in name or name.startswith("norm") else TOL_GRAD_REL
        norm = float(want[name].norm())
        jax_off = float((want[name].double() - exact[name]).abs().max())
        err = float((g - want[name]).abs().max())
        assert err <= share * norm + 2 * jax_off, f"{net} {name}: |diff| {err}, norm {norm}, JAX off {jax_off}"


def test_step_gradients_are_the_d_update_s_and_g_s_own(step_runs):
    """The step's D gradients are those of the D update (the G backward
    leaves none in D: Adam's first moment after one step is grad / 2), and
    equal, bit for bit, the same gradients taken outside the trainer."""
    for name, g in step_runs["step_disc_grads"].items():
        torch.testing.assert_close(g, step_runs["disc_adam"][name] * 2.0, rtol=0, atol=0)
        torch.testing.assert_close(g, step_runs["port_grads"]["disc"][name], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("step,key", [(0, "losses_generator_synthetic")] + [(1, k) for k in LOSS_KEYS])
def test_losses_after_an_adam_update_match_jax(step_runs, step, key):
    np.testing.assert_allclose(
        step_runs["port_losses"][step][key], step_runs["jax_losses"][step][key], rtol=TOL_AFTER_ADAM
    )


def test_dropout_draws_depend_on_epoch_and_step_only():
    """Two trainers from one seed take the same step (epoch 3, step 2) to
    the same state; another step index draws other masks.  ``generate``
    draws the seed-47 inference stream: the same output on every call."""
    x, y = _inputs(batch=1)
    runs = []
    for step in (2, 2, 5):
        t = PairedTrainer("pix2pix", CH, device="cpu", seed=11)
        m = t.train_step(x, y, LR, epoch=3, step=step)
        runs.append((m, t))
    (ma, ta), (mb, tb), (mc, _) = runs
    for k in LOSS_KEYS:
        assert float(ma[k]) == float(mb[k])
    assert float(ma["l1_losses_generator_synthetic"]) != float(mc["l1_losses_generator_synthetic"])
    for p, q in zip(ta.generator.parameters(), tb.generator.parameters()):
        assert torch.equal(p, q)
    out1, mask = ta.generate(x)
    out2, _ = ta.generate(x)
    assert mask is None and torch.equal(out1, out2)
    layers_ = [m for m in ta.generator.modules() if isinstance(m, layers.Dropout)]
    assert len(layers_) == 3 and all(m.rate == 0.5 for m in layers_)


def test_engine_serves_pix2pix_with_the_inference_stream(big_tmp):
    x, _ = _inputs(batch=1)
    t = PairedTrainer("pix2pix", CH, device="cpu", seed=2)
    path = str(big_tmp / "p2p.ckpt")
    meta = {"model": "pix2pix", "starting_epoch": 2, "num_epochs": 1, "topography": "all",
            "all_losses": {}, "add_identity_loss": False}
    save_checkpoint(path, meta, paired_state_to_jax(t))
    engine = InferenceEngine.from_checkpoint(path, batch_size=1, image_size=SIZE, device="cpu", aot=False)
    got = engine.predict(_t(x))
    want = denormalize(t.generate(x)[0])
    assert got.shape == (1, SIZE, SIZE, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(engine.predict(_t(x)), got, rtol=0, atol=0)


def test_reference_pix2pix_checkpoint_migrates_like_jax(big_tmp):
    """A stepped port Pix2Pix state -> .ckpt -> JAX's export to a reference
    .pth.tar; the port's maybe_migrate and JAX's turn it into the same
    bytes (the paired branch, with the batch-norm D spec)."""
    x, y = _inputs(batch=1)
    t = PairedTrainer("pix2pix", CH, device="cpu", seed=6)
    t.train_step(x, y, LR)
    src = str(big_tmp / "p2p.ckpt")
    meta = {"model": "pix2pix", "starting_epoch": 2, "num_epochs": 4, "topography": "all",
            "all_losses": {"all_losses_discriminator_real": [0.5]}, "add_identity_loss": False}
    save_checkpoint(src, meta, paired_state_to_jax(t))
    names = {"generator": [n for n, _ in t.generator.named_parameters()],
             "discriminator": [n for n, _ in t.discriminator.named_parameters()]}
    ref = str(big_tmp / "ref.pth.tar")
    export_gan_checkpoint(src, ref, names)
    os.makedirs(big_tmp / "jax")
    jax_ref = shutil.copy(ref, big_tmp / "jax" / "ref.pth.tar")
    port_out, jax_out = migrate.maybe_migrate(ref), jax_migrate.maybe_migrate(str(jax_ref), "gan")
    with open(port_out, "rb") as a, open(jax_out, "rb") as b:
        assert a.read() == b.read()
    _, raw = jax_load_checkpoint(port_out)
    assert int(raw["gen_opt"]["count"]) == 1 and "norm1" in raw["disc_params"]
