"""The port's paired training slice against the JAX package.

- ``TrainConfig``, ``lambda_rule`` and the losses against JAX's.
- The port's Adam against ``apply_adam(adam_tx(0.5, 0.999))`` on identical
  gradients over 3 steps.
- One full ``PairedTrainer`` step and a second, PairedAttention at 32^2,
  batch 2, f32, image space (``phase_step=False``), from the same JAX
  init, on both JAX routes: the defaults, and FLOODGAN_PALLAS=1 in
  interpret mode.  The inputs are those of tests/test_train_steps.py
  (rng 47, standard normal x 0.3).

Adam turns rounding into +-lr: its first update is about lr * sign(grad),
so a gradient that is zero up to rounding (the bias of a conv that feeds
an instance norm) or merely tiny flips sign between two correct
implementations.  So the step is held in parts:
- the three step-1 losses that precede any update (D real, D synthetic,
  L1) within rtol 1e-5;
- the step-1 G adversarial loss, which reads D after its Adam update,
  within rtol 1e-5 when the port reads JAX's updated D;
- the step-1 gradients, which Adam consumes, within 1e-4 of each tensor's
  norm.  A conv bias that feeds an instance norm has a gradient of zero
  up to rounding in both packages, so it gets an absolute bound of 1e-5
  instead (seen up to 2e-6 at this size);
- the free-running step-1 G adversarial loss and the step-2 losses within
  rtol 2e-3, a bound that rests on the 4.3e-4 spread measured between
  JAX's own two routes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu.core import config as jax_config
from floodgan_tpu.ops import pallas_kernels as pk
from floodgan_tpu.train import losses as jax_losses
from floodgan_tpu.train.optim import adam_tx, apply_adam
from floodgan_tpu.train.paired import PairedTrainer as JaxPairedTrainer
from floodgan_tpu_torch.core import config
from floodgan_tpu_torch.models.registry import build_discriminator, build_generator
from floodgan_tpu_torch.ops import kernels
from floodgan_tpu_torch.train import losses
from floodgan_tpu_torch.train.optim import adam
from floodgan_tpu_torch.train.optim import apply_adam as port_apply_adam
from floodgan_tpu_torch.train.paired import PairedTrainer
from floodgan_tpu_torch.utils.jax_params import state_dict_from_jax

LR = 2e-4
SIZE, BATCH, CH = 32, 2, 9
LOSS_KEYS = (
    "losses_discriminator_real",
    "losses_discriminator_synthetic",
    "losses_generator_synthetic",
    "l1_losses_generator_synthetic",
)
# Conv biases whose output goes straight into an instance norm: the norm
# removes any per-channel constant, so their true gradient is zero.
NOT_NORMED_BIASES = {"deconv3_content.bias", "deconv3_attention.bias", "conv0.bias", "conv4.bias"}
TOL_GRAD_REL, TOL_ZERO_GRAD = 1e-4, 1e-5
TOL_LOSS, TOL_AFTER_ADAM = 1e-5, 2e-3


@pytest.fixture(scope="module", autouse=True)
def warm_torch_exp():
    """The first torch.exp of a process can come out up to 4e-5 off with
    the CPU build of torch 2.13 (see tests/test_torch_kernels.py); discard
    one call."""
    torch.exp(torch.randn(1 << 20))


# ------------------------------------------------------------ recipe pieces

def test_train_config_matches_jax():
    assert dataclasses.asdict(config.TrainConfig()) == dataclasses.asdict(jax_config.TrainConfig())


@pytest.mark.parametrize("num_epochs", [1, 2, 7, 10, 200])
def test_lambda_rule_matches_jax(num_epochs):
    for epoch in range(num_epochs + 2):
        assert config.lambda_rule(epoch, num_epochs) == jax_config.lambda_rule(epoch, num_epochs)


@pytest.mark.parametrize("target", [0.0, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lsgan_mse_matches_jax(rng, target, dtype):
    p = rng.standard_normal((2, 1, 6, 6)).astype(np.float32)
    want = jax_losses.lsgan_mse(jnp.asarray(p).astype(dtype), target)
    got = losses.lsgan_mse(torch.from_numpy(p).to(getattr(torch, dtype)), target)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l1_loss_matches_jax(rng, dtype):
    a = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    b = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    want = jax_losses.l1_loss(jnp.asarray(a).astype(dtype), jnp.asarray(b).astype(dtype))
    got = losses.l1_loss(torch.from_numpy(a).to(getattr(torch, dtype)), torch.from_numpy(b).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_adam_matches_jax_on_identical_gradients(rng):
    """Moments within rtol 1e-6 plus one f32 ulp of the tensor's largest
    element (torch moves the first moment by lerp, optax by a weighted
    sum); parameters within rtol 1e-6 plus 5e-5 of lr.  optax forms the bias correction 1 - b2^t in f32, where 0.999
    rounds: it comes out 1.3e-5, 2.0e-5 and 2.7e-5 relative off at steps
    1-3, while torch forms it in double.  So each update differs by up to
    half that times |update| / lr, 3e-5 of lr summed over the three steps
    for a unit update, which shows on a parameter near zero."""
    shapes = {"w": (4, 3, 3, 3), "b": (4,), "v": (17,)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.02 for k, s in shapes.items()}
    tx = adam_tx(0.5, 0.999)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = adam(tp.values(), 0.5, 0.999)
    for step in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32) * 10.0 ** -(step + 1) for k, s in shapes.items()}
        jp, jstate = apply_adam(tx, jp, jstate, {k: jnp.asarray(g) for k, g in grads.items()}, jnp.float32(LR))
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        port_apply_adam(opt, LR)
        for k, p in tp.items():
            st = opt.state[p]
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=5e-5 * LR, err_msg=f"step {step} {k}"
            )
            for got, want in ((st["exp_avg"], jstate.mu[k]), (st["exp_avg_sq"], jstate.nu[k])):
                want = np.asarray(want)
                ulp = float(np.spacing(np.abs(want).max()))
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=ulp)


# ------------------------------------------------------------ the full step

def _inputs():
    rng = np.random.default_rng(47)
    x = rng.standard_normal((BATCH, SIZE, SIZE, CH), dtype=np.float32) * 0.3
    y = rng.standard_normal((BATCH, SIZE, SIZE, 3), dtype=np.float32) * 0.3
    return x, y


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=["jax_defaults", "pallas_interpret"])
def step_runs(request):
    """Two JAX steps on one route and two port steps from the same init."""
    x, y = _inputs()
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "pallas_interpret":
            mp.setenv("FLOODGAN_PALLAS", "1")
            mp.setattr(pk, "_INTERPRET", True)
        jt = JaxPairedTrainer("pairedattention", CH, phase_step=False)
        s0 = jt.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
        init = {"gen": _np_tree(s0.gen_params), "disc": _np_tree(s0.disc_params)}
        s1, m1 = jt.train_step(s0, jnp.asarray(x), jnp.asarray(y), jnp.float32(LR), jax.random.key(1))
        # After one step optax's first moment is (1 - b1) * grad = grad / 2.
        jax_grads = {"gen": jax.tree.map(lambda m: np.asarray(m) * 2.0, s1.gen_opt.mu),
                     "disc": jax.tree.map(lambda m: np.asarray(m) * 2.0, s1.disc_opt.mu)}
        disc1 = _np_tree(s1.disc_params)
        s2, m2 = jt.train_step(s1, jnp.asarray(x), jnp.asarray(y), jnp.float32(LR), jax.random.key(1))
        jax_losses_ = [{k: float(m[k]) for k in LOSS_KEYS} for m in (m1, m2)]

    gen_sd = state_dict_from_jax(build_generator("pairedattention", CH), init["gen"])
    disc_sd = state_dict_from_jax(build_discriminator("pairedattention", CH + 3), init["disc"])
    t = PairedTrainer("pairedattention", CH, device="cpu", gen_params=gen_sd, disc_params=disc_sd)
    p1 = t.train_step(x, y, LR)
    port_grads = {"gen": {n: p.grad.clone() for n, p in t.generator.named_parameters()},
                  "disc": {n: p.grad.clone() for n, p in t.discriminator.named_parameters()}}
    disc_adam = {n: t.disc_opt.state[p]["exp_avg"].clone() for n, p in t.discriminator.named_parameters()}
    p2 = t.train_step(x, y, LR)
    return {
        "x": x, "y": y, "gen_sd": gen_sd, "jax_disc1": disc1, "jax_grads": jax_grads,
        "jax_losses": jax_losses_, "port_grads": port_grads, "port_disc_adam": disc_adam,
        "port_losses": [{k: float(m[k]) for k in LOSS_KEYS} for m in (p1, p2)],
    }


@pytest.mark.parametrize("key", [k for k in LOSS_KEYS if k != "losses_generator_synthetic"])
def test_step1_losses_before_any_update_match_jax(step_runs, key):
    np.testing.assert_allclose(step_runs["port_losses"][0][key], step_runs["jax_losses"][0][key], rtol=TOL_LOSS)


def test_step1_generator_loss_against_jaxs_updated_discriminator(step_runs):
    """The G update's loss, read through the port's generator and D on
    JAX's D after its step-1 update: the same function on the same
    weights."""
    t = PairedTrainer(
        "pairedattention", CH, device="cpu", gen_params=step_runs["gen_sd"],
        disc_params=state_dict_from_jax(build_discriminator("pairedattention", CH + 3), step_runs["jax_disc1"]),
    )
    with torch.no_grad():
        x = t._nchw(step_runs["x"])
        loss = losses.lsgan_mse(t.disc_apply(torch.cat([x, t.gen_apply(x)], 1)), 1.0)
    np.testing.assert_allclose(float(loss), step_runs["jax_losses"][0]["losses_generator_synthetic"], rtol=TOL_LOSS)


@pytest.mark.parametrize("net", ["gen", "disc"])
def test_step1_gradients_match_jax(step_runs, net):
    module = build_generator("pairedattention", CH) if net == "gen" else build_discriminator("pairedattention", CH + 3)
    want = state_dict_from_jax(module, step_runs["jax_grads"][net])
    got = step_runs["port_grads"][net]
    assert set(got) == set(want)
    for name, g in got.items():
        err = float((g - want[name]).abs().max())
        if name.endswith(".bias") and name not in NOT_NORMED_BIASES:
            assert err <= TOL_ZERO_GRAD, f"{net} {name}: |diff| {err} over {TOL_ZERO_GRAD}"
        else:
            norm = float(want[name].norm())
            assert err <= TOL_GRAD_REL * norm, f"{net} {name}: |diff| {err} over {TOL_GRAD_REL} x norm {norm}"


def test_generator_backward_leaves_no_gradient_in_the_discriminator(step_runs):
    """After the step D's .grad is still the D update's own gradient, the
    one Adam took: its first moment after one step is grad / 2."""
    for name, g in step_runs["port_grads"]["disc"].items():
        torch.testing.assert_close(g, step_runs["port_disc_adam"][name] * 2.0, rtol=0, atol=0)


@pytest.mark.parametrize("step,key", [(0, "losses_generator_synthetic")] + [(1, k) for k in LOSS_KEYS])
def test_losses_after_an_adam_update_match_jax(step_runs, step, key):
    np.testing.assert_allclose(
        step_runs["port_losses"][step][key], step_runs["jax_losses"][step][key], rtol=TOL_AFTER_ADAM
    )


# ------------------------------------------------------------ the trainer

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_generator_update_reads_the_updated_discriminator(compute_dtype):
    """The G loss of a step equals LSGAN(D'(x ⊕ G(x)), 1) with the step's
    initial G and D's updated weights: under bf16 each read has its own
    autocast region, so no bf16 copy of D's old weights is reused."""
    x, y = _inputs()
    t = PairedTrainer("pairedattention", CH, compute_dtype=compute_dtype, device="cpu", seed=5)
    g0 = {k: v.clone() for k, v in t.generator.state_dict().items()}
    m = t.train_step(x, y, LR)
    check = PairedTrainer("pairedattention", CH, compute_dtype=compute_dtype, device="cpu",
                          gen_params=g0, disc_params=t.discriminator.state_dict())
    with torch.no_grad():
        xt = check._nchw(x)
        want = losses.lsgan_mse(check.disc_apply(torch.cat([xt, check.gen_apply(xt)], 1)), 1.0)
    np.testing.assert_allclose(float(m["losses_generator_synthetic"]), float(want), rtol=1e-6)


def test_bf16_step_follows_the_f32_step():
    x, y = _inputs()
    runs = {}
    for cd in ("float32", "bfloat16"):
        t = PairedTrainer("pairedattention", CH, compute_dtype=cd, device="cpu")
        m = t.train_step(x, y, LR)
        assert all(v.dtype == torch.float32 and v.shape == () for v in m.values())
        runs[cd] = {k: float(v) for k, v in m.items()}
    assert set(runs["float32"]) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        assert np.isfinite(runs["bfloat16"][k])
        np.testing.assert_allclose(runs["bfloat16"][k], runs["float32"][k], rtol=5e-2, err_msg=k)


def test_step_changes_both_parameter_sets_and_launches_nothing_on_cpu():
    x, y = _inputs()
    t = PairedTrainer("pairedattention", CH, device="cpu")
    before = dict(kernels.LAUNCHES)
    g0 = {k: v.clone() for k, v in t.generator.state_dict().items()}
    d0 = {k: v.clone() for k, v in t.discriminator.state_dict().items()}
    t.train_step(torch.from_numpy(x), torch.from_numpy(y), LR)
    assert kernels.LAUNCHES == before
    for module, start in ((t.generator, g0), (t.discriminator, d0)):
        for k, v in module.state_dict().items():
            assert not torch.equal(v, start[k]), k


def test_seeded_init_is_reproducible():
    a, b, c = (PairedTrainer("pairedattention", CH, device="cpu", seed=s) for s in (47, 47, 48))
    for mod in ("generator", "discriminator"):
        sa, sb, sc = (getattr(t, mod).state_dict() for t in (a, b, c))
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert not all(torch.equal(sa[k], sc[k]) for k in sa)


def test_generate_matches_jax():
    x, y = _inputs()
    jt = JaxPairedTrainer("pairedattention", CH, phase_step=False)
    s0 = jt.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
    want_out, want_mask = jt.generate(s0.gen_params, jnp.asarray(x), jax.random.key(47))
    gen_sd = state_dict_from_jax(build_generator("pairedattention", CH), _np_tree(s0.gen_params))
    out, mask = PairedTrainer("pairedattention", CH, device="cpu", gen_params=gen_sd).generate(x)
    assert out.shape == (BATCH, SIZE, SIZE, 3) and mask.shape == (BATCH, SIZE, SIZE)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-4)
    np.testing.assert_allclose(mask.numpy(), np.asarray(want_mask), atol=2e-4)


def test_trainer_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PairedTrainer("pairedattention", CH)


@pytest.mark.parametrize("model,err", [("pix2pix", None), ("cyclegan", ValueError),
                                       ("attentiongan", ValueError)])
def test_trainer_takes_the_attention_paired_family_only(model, err):
    """The paired families (Pix2Pix and PairedAttention) build; the cycle
    families train with train.cycle.CycleTrainer."""
    if err is None:
        t = PairedTrainer(model, CH, device="cpu")
        assert t.discriminator.norm == "batch" and t.discriminator.conv0.in_channels == CH + 3
        return
    with pytest.raises(err, match="cycle step"):
        PairedTrainer(model, CH, device="cpu")


def test_trainer_rejects_an_unknown_compute_dtype():
    with pytest.raises(ValueError, match="compute_dtype"):
        PairedTrainer("pairedattention", CH, compute_dtype="float16", device="cpu")


def test_train_profile_needs_the_card(monkeypatch):
    from floodgan_tpu_torch import train_profile

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        train_profile.main(["--size", "32", "--batch", "1"])
