"""The cycle step held against the JAX package's (tests/test_torch_cycle.py,
test_torch_cycle_attention.py and test_torch_cycle_attention_pallas.py
share it; each file runs one case, so that pytest-xdist spreads the three
JAX compiles).

One ``CycleTrainer`` step and a second, 64^2, batch 2, f32, image space,
from the same JAX init.  Held by the rule of tests/test_torch_train.py:
every step-1 loss precedes the update it could read (G is updated against
the current Ds, and the D update reads the synthetics of G before its
update), so all of them within rtol 1e-5; the four networks' gradients
within 1e-4 of each tensor's norm (1e-5 absolute for a conv bias that feeds
an instance norm), where a float64 evaluation decides the few tensors that
an f32 kink flip moves (see ``test_step1_gradients_match_jax``); step-2
losses within 2e-3.  The G backward leaves no gradient in the Ds; the
buffers hold JAX's synthetics; ``generate`` in both directions.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from floodgan_tpu.ops import pallas_kernels as pk
from floodgan_tpu.train.cycle import CycleTrainer as JaxCycleTrainer
from floodgan_tpu_torch.models.registry import build_discriminator, build_generator
from floodgan_tpu_torch.train.cycle import CycleTrainer
from floodgan_tpu_torch.utils.jax_params import load_cycle_state, state_dict_from_jax

from torch_seg_fixtures import few_torch_threads

SIZE, BATCH, CH = 64, 2, 9
LR = 2e-4
TOL_ARCH = 2e-4
TOL_GRAD_REL, TOL_ZERO_GRAD = 1e-4, 1e-5
TOL_LOSS, TOL_AFTER_ADAM = 1e-5, 2e-3
KINK_TOL = 2e-3
# Conv biases whose output does not go straight into an instance norm (the
# norm removes a per-channel constant, so the others' true gradient is 0).
NOT_NORMED_BIASES = {"conv_out.bias", "deconv3_content.bias", "deconv3_attention.bias", "conv0.bias", "conv4.bias"}
NETS = {"gen_ab": ("gen", "ab"), "gen_ba": ("gen", "ba"), "disc_post": ("disc", "post"), "disc_pre": ("disc", "pre")}



def threads_and_warm_exp():
    """Body of a module fixture: torch on two threads (pytest-xdist's
    workers share the cores); the first torch.exp of a process can come out
    up to 4e-5 off with the CPU build of torch 2.13 (see
    tests/test_torch_kernels.py), so one call is discarded."""
    torch.exp(torch.randn(1 << 20))
    yield from few_torch_threads()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(a):
    return _t(np.transpose(a, (0, 3, 1, 2)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------------- the step

def _inputs(seed=47):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, SIZE, SIZE, CH), dtype=np.float32) * 0.3
    y = rng.standard_normal((BATCH, SIZE, SIZE, 3), dtype=np.float32) * 0.3
    return x, y


def _exact_gradients(nets, x, y, identity):
    """The step-1 gradients of the four networks in float64, from copies of
    the trainer's networks before the step (the G loss against the current
    Ds, the D loss on the reals and G's synthetics): the exact gradients
    that both packages' f32 ones approximate."""
    gen_ab, gen_ba, disc_post, disc_pre = (copy.deepcopy(n).double() for n in nets)

    def g(gen, a):
        out = gen(a)
        return out[0] if isinstance(out, tuple) else out

    real_pre, post_rgb = _nchw(x).double(), _nchw(y).double()
    with_cond = lambda rgb: torch.cat([rgb, real_pre[:, 3:]], 1)
    l1 = lambda a, b: (a - b).abs().mean()
    lsgan = lambda p: ((p - 1.0) ** 2).mean()
    syn_post, syn_pre = with_cond(g(gen_ab, real_pre)), with_cond(g(gen_ba, with_cond(post_rgb)))
    total = (lsgan(disc_post(syn_post)) + lsgan(disc_pre(syn_pre)) + 10.0 * l1(g(gen_ba, syn_post), real_pre[:, :3])
             + 10.0 * l1(g(gen_ab, syn_pre), post_rgb))
    if identity:
        total = total + 5.0 * l1(g(gen_ab, with_cond(post_rgb)), post_rgb) + 5.0 * l1(g(gen_ba, real_pre), real_pre[:, :3])
    lsgan0 = lambda p: (p ** 2).mean()
    real_post = with_cond(post_rgb)
    d_total = ((lsgan(disc_pre(real_pre)) + lsgan0(disc_pre(syn_pre.detach()))) * 0.5
               + (lsgan(disc_post(real_post)) + lsgan0(disc_post(syn_post.detach()))) * 0.5)
    out = {}
    for net, module, loss in (("gen_ab", gen_ab, total), ("gen_ba", gen_ba, total),
                              ("disc_post", disc_post, d_total), ("disc_pre", disc_pre, d_total)):
        params = dict(module.named_parameters())
        out[net] = dict(zip(params, torch.autograd.grad(loss, list(params.values()), retain_graph=True)))
    return out


STEP_CASES = {
    "cyclegan_identity": ("cyclegan", True, False),
    "attentiongan": ("attentiongan", False, False),
    "attentiongan_pallas_interpret": ("attentiongan", False, True),
}


def step_fixture(cases):
    """A module fixture over ``cases`` (keys of STEP_CASES): two JAX cycle
    steps on one route and two port steps from the same init (JAX's state
    carried over by ``load_cycle_state``)."""
    return pytest.fixture(scope="module", params=list(cases))(_step_runs)


def _step_runs(request):
    model, identity, pallas = STEP_CASES[request.param]
    x, y = _inputs()
    with pytest.MonkeyPatch.context() as mp:
        if pallas:
            mp.setenv("FLOODGAN_PALLAS", "1")
            mp.setattr(pk, "_INTERPRET", True)
        jt = JaxCycleTrainer(model, CH, add_identity_loss=identity, phase_d=False, phase_gen=False)
        s0 = jt.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
        raw0 = _np_tree(serialization.to_state_dict(s0))  # the step donates s0
        s1, m1 = jt.train_step(s0, jnp.asarray(x), jnp.asarray(y), jnp.float32(LR), jax.random.key(1))
        # After one step optax's first moment is (1 - b1) * grad = grad / 2.
        jax_grads = {f"{kind}_{k}": jax.tree.map(lambda m: np.asarray(m) * 2.0, getattr(s1, f"{kind}_opt").mu[k])
                     for kind, k in NETS.values()}
        buffers1 = {k: _np_tree(serialization.to_state_dict(getattr(s1, k))) for k in ("pre_buffer", "post_buffer")}
        s2, m2 = jt.train_step(s1, jnp.asarray(x), jnp.asarray(y), jnp.float32(LR), jax.random.key(2))
        jax_losses = [{k: float(v) for k, v in m.items()} for m in (m1, m2)]
        gens = {d: [np.asarray(a) for a in jax.tree.leaves(jt.generator.apply({"params": raw0["gen_params"][d]},
                                                                              jnp.asarray(x)))]
                for d in ("ab", "ba")}

    t = CycleTrainer(model, CH, (SIZE, SIZE), add_identity_loss=identity, device="cpu", seed=5)
    load_cycle_state(t, raw0)
    generated = {d: t.generate(x, d) for d in ("ab", "ba")}
    exact = _exact_gradients((t.gen_ab, t.gen_ba, t.disc_post, t.disc_pre), x, y, identity)
    p1 = t.train_step(x, y, LR)
    port_grads = {net: {n: p.grad.clone() for n, p in getattr(t, net).named_parameters()} for net in NETS}
    disc_adam = {net: {n: t.disc_opt.state[p]["exp_avg"].clone() for n, p in getattr(t, net).named_parameters()}
                 for net in ("disc_post", "disc_pre")}
    buffers = {k: (getattr(t, k).count, getattr(t, k).images.clone()) for k in ("pre_buffer", "post_buffer")}
    p2 = t.train_step(x, y, LR, step=1)
    return {
        "model": model, "jax_losses": jax_losses, "port_losses": [{k: float(v) for k, v in m.items()} for m in (p1, p2)],
        "jax_grads": jax_grads, "port_grads": port_grads, "disc_adam": disc_adam, "jax_buffers": buffers1,
        "port_buffers": buffers, "jax_generated": gens, "generated": generated, "exact_grads": exact,
    }


def test_step1_losses_match_jax(step_runs):
    got, want = step_runs["port_losses"][0], step_runs["jax_losses"][0]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL_LOSS, err_msg=k)


@pytest.mark.parametrize("net", list(NETS))
def test_step1_gradients_match_jax(step_runs, net):
    """Each tensor within 1e-4 of its norm of JAX's (1e-5 absolute for a
    conv bias that feeds an instance norm), but for the tensors that sit
    downstream of a kink.

    Four or six generator passes at 64^2 put millions of elements through
    ReLUs and L1 terms, and some lie within f32 rounding (1e-6) of 0: there
    each package takes its own branch, and a flip moves a few tensors'
    gradients by up to ~1e-3 of their norm (one flipped element of the
    cycle L1 moves conv_out.bias by 2 x 10 / (2 x 3 x 64^2) = 8e-4).  The
    float64 gradient, from copies of the port's networks, decides: a tensor
    may leave JAX's by more than 1e-4 where JAX's f32 gradient leaves the
    float64 one and the port's stays within 1e-4 of it (seen up to 1.5e-3
    on the Pallas route's D), or where the port's leaves it by at most
    KINK_TOL, for at most a tenth of a network's tensors (one for a D).
    JAX's f32 gradients within KINK_TOL of the float64 ones everywhere
    anchor those to JAX's math."""
    module = (build_generator(step_runs["model"], CH) if net.startswith("gen")
              else build_discriminator(step_runs["model"], CH))
    want = state_dict_from_jax(module, step_runs["jax_grads"][net])
    got = step_runs["port_grads"][net]
    exact = step_runs["exact_grads"][net]
    assert set(got) == set(want)
    kinked = []
    for name, g in got.items():
        err = float((g - want[name]).abs().max())
        if name.endswith(".bias") and name not in NOT_NORMED_BIASES:
            assert err <= TOL_ZERO_GRAD, f"{net} {name}: |diff| {err} over {TOL_ZERO_GRAD}"
            continue
        norm = float(want[name].norm())
        jax_off = float((want[name].double() - exact[name]).abs().max())
        port_off = float((g.double() - exact[name]).abs().max())
        assert jax_off <= KINK_TOL * norm, f"{net} {name}: JAX {jax_off} from the float64 gradient, norm {norm}"
        if err > TOL_GRAD_REL * norm and port_off <= TOL_GRAD_REL * norm < jax_off:
            continue  # JAX's f32 gradient left the exact one, the port's did not
        if err > TOL_GRAD_REL * norm and port_off > TOL_GRAD_REL * norm:
            assert port_off <= KINK_TOL * norm, f"{net} {name}: port {port_off} from float64, norm {norm}"
            kinked.append(name)
            continue
        assert err <= TOL_GRAD_REL * norm, f"{net} {name}: |diff| {err} over {TOL_GRAD_REL} x norm {norm}"
    assert len(kinked) <= max(1, len(got) // 10), kinked


def test_generator_backward_leaves_no_gradient_in_the_discriminators(step_runs):
    """After the step a D's .grad is the D update's own gradient, the one
    Adam took: its first moment after one step is grad / 2."""
    for net, moments in step_runs["disc_adam"].items():
        for name, g in step_runs["port_grads"][net].items():
            torch.testing.assert_close(g, moments[name] * 2.0, rtol=0, atol=0)


def test_step2_losses_match_jax(step_runs):
    got, want = step_runs["port_losses"][1], step_runs["jax_losses"][1]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL_AFTER_ADAM, err_msg=k)


def test_step1_buffers_hold_jaxs_synthetics(step_runs):
    """The step stored its batch's detached synthetics, with their
    condition channels, in both buffers (not full: fill in batch order)."""
    for key, want in step_runs["jax_buffers"].items():
        count, images = step_runs["port_buffers"][key]
        assert count == int(want["count"]) == BATCH
        np.testing.assert_allclose(images[:BATCH].permute(0, 2, 3, 1).numpy(), want["images"][:BATCH], atol=TOL_ARCH)
        assert not images[BATCH:].any()


def test_generate_both_directions_matches_jax(step_runs):
    for d, want in step_runs["jax_generated"].items():
        out, mask = step_runs["generated"][d]
        np.testing.assert_allclose(out.numpy(), want[0], atol=TOL_ARCH)
        if step_runs["model"] == "attentiongan":
            np.testing.assert_allclose(mask.numpy(), want[1], atol=TOL_ARCH)
        else:
            assert mask is None and len(want) == 1
