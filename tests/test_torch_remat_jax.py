"""The port's rematerialised train steps against the JAX package's, on the
CPU, by the rule of tests/test_torch_train.py: ``PairedTrainer(remat=True)``
(PairedAttention at 32^2, ``boundaries``, from JAX's init) and
``SegTrainer(remat=True)`` (the U-Net at 32^2, tests/test_torch_seg.py's
weights and batch).  Losses before an update within rtol 1e-5, gradients
within 1e-4 of each tensor's norm (1e-5 absolute for a conv bias that
feeds an instance norm), losses after an update within 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from floodgan_tpu.train.paired import PairedTrainer as JaxPairedTrainer
from floodgan_tpu.train.seg import SegState
from floodgan_tpu.train.seg import SegTrainer as JaxSegTrainer
from floodgan_tpu_torch.models.registry import build_discriminator, build_generator
from floodgan_tpu_torch.models.unet import UNet
from floodgan_tpu_torch.train.paired import PairedTrainer
from floodgan_tpu_torch.utils.jax_params import state_dict_from_jax

from torch_remat_steps import CH, LR, SEG_LR, batch, threads_and_warm_exp
from torch_seg_fixtures import jax_unet_params, port_seg_trainer

TOL_LOSS, TOL_GRAD_REL, TOL_ZERO_GRAD, TOL_AFTER_ADAM = 1e-5, 1e-4, 1e-5, 2e-3
# Conv biases whose output does not feed an instance norm (the others' true
# gradient is zero up to rounding; tests/test_torch_train.py).
NOT_NORMED_BIASES = {"deconv3_content.bias", "deconv3_attention.bias", "conv0.bias", "conv4.bias"}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from threads_and_warm_exp()

# ------------------------------------------------------ against JAX

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def paired_vs_jax():
    x, y = batch(32)
    jt = JaxPairedTrainer("pairedattention", CH, phase_step=False, remat=True)
    s0 = jt.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
    init = {"gen": _np_tree(s0.gen_params), "disc": _np_tree(s0.disc_params)}
    s1, m1 = jt.train_step(s0, jnp.asarray(x), jnp.asarray(y), jnp.float32(LR), jax.random.key(1))
    jax_grads = {"gen": jax.tree.map(lambda m: np.asarray(m) * 2.0, s1.gen_opt.mu),
                 "disc": jax.tree.map(lambda m: np.asarray(m) * 2.0, s1.disc_opt.mu)}
    _, m2 = jt.train_step(s1, jnp.asarray(x), jnp.asarray(y), jnp.float32(LR), jax.random.key(1))
    t = PairedTrainer("pairedattention", CH, device="cpu", remat=True,
                      gen_params=state_dict_from_jax(build_generator("pairedattention", CH), init["gen"]),
                      disc_params=state_dict_from_jax(build_discriminator("pairedattention", CH + 3), init["disc"]))
    assert t.remat and t.remat_policy == jt.remat_policy == "boundaries"
    p1 = t.train_step(x, y, LR)
    port_grads = {"gen": {n: p.grad.clone() for n, p in t.generator.named_parameters()},
                  "disc": {n: p.grad.clone() for n, p in t.discriminator.named_parameters()}}
    p2 = t.train_step(x, y, LR)
    return {"jax": [{k: float(v) for k, v in m.items()} for m in (m1, m2)],
            "port": [{k: float(v) for k, v in m.items()} for m in (p1, p2)],
            "jax_grads": jax_grads, "port_grads": port_grads}


def test_paired_remat_step_matches_jax_losses(paired_vs_jax):
    jl, pl = paired_vs_jax["jax"], paired_vs_jax["port"]
    for k in ("losses_discriminator_real", "losses_discriminator_synthetic", "l1_losses_generator_synthetic"):
        np.testing.assert_allclose(pl[0][k], jl[0][k], rtol=TOL_LOSS, err_msg=k)
    np.testing.assert_allclose(pl[0]["losses_generator_synthetic"], jl[0]["losses_generator_synthetic"],
                               rtol=TOL_AFTER_ADAM)
    for k, v in jl[1].items():
        np.testing.assert_allclose(pl[1][k], v, rtol=TOL_AFTER_ADAM, err_msg=k)


@pytest.mark.parametrize("net", ["gen", "disc"])
def test_paired_remat_gradients_match_jax(paired_vs_jax, net):
    module = build_generator("pairedattention", CH) if net == "gen" else build_discriminator("pairedattention", CH + 3)
    want = state_dict_from_jax(module, paired_vs_jax["jax_grads"][net])
    got = paired_vs_jax["port_grads"][net]
    assert set(got) == set(want)
    for name, g in got.items():
        err = float((g - want[name]).abs().max())
        if name.endswith(".bias") and name not in NOT_NORMED_BIASES:
            assert err <= TOL_ZERO_GRAD, f"{net} {name}: |diff| {err}"
        else:
            assert err <= TOL_GRAD_REL * float(want[name].norm()), f"{net} {name}: |diff| {err}"


@pytest.fixture(scope="module")
def seg_vs_jax():
    unet = jax_unet_params(seed=1)[1]
    r = np.random.default_rng(9)
    x = r.random((2, 32, 32, 3), dtype=np.float32)
    m = (r.random((2, 32, 32, 1)) > 0.5).astype(np.float32)
    jt = JaxSegTrainer(remat=True)
    params = jax.tree_util.tree_map(jnp.array, unet)  # copies: the step donates them
    s0 = SegState(params=params, opt=jt.tx.init(params))
    s1, j1 = jt.train_step(s0, jnp.asarray(x), jnp.asarray(m), jnp.float32(SEG_LR))
    # After one step optax's first moment is (1 - b1) * grad = grad / 2; the next step donates s1.
    jax_grads = state_dict_from_jax(UNet(), jax.tree.map(lambda v: np.asarray(v) * 2.0, s1.opt.mu))
    _, j2 = jt.train_step(s1, jnp.asarray(x), jnp.asarray(m), jnp.float32(SEG_LR))
    port = port_seg_trainer(unet, remat=True)
    p1 = port.train_step(x, m, SEG_LR)
    grads = {n: p.grad.clone() for n, p in port.model.named_parameters()}
    p2 = port.train_step(x, m, SEG_LR)
    return {"jax": (float(j1["loss"]), float(j1["accuracy"]), float(j2["loss"])),
            "port": (float(p1["loss"]), float(p1["accuracy"]), float(p2["loss"])),
            "jax_grads": jax_grads,
            "port_grads": grads}


def test_seg_remat_step_matches_jax(seg_vs_jax):
    (jl, ja, jl2), (pl, pa, pl2) = seg_vs_jax["jax"], seg_vs_jax["port"]
    np.testing.assert_allclose(pl, jl, rtol=TOL_LOSS)
    np.testing.assert_allclose(pa, ja, atol=TOL_LOSS)
    np.testing.assert_allclose(pl2, jl2, rtol=TOL_AFTER_ADAM)
    for name, g in seg_vs_jax["port_grads"].items():
        want = seg_vs_jax["jax_grads"][name]
        assert float((g - want).abs().max()) <= TOL_GRAD_REL * float(want.norm()), name


