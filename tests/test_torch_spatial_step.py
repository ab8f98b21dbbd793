"""PairedAttention on the spatial axis of the port's mesh, on the CPU (gloo
ranks, tests/torch_spatial_workers.py), against one process and against
the JAX package's spatial mesh.

Cases, all from the port's seed-47 init (carried into JAX's state): the
64^2 step at global batch 4 on a 1 x 2 mesh and on a 2 x 2 mesh; a (1, 256, 32) step under remat
``boundaries`` on 1 x 2 and 1 x 4, the port's twin of JAX's 512-row test
(tests/test_parallel.py:131-172) at half the rows.

- The ranks of a case hold the same losses and parameters, bit for bit.
- Step-1 losses within rtol 1e-6 of one process's (the sums split over
  shards and added); step-2 losses within 2e-3 (they read parameters that
  Adam moved by about lr x sign(grad), which turns a rounding-size
  gradient difference into +-lr; tests/test_torch_parallel.py's rule).
- Step-1 gradients, with no update between the D and the G loss: in
  float64 the shards' summed gradients equal one process's within 1e-10 of
  each tensor's norm (which holds the gradient scaling: spatial sum, data
  mean).  In f32 within 1e-5 of the norm (1e-5 absolute for a conv bias
  that feeds an instance norm, whose true gradient is 0), but where one
  run crossed a kink, which the float64 gradient decides.  A shard's
  statistics are sums split over ranks and added, so its yhat differs from
  one process's in the last bits, and a ReLU input within that of 0 takes
  the other branch in one of the two runs; the flip moves that layer's
  weight gradient in one channel and every gradient upstream of it.  Seen
  both ways: at 64^2 one process's own f32 run crossed one near the
  attention head (29 generator tensors 4e-5 to 4.6e-4 of their norms off
  the float64 gradient, the shards' within 1e-7); at S = 4 the shards'
  run crossed one in trunk block 1 (4.7e-4 there, up to 1e-4 upstream).
  So a tensor off by more than 1e-5 passes if the shards' gradient is
  within 1e-5 of the float64 one, or if both f32 gradients are within
  KINK_TOL = 2e-3 of their norm of it (the cycle tests' bound).  The
  partial forms on one process (a group of one) come as close to the
  float64 gradients as the fused forms do, so the split, not the forms'
  arithmetic, is what differs.
- The generator's forward on each rank's rows against JAX's ``gen_apply``
  on ``make_mesh(2|4, spatial=2)`` within rtol 2e-4, atol 2e-5 (JAX's own
  tolerance, tests/test_parallel.py:103), and against one process.
- The 1 x 2 step's step-1 losses against JAX's spatial train step within
  rtol 2e-4, atol 1e-5 (tests/test_parallel.py:125-127).
"""

import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu.parallel import make_mesh as jax_make_mesh
from floodgan_tpu.parallel import replicate_tree
from floodgan_tpu.parallel.mesh import shard_images as jax_shard_images
from floodgan_tpu.train.paired import PairedTrainer as JaxPairedTrainer
from flax import serialization
from floodgan_tpu_torch.train.paired import PairedTrainer
from floodgan_tpu_torch.utils.jax_params import paired_state_to_jax

from torch_spatial_workers import CH, LR, make_batch, run_ranks, step1_grads, step_case, steps_on_ranks

TOL_STEP1_LOSS = 1e-6
TOL_AFTER_ADAM = 2e-3
TOL_F64_GRAD = 1e-10
TOL_GRAD = 1e-5
TOL_ZERO_GRAD = 1e-5
KINK_TOL = 2e-3
TOL_JAX_FWD = (2e-4, 2e-5)
TOL_JAX_LOSS = (2e-4, 1e-5)
TOL_FWD = 1e-5
NOT_NORMED_BIASES = {"deconv3_content.bias", "deconv3_attention.bias", "conv0.bias", "conv4.bias"}
REMAT = {"remat": True, "remat_policy": "boundaries"}

# name: (world size, case); "ref" names the one-process run it is held to.
CASES = {
    "64^2 1x2": (2, {"batch": 4, "height": 64, "width": 64, "spatial": 2, "ref": "64^2"}),
    "remat 256x32 1x2": (2, {"batch": 1, "height": 256, "width": 32, "spatial": 2, "kw": REMAT, "ref": "remat"}),
    "64^2 2x2": (4, {"batch": 4, "height": 64, "width": 64, "spatial": 2, "ref": "64^2"}),
    "remat 256x32 1x4": (4, {"batch": 1, "height": 256, "width": 32, "spatial": 4, "kw": REMAT, "ref": "remat"}),
}
JAX_MESHES = {"64^2 1x2": 2, "64^2 2x2": 4}


def _jax_state(jt, x, y):
    """JAX's ``PairedState`` holding the port's seed-47 init, on a template
    that ``jax.eval_shape`` traces (JAX's eager init takes ~25 s here)."""
    template = jax.eval_shape(jt.init, jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
    state = paired_state_to_jax(PairedTrainer("pairedattention", CH, device="cpu"))
    return serialization.from_state_dict(template, jax.tree.map(jnp.asarray, state))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("spatial_steps"))
    x, y = make_batch(4, 64, 64)
    jt = JaxPairedTrainer("pairedattention", CH, phase_step=False)
    cases = {}
    for name, (world, case) in CASES.items():
        cases.setdefault(world, {})[name] = dict(case, step1_grads=True)
    failures = []

    def launch(world):
        try:
            run_ranks(steps_on_ranks, world, args=(out, f"w{world}", cases[world]))
        except Exception as e:  # re-raised below, on the test's thread
            failures.append(e)

    threads = [threading.Thread(target=launch, args=(w,)) for w in cases]
    for t in threads:
        t.start()
    # The one-process references, on this thread meanwhile.
    torch.set_num_threads(2)
    refs = {}
    for ref, case in (("64^2", cases[2]["64^2 1x2"]), ("remat", cases[2]["remat 256x32 1x2"])):
        refs[ref] = step_case(case)
        refs[ref]["grads32"] = step1_grads(case, None, torch.float32)
        refs[ref]["grads64"] = step1_grads(case, None, torch.float64)
    # JAX's spatial meshes: the generator forward on 1 x 2 and 2 x 2, the step on 1 x 2.
    s0 = _jax_state(jt, x, y)
    key = jax.random.key(7)
    jax_fwd = {}
    for name, devices in JAX_MESHES.items():
        mesh = jax_make_mesh(devices, spatial=2)
        jax_fwd[name] = np.asarray(jt.gen_apply(replicate_tree(s0.gen_params, mesh),
                                                jax_shard_images(jnp.asarray(x), mesh), key))
    mesh = jax_make_mesh(2, spatial=2)
    _, metrics = jt.train_step(replicate_tree(s0, mesh), jax_shard_images(jnp.asarray(x), mesh),
                               jax_shard_images(jnp.asarray(y), mesh), jnp.float32(LR), jax.random.key(1))
    jax_losses = {k: float(v) for k, v in metrics.items()}
    for t in threads:
        t.join()
    if failures:
        raise failures[0]
    ranks = {}
    for world, named in cases.items():
        for r in range(world):
            for name, res in torch.load(os.path.join(out, f"w{world}_rank{r}.pt")).items():
                ranks.setdefault(name, []).append(res)
    shutil.rmtree(out)  # the gradients of four cases: hundreds of MB
    return {"ranks": ranks, "refs": refs, "jax_fwd": jax_fwd, "jax_losses": jax_losses}


def _groups(runs, name):
    """The case's ranks, grouped by data stripe, each in spatial order."""
    stripes = {}
    for res in runs["ranks"][name]:
        d, s = res["mesh"]
        stripes.setdefault(d, {})[s] = res
    return [[stripe[s] for s in sorted(stripe)] for _, stripe in sorted(stripes.items())]


def _ref(runs, name):
    return runs["refs"][CASES[name][1]["ref"]]


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_the_same_losses_and_parameters(runs, name):
    first, *rest = runs["ranks"][name]
    assert len(rest) + 1 == CASES[name][0]
    for other in rest:
        assert other["losses"] == first["losses"]
        assert other["params"] == first["params"]  # digests of every parameter's bytes


@pytest.mark.parametrize("name", list(CASES))
def test_step1_losses_equal_one_process(runs, name):
    got, want = runs["ranks"][name][0]["losses"][0], _ref(runs, name)["losses"][0]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=TOL_STEP1_LOSS, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_step2_losses_follow_one_process(runs, name):
    got, want = runs["ranks"][name][0]["losses"][1], _ref(runs, name)["losses"][1]
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=TOL_AFTER_ADAM, err_msg=k)


def _feeds_an_instance_norm(name: str) -> bool:
    param = name.split(".", 1)[1]
    return param.endswith(".bias") and param not in NOT_NORMED_BIASES


@pytest.mark.parametrize("name", list(CASES))
def test_float64_gradients_of_the_shards_add_up_to_one_process(runs, name):
    got, want = runs["ranks"][name][0]["grads64"], _ref(runs, name)["grads64"]
    assert set(got) == set(want)
    for k, g in got.items():
        err = float((g - want[k]).abs().max())
        if _feeds_an_instance_norm(k):
            assert err <= 1e-12 and float(want[k].abs().max()) <= 1e-12, k  # zero up to float64 rounding
        else:
            assert err <= TOL_F64_GRAD * float(want[k].norm()), (k, err)


@pytest.mark.parametrize("name", list(CASES))
def test_f32_gradients_equal_one_process(runs, name):
    got, want, exact = runs["ranks"][name][0]["grads32"], _ref(runs, name)["grads32"], _ref(runs, name)["grads64"]
    for k, g in got.items():
        err = float((g - want[k]).abs().max())
        if _feeds_an_instance_norm(k):
            assert err <= TOL_ZERO_GRAD, (k, err)
            continue
        norm = float(exact[k].norm())
        if err <= TOL_GRAD * norm:
            continue
        # One run crossed a kink: the float64 gradient decides.
        ours, theirs = (float((side.double() - exact[k]).abs().max()) for side in (g, want[k]))
        assert ours <= TOL_GRAD * norm or (ours <= KINK_TOL * norm and theirs <= KINK_TOL * norm), \
            (k, err, ours, theirs, norm)


@pytest.mark.parametrize("name", list(JAX_MESHES))
def test_generator_forward_matches_jax_on_its_spatial_mesh(runs, name):
    want = runs["jax_fwd"][name]  # (4, 64, 64, 3), NHWC
    rtol, atol = TOL_JAX_FWD
    stripes = _groups(runs, name)
    per = want.shape[0] // len(stripes)
    for d, stripe in enumerate(stripes):
        rows = want.shape[1] // len(stripe)
        for s, res in enumerate(stripe):
            got = res["forward"].permute(0, 2, 3, 1).numpy()
            np.testing.assert_allclose(got, want[d * per:(d + 1) * per, s * rows:(s + 1) * rows], rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_generator_forward_equals_one_process(runs, name):
    want = _ref(runs, name)["forward"]
    stripes = _groups(runs, name)
    per = want.shape[0] // len(stripes)
    got = torch.cat([torch.cat([r["forward"] for r in stripe], 2) for stripe in stripes])
    assert got.shape == want.shape and per * len(stripes) == want.shape[0]
    assert float((got - want).abs().max()) <= TOL_FWD


def test_step1_losses_match_jax_spatial_step(runs):
    got = runs["ranks"]["64^2 1x2"][0]["losses"][0]
    rtol, atol = TOL_JAX_LOSS
    for k, v in runs["jax_losses"].items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol, err_msg=k)
