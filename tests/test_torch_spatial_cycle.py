"""CycleGAN and AttentionGAN cycle training on the spatial axis of the
port's mesh, on the CPU (gloo ranks, tests/torch_spatial_workers.py),
against one process and against the JAX package's spatial mesh.

Cases, all from the port's seed-47 init at 64^2, global batch 4, f32: each
family on a 1 x 2 and a 2 x 2 mesh; AttentionGAN under remat ``convs`` (the
cycle trainer's default policy, whose selective checkpoint recomputes the
halo exchanges and the partial instance-norm reductions in the backward);
CycleGAN with the identity loss; CycleGAN with ``TrainConfig(buffer_size=2)``
on 2 x 2, so that every item after the first two goes through the
buffers' replace draws (two of step 1's four, all of step 2's).

- The ranks of a case hold the same losses and parameters, bit for bit.
- Step-1 losses within rtol 1e-6 of one process's (the sums split over
  shards and added); step 2 within 2e-3 (it reads parameters that
  Adam moved by about lr x sign(grad), which turns a rounding-size
  gradient difference into +-lr; tests/test_torch_parallel.py's rule).
- Step-1 gradients in float64 (the G loss against the current Ds, the D
  loss on the reals and the synthetics): the shards' gradients, summed over
  the spatial ranks and averaged over the stripes, equal one process's
  within 1e-10 of each tensor's norm; a conv bias that feeds an instance
  norm has a true gradient of 0, held to 1e-12.  This holds the gradient
  scale: the spatial sum happens once.
- The buffers: the spatial ranks' rows of each buffered image,
  concatenated, equal one process's buffer, slot for slot, and its count,
  the data stripes gathering over the data group (every spatial rank
  queries the same images' rows with the same draws): within 1e-5 after
  step 1 (the generators' outputs, held as their forward is below; 4.8e-6
  seen), within 2e-2 of the images' scale after step 2, whose synthetics
  come from generators that Adam moved (6e-3 to 8e-3 of the scale seen
  here; a slot holding another image would be off by the scale itself).
- The CycleGAN generator's forward on each rank's rows against JAX's
  ``gen_apply`` on ``make_mesh(2, spatial=2)`` within rtol 2e-4, atol 2e-5
  (tests/test_parallel.py:103's tolerance), and against one process.
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
from floodgan_tpu.train.cycle import CycleTrainer as JaxCycleTrainer
from floodgan_tpu_torch.utils.jax_params import jax_tree_from_state_dict

from torch_spatial_workers import (
    CH,
    cycle_case,
    cycle_on_ranks,
    cycle_step1_grads,
    cycle_trainer,
    make_batch,
    run_ranks,
)

TOL_STEP1_LOSS = 1e-6
TOL_AFTER_ADAM = 2e-3
TOL_F64_GRAD = 1e-10
TOL_ZERO_GRAD = 1e-12
TOL_BUFFER_AFTER_ADAM = 2e-2
TOL_JAX_FWD = (2e-4, 2e-5)
TOL_FWD = 1e-5
NOT_NORMED_BIASES = {"conv_out.bias", "deconv3_content.bias", "deconv3_attention.bias", "conv0.bias", "conv4.bias"}

BASE = {"batch": 4, "height": 64, "width": 64}
# name: (world size, case); "ref" names the one-process run it is held to.
CASES = {
    "attentiongan 1x2": (2, dict(BASE, model="attentiongan", spatial=2, grads=True, ref="attentiongan")),
    "cyclegan 1x2": (2, dict(BASE, model="cyclegan", spatial=2, grads=True, ref="cyclegan")),
    "attentiongan convs 1x2": (2, dict(BASE, model="attentiongan", spatial=2, ref="attentiongan",
                                       kw={"remat": True, "remat_policy": "convs"})),
    "cyclegan identity 1x2": (2, dict(BASE, model="cyclegan", spatial=2, ref="cyclegan identity",
                                      kw={"add_identity_loss": True})),
    "attentiongan 2x2": (4, dict(BASE, model="attentiongan", spatial=2, grads=True, ref="attentiongan")),
    "cyclegan 2x2": (4, dict(BASE, model="cyclegan", spatial=2, ref="cyclegan")),
    "cyclegan buffer 2 2x2": (4, dict(BASE, model="cyclegan", spatial=2, buffer_size=2, ref="cyclegan buffer 2")),
}
REFS = {
    "attentiongan": dict(BASE, model="attentiongan", grads=True),
    "cyclegan": dict(BASE, model="cyclegan", grads=True),
    "cyclegan identity": dict(BASE, model="cyclegan", kw={"add_identity_loss": True}),
    "cyclegan buffer 2": dict(BASE, model="cyclegan", buffer_size=2),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("spatial_cycle"))
    cases = {}
    for name, (world, case) in CASES.items():
        cases.setdefault(world, {})[name] = case
    failures = []

    def launch(world):
        try:
            run_ranks(cycle_on_ranks, world, args=(out, f"w{world}", cases[world]))
        except Exception as e:  # re-raised below, on the test's thread
            failures.append(e)

    threads = [threading.Thread(target=launch, args=(w,)) for w in cases]
    for t in threads:
        t.start()
    # The one-process references and JAX's spatial forward, on this thread meanwhile.
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        refs = {}
        for ref, case in REFS.items():
            refs[ref] = cycle_case(case)
            if case.get("grads"):
                refs[ref]["grads64"] = cycle_step1_grads(case)
        jax_fwd = _jax_cyclegan_forward()
    finally:
        torch.set_num_threads(before)
    for t in threads:
        t.join()
    if failures:
        raise failures[0]
    ranks = {}
    for world in cases:
        for r in range(world):
            for name, res in torch.load(os.path.join(out, f"w{world}_rank{r}.pt")).items():
                ranks.setdefault(name, []).append(res)
    shutil.rmtree(out)  # the gradients of three cases
    return {"ranks": ranks, "refs": refs, "jax_fwd": jax_fwd}


def _jax_cyclegan_forward():
    """JAX's CycleGAN G_ab on ``make_mesh(2, spatial=2)``, with the port's
    seed-47 parameters, on the 64^2 batch: (4, 64, 64, 3) NHWC."""
    x, _ = make_batch(BASE["batch"], BASE["height"], BASE["width"])
    gen = cycle_trainer(dict(BASE, model="cyclegan")).gen_ab
    params = jax.tree.map(jnp.asarray, jax_tree_from_state_dict(gen, dict(gen.named_parameters())))
    jt = JaxCycleTrainer("cyclegan", CH, phase_d=False, phase_gen=False)
    mesh = jax_make_mesh(2, spatial=2)
    return np.asarray(jt.gen_apply(replicate_tree(params, mesh), jax_shard_images(jnp.asarray(x), mesh)))


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


@pytest.mark.parametrize("name", [n for n, (_, c) in CASES.items() if c.get("grads")])
def test_float64_gradients_of_the_shards_add_up_to_one_process(runs, name):
    got, want = runs["ranks"][name][0]["grads64"], _ref(runs, name)["grads64"]
    assert set(got) == set(want)
    for k, g in got.items():
        err = float((g - want[k]).abs().max())
        if _feeds_an_instance_norm(k):
            assert err <= TOL_ZERO_GRAD and float(want[k].abs().max()) <= TOL_ZERO_GRAD, k
        else:
            assert err <= TOL_F64_GRAD * float(want[k].norm()), (k, err)


@pytest.mark.parametrize("name", list(CASES))
def test_the_spatial_ranks_buffer_rows_make_one_process_buffer(runs, name):
    for step, tol in enumerate((TOL_FWD, TOL_BUFFER_AFTER_ADAM)):
        want = _ref(runs, name)["buffers"][step]
        for stripe in _groups(runs, name):
            for key, (images, count) in want.items():
                got = torch.cat([res["buffers"][step][key][0] for res in stripe], 2)
                assert all(res["buffers"][step][key][1] == count for res in stripe)
                assert got.shape == images.shape
                scale = 1.0 if step == 0 else float(images.abs().max())
                err = (got - images).abs().amax(dim=(1, 2, 3))
                assert float(err.max()) <= tol * scale, (key, step, err.tolist())


def test_the_small_buffer_went_through_its_replace_draws(runs):
    # 2 steps of 4 items into 2 slots: 2 stores, then 6 items through the replace draws.
    for res in runs["ranks"]["cyclegan buffer 2 2x2"]:
        assert all(count == 2 for step in res["buffers"] for _, count in step.values())


def test_cyclegan_generator_forward_matches_jax_on_its_spatial_mesh(runs):
    want = runs["jax_fwd"]  # (4, 64, 64, 3), NHWC
    rtol, atol = TOL_JAX_FWD
    (stripe,) = _groups(runs, "cyclegan 1x2")
    rows = want.shape[1] // len(stripe)
    for s, res in enumerate(stripe):
        got = res["forward"].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want[:, s * rows:(s + 1) * rows], rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["attentiongan 1x2", "cyclegan 1x2", "attentiongan 2x2"])
def test_generator_forward_equals_one_process(runs, name):
    want = _ref(runs, name)["forward"]
    stripes = _groups(runs, name)
    per = want.shape[0] // len(stripes)
    got = torch.cat([torch.cat([r["forward"] for r in stripe], 2) for stripe in stripes])
    assert got.shape == want.shape and per * len(stripes) == want.shape[0]
    assert float((got - want).abs().max()) <= TOL_FWD
