"""Pix2Pix on the spatial axis of the port's mesh, on the CPU (gloo ranks,
tests/torch_spatial_workers.py), against one process and against the JAX
package's spatial mesh.

The 8-level U-Net at 256^2 reaches 1 x 1 at its innermost level, narrower
than a shard: from the first down level that cannot halve its shard
(``parallel.spatial.pix2pix_gather_level``: level 7 at S = 2, level 6 at
S = 4) the rows are gathered and the deep levels run replicated, their
batch norms over the data stripes alone; the decoder cuts back to rows.

Cases, from the port's seed-47 init at 256^2, global batch 2, dropout rate
0.5 (the masks of the global batch, rows kept where a level holds rows):
1 x 2 and 1 x 4 meshes; and the batch-norm PatchGAN alone on a 2 x 2 mesh.

- The ranks of a case hold the same losses and parameters, bit for bit.
- Step-1 losses within rtol 1e-6 of one process's, but the G adversarial
  loss, which reads the D that Adam has just moved (the paired step is D
  then G), within 2e-3 as every loss of step 2 is (tests/test_torch_spatial_step.py's
  after-Adam rule; 2.2e-5 seen at step 1).
- Step-1 gradients in float64, no update between the D and the G loss:
  the shards' gradients summed over the ranks equal one process's within
  1e-10 of each tensor's norm, which holds the replicated levels' scale
  (the gather's reduce-scatter and ``mean_grads`` each sum once).
- The generator's forward (dropout rate 0) on each rank's rows against
  JAX's ``gen_apply`` on ``make_mesh(2, spatial=2)`` and ``make_mesh(4,
  spatial=4)`` within atol 3e-5 (tests/test_parallel.py:329-345's
  tolerance), and against one process within 1e-5.
- The batch-norm PatchGAN on its stripe and rows of a 2 x 2 mesh, float64:
  forward and input gradient within 1e-12 of the whole batch, parameter
  gradients within 1e-10 of each tensor's norm (its last shard's logit
  rows are fewer, and norm3's element count is summed from the real
  shapes).
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
from floodgan_tpu_torch.utils.jax_params import jax_tree_from_state_dict

from torch_spatial_workers import CH, make_batch, paired_trainer, pix2pix_on_ranks, run_ranks, step1_grads, step_case

TOL_STEP1_LOSS = 1e-6
TOL_AFTER_ADAM = 2e-3
TOL_F64_GRAD = 1e-10
TOL_JAX_FWD = 3e-5
TOL_FWD = 1e-5
TOL_LAYER = 1e-12
READS_THE_UPDATED_D = {"losses_generator_synthetic"}

BASE = {"model": "pix2pix", "batch": 2, "height": 256, "width": 256, "dropout": 0.5, "grads": True}
# name: (world size, case)
CASES = {"S=2 1x2": (2, dict(BASE, spatial=2)), "S=4 1x4": (4, dict(BASE, spatial=4))}
NETWORKS = {"batch-norm PatchGAN 2x2": (4, (2, "batch-norm PatchGAN", (2, CH + 3, 48, 24)))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("spatial_pix2pix"))
    jobs = {}
    for name, (world, case) in CASES.items():
        jobs.setdefault(world, ({}, {}))[0][name] = case
    for name, (world, net) in NETWORKS.items():
        jobs.setdefault(world, ({}, {}))[1][name] = net
    failures = []

    def launch(world):
        try:
            run_ranks(pix2pix_on_ranks, world, args=(out, f"w{world}", *jobs[world]))
        except Exception as e:  # re-raised below, on the test's thread
            failures.append(e)

    threads = [threading.Thread(target=launch, args=(w,)) for w in jobs]
    for t in threads:
        t.start()
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ref = step_case(BASE)
        ref["grads64"] = step1_grads(BASE, None, torch.float64)
        jax_fwd = _jax_forwards()
    finally:
        torch.set_num_threads(before)
    for t in threads:
        t.join()
    if failures:
        raise failures[0]
    ranks = {}
    for world in jobs:
        for r in range(world):
            for name, res in torch.load(os.path.join(out, f"w{world}_rank{r}.pt")).items():
                ranks.setdefault(name, []).append(res)
    shutil.rmtree(out)
    return {"ranks": ranks, "ref": ref, "jax_fwd": jax_fwd}


def _jax_forwards():
    """JAX's Pix2Pix generator (dropout rate 0) with the port's seed-47
    parameters on ``make_mesh(S, spatial=S)`` for S = 2 and 4: {S: (2, 256,
    256, 3) NHWC}."""
    x, _ = make_batch(BASE["batch"], BASE["height"], BASE["width"])
    gen = paired_trainer(BASE).generator
    params = jax.tree.map(jnp.asarray, jax_tree_from_state_dict(gen, dict(gen.named_parameters())))
    jt = JaxPairedTrainer("pix2pix", CH, dropout_rate=0.0, phase_step=False)
    out = {}
    for s in (2, 4):
        mesh = jax_make_mesh(s, spatial=s)
        out[s] = np.asarray(jt.gen_apply(replicate_tree(params, mesh), jax_shard_images(jnp.asarray(x), mesh),
                                         jax.random.key(7)))
    return out


def _in_spatial_order(runs, name):
    return sorted(runs["ranks"][name], key=lambda res: res["mesh"][1])


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_the_same_losses_and_parameters(runs, name):
    first, *rest = runs["ranks"][name]
    assert len(rest) + 1 == CASES[name][0]
    for other in rest:
        assert other["losses"] == first["losses"]
        assert other["params"] == first["params"]


@pytest.mark.parametrize("name", list(CASES))
def test_step1_losses_equal_one_process(runs, name):
    got, want = runs["ranks"][name][0]["losses"][0], runs["ref"]["losses"][0]
    assert set(got) == set(want)
    for k, v in want.items():
        tol = TOL_AFTER_ADAM if k in READS_THE_UPDATED_D else TOL_STEP1_LOSS
        np.testing.assert_allclose(got[k], v, rtol=tol, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_step2_losses_follow_one_process(runs, name):
    got, want = runs["ranks"][name][0]["losses"][1], runs["ref"]["losses"][1]
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=TOL_AFTER_ADAM, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_float64_gradients_of_the_shards_add_up_to_one_process(runs, name):
    got, want = runs["ranks"][name][0]["grads64"], runs["ref"]["grads64"]
    assert set(got) == set(want)
    for k, g in got.items():
        assert float((g - want[k]).abs().max()) <= TOL_F64_GRAD * float(want[k].norm()), k


@pytest.mark.parametrize("name", list(CASES))
def test_generator_forward_matches_jax_on_its_spatial_mesh(runs, name):
    spatial = CASES[name][1]["spatial"]
    want = runs["jax_fwd"][spatial]
    rows = want.shape[1] // spatial
    for s, res in enumerate(_in_spatial_order(runs, name)):
        got = res["forward"].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want[:, s * rows:(s + 1) * rows], atol=TOL_JAX_FWD)


@pytest.mark.parametrize("name", list(CASES))
def test_generator_forward_equals_one_process(runs, name):
    got = torch.cat([res["forward"] for res in _in_spatial_order(runs, name)], 2)
    want = runs["ref"]["forward"]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= TOL_FWD


def test_batch_norm_patchgan_on_a_2x2_mesh_equals_the_whole_batch(runs):
    for res in runs["ranks"]["batch-norm PatchGAN 2x2"]:
        assert res["err"] <= TOL_LAYER and res["derr"] <= TOL_LAYER, (res["err"], res["derr"])
        assert res["rows"] == [3, 1]  # 48 rows: the k4 s1 p1 convs take two off the last shard
        for name, (err, norm) in res["grads"].items():
            assert err <= max(TOL_F64_GRAD * norm, TOL_LAYER), (name, err, norm)
