"""The segmentation U-Net on the spatial axis of the port's mesh
(``SegTrainer(mesh=...)``), on the CPU (gloo ranks,
tests/torch_spatial_workers.py), against one process and against the JAX
package's spatial mesh.

JAX's ``SegTrainer`` runs on a mesh when it is handed sharded arrays
(tests/test_parallel.py:309-326); the port's takes the mesh and this
rank's part of each batch (``mesh.shard_images``).

Cases, from the port's seed-47 init, f32: ``SegTrainer`` at 64^2, global
batch 4 on a 2 x 2 mesh (its stripe and rows on each rank); the bilinear
variant's network alone at 64^2, batch 2, on a 1 x 2 mesh in float64.

- ``predict_logits`` on each rank's part against JAX's on ``make_mesh(8,
  spatial=2)`` within atol 3e-5 (tests/test_parallel.py:326's tolerance),
  and against one process within 1e-5.
- Two train steps: the ranks' metrics and parameters equal bit for bit;
  step 1's BCE within rtol 1e-6 of one process's and its accuracy within
  the share of pixels whose logit lies within 1e-5 of the threshold; step
  2's BCE within 2e-3 (it reads parameters Adam moved).  Step 1's
  gradients in float64, summed over the spatial ranks and averaged over
  the stripes, within 1e-10 of each tensor's norm of one process's.
- The bilinear U-Net on rows (the align-corners upsample at global
  coordinates): forward and input gradient within 1e-12 of the whole
  image, parameter gradients within 1e-10 of each tensor's norm.
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
from floodgan_tpu.train.seg import SegTrainer as JaxSegTrainer
from floodgan_tpu_torch.train.seg import SegTrainer
from floodgan_tpu_torch.utils.jax_params import jax_tree_from_state_dict

from torch_spatial_workers import run_ranks, seg_batch, seg_case, seg_on_ranks, seg_step1_grads

TOL_JAX = 3e-5
TOL_FWD = 1e-5
TOL_STEP1_LOSS = 1e-6
TOL_AFTER_ADAM = 2e-3
TOL_F64_GRAD = 1e-10
TOL_LAYER = 1e-12
NEAR_THRESHOLD = 1e-5

CASE = {"batch": 4, "size": 64, "spatial": 2}
BILINEAR = (2, "unet bilinear", (2, 3, 64, 64))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("spatial_unet"))
    jobs = {4: ({"2x2": CASE}, {}), 2: ({}, {"bilinear 1x2": BILINEAR})}
    failures = []

    def launch(world):
        try:
            run_ranks(seg_on_ranks, world, args=(out, f"w{world}", *jobs[world]))
        except Exception as e:  # re-raised below, on the test's thread
            failures.append(e)

    threads = [threading.Thread(target=launch, args=(w,)) for w in jobs]
    for t in threads:
        t.start()
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ref = seg_case(CASE)
        ref["grads64"] = seg_step1_grads(CASE)
        jax_logits = _jax_logits()
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
    return {"ranks": ranks, "ref": ref, "jax": jax_logits}


def _jax_logits():
    """JAX's ``predict_logits`` with the port's seed-47 U-Net on the 64^2
    batch sharded over ``make_mesh(8, spatial=2)``: (4, 64, 64, 1)."""
    x, _ = seg_batch(CASE["batch"], CASE["size"])
    model = SegTrainer(device="cpu").model
    params = jax.tree.map(jnp.asarray, jax_tree_from_state_dict(model, dict(model.named_parameters())))
    mesh = jax_make_mesh(8, spatial=2)
    return np.asarray(JaxSegTrainer().predict_logits(replicate_tree(params, mesh), jax_shard_images(jnp.asarray(x), mesh)))


def _global(runs, key):
    """The 2 x 2 ranks' ``key`` (NHWC) reassembled: stripes on the batch
    axis, rows on H."""
    stripes = {}
    for res in runs["ranks"]["2x2"]:
        d, s = res["mesh"]
        stripes.setdefault(d, {})[s] = res[key]
    return torch.cat([torch.cat([row[s] for s in sorted(row)], 1) for _, row in sorted(stripes.items())])


def test_predict_logits_on_the_mesh_match_jax_on_its_spatial_mesh(runs):
    got = _global(runs, "logits").numpy()
    assert got.shape == runs["jax"].shape == (4, 64, 64, 1)
    np.testing.assert_allclose(got, runs["jax"], atol=TOL_JAX)


def test_predict_logits_on_the_mesh_equal_one_process(runs):
    got, want = _global(runs, "logits"), runs["ref"]["logits"]
    assert float((got - want).abs().max()) <= TOL_FWD


def test_ranks_hold_the_same_metrics_and_parameters(runs):
    first, *rest = runs["ranks"]["2x2"]
    assert len(rest) == 3
    for other in rest:
        assert other["metrics"] == first["metrics"] and other["params"] == first["params"]


def test_train_steps_follow_one_process(runs):
    got, want = runs["ranks"]["2x2"][0]["metrics"], runs["ref"]["metrics"]
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=TOL_STEP1_LOSS)
    near = float((runs["ref"]["logits"].abs() <= NEAR_THRESHOLD).float().mean())
    assert abs(got[0]["accuracy"] - want[0]["accuracy"]) <= near + 1e-7
    np.testing.assert_allclose(got[1]["loss"], want[1]["loss"], rtol=TOL_AFTER_ADAM)


def test_float64_gradients_of_the_shards_add_up_to_one_process(runs):
    got, want = runs["ranks"]["2x2"][0]["grads64"], runs["ref"]["grads64"]
    assert set(got) == set(want)
    for k, g in got.items():
        assert float((g - want[k]).abs().max()) <= TOL_F64_GRAD * float(want[k].norm()), k


def test_bilinear_unet_on_rows_equals_the_whole_image(runs):
    for res in runs["ranks"]["bilinear 1x2"]:
        assert res["rows"] == [32, 32]
        assert res["err"] <= TOL_LAYER and res["derr"] <= TOL_LAYER, (res["err"], res["derr"])
        for name, (err, norm) in res["grads"].items():
            assert err <= max(TOL_F64_GRAD * norm, TOL_LAYER), (name, err, norm)
