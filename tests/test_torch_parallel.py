"""The port's data parallelism on the CPU (gloo), against one process and
against the JAX package.

- ``process_stripe`` against JAX's.
- ``MultiHostBatchLoader``: with one process it yields ``BatchLoader``'s
  batches with the remainder dropped, and the names of JAX's
  ``MultiHostBatchLoader`` over a one-process view of the conftest's
  8-device mesh; the stripes of 2 and 4 processes partition each global
  batch in rank order.
- Two gloo ranks, each on its stripe of a global batch, against one
  process on the whole batch (tests/torch_parallel_workers.py):
  PairedAttention at 32^2; Pix2Pix at 256^2 with global batch norm and
  dropout rate 0.5; AttentionGAN at 32^2 with its replay buffers;
  PairedAttention under remat (``full``).  The two ranks hold the same
  losses, gradients, parameters and buffers exactly.  Against one
  process, the step-1 losses are within rtol 1e-6 and the step-1
  gradients within 1e-5 of each tensor's norm: only the summation order
  differs (a batch's sums split over two ranks and then added); a conv
  bias that feeds an instance norm, whose gradient is zero up to rounding,
  gets 1e-5 absolute instead, as in tests/test_torch_train.py.  Pix2Pix's
  gradients get 1e-3 of the norm: at 256^2 with a global batch of 2 its
  innermost batch norms normalise 2 or 8 values per channel, whose output
  hardly depends on x, so the gradient through them is a difference of
  rounding-size terms (up to 1.9e-4 of the norm was seen, at
  up5_norm.weight; the same step in float64 put the two runs 2.7e-15 of
  the norm apart).  The float64 batch norm of two ranks equals one
  process's within 1e-12 (output, input gradient, scale and bias
  gradients), which holds the global statistics' arithmetic itself.  The
  step-2 losses read parameters that Adam moved by about lr x sign(grad),
  which turns a rounding-size gradient difference into +-lr, so they are
  held within 2e-3, the after-update rule of tests/test_torch_train.py.
  The buffers hold the same counts, and images within 1e-5 (the
  generators' f32 outputs for a batch of 2 against one of 4; CPU
  convolutions block their sums by the batch).
- The 2-rank PairedAttention step against JAX's ``PairedTrainer`` on a
  2-device data mesh from the same init: step-1 losses within 1e-5.
- ``spawn`` fails fast, and does not hang, when a rank dies while the other
  waits for it in a collective; ``make_mesh`` checks its arguments as JAX's
  does, the spatial axis included (tests/test_torch_spatial*.py run it).
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu.data.pipeline import create_flood_dataset as jax_create_flood_dataset
from floodgan_tpu.parallel import make_mesh as jax_make_mesh
from floodgan_tpu.parallel import replicate_tree, shard_batch
from floodgan_tpu.parallel.multihost import MultiHostBatchLoader as JaxMultiHostBatchLoader
from floodgan_tpu.parallel.multihost import process_stripe as jax_process_stripe
from floodgan_tpu.train.paired import PairedTrainer as JaxPairedTrainer
from floodgan_tpu_torch.data.pipeline import create_flood_dataset
from floodgan_tpu_torch.models.registry import build_discriminator, build_generator
from floodgan_tpu_torch.parallel import mesh as mesh_lib
from floodgan_tpu_torch.parallel.multihost import MultiHostBatchLoader, process_stripe
from floodgan_tpu_torch.utils.jax_params import state_dict_from_jax

from fixtures import make_flood_fixture
from torch_parallel_workers import CH, LR, batch_norm_f64, case_batch, failing_rank, run_case, run_ranks, step_cases

TOL_STEP1_LOSS = 1e-6   # rtol
TOL_GRAD = 1e-5         # of each gradient tensor's norm
TOL_GRAD_BN = 1e-3      # the same for Pix2Pix: see the module docstring
TOL_F64 = 1e-12
TOL_ZERO_GRAD = 1e-5    # absolute, for a conv bias that feeds an instance norm
NOT_NORMED_BIASES = {"deconv3_content.bias", "deconv3_attention.bias", "conv_out.bias", "conv0.bias", "conv4.bias"}
TOL_AFTER_ADAM = 2e-3
TOL_BUFFER = 1e-5
TOL_JAX_LOSS = 1e-5

CASES = {
    "pairedattention": {"model": "pairedattention", "size": 32, "batch": 4},
    "pix2pix": {"model": "pix2pix", "size": 256, "batch": 2, "kw": {"dropout_rate": 0.5}},
    "attentiongan": {"model": "attentiongan", "size": 32, "batch": 4},
    "pairedattention_remat": {"model": "pairedattention", "size": 32, "batch": 4,
                              "kw": {"remat": True, "remat_policy": "full"}},
}


# ------------------------------------------------------------ the stripe

@pytest.mark.parametrize("global_batch,count", [(8, 1), (8, 2), (8, 4), (8, 8), (6, 3)])
def test_process_stripe_matches_jax(global_batch, count):
    for i in range(count):
        assert process_stripe(global_batch, i, count) == jax_process_stripe(global_batch, i, count)


def test_process_stripe_needs_an_even_split():
    with pytest.raises(ValueError, match="must divide over 3 processes"):
        process_stripe(8, 0, 3)
    with pytest.raises(ValueError):
        jax_process_stripe(8, 0, 3)


# ------------------------------------------------------------ the loader

@pytest.fixture(scope="module")
def flood_data(tmp_path_factory):
    return make_flood_fixture(tmp_path_factory.mktemp("dp_data"), size=32, n_per_disaster=3)


def test_one_process_loader_is_the_batch_loader_without_the_remainder(flood_data):
    data_path, meta_dir = flood_data
    train, _, _ = create_flood_dataset("usa", "same", data_path, "all", None, None, batch_size=4,
                                       metadata_dir=meta_dir, device="cpu")
    striped = MultiHostBatchLoader(train.dataset, 4, device="cpu")
    assert len(striped) == len(train.dataset) // 4 < len(train)
    for epoch in (1, 2):
        got, want = list(striped.epoch_iter(epoch)), list(train.epoch_iter(epoch))[:len(striped)]
        assert [b["names"] for b in got] == [b["names"] for b in want]
        for a, b in zip(got, want):
            assert torch.equal(a["input"], b["input"]) and torch.equal(a["output"], b["output"])


def test_one_process_loader_names_match_jax(flood_data):
    data_path, meta_dir = flood_data
    train, _, _ = create_flood_dataset("usa", "same", data_path, "all", None, None, batch_size=4,
                                       metadata_dir=meta_dir, device="cpu")
    jax_train, _, _ = jax_create_flood_dataset("usa", "same", data_path, "all", None, None, batch_size=4,
                                               metadata_dir=meta_dir)
    theirs = JaxMultiHostBatchLoader(jax_train.dataset, jax_make_mesh(2), 4, process_index=0, process_count=1,
                                     num_workers=2)
    ours = MultiHostBatchLoader(train.dataset, 4, device="cpu")
    assert len(ours) == len(theirs)
    for epoch in (0, 3):
        assert [b["names"] for b in ours.epoch_iter(epoch)] == [b["names"] for b in theirs.epoch_iter(epoch)]


@pytest.mark.parametrize("count", [2, 4])
def test_stripes_partition_each_global_batch(flood_data, count):
    data_path, meta_dir = flood_data
    train, _, _ = create_flood_dataset("usa", "same", data_path, "all", None, None, batch_size=4,
                                       metadata_dir=meta_dir, device="cpu")
    whole = [b["names"] for b in MultiHostBatchLoader(train.dataset, 4, device="cpu").epoch_iter(5)]
    ranks = [[b["names"] for b in MultiHostBatchLoader(train.dataset, 4, i, count, device="cpu").epoch_iter(5)]
             for i in range(count)]
    assert all(len(r) == len(whole) for r in ranks)
    for j, names in enumerate(whole):
        assert [n for r in ranks for n in r[j]] == names
        assert all(len(r[j]) == 4 // count for r in ranks)


# ------------------------------------------------------------ two ranks

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp_steps"))
    # PairedAttention starts from JAX's init, so that its run also serves the JAX comparison.
    x, y = case_batch(32, 4)
    jt = JaxPairedTrainer("pairedattention", CH, phase_step=False)
    s0 = jt.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
    init = {"gen": state_dict_from_jax(build_generator("pairedattention", CH), jax.tree.map(np.asarray, s0.gen_params)),
            "disc": state_dict_from_jax(build_discriminator("pairedattention", CH + 3),
                                        jax.tree.map(np.asarray, s0.disc_params))}
    torch.save(init, os.path.join(out, "init.pt"))
    cases = {k: dict(v) for k, v in CASES.items()}
    cases["pairedattention"]["init"] = os.path.join(out, "init.pt")
    # The ranks run in their own processes while this one runs the reference.
    failure = []

    def ranks():
        try:
            run_ranks(step_cases, 2, args=(out, cases))
        except Exception as e:  # re-raised below, on the test's thread
            failure.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()
    torch.set_num_threads(2)
    one = {name: run_case(case) for name, case in cases.items()}
    thread.join()
    if failure:
        raise failure[0]
    ranks_ = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    return {"ranks": ranks_, "one": one, "jax_state": s0, "jax_trainer": jt, "x": x, "y": y}


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_the_same_state(two_ranks, name):
    a, b = (r[name] for r in two_ranks["ranks"])
    assert a["losses"] == b["losses"]
    for key in ("grads", "params"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key]), key
    for sa, sb in zip(a["buffers"], b["buffers"]):
        assert all(torch.equal(sa[k][0], sb[k][0]) and sa[k][1] == sb[k][1] for k in sa)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_step1_losses_equal_one_process(two_ranks, name):
    got, want = two_ranks["ranks"][0][name]["losses"][0], two_ranks["one"][name]["losses"][0]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=TOL_STEP1_LOSS, err_msg=k)


def _feeds_an_instance_norm(model: str, name: str) -> bool:
    """A conv bias whose output goes straight into an instance norm: the
    norm removes any per-channel constant, so its gradient is zero up to
    rounding (tests/test_torch_train.py)."""
    net, param = name.split(".", 1)
    return model != "pix2pix" and param.endswith(".bias") and param not in NOT_NORMED_BIASES


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_gradients_equal_one_process(two_ranks, name):
    got, want = two_ranks["ranks"][0][name]["grads"], two_ranks["one"][name]["grads"]
    assert set(got) == set(want)
    for k, g in got.items():
        err = float((g - want[k]).abs().max())
        if _feeds_an_instance_norm(CASES[name]["model"], k):
            assert err <= TOL_ZERO_GRAD, k
        else:
            tol = TOL_GRAD_BN if CASES[name]["model"] == "pix2pix" else TOL_GRAD
            assert err <= tol * float(want[k].norm()), k


def test_two_ranks_batch_norm_equals_one_process_in_float64(two_ranks):
    want = batch_norm_f64()
    for rank, res in enumerate(two_ranks["ranks"]):
        got = res["batch_norm_f64"]
        for k in ("y", "dx"):
            torch.testing.assert_close(got[k], want[k][2 * rank:2 * rank + 2], rtol=0, atol=TOL_F64)
        torch.testing.assert_close(got["dscale_dbias"], want["dscale_dbias"], rtol=0, atol=TOL_F64)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_step2_losses_follow_one_process(two_ranks, name):
    got, want = two_ranks["ranks"][0][name]["losses"][1], two_ranks["one"][name]["losses"][1]
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=TOL_AFTER_ADAM, err_msg=k)


def test_two_ranks_buffers_equal_one_process(two_ranks):
    got, want = two_ranks["ranks"][0]["attentiongan"]["buffers"], two_ranks["one"]["attentiongan"]["buffers"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("pre_buffer", "post_buffer"):
            assert g[k][1] == w[k][1]
            torch.testing.assert_close(g[k][0], w[k][0], rtol=0, atol=TOL_BUFFER)


def test_two_ranks_step_matches_jax_on_a_two_device_mesh(two_ranks):
    jt, s0 = two_ranks["jax_trainer"], two_ranks["jax_state"]
    mesh = jax_make_mesh(2)
    state = replicate_tree(s0, mesh)
    x, y = shard_batch(jnp.asarray(two_ranks["x"]), mesh), shard_batch(jnp.asarray(two_ranks["y"]), mesh)
    _, metrics = jt.train_step(state, x, y, jnp.float32(LR), jax.random.key(1))
    got = two_ranks["ranks"][0]["pairedattention"]["losses"][0]
    for k in ("losses_discriminator_real", "losses_discriminator_synthetic", "l1_losses_generator_synthetic"):
        np.testing.assert_allclose(got[k], float(metrics[k]), rtol=TOL_JAX_LOSS, err_msg=k)
    # The G loss reads D after its update, where Adam turns rounding into +-lr.
    np.testing.assert_allclose(got["losses_generator_synthetic"], float(metrics["losses_generator_synthetic"]),
                               rtol=TOL_AFTER_ADAM)


# ------------------------------------------------------------ failures

def test_a_dead_rank_fails_the_run_instead_of_hanging():
    import time

    from torch.multiprocessing import ProcessRaisedException

    t0 = time.monotonic()
    # The launcher reports the first rank it finds dead: rank 1 itself, or
    # rank 0, whose barrier fails once its peer's connection closes.
    with pytest.raises(ProcessRaisedException, match="rank 1 failed on purpose|Connection (closed|reset) by peer"):
        run_ranks(failing_rank, 2)
    assert time.monotonic() - t0 < 60


def test_make_mesh_checks_like_jax(monkeypatch):
    # The spatial axis validates as JAX's make_mesh does: it must divide the world.
    for bad in (3, 0):
        with pytest.raises(ValueError, match=f"spatial={bad} must divide the 8-device mesh"):
            mesh_lib.make_mesh(8, spatial=bad)
        with pytest.raises(ValueError):
            jax_make_mesh(8, spatial=bad)
    with pytest.raises(RuntimeError, match="one process per rank"):  # valid, but no group joined
        mesh_lib.make_mesh(8, spatial=4)
    assert jax_make_mesh(8, spatial=4).shape == {"data": 2, "spatial": 4}
    with pytest.raises(RuntimeError, match="one process per rank"):
        mesh_lib.make_mesh(2, device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        mesh_lib.check_devices(2, "cuda")
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        mesh_lib.spawn(failing_rank, 2, device_type="cuda")
    mesh_lib.check_devices(8, "cpu")  # CPU ranks are processes


def test_cli_refuses_more_ranks_than_cards(monkeypatch, flood_data):
    from floodgan_tpu_torch.cli import train as cli_train

    data_path, meta_dir = flood_data
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        cli_train.main(["--model=PairedAttention", "--dataset_subset=usa", "--dataset_dem=same",
                        f"--data_path={data_path}", f"--metadata_dir={meta_dir}", "--batch_size=2",
                        "--num_data_devices=2"])


def test_model_needs_a_batch_the_ranks_divide(flood_data):
    from floodgan_tpu_torch.api.model import Model

    data_path, meta_dir = flood_data
    with pytest.raises(ValueError, match="batch_size must be divisible by num_data_devices"):
        Model(model="PairedAttention", dataset_subset="usa", dataset_dem="same", data_path=data_path,
              metadata_dir=meta_dir, batch_size=3, num_data_devices=2, device="cpu")


class _LocalOnlyMesh:
    """A one-rank mesh whose collectives must not run."""

    size, rank, device = 1, 0, torch.device("cpu")

    def replicate_(self, *modules):
        pass

    def stripe(self, global_batch):
        return process_stripe(global_batch, 0, 1)

    def all_reduce_sum_(self, t):
        raise AssertionError("inference ran a collective")


def test_pix2pix_inference_on_a_mesh_reads_its_own_batch():
    from floodgan_tpu_torch.train.paired import PairedTrainer

    x = np.random.default_rng(2).standard_normal((1, 256, 256, CH)).astype(np.float32)
    on_mesh = PairedTrainer("pix2pix", CH, device="cpu", mesh=_LocalOnlyMesh())
    plain = PairedTrainer("pix2pix", CH, device="cpu")
    # The first vectorised exp/tanh calls of a CPU process with JAX loaded can
    # come out ~4e-5 off (tests/test_torch_kernels.py): discard one forward.
    plain.generate(x)
    out, _ = on_mesh.generate(x)  # would raise had it run a collective
    torch.testing.assert_close(out, plain.generate(x)[0], rtol=0, atol=1e-6)
    bn = on_mesh.generator.unet.down1_norm
    assert bn.mesh is on_mesh.mesh  # restored for training


def test_plain_iteration_advances_the_epoch(flood_data):
    data_path, meta_dir = flood_data
    train, _, _ = create_flood_dataset("usa", "same", data_path, "all", None, None, batch_size=2,
                                       metadata_dir=meta_dir, device="cpu")
    loader = MultiHostBatchLoader(train.dataset, 2, device="cpu")
    first, second = [[b["names"] for b in loader] for _ in range(2)]
    assert first == [b["names"] for b in loader.epoch_iter(0)]
    assert second == [b["names"] for b in loader.epoch_iter(1)] != first
