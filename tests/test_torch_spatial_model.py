"""``Model`` and the training CLI on the spatial axis of the port's mesh, on
the CPU (gloo ranks).

- ``Model(num_data_devices=2, num_spatial_devices=2)`` trains
  PairedAttention on the 64^2 flood fixture (4 ranks, global batch 2, 2
  epochs): its epoch-1 loss means match one process's within rtol 2e-4,
  atol 1e-5 (tests/test_api_e2e.py:302-320's tolerance); epoch 2's within
  2e-3, since its steps read parameters that Adam moved by about lr x
  sign(grad), which turns a rounding-size gradient difference into +-lr
  (tests/test_torch_parallel.py's after-update rule; 4.9e-4 was seen).  The
  ranks hold the same state, and the stripes and rows add up to the global
  batch.  On the same
  ranks a height that the shards cannot take raises the ValueError that
  names the requirement.
- ``python -m floodgan_tpu_torch.cli.train --num_spatial_devices 2 --device
  cpu`` (2 gloo ranks, 1 epoch) writes a ``.sharded`` directory with one
  shard file per rank, which the JAX package's ``load_checkpoint_sharded``
  reads to the same tree, leaf for leaf, as the port's loader: for
  PairedAttention, and for AttentionGAN, whose replay buffers each spatial
  rank writes as a piece of its rows (rows [0, 32) in rank 0's file,
  [32, 64) in rank 1's).  The AttentionGAN directory, and the same state
  written by JAX's ``save_checkpoint_sharded`` (each buffer whole), resume
  on 2 spatial ranks bit for bit: each rank holds every parameter and
  moment of the file and its own rows of each buffer.
- ``Model(num_spatial_devices=2)`` trains CycleGAN (64^2) and Pix2Pix
  (resized to 256^2) for an epoch on 2 ranks: finite losses, the same on
  both.
- Each family's shard checks refuse a height its networks cannot take,
  naming the layer, before any rank builds a trainer.
"""

import glob
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from floodgan_tpu.ckpt import load_checkpoint_sharded as jax_load_sharded
from floodgan_tpu_torch.api.model import Model, check_shards, loss_keys
from floodgan_tpu_torch.ckpt import BF16Array, _msgpack
from floodgan_tpu_torch.ckpt.sharded import load_checkpoint_sharded

from fixtures import make_flood_fixture
from torch_seg_fixtures import few_torch_threads
from torch_spatial_workers import model_ranks, resume_ranks, run_ranks

ROOT = Path(__file__).resolve().parents[1]
CLI_TIMEOUT_S = 240
TOL_LOSS = (2e-4, 1e-5)
TOL_AFTER_ADAM = 2e-3


@pytest.fixture(scope="module")
def threads():
    yield from few_torch_threads()


@pytest.fixture(scope="module")
def flood(tmp_path_factory):
    return make_flood_fixture(tmp_path_factory.mktemp("spatial_data"), size=64, n_per_disaster=3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, flood, threads):
    out = str(tmp_path_factory.mktemp("spatial_model"))
    cli_path = str(tmp_path_factory.mktemp("spatial_cli"))
    try:
        yield _runs(flood, out, cli_path)
    finally:  # a .sharded directory of 168 MB
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(cli_path, ignore_errors=True)


def _cli(model, cli_path, meta_dir):
    return _start_cli(f"--model={model}", "--dataset_subset=usa", "--dataset_dem=same", f"--data_path={cli_path}",
                      f"--metadata_dir={meta_dir}", "--topography=all", "--batch_size=2", "--num_spatial_devices=2",
                      "--device=cpu", "--save_model_interval=1", "--num_epochs=1", "--verbose")


def _runs(flood, out, cli_path):
    """The CLI's 1 x 2 runs (PairedAttention and AttentionGAN, each a
    subprocess), the 2 x 2 ``Model`` ranks (a thread's spawn) and the
    one-process ``Model`` (this thread), together; then the AttentionGAN
    directory rewritten by JAX and both resumed on 2 ranks."""
    data_path, meta_dir = flood
    for sub in ("", "/cycle"):
        os.makedirs(cli_path + sub, exist_ok=True)
        for d in ("dataset_input", "dataset_output", "metadata"):
            os.symlink(os.path.join(data_path, d), os.path.join(cli_path + sub, d))
    cli = _cli("PairedAttention", cli_path, meta_dir)
    cycle_cli = _cli("AttentionGAN", cli_path + "/cycle", meta_dir)
    kwargs = dict(model="PairedAttention", dataset_subset="usa", dataset_dem="same", data_path=data_path,
                  num_epochs=2, topography="all", resize=None, metadata_dir=meta_dir, batch_size=2)
    failure = []

    def ranks():
        try:
            run_ranks(model_ranks, 4, args=(out, dict(kwargs, num_data_devices=2, num_spatial_devices=2)))
        except Exception as e:  # re-raised below, on the test's thread
            failure.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        single = Model(device="cpu", **kwargs)
        single.train_paired()
        thread.join()
    finally:
        cli_out = _finish_cli(cli)
        cycle_out = _finish_cli(cycle_cli)
    if failure:
        raise failure[0]
    (cycle_dir,) = glob.glob(f"{cli_path}/cycle/models/*.sharded")
    jax_dir = os.path.join(out, "jax_written.sharded")
    _jax_rewrite(cycle_dir, jax_dir)
    resume_kw = dict(kwargs, model="AttentionGAN", num_epochs=1, num_spatial_devices=2)
    run_ranks(resume_ranks, 2, args=(out, resume_kw, [cycle_dir, jax_dir], FAMILIES))
    return {"single": single, "ranks": [torch.load(os.path.join(out, f"model_rank{r}.pt"), weights_only=False)
                                        for r in range(4)],
            "cli_out": cli_out, "cli_dirs": sorted(glob.glob(f"{cli_path}/models/*.sharded")),
            "cycle_out": cycle_out, "cycle_dir": cycle_dir, "jax_dir": jax_dir,
            "resumed": [torch.load(os.path.join(out, f"resume_rank{r}.pt")) for r in range(2)]}


# Model(num_spatial_devices=2) for the other families, one epoch each.
FAMILIES = {"cyclegan": {"model": "CycleGAN"}, "pix2pix": {"model": "Pix2Pix", "resize": 256}}


def _jax_cycle_template():
    """JAX's image-space AttentionGAN ``CycleState`` at 64^2 as shapes
    (JAX's eager init takes ~25 s here)."""
    import jax
    import jax.numpy as jnp

    from floodgan_tpu.train.cycle import CycleTrainer as JaxCycleTrainer

    zeros = jnp.zeros((1, 64, 64, 9)), jnp.zeros((1, 64, 64, 3))
    jt = JaxCycleTrainer("attentiongan", 9, phase_d=False, phase_gen=False)
    return jax.eval_shape(jt.init, jax.random.key(0), *zeros)


def _jax_rewrite(src: str, dst: str) -> None:
    """The state of the port's ``.sharded`` directory ``src`` written by
    JAX's ``save_checkpoint_sharded`` into ``dst`` (one process: every
    leaf whole)."""
    import jax.numpy as jnp
    from flax import serialization

    from floodgan_tpu.ckpt import save_checkpoint_sharded as jax_save_sharded

    meta, raw = jax_load_sharded(src, _jax_cycle_template())
    state = serialization.to_state_dict(raw)
    jax_save_sharded(dst, meta, _map_leaves(state, jnp.asarray))


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def test_model_on_a_2x2_mesh_matches_one_process(runs):
    single, got = runs["single"], runs["ranks"][0]["all_losses"]
    rtol, atol = TOL_LOSS
    assert set(got) == set(single.all_losses)
    for k, v in single.all_losses.items():
        assert len(got[k]) == len(v) == 2
        np.testing.assert_allclose(got[k][0], v[0], rtol=rtol, atol=atol, err_msg=k)
        # Epoch 2 reads parameters that Adam moved 3 times by about lr x sign(grad).
        np.testing.assert_allclose(got[k][1], v[1], rtol=TOL_AFTER_ADAM, err_msg=k)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _bits(leaf):
    return leaf.bits if isinstance(leaf, BF16Array) else np.asarray(leaf)


def test_the_four_ranks_hold_the_same_state(runs):
    ranks = runs["ranks"]
    assert sorted(r["mesh"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for other in ranks[1:]:
        assert other["all_losses"] == ranks[0]["all_losses"]
        assert other["state"] == ranks[0]["state"]  # a digest of every leaf's bytes
    # Each epoch counts the global batch's samples: 3 steps of 2.
    assert all(r["samples"] == [6, 6] for r in ranks)


def test_a_height_the_shards_cannot_take_raises(runs):
    for r in runs["ranks"]:
        assert "a shard of 20 rows (height 40 over 2 spatial ranks)" in r["refusal"]


def _start_cli(*flags):
    """The training CLI in a subprocess of its own session."""
    cmd = [sys.executable, "-m", "floodgan_tpu_torch.cli.train", *flags]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _finish_cli(proc):
    """The CLI's output; on a timeout the session (the CLI and its ranks) is
    killed and the test fails."""
    try:
        out, _ = proc.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the CLI outlived {CLI_TIMEOUT_S} s")
    assert proc.returncode == 0, out
    return out


def test_cli_trains_on_two_spatial_ranks(runs):
    (d,) = runs["cli_dirs"]
    assert sorted(os.listdir(d)) == ["meta.json", "shards_p0.msgpack", "shards_p1.msgpack"]
    assert runs["cli_out"].count("Beginning training PairedAttention:") == 1  # rank 0 alone prints
    meta, raw = load_checkpoint_sharded(d)
    assert meta["starting_epoch"] == 2 and int(raw["gen_opt"]["count"]) == 3  # 6 samples, global batch 2
    assert all(len(v) == 1 and np.all(np.isfinite(v)) for v in meta["all_losses"].values())


def test_jax_reads_the_sharded_directory_of_a_1x2_run(runs):
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from floodgan_tpu.train.paired import PairedTrainer as JaxPairedTrainer

    (d,) = runs["cli_dirs"]
    want_meta, want = load_checkpoint_sharded(d)
    zeros = jnp.zeros((1, 64, 64, 9)), jnp.zeros((1, 64, 64, 3))
    # The tree's shapes are all the loader needs (JAX's eager init takes ~25 s here).
    template = jax.eval_shape(JaxPairedTrainer("pairedattention", 9, phase_step=False).init, jax.random.key(0), *zeros)
    got_meta, got = jax_load_sharded(d, template)
    assert got_meta == want_meta
    la = dict(_leaves(jax.tree.map(np.asarray, serialization.to_state_dict(got))))
    lb = dict(_leaves(want))
    assert set(la) == set(lb)
    for k in la:
        assert la[k].shape == _bits(lb[k]).shape and la[k].tobytes() == _bits(lb[k]).tobytes(), k


def test_cli_trains_attentiongan_on_two_spatial_ranks(runs):
    d = runs["cycle_dir"]
    assert sorted(os.listdir(d)) == ["meta.json", "shards_p0.msgpack", "shards_p1.msgpack"]
    assert runs["cycle_out"].count("Beginning training AttentionGAN:") == 1
    meta, raw = load_checkpoint_sharded(d)
    assert meta["starting_epoch"] == 2 and int(raw["gen_opt"]["count"]) == 3
    assert all(len(v) == 1 and np.all(np.isfinite(v)) for v in meta["all_losses"].values())
    for key in ("pre_buffer", "post_buffer"):
        assert raw[key]["images"].shape == (50, 64, 64, 9) and int(raw[key]["count"]) == 6


def test_each_spatial_rank_writes_its_buffer_rows_as_a_piece(runs):
    for rank, rows in enumerate(([0, 32], [32, 64])):
        with open(os.path.join(runs["cycle_dir"], f"shards_p{rank}.msgpack"), "rb") as f:
            pieces = _msgpack.unpackb(f.read())
        buffers = {"pre_buffer/images", "post_buffer/images"}
        for key in buffers:
            (piece,) = pieces[key]
            assert piece["index"] == [[0, 50], rows, [0, 64], [0, 9]]
        # The replicated leaves are rank 0's alone.
        assert len(pieces) > 100 if rank == 0 else set(pieces) == buffers


def test_jax_reads_the_sharded_directory_of_a_spatial_cycle_run(runs):
    import jax
    from flax import serialization

    want_meta, want = load_checkpoint_sharded(runs["cycle_dir"])
    got_meta, got = jax_load_sharded(runs["cycle_dir"], _jax_cycle_template())
    assert got_meta == want_meta
    la = dict(_leaves(jax.tree.map(np.asarray, serialization.to_state_dict(got))))
    lb = dict(_leaves(want))
    assert set(la) == set(lb)
    for k in la:
        assert la[k].shape == _bits(lb[k]).shape and la[k].tobytes() == _bits(lb[k]).tobytes(), k


def test_the_port_reads_jaxs_directory_of_the_same_state(runs):
    _, want = load_checkpoint_sharded(runs["cycle_dir"])
    _, got = load_checkpoint_sharded(runs["jax_dir"])
    la, lb = dict(_leaves(got)), dict(_leaves(want))
    assert set(la) == set(lb)
    for k in la:
        assert _bits(la[k]).tobytes() == _bits(lb[k]).tobytes(), k


def _sliced_digests(state, rows):
    """{leaf path: SHA-256} of a whole state as a rank holding ``rows`` of
    each buffered image holds it."""
    import hashlib

    out = {}
    for k, leaf in _leaves(state):
        arr = _bits(leaf)
        if k.endswith("_buffer/images"):
            arr = arr[:, rows[0]:rows[1]]
        out[k] = hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()
    return out


def test_both_directories_resume_bit_for_bit_on_two_spatial_ranks(runs):
    _, state = load_checkpoint_sharded(runs["cycle_dir"])
    for res in runs["resumed"]:
        for resumed in res["resumed"]:  # the port's directory, then JAX's
            s = resumed["mesh"][1]
            assert resumed["rows"] == (32 * s, 32 * (s + 1)) and resumed["starting_epoch"] == 2
            assert resumed["state"] == _sliced_digests(state, resumed["rows"])


# (model, height, spatial size, what the refusal names)
REFUSED = {
    "pix2pix": ("pix2pix", 256, 256, "down0_conv (k4 s2 p1)"),
    "cyclegan": ("cyclegan", 12, 2, "down2 (k3 s2 p1)"),
    "attentiongan": ("attentiongan", 12, 2, "conv3 (k3 s2 p1)"),
    "pairedattention": ("pairedattention", 32, 2, "conv3/conv4 (k4 s1 p1)"),
}


@pytest.mark.parametrize("family", list(REFUSED))
def test_each_family_refuses_a_height_its_shards_cannot_take(family):
    model, height, spatial, layer = REFUSED[family]
    rows = height // spatial
    with pytest.raises(ValueError, match=re.escape(f"a shard of {rows} rows (height {height} over {spatial} "
                                                   f"spatial ranks): {layer}")):
        check_shards(model, (height, 256), spatial)
    check_shards(model, (512, 512), 2)  # bench.py's 512^2 at S = 2: every family takes it


@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_trains_the_family_on_two_spatial_ranks(runs, family):
    a, b = (res["trained"][family] for res in runs["resumed"])
    assert a == b and set(a) == {f"all_{k}" for k in loss_keys(family)}
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in a.values())
