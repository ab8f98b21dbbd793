"""The port's per-process checkpoint directories (``ckpt/sharded.py``)
against the JAX package's (floodgan_tpu/ckpt/sharded.py), on the CPU.

- A trainer's state (PairedAttention f32, AttentionGAN with bf16 buffers)
  round-trips bit for bit, written as one rank of two.
- JAX's directory of a mixed tree (replicated leaves, a leaf sharded over
  the conftest's 8-device (data, spatial) mesh, a host scalar) reads in
  the port piece by piece; a JAX ``PairedTrainer`` state's directory
  loads into the port's trainer; the port's directory of a port trainer
  loads in JAX's loader onto a JAX state.  Every leaf bit for bit.
- A missing shard file or a duplicated one raises; shard files of a larger
  topology are ignored by the loader and removed by the next save.
- ``python -m floodgan_tpu_torch.cli.train --num_data_devices 2 --device
  cpu`` (2 gloo ranks, PairedAttention at 32^2, global batch 2) writes a
  ``.sharded`` directory each epoch; a 2-rank resume from the epoch-1
  directory writes an epoch-2 directory equal bit for bit to the unbroken
  run's (state and loss history), which a one-process ``Model`` resumes
  too.  Each CLI run is a subprocess in its own session, killed with its
  ranks if it outlives its timeout.
"""

import glob
import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from floodgan_tpu.ckpt import load_checkpoint_sharded as jax_load_sharded
from floodgan_tpu.ckpt import save_checkpoint_sharded as jax_save_sharded
from floodgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from floodgan_tpu.train.paired import PairedTrainer as JaxPairedTrainer
from floodgan_tpu_torch.api.model import Model
from floodgan_tpu_torch.ckpt import BF16Array
from floodgan_tpu_torch.ckpt.sharded import load_checkpoint_sharded, save_checkpoint_sharded
from floodgan_tpu_torch.train.cycle import CycleTrainer
from floodgan_tpu_torch.train.paired import PairedTrainer
from floodgan_tpu_torch.utils.jax_params import (
    cycle_state_to_jax,
    load_paired_state,
    paired_state_to_jax,
    state_dict_from_jax,
)

from fixtures import make_flood_fixture

ROOT = Path(__file__).resolve().parents[1]
CLI_TIMEOUT_S = 240
META = {"model": "pairedattention", "starting_epoch": 2}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _bits(leaf):
    if isinstance(leaf, BF16Array):
        return leaf.bits
    return np.asarray(leaf)


def _assert_same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert set(la) == set(lb)
    for k in la:
        x, y = _bits(la[k]), _bits(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), k


# ------------------------------------------------------------ the format

@pytest.mark.parametrize("model", ["pairedattention", "attentiongan"])
def test_round_trip_bit_for_bit(tmp_path, model):
    r = np.random.default_rng(6)
    x, y = r.standard_normal((2, 32, 32, 9), dtype=np.float32), r.standard_normal((2, 32, 32, 3), dtype=np.float32)
    if model == "pairedattention":
        t = PairedTrainer(model, 9, device="cpu", seed=3)
        t.train_step(x, y, 2e-4)
        state = paired_state_to_jax(t)
    else:
        t = CycleTrainer(model, 9, (32, 32), compute_dtype="bfloat16", device="cpu", seed=3)
        t.train_step(x, y, 2e-4)
        state = cycle_state_to_jax(t)
        assert isinstance(state["pre_buffer"]["images"], BF16Array)
    d = str(tmp_path / "m.sharded")
    for rank in (1, 0):
        save_checkpoint_sharded(d, META, state, rank, 2)
    assert sorted(os.listdir(d)) == ["meta.json", "shards_p0.msgpack", "shards_p1.msgpack"]
    assert os.path.getsize(os.path.join(d, "shards_p1.msgpack")) == 1  # an empty map: rank 0 holds replica 0
    meta, got = load_checkpoint_sharded(d)
    assert meta == META
    _assert_same_tree(got, state)


def test_jax_mixed_tree_reads_in_the_port(tmp_path):
    mesh = jax_make_mesh(8, spatial=2)
    rep, shard = NamedSharding(mesh, P()), NamedSharding(mesh, P("data", "spatial"))
    state = {"params": {"w": jax.device_put(jnp.arange(12.0).reshape(3, 4), rep),
                        "b": jax.device_put(jnp.ones((4,)), rep)},
             "buffer": jax.device_put(jnp.arange(40, dtype=jnp.float32).reshape(4, 2, 5), shard),
             "step": np.int64(7)}
    jax_save_sharded(str(tmp_path), META, state)
    meta, got = load_checkpoint_sharded(str(tmp_path))
    assert meta == META
    _assert_same_tree(got, jax.tree.map(np.asarray, state))


@pytest.fixture(scope="module")
def jax_paired():
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 9)).astype(np.float32)
    y = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    jt = JaxPairedTrainer("pairedattention", 9, phase_step=False)
    s0 = jt.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
    return jt, s0


def test_jax_trainer_directory_loads_into_the_port(tmp_path, jax_paired):
    _, s0 = jax_paired
    jax_save_sharded(str(tmp_path), META, s0)
    meta, raw = load_checkpoint_sharded(str(tmp_path))
    t = PairedTrainer("pairedattention", 9, device="cpu")
    load_paired_state(t, raw)
    want = state_dict_from_jax(t.generator, jax.tree.map(np.asarray, s0.gen_params))
    assert all(torch.equal(p, want[n]) for n, p in t.generator.named_parameters())
    from flax import serialization

    _assert_same_tree(paired_state_to_jax(t), jax.tree.map(np.asarray, serialization.to_state_dict(s0)))


def test_port_directory_loads_in_jax(tmp_path, jax_paired):
    _, s0 = jax_paired
    t = PairedTrainer("pairedattention", 9, device="cpu", seed=9)
    state = paired_state_to_jax(t)
    for rank in (0, 1):
        save_checkpoint_sharded(str(tmp_path), META, state, rank, 2)
    meta, restored = jax_load_sharded(str(tmp_path), s0)
    assert meta == META
    assert jax.tree.structure(restored) == jax.tree.structure(s0)
    from flax import serialization

    _assert_same_tree(jax.tree.map(np.asarray, serialization.to_state_dict(restored)), state)


def test_missing_or_duplicated_shard_raises(tmp_path):
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "count": np.asarray(3, np.int32)}
    d = str(tmp_path)
    for rank in (0, 1):
        save_checkpoint_sharded(d, META, state, rank, 2)
    shutil.copy(os.path.join(d, "shards_p0.msgpack"), os.path.join(d, "shards_p1.msgpack"))
    with pytest.raises(ValueError, match="does not exactly cover leaf"):
        load_checkpoint_sharded(d)
    os.remove(os.path.join(d, "shards_p0.msgpack"))
    os.remove(os.path.join(d, "shards_p1.msgpack"))
    with pytest.raises(ValueError, match="does not exactly cover leaf 'w': 0/6"):
        load_checkpoint_sharded(d)


def test_stale_shards_are_ignored_and_cleaned(tmp_path):
    d = str(tmp_path)
    old = {"w": np.full((2, 3), 9.0, np.float32)}
    for rank in range(4):
        save_checkpoint_sharded(d, META, old, rank, 4)
    shutil.copy(os.path.join(d, "shards_p0.msgpack"), os.path.join(d, "shards_p3.msgpack"))
    new = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    save_checkpoint_sharded(d, META, new, 1, 2)
    # Before process 0's save lands, the old header still names 4 processes: p3's stale piece duplicates p0's.
    with pytest.raises(ValueError, match="does not exactly cover"):
        load_checkpoint_sharded(d)
    save_checkpoint_sharded(d, META, new, 0, 2)
    assert sorted(os.listdir(d)) == ["meta.json", "shards_p0.msgpack", "shards_p1.msgpack"]
    shutil.copy(os.path.join(d, "shards_p0.msgpack"), os.path.join(d, "shards_p2.msgpack"))
    _, got = load_checkpoint_sharded(d)  # p2 lies beyond the recorded 2 processes
    _assert_same_tree(got, new)
    assert json.load(open(os.path.join(d, "meta.json")))["process_count"] == 2


# ------------------------------------------------------------ 2 ranks

def _cli(*flags):
    """The training CLI in a subprocess of its own session; on a timeout
    the session (the CLI and its ranks) is killed and the test fails."""
    cmd = [sys.executable, "-m", "floodgan_tpu_torch.cli.train", *flags]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{' '.join(flags)} outlived {CLI_TIMEOUT_S} s")
    assert proc.returncode == 0, out
    return out


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    data_path, meta_dir = make_flood_fixture(tmp_path_factory.mktemp("dp_ckpt"), size=32, n_per_disaster=3)
    flags = ["--model=PairedAttention", "--dataset_subset=usa", "--dataset_dem=same", f"--data_path={data_path}",
             f"--metadata_dir={meta_dir}", "--topography=all", "--batch_size=2", "--num_data_devices=2",
             "--device=cpu", "--save_model_interval=1", "--num_epochs=2", "--verbose"]
    out = _cli(*flags)
    first = sorted(glob.glob(f"{data_path}/models/*.sharded"))
    resumed = str(tmp_path_factory.mktemp("resumed"))
    for d in ("dataset_input", "dataset_output", "metadata"):
        os.symlink(os.path.join(data_path, d), os.path.join(resumed, d))
    out2 = _cli(*[f for f in flags if not f.startswith("--data_path")], f"--data_path={resumed}",
                "--load_pretrained_model", f"--pretrained_model_path={first[0]}")
    return {"first": first, "resumed": sorted(glob.glob(f"{resumed}/models/*.sharded")), "out": out, "out2": out2,
            "data_path": data_path, "meta_dir": meta_dir}


def test_two_ranks_write_a_sharded_directory_each_epoch(two_rank_runs):
    first = two_rank_runs["first"]
    assert [os.path.basename(p).split("_date")[0] for p in first] == [
        f"PairedAttention_epoch{e}_allTopography_usaData_sameDEM_resizeNone_cropNone" for e in (1, 2)]
    for d in first:
        assert sorted(os.listdir(d)) == ["meta.json", "shards_p0.msgpack", "shards_p1.msgpack"]
    meta, raw = load_checkpoint_sharded(first[-1])
    assert meta["starting_epoch"] == 3 and int(raw["gen_opt"]["count"]) == 2 * 3  # 6 samples, global batch 2
    assert all(len(v) == 2 and np.all(np.isfinite(v)) for v in meta["all_losses"].values())
    # Rank 0 alone prints.
    assert two_rank_runs["out"].count("Beginning training PairedAttention:") == 1
    assert two_rank_runs["out"].count("Saving PairedAttention model to ") == 2


def test_two_rank_resume_is_bit_for_bit(two_rank_runs):
    (resumed,) = two_rank_runs["resumed"]
    assert "Continuing training PairedAttention:" in two_rank_runs["out2"]
    want_meta, want = load_checkpoint_sharded(two_rank_runs["first"][-1])
    got_meta, got = load_checkpoint_sharded(resumed)
    assert got_meta == want_meta
    _assert_same_tree(got, want)


def test_one_process_model_resumes_a_sharded_directory(two_rank_runs):
    m = Model(load_pretrained_model=True, pretrained_model_path=two_rank_runs["first"][0],
              dataset_subset="usa", dataset_dem="same", data_path=two_rank_runs["data_path"],
              metadata_dir=two_rank_runs["meta_dir"], batch_size=2, device="cpu")
    assert m.starting_epoch == 2 and m.mesh is None
    _, raw = load_checkpoint_sharded(two_rank_runs["first"][0])
    _assert_same_tree(paired_state_to_jax(m.trainer), raw)
