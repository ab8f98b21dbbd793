"""The port's checkpoints against the JAX package's.

- ``ckpt/_msgpack.py`` against the ``msgpack`` package, both ways, bytes
  and values, over every header width, and the flax ext types 1 and 3
  (0-d arrays, numpy scalars) against ``flax.serialization``.
- A JAX ``PairedTrainer`` state at 32^2, before any step (Adam count 0)
  and after one, saved by JAX's ``save_checkpoint``: the port reads it,
  carries it into a port trainer, and its ``generate`` agrees with JAX's
  within 1e-5.  The port writes it back byte for byte, and JAX's
  ``load_checkpoint`` + ``restore_state`` give every array bit for bit.
- The reference ``.pth.tar`` path: JAX's ``export_gan_checkpoint`` writes a
  file; the port's ``maybe_migrate`` and JAX's convert it to equal states.
- ``AsyncCheckpointer``'s snapshot semantics (tests/test_misc.py:110).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from floodgan_tpu.ckpt import load_checkpoint as jax_load_checkpoint
from floodgan_tpu.ckpt import restore_state
from floodgan_tpu.ckpt import save_checkpoint as jax_save_checkpoint
from floodgan_tpu.train.paired import PairedTrainer as JaxPairedTrainer
from floodgan_tpu.utils import migrate as jax_migrate
from floodgan_tpu.utils.torch_export import export_gan_checkpoint
from floodgan_tpu_torch.ckpt import AsyncCheckpointer, _msgpack, checkpoint, load_checkpoint, save_checkpoint
from floodgan_tpu_torch.ckpt import migrate
from floodgan_tpu_torch.models.registry import build_discriminator, build_generator
from floodgan_tpu_torch.train.paired import PairedTrainer
from floodgan_tpu_torch.utils import jax_params

SIZE, CH = 32, 4
META = {"model": "pairedattention", "starting_epoch": 2, "num_epochs": 3, "topography": "dem",
        "all_losses": {"all_losses_discriminator_real": [0.25]}, "add_identity_loss": False}


# ------------------------------------------------------------------ codec

_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63 - 1, 2**64 - 1,
         -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
_VALUES = (
    [None, True, False, 0.0, 1.5, -2.25e300, float("inf")] + _INTS
    + ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000, "e" * 65536]
    + [b"", b"\x00", b"x" * 255, b"y" * 256, b"z" * 65535, b"w" * 65536]
    + [[], list(range(15)), list(range(16)), list(range(70000)), (1, "two", 3.0)]
    + [{}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
       {str(i): [i] for i in range(70000)}, {"a": {"b": [None, {"c": b"d"}]}, 1: 2}]
)


@pytest.mark.parametrize("value", _VALUES, ids=lambda v: f"{type(v).__name__}{len(v) if hasattr(v, '__len__') else v!r:.20}")
def test_codec_matches_msgpack_both_ways(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert _msgpack.packb(value) == want
    decoded = _msgpack.unpackb(want)
    expect = msgpack.unpackb(want, raw=False, strict_map_key=False)
    assert decoded == expect
    assert _msgpack.packb(decoded) == want


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 3, 17, 255, 256, 65535, 65536])
def test_codec_ext_matches_msgpack(n):
    payload = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    want = msgpack.packb([msgpack.ExtType(5, payload), 7], use_bin_type=True)
    assert _msgpack.packb([_msgpack.ExtType(5, payload), 7]) == want
    got = _msgpack.unpackb(want)
    assert got[0].code == 5 and bytes(got[0].data) == payload and got[1] == 7
    hooked = _msgpack.unpackb(want, ext_hook=lambda code, data: (code, bytes(data)))
    assert hooked == [(5, payload), 7]


def test_codec_reads_single_floats_and_rejects_trailing_bytes():
    data = msgpack.packb([1.5, -0.25], use_single_float=True)
    assert data[1] == 0xCA
    assert _msgpack.unpackb(data) == [1.5, -0.25]
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(data + b"\x00")
    with pytest.raises(ValueError, match="ends inside"):
        _msgpack.unpackb(data[:-2])


def test_codec_slices_large_bins_instead_of_copying():
    blob = np.arange(1 << 20, dtype=np.uint8).tobytes()
    data = msgpack.packb({"blob": blob})
    got = _msgpack.unpackb(data)["blob"]
    assert isinstance(got, memoryview) and got.obj is not None and got == blob


def _flax_tree():
    rng = np.random.default_rng(3)
    return {
        "count": np.asarray(7, np.int32),
        "scalar": np.float32(2.5),
        "iscalar": np.int64(-4),
        "w": rng.standard_normal((3, 2, 5)).astype(np.float32),
        "u8": np.arange(6, dtype=np.uint8).reshape(2, 3),
        "f64": rng.standard_normal(4),
        "empty": np.zeros((0, 3), np.float32),
        "nested": {"b": rng.standard_normal(7).astype(np.float32), "a": np.asarray(1.0, np.float32)},
    }


def test_state_bytes_and_values_match_flax():
    tree = _flax_tree()
    want = serialization.msgpack_serialize(tree)
    assert b"".join(bytes(c) for c in checkpoint.serialize_state(tree)) == want
    got = _msgpack.unpackb(want, ext_hook=checkpoint._ext_hook)
    expect = serialization.msgpack_restore(want)
    for k in ("count", "w", "u8", "f64", "empty"):
        assert got[k].dtype == expect[k].dtype and got[k].shape == expect[k].shape, k
        assert got[k].tobytes() == expect[k].tobytes(), k
    assert got["count"].shape == () and isinstance(got["scalar"], np.float32) and got["scalar"] == 2.5
    assert isinstance(got["iscalar"], np.int64) and got["iscalar"] == -4
    assert list(got["nested"]) == list(expect["nested"]) == ["a", "b"]  # sorted, as flax writes


def test_unsupported_leaves_raise(tmp_path):
    """Leaves flax cannot write either: a Python object, a structured or an
    object array, and an ext type that is not a checkpoint type."""
    with pytest.raises(TypeError, match="cannot checkpoint"):
        save_checkpoint(str(tmp_path / "x.ckpt"), {}, {"w": object()})
    for arr in (np.zeros(2, dtype=[("a", np.int32)]), np.array([None, 1], dtype=object)):
        with pytest.raises(ValueError, match="cannot checkpoint an array"):
            checkpoint.serialize_state({"w": arr})
    with pytest.raises(ValueError, match="not a checkpoint type"):
        _msgpack.unpackb(msgpack.packb(msgpack.ExtType(9, b"xy")), ext_hook=checkpoint._ext_hook)


def _bf16_tree():
    rng = np.random.default_rng(5)
    return {"buf": {"images": jnp.asarray(rng.standard_normal((3, 4, 5, 2)), jnp.bfloat16),
                    "count": np.asarray(3, np.int32)},
            "scalar": jnp.asarray(1.5, jnp.bfloat16)}


def test_bf16_leaves_match_flax_both_ways():
    """A bf16 array (a cycle replay buffer under bf16) writes as flax
    writes it, from a ``BF16Array`` or a bf16 tensor, and reads back as a
    ``BF16Array`` of the same bits."""
    tree = _bf16_tree()
    want = serialization.msgpack_serialize(tree)
    bits = {k: np.asarray(v).view(np.uint16) for k, v in (("images", tree["buf"]["images"]),
                                                             ("scalar", tree["scalar"]))}
    as_bf16 = {"buf": {"images": checkpoint.BF16Array(bits["images"]), "count": tree["buf"]["count"]},
               "scalar": checkpoint.BF16Array(bits["scalar"])}
    as_tensor = {"buf": {"images": checkpoint.BF16Array(bits["images"]).to_tensor(), "count": tree["buf"]["count"]},
                 "scalar": checkpoint.BF16Array(bits["scalar"]).to_tensor()}
    for port_tree in (as_bf16, as_tensor):
        assert b"".join(bytes(c) for c in checkpoint.serialize_state(port_tree)) == want
    got = _msgpack.unpackb(want, ext_hook=checkpoint._ext_hook)
    for key, leaf in (("images", got["buf"]["images"]), ("scalar", got["scalar"])):
        assert isinstance(leaf, checkpoint.BF16Array) and leaf.shape == bits[key].shape
        np.testing.assert_array_equal(leaf.bits, bits[key])
    assert torch.equal(got["buf"]["images"].to_tensor().float(),
                       torch.from_numpy(np.asarray(tree["buf"]["images"], np.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_arrays_match_flax_both_ways(monkeypatch, tmp_path, dtype):
    """An array over flax's MAX_CHUNK_SIZE is written as flax's
    ``__msgpack_chunked_array__`` map and read back whole.  The limit is
    patched down to 64 bytes on both sides: a 50-slot f32 buffer at
    1024^2 x 9 channels is 1.89 GB."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(8)
    big = jnp.asarray(rng.standard_normal((5, 3, 7)), dtype)  # 105 elements: 64-byte chunks and a tail
    tree = {"a": {"images": big, "count": np.asarray(2, np.int32)}, "small": np.ones(3, np.float32)}
    want = serialization.msgpack_serialize(tree)
    assert checkpoint.CHUNKED_KEY.encode() in want
    port_big = checkpoint.BF16Array(np.asarray(big).view(np.uint16)) if dtype == "bfloat16" else np.asarray(big)
    port_tree = {"a": {"images": port_big, "count": tree["a"]["count"]}, "small": tree["small"]}
    assert b"".join(bytes(c) for c in checkpoint.serialize_state(port_tree)) == want
    path = str(tmp_path / "chunked.ckpt")
    jax_save_checkpoint(path, META, tree)
    _, raw = load_checkpoint(path)
    leaf = raw["a"]["images"]
    got = leaf.bits if dtype == "bfloat16" else leaf
    assert got.shape == big.shape
    assert got.tobytes() == np.asarray(big).tobytes()
    np.testing.assert_array_equal(raw["small"], tree["small"])
    # ... and flax reads the port's file back whole.
    save_checkpoint(path, META, port_tree)
    _, jraw = jax_load_checkpoint(path)
    assert np.asarray(jraw["a"]["images"]).tobytes() == np.asarray(big).tobytes()


# ------------------------------------------------------- JAX state round trip

def _inputs():
    rng = np.random.default_rng(47)
    return (rng.standard_normal((2, SIZE, SIZE, CH), dtype=np.float32) * 0.3,
            rng.standard_normal((2, SIZE, SIZE, 3), dtype=np.float32) * 0.3)


@pytest.fixture(scope="module")
def jax_states(tmp_path_factory):
    """A JAX PairedState before any step and after one, each saved by JAX."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    x, y = _inputs()
    jt = JaxPairedTrainer("pairedattention", CH, phase_step=False)
    s0 = jt.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
    h0 = jax.device_get(s0)  # the step donates s0
    s1, _ = jt.train_step(s0, jnp.asarray(x), jnp.asarray(y), jnp.float32(2e-4), jax.random.key(1))
    out = {}
    for name, state in (("fresh", h0), ("stepped", jax.device_get(s1))):
        path = str(root / f"{name}.ckpt")
        jax_save_checkpoint(path, META, state)
        want, _ = jt.generate(state.gen_params, jnp.asarray(x), jax.random.key(47))
        out[name] = {"path": path, "state": state, "generate": np.asarray(want)}
    out["x"] = x
    return out


@pytest.mark.parametrize("name", ["fresh", "stepped"])
def test_port_reads_a_jax_checkpoint_into_a_trainer(jax_states, name):
    run = jax_states[name]
    meta, raw = load_checkpoint(run["path"])
    assert meta == META
    t = PairedTrainer("pairedattention", CH, device="cpu", seed=5)
    jax_params.load_paired_state(t, raw)
    out, _ = t.generate(jax_states["x"])
    np.testing.assert_allclose(out.numpy(), run["generate"], atol=1e-5)
    count = int(run["state"].gen_opt.count)
    assert count == (0 if name == "fresh" else 1)
    for module, opt in ((t.generator, t.gen_opt), (t.discriminator, t.disc_opt)):
        if count == 0:
            assert not opt.state
        else:
            for p in module.parameters():
                st = opt.state[p]
                assert st["step"].dtype == torch.float32 and float(st["step"]) == count
                assert st["exp_avg"].shape == p.shape


@pytest.mark.parametrize("name", ["fresh", "stepped"])
def test_port_writes_the_jax_state_back_bit_for_bit(jax_states, name, tmp_path):
    run = jax_states[name]
    _, raw = load_checkpoint(run["path"])
    t = PairedTrainer("pairedattention", CH, device="cpu")
    jax_params.load_paired_state(t, raw)
    path = str(tmp_path / "port.ckpt")
    save_checkpoint(path, META, jax_params.paired_state_to_jax(t))
    with open(path, "rb") as a, open(run["path"], "rb") as b:
        assert a.read() == b.read()  # the same bytes as JAX's own file
    meta, jraw = jax_load_checkpoint(path)
    assert meta == META
    restored = restore_state(run["state"], jraw)
    got, want = jax.tree_util.tree_flatten(restored), jax.tree_util.tree_flatten(run["state"])
    assert got[1] == want[1]
    for a, b in zip(got[0], want[0]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_adam_state_round_trips_through_optax_trees():
    """A port trainer after two steps -> optax tree -> a fresh trainer ->
    optax tree: the same arrays, and count 2."""
    x, y = _inputs()
    t = PairedTrainer("pairedattention", CH, device="cpu", seed=3)
    for _ in range(2):
        t.train_step(x, y, 2e-4)
    tree = jax_params.paired_state_to_jax(t)
    assert int(tree["gen_opt"]["count"]) == 2 and tree["gen_opt"]["count"].dtype == np.int32
    fresh = PairedTrainer("pairedattention", CH, device="cpu", seed=4)
    jax_params.load_paired_state(fresh, tree)
    again = jax_params.paired_state_to_jax(fresh)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                jax.tree_util.tree_flatten_with_path(again)[0]):
        assert pa == pb and a.tobytes() == b.tobytes(), pa
    for p, q in zip(t.generator.parameters(), fresh.generator.parameters()):
        assert torch.equal(t.gen_opt.state[p]["exp_avg_sq"], fresh.gen_opt.state[q]["exp_avg_sq"])


def test_unequal_adam_steps_raise():
    t = PairedTrainer("pairedattention", CH, device="cpu")
    p = next(t.generator.parameters())
    t.gen_opt.state[p] = {"step": torch.tensor(3.0), "exp_avg": torch.zeros_like(p),
                          "exp_avg_sq": torch.zeros_like(p)}
    with pytest.raises(ValueError, match="unequally"):
        jax_params.adam_state_to_jax(t.generator, t.gen_opt)


# ------------------------------------------------------ reference .pth.tar

def test_reference_checkpoint_migrates_like_jax(jax_states, tmp_path):
    names = {"generator": [n for n, _ in build_generator("pairedattention", CH).named_parameters()],
             "discriminator": [n for n, _ in build_discriminator("pairedattention", CH + 3).named_parameters()]}
    ref = str(tmp_path / "ref.pth.tar")
    export_gan_checkpoint(jax_states["stepped"]["path"], ref, names)
    assert migrate.is_torch_checkpoint(ref) and not migrate.is_torch_checkpoint(jax_states["stepped"]["path"])
    assert migrate.maybe_migrate(jax_states["stepped"]["path"]) == jax_states["stepped"]["path"]
    os.makedirs(tmp_path / "jax")
    jax_ref = shutil.copy(ref, tmp_path / "jax" / "ref.pth.tar")

    port_out = migrate.maybe_migrate(ref)
    jax_out = jax_migrate.maybe_migrate(str(jax_ref), "gan")
    assert port_out == ref + ".floodgan.ckpt" and jax_out == str(jax_ref) + ".floodgan.ckpt"
    pm, praw = jax_load_checkpoint(port_out)
    jm, jraw = jax_load_checkpoint(jax_out)
    assert pm == jm
    pl, pt = jax.tree_util.tree_flatten_with_path(praw)
    jl, jt = jax.tree_util.tree_flatten_with_path(jraw)
    assert [p for p, _ in pl] == [p for p, _ in jl]
    for (path, a), (_, b) in zip(pl, jl):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), path
    # ... and equal to the state the reference file was exported from.
    _, src = jax_load_checkpoint(jax_states["stepped"]["path"])
    for key in ("gen_params", "disc_params"):
        for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(praw[key])[0],
                                     jax.tree_util.tree_flatten_with_path(src[key])[0]):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), (key, path)

    stamp = os.path.getmtime(port_out)
    assert migrate.maybe_migrate(ref) == port_out and os.path.getmtime(port_out) == stamp  # reused


def test_migrate_raises_for_cycle_and_segmentation_files(tmp_path):
    """Cycle-family files migrate (tests/test_torch_cycle_ckpt.py holds them
    against JAX's), so a cycle file without its four networks raises for
    the missing one; segmentation files migrate (tests/test_torch_seg.py),
    and a GAN file read as one raises."""
    path = str(tmp_path / "cycle.pth.tar")
    torch.save({"model": "attentiongan", "topography": "dem"}, path)
    with pytest.raises(KeyError, match="pre_to_post_generator"):
        migrate.maybe_migrate(path)
    with pytest.raises(ValueError, match="no segmentation U-Net state dict"):
        migrate.maybe_migrate(path, kind="seg")


# -------------------------------------------------------- async checkpoints

def test_async_checkpointer_snapshots_on_the_callers_thread(tmp_path):
    w = torch.arange(12.0).reshape(3, 4)
    state = {"w": w, "b": np.ones(4, np.float32)}
    meta = {"model": "pairedattention", "starting_epoch": 3, "all_losses": {"a": [1.0]}}

    sync_path = str(tmp_path / "sync.ckpt")
    save_checkpoint(sync_path, meta, state)
    ck = AsyncCheckpointer()
    async_path = str(tmp_path / "async.ckpt")
    ck.save(async_path, meta, state)
    # Changes after save() reach neither the file's state nor its meta.
    w.add_(100.0)
    state["b"][:] = 0
    meta["all_losses"]["a"].append(2.0)
    ck.wait()
    m1, s1 = load_checkpoint(sync_path)
    m2, s2 = load_checkpoint(async_path)
    assert m1 == m2 and m2["all_losses"]["a"] == [1.0]
    np.testing.assert_array_equal(s2["w"], np.arange(12.0, dtype=np.float32).reshape(3, 4))
    np.testing.assert_array_equal(s1["b"], s2["b"])
    ck.save(async_path, meta, state)
    ck.wait()
    ck.wait()
    assert load_checkpoint(async_path)[0]["all_losses"]["a"] == [1.0, 2.0]
    ck.close()
    assert not os.path.exists(async_path + ".tmp")


def test_load_rejects_a_file_that_is_not_a_checkpoint(tmp_path):
    path = str(tmp_path / "x.ckpt")
    with open(path, "wb") as f:
        f.write(msgpack.packb({"weights": json.dumps({})}))
    with pytest.raises(ValueError, match="not a floodgan checkpoint"):
        load_checkpoint(path)
