"""The cycle family's checkpoints against the JAX package's, and resumes.

- A JAX ``CycleState`` (AttentionGAN, topography "dem", 32^2), fresh and
  with filled Adam moments and buffers, saved by JAX: the port reads it
  into a ``CycleTrainer`` (its ``generate`` within 1e-5 of JAX's, the
  buffers and counts exactly) and writes it back byte for byte.  The same
  with bf16 buffers (``compute_dtype="bfloat16"``), and with buffers in the
  2x2 phase layout that JAX writes under ``FLOODGAN_CYCLE_PHASE_D``: the
  port depth-to-spaces them, writes image layout, and JAX's own loader
  (``_adapt_cycle_buffer_layout``, as its ``Model`` runs it) restores the
  original phase state bit for bit.
- A reference cycle ``.pth.tar`` (JAX's ``export_gan_checkpoint``) migrates
  to the same bytes in both packages.
- ``InferenceEngine.from_checkpoint`` serves both cycle families.
- Resume: two epochs against one, a resume from its ``.ckpt`` and one more,
  bit for bit, for CycleGAN (buffers of 2 slots, so that they fill and
  swap) and Pix2Pix (dropout on): the per-step draws depend on (seed,
  epoch, step) alone.
"""

import glob
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from floodgan_tpu.api.model import _adapt_cycle_buffer_layout
from floodgan_tpu.ckpt import load_checkpoint as jax_load_checkpoint
from floodgan_tpu.ckpt import restore_state
from floodgan_tpu.ckpt import save_checkpoint as jax_save_checkpoint
from floodgan_tpu.ops.nn_ops import depth_to_space_phases
from floodgan_tpu.train.cycle import CycleTrainer as JaxCycleTrainer
from floodgan_tpu.train.cycle import ImageBuffer as JaxImageBuffer
from floodgan_tpu.utils import migrate as jax_migrate
from floodgan_tpu.utils.torch_export import export_gan_checkpoint
from floodgan_tpu_torch.api.model import Model
from floodgan_tpu_torch.ckpt import BF16Array, load_checkpoint, migrate, save_checkpoint
from floodgan_tpu_torch.core.config import TrainConfig
from floodgan_tpu_torch.data.transforms import denormalize
from floodgan_tpu_torch.serve import InferenceEngine
from floodgan_tpu_torch.train.cycle import CycleTrainer
from floodgan_tpu_torch.utils.jax_params import cycle_state_to_jax, load_cycle_state, paired_state_to_jax

from fixtures import make_flood_fixture
from torch_seg_fixtures import big_tmp, few_torch_threads  # noqa: F401

SIZE, CH, CAP = 32, 4, 50
META = {"model": "attentiongan", "starting_epoch": 2, "num_epochs": 3, "topography": "dem",
        "all_losses": {"all_losses_generator_post": [0.5]}, "add_identity_loss": False}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    yield from few_torch_threads()


def _inputs():
    rng = np.random.default_rng(47)
    return (rng.standard_normal((2, SIZE, SIZE, CH), dtype=np.float32) * 0.3,
            rng.standard_normal((2, SIZE, SIZE, 3), dtype=np.float32) * 0.3)


def _filled(buffer, rng, count):
    images = rng.standard_normal(buffer.images.shape).astype(np.float32)
    images[count:] = 0
    return JaxImageBuffer(images=jnp.asarray(images, buffer.images.dtype), count=jnp.int32(count))


@pytest.fixture(scope="module")
def jax_states(tmp_path_factory):
    """JAX CycleStates saved by JAX: ``fresh`` (the init), ``stepped`` (Adam
    count 3, drawn moments, buffers of 5 and 50 images), ``bf16`` (bf16
    buffers) and ``phase`` (buffers in the 2x2 phase layout)."""
    root = tmp_path_factory.mktemp("cycle_ckpt")
    x, y = _inputs()
    jt = JaxCycleTrainer("attentiongan", CH, phase_d=False, phase_gen=False)
    fresh = jax.device_get(jt.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(y)))
    rng = np.random.default_rng(3)
    draw = lambda t: jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-3, t)
    stepped = fresh.replace(
        gen_opt=fresh.gen_opt._replace(count=np.int32(3), mu=draw(fresh.gen_opt.mu), nu=draw(fresh.gen_opt.nu)),
        disc_opt=fresh.disc_opt._replace(count=np.int32(3), mu=draw(fresh.disc_opt.mu), nu=draw(fresh.disc_opt.nu)),
        pre_buffer=_filled(fresh.pre_buffer, rng, 5), post_buffer=_filled(fresh.post_buffer, rng, CAP),
    )
    bf16_template = JaxImageBuffer.create(CAP, SIZE, SIZE, CH, jnp.bfloat16)
    phase_template = JaxImageBuffer.create(CAP, SIZE // 2, SIZE // 2, 4 * CH)
    states = {
        "fresh": fresh, "stepped": stepped,
        "bf16": stepped.replace(pre_buffer=_filled(bf16_template, rng, 7), post_buffer=_filled(bf16_template, rng, CAP)),
        "phase": stepped.replace(pre_buffer=_filled(phase_template, rng, 9), post_buffer=_filled(phase_template, rng, 2)),
    }
    out = {"x": x}
    for name, state in states.items():
        state = jax.device_get(state)
        path = str(root / f"{name}.ckpt")
        jax_save_checkpoint(path, META, state)
        gen = np.asarray(jt.generator.apply({"params": state.gen_params["ab"]}, jnp.asarray(x))[0])
        out[name] = {"path": path, "state": state, "generate": gen}
    yield out
    shutil.rmtree(root, ignore_errors=True)


def _port_trainer(name):
    return CycleTrainer("attentiongan", CH, (SIZE, SIZE), compute_dtype="bfloat16" if name == "bf16" else "float32",
                        device="cpu", seed=5)


def _buffer_nhwc(buffer):
    return buffer.images.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("name", ["fresh", "stepped", "bf16", "phase"])
def test_port_reads_a_jax_cycle_checkpoint(jax_states, name):
    run = jax_states[name]
    meta, raw = load_checkpoint(run["path"])
    assert meta == META
    t = _port_trainer(name)
    load_cycle_state(t, raw)
    out, mask = t.generate(jax_states["x"])
    np.testing.assert_allclose(out.numpy(), run["generate"], atol=1e-5)
    assert mask.shape == (2, SIZE, SIZE)
    count = int(run["state"].gen_opt.count)
    for opt in (t.gen_opt, t.disc_opt):
        assert (not opt.state) if count == 0 else all(float(s["step"]) == count for s in opt.state.values())
    for key in ("pre_buffer", "post_buffer"):
        want = run["state"].__getattribute__(key)
        images = np.asarray(want.images.astype(jnp.float32))
        if name == "phase":  # (cap, H/2, W/2, 4C) -> (cap, H, W, C), JAX's own inverse
            images = np.asarray(depth_to_space_phases(jnp.asarray(images), SIZE, SIZE, CH))
        assert getattr(t, key).count == int(want.count)
        assert getattr(t, key).images.dtype == (torch.bfloat16 if name == "bf16" else torch.float32)
        np.testing.assert_array_equal(_buffer_nhwc(getattr(t, key)), images)


@pytest.mark.parametrize("name", ["fresh", "stepped", "bf16"])
def test_port_writes_the_jax_cycle_state_back_bit_for_bit(jax_states, name, big_tmp):
    run = jax_states[name]
    _, raw = load_checkpoint(run["path"])
    t = _port_trainer(name)
    load_cycle_state(t, raw)
    path = str(big_tmp / "port.ckpt")
    tree = cycle_state_to_jax(t)
    assert isinstance(tree["pre_buffer"]["images"], BF16Array) == (name == "bf16")
    save_checkpoint(path, META, tree)
    with open(path, "rb") as a, open(run["path"], "rb") as b:
        assert a.read() == b.read()  # the same bytes as JAX's own file


def test_jax_loads_the_ports_image_layout_into_a_phase_run(jax_states, big_tmp):
    """The port writes image-layout buffers; JAX's Model, running its phase
    layout, converts them back on load (floodgan_tpu/api/model.py:52-82):
    every leaf of the original phase state, bit for bit."""
    run = jax_states["phase"]
    _, raw = load_checkpoint(run["path"])
    t = _port_trainer("phase")
    load_cycle_state(t, raw)
    path = str(big_tmp / "port.ckpt")
    save_checkpoint(path, META, cycle_state_to_jax(t))
    _, jraw = jax_load_checkpoint(path)
    assert jraw["pre_buffer"]["images"].shape == (CAP, SIZE, SIZE, CH)
    restored = restore_state(run["state"], _adapt_cycle_buffer_layout(run["state"], jraw))
    got, want = jax.tree_util.tree_flatten(restored), jax.tree_util.tree_flatten(run["state"])
    assert got[1] == want[1]
    for a, b in zip(got[0], want[0]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_reference_cycle_checkpoint_migrates_like_jax(jax_states, big_tmp):
    """The generator groups ab then ba, the D groups post then pre; empty
    f32 buffers sized by --resize."""
    t = _port_trainer("stepped")
    names = {"pre_to_post_generator": [n for n, _ in t.gen_ab.named_parameters()],
             "post_to_pre_generator": [n for n, _ in t.gen_ba.named_parameters()],
             "post_discriminator": [n for n, _ in t.disc_post.named_parameters()],
             "pre_discriminator": [n for n, _ in t.disc_pre.named_parameters()]}
    ref = str(big_tmp / "ref.pth.tar")
    export_gan_checkpoint(jax_states["stepped"]["path"], ref, names)
    os.makedirs(big_tmp / "jax")
    jax_ref = shutil.copy(ref, big_tmp / "jax" / "ref.pth.tar")
    port_out = migrate.maybe_migrate(ref, resize=SIZE)
    jax_out = jax_migrate.maybe_migrate(str(jax_ref), "gan", resize=SIZE)
    with open(port_out, "rb") as a, open(jax_out, "rb") as b:
        assert a.read() == b.read()
    _, praw = jax_load_checkpoint(port_out)
    _, src = jax_load_checkpoint(jax_states["stepped"]["path"])
    for key in ("gen_params", "disc_params"):
        for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(praw[key])[0],
                                     jax.tree_util.tree_flatten_with_path(src[key])[0]):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), (key, path)
    assert int(praw["gen_opt"]["count"]) == 3 and int(praw["pre_buffer"]["count"]) == 0
    assert praw["pre_buffer"]["images"].shape == (CAP, SIZE, SIZE, CH)


@pytest.mark.parametrize("model", ["cyclegan", "attentiongan"])
def test_engine_serves_cycle_checkpoints(model, big_tmp):
    x, _ = _inputs()
    t = CycleTrainer(model, CH, (SIZE, SIZE), device="cpu", seed=8)
    path = str(big_tmp / f"{model}.ckpt")
    save_checkpoint(path, dict(META, model=model), cycle_state_to_jax(t))
    engine = InferenceEngine.from_checkpoint(path, batch_size=2, image_size=SIZE, device="cpu", aot=False)
    got = engine.predict(torch.from_numpy(x))
    want = denormalize(t.generate(x, "ab")[0])
    assert got.shape == (2, SIZE, SIZE, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------------- resume

def _state_bytes(model):
    state = (cycle_state_to_jax if model.model_is_cycle else paired_state_to_jax)(model.trainer)
    flat = []

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}", node[k])
        else:
            flat.append((prefix, np.asarray(node).tobytes()))

    walk("", state)
    return flat


@pytest.mark.parametrize("family,size", [("CycleGAN", 32), ("Pix2Pix", 256)])
def test_resume_reproduces_an_unbroken_run(big_tmp, family, size):
    """Two epochs straight, against one epoch, a resume from its .ckpt and
    the second epoch: the same parameters, Adam moments, buffers and loss
    history, bit for bit."""
    data, meta = make_flood_fixture(big_tmp, size=size, n_per_disaster=3)
    kw = dict(dataset_subset="usa", dataset_dem="same", data_path=data, metadata_dir=meta, topography="all",
              resize=None, batch_size=2, add_identity_loss=True, verbose=False, device="cpu",
              train_cfg=TrainConfig(buffer_size=2))
    straight = Model(model=family, num_epochs=2, save_model_interval=1, **kw)
    straight.train_cycle() if straight.model_is_cycle else straight.train_paired()
    want = _state_bytes(straight)
    (first,) = glob.glob(os.path.join(data, "models", f"{family}_epoch1_*.ckpt"))
    resumed = Model(load_pretrained_model=True, pretrained_model_path=first, save_model_interval=0, **kw)
    assert resumed.starting_epoch == 2 and len(resumed.all_losses[next(iter(resumed.all_losses))]) == 1
    resumed.train_cycle() if resumed.model_is_cycle else resumed.train_paired()
    assert resumed.all_losses == straight.all_losses
    got = _state_bytes(resumed)
    assert [k for k, _ in got] == [k for k, _ in want]
    differ = [k for (k, a), (_, b) in zip(got, want) if a != b]
    assert not differ, differ[:5]
    if family == "CycleGAN":
        assert straight.trainer.pre_buffer.count == 2  # the buffers filled and swapped
