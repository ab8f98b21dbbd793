"""The port's ``.pth.tar`` export (floodgan_tpu_torch/utils/torch_export.py)
and migrate CLI against the JAX package's, on the same JAX ``.ckpt``.

Each ``.ckpt`` is written by the JAX package's ``save_checkpoint`` from a
tree of seeded random arrays (parameters, both Adam moments and a step
count for every network), so nothing in it is zero by chance.  Both
exporters get the port's module names; the two files, ``torch.load``ed,
must hold the same keys in the same order, every tensor bit for bit and
every other value equal.  The port's migration of the export reproduces
the ``.ckpt``'s parameters, moments and counts bit for bit.
"""

import io
import os

import numpy as np
import pytest
import torch

from floodgan_tpu.ckpt import save_checkpoint as jax_save_checkpoint
from floodgan_tpu.utils import torch_export as jax_export
from floodgan_tpu.utils import torch_import as ti
from floodgan_tpu_torch.ckpt import load_checkpoint
from floodgan_tpu_torch.ckpt import migrate
from floodgan_tpu_torch.core.config import model_is_cycle
from floodgan_tpu_torch.models.registry import build_discriminator, build_generator
from floodgan_tpu_torch.models.unet import UNet
from floodgan_tpu_torch.utils import torch_export
from floodgan_tpu_torch.utils.jax_params import jax_tree_from_state_dict
from torch_seg_fixtures import big_tmp, few_torch_threads  # noqa: F401

SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from few_torch_threads()


def _random_tree(module, gen, positive=False):
    sd = {n: torch.randn(p.shape, generator=gen) * 0.05 for n, p in module.named_parameters()}
    if positive:
        sd = {n: t.abs() for n, t in sd.items()}
    return jax_tree_from_state_dict(module, sd)


def _nets(model):
    channels = 9
    gen = build_generator(model, channels)
    disc = build_discriminator(model, channels if model_is_cycle(model) else channels + 3)
    return gen, disc


def _jax_ckpt(path, model, seed):
    """A ``.ckpt`` of ``model`` written by the JAX package; returns its meta."""
    gen_t, disc_t = _nets(model)
    g = torch.Generator().manual_seed(seed)

    def adam(module, keys=None):
        if keys is None:
            return {"mu": _random_tree(module, g), "nu": _random_tree(module, g, positive=True)}
        return {"mu": {k: _random_tree(module, g) for k in keys},
                "nu": {k: _random_tree(module, g, positive=True) for k in keys}}

    if model_is_cycle(model):
        state = {
            "gen_params": {k: _random_tree(gen_t, g) for k in ("ab", "ba")},
            "disc_params": {k: _random_tree(disc_t, g) for k in ("post", "pre")},
            "gen_opt": {"count": np.asarray(7, np.int32), **adam(gen_t, ("ab", "ba"))},
            "disc_opt": {"count": np.asarray(7, np.int32), **adam(disc_t, ("post", "pre"))},
            "pre_buffer": {"count": np.asarray(0, np.int32), "images": np.zeros((50, SIZE, SIZE, 9), np.float32)},
            "post_buffer": {"count": np.asarray(0, np.int32), "images": np.zeros((50, SIZE, SIZE, 9), np.float32)},
        }
    else:
        state = {
            "gen_params": _random_tree(gen_t, g),
            "disc_params": _random_tree(disc_t, g),
            "gen_opt": {"count": np.asarray(5, np.int32), **adam(gen_t)},
            "disc_opt": {"count": np.asarray(5, np.int32), **adam(disc_t)},
        }
    meta = {"model": model, "starting_epoch": 3, "num_epochs": 6, "topography": "all",
            "all_losses": {"all_losses_generator_synthetic": [0.25, 0.125]},
            "add_identity_loss": model_is_cycle(model)}
    jax_save_checkpoint(path, meta, state)
    return meta


def _names(model):
    gen, disc = _nets(model)
    g = [n for n, _ in gen.named_parameters()]
    d = [n for n, _ in disc.named_parameters()]
    if model_is_cycle(model):
        return {"pre_to_post_generator": g, "post_to_pre_generator": g,
                "post_discriminator": d, "pre_discriminator": d}
    return {"generator": g, "discriminator": d}


def _assert_same(got, want, where="file"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{where}[{i}]")
    elif torch.is_tensor(want):
        assert torch.is_tensor(got) and got.dtype == want.dtype and got.shape == want.shape, where
        assert got.numpy().tobytes() == want.numpy().tobytes(), where
    elif isinstance(want, np.ndarray) or hasattr(want, "bits"):
        a, b = (np.asarray(getattr(x, "bits", x)) for x in (got, want))
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), where
    else:
        assert type(got) is type(want) and got == want, where


@pytest.mark.parametrize("model", ["pairedattention", "pix2pix", "cyclegan"])
def test_export_matches_jax_and_migrates_back(big_tmp, model):
    # A Pix2Pix file is 650 MB: the JAX export goes to memory, and each file
    # is removed once read, so that at most two lie on disk at a time.
    tmp_path = big_tmp
    ckpt = str(tmp_path / "m.ckpt")
    meta = _jax_ckpt(ckpt, model, seed=len(model))
    names = _names(model)
    jax_file = io.BytesIO()
    jax_export.export_gan_checkpoint(ckpt, jax_file, names)
    port = str(tmp_path / "port.pth.tar")
    assert torch_export.export_gan_checkpoint(ckpt, port, names) == port
    jax_file.seek(0)
    want = torch.load(jax_file, map_location="cpu", weights_only=True)
    del jax_file
    got = torch.load(port, map_location="cpu", weights_only=True)
    _assert_same(got, want)
    n_g = len(names.get("generator", names.get("pre_to_post_generator")))
    assert len(got["optimizer_generator"]["state"]) == (2 * n_g if model_is_cycle(model) else n_g)
    del want, got

    # The port's migration of the export: the .ckpt's parameters, moments and counts.
    _, raw = load_checkpoint(ckpt)
    os.remove(ckpt)
    back = str(tmp_path / "back.ckpt")
    migrate.migrate_gan(port, back, resize=SIZE)
    os.remove(port)
    meta_back, raw_back = load_checkpoint(back)
    for key in ("gen_params", "disc_params", "gen_opt", "disc_opt"):
        _assert_same(raw_back[key], raw[key], key)
    assert meta_back == meta


def test_state_dict_from_params_length_check_matches_jax():
    gen = build_generator("pairedattention", 9)
    tree = _random_tree(gen, torch.Generator().manual_seed(0))
    names = [n for n, _ in gen.named_parameters()]
    got = torch_export.state_dict_from_params(gen, tree, names)
    want = jax_export.state_dict_from_params(ti.GENERATOR_SPECS["pairedattention"](), tree, names)
    _assert_same(got, want)
    with pytest.raises(ValueError) as e_port:
        torch_export.state_dict_from_params(gen, tree, names[:-1])
    with pytest.raises(ValueError) as e_jax:
        jax_export.state_dict_from_params(ti.GENERATOR_SPECS["pairedattention"](), tree, names[:-1])
    assert str(e_port.value) == str(e_jax.value)


def test_migrate_cli_equals_the_functions(big_tmp):
    tmp_path = big_tmp
    model = "attentiongan"
    ckpt = str(tmp_path / "m.ckpt")
    _jax_ckpt(ckpt, model, seed=5)
    pth = torch_export.export_gan_checkpoint(ckpt, str(tmp_path / "m.pth.tar"), _names(model))
    os.remove(ckpt)
    assert migrate.main(["gan", pth, str(tmp_path / "cli.ckpt"), "--resize", "128", "--crop", "4"]) == str(
        tmp_path / "cli.ckpt")
    migrate.migrate_gan(pth, str(tmp_path / "fn.ckpt"), 128, 4)
    assert (tmp_path / "cli.ckpt").read_bytes() == (tmp_path / "fn.ckpt").read_bytes()
    _, raw = load_checkpoint(str(tmp_path / "cli.ckpt"))
    assert raw["pre_buffer"]["images"].shape == (50, 64, 64, 9)  # 128 / sqrt(4)

    unet = UNet()
    g = torch.Generator().manual_seed(6)
    sd = {n: torch.randn(t.shape, generator=g) if t.is_floating_point() else t
          for n, t in unet.state_dict().items()}
    seg = str(tmp_path / "seg.pth.tar")
    torch.save({"model": sd, "current_epoch": 4, "num_epochs": 9, "all_losses": [0.5, 0.25],
                "all_accuracies": [0.75, 0.875]}, seg)
    migrate.main(["seg", seg, str(tmp_path / "seg_cli.ckpt")])
    migrate.migrate_seg(seg, str(tmp_path / "seg_fn.ckpt"))
    assert (tmp_path / "seg_cli.ckpt").read_bytes() == (tmp_path / "seg_fn.ckpt").read_bytes()
    with pytest.raises(SystemExit):
        migrate.main(["unet", seg, str(tmp_path / "x.ckpt")])
