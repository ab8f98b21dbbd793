"""Cross-package resume through the two ``Model`` classes.

JAX's ``Model`` trains PairedAttention on ``nepal-flooding`` (topography
``dem``, 32^2, 2 epochs, a ``.ckpt`` each epoch).  From its epoch-1 file
the port's ``Model`` and JAX's each resume for epoch 2.  Their epoch-2 loss
means agree within 2e-3 relative: the bound tests/test_torch_train.py holds
losses to after an Adam update, where Adam turns rounding into +-lr.  The
port's epoch-2 ``.ckpt`` then loads in JAX's ``Model`` with the same model,
topography, starting epoch and loss history, and its artifact names equal
JAX's apart from the timestamp.

JAX trains with its image-space step (``FLOODGAN_PHASE_STEP=0``), the form
the port computes; its default phase-space step is the same math
(tests/test_train_steps.py) and would double the compile time here.
"""

import glob
import os
import re
import shutil

import numpy as np
import pytest
import torch

from floodgan_tpu.api import Model as JaxModel
from floodgan_tpu_torch.api import Model
from floodgan_tpu_torch.ckpt import load_checkpoint

from fixtures import make_flood_fixture

TOL_AFTER_ADAM = 2e-3
KW = dict(dataset_subset="nepal-flooding", dataset_dem="same", resize=None, crop=None, verbose=False)


def _untimed(path: str) -> str:
    return re.sub(r"_date[0-9-]+\.ckpt$", "", os.path.basename(path))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_root = tmp_path_factory.mktemp("jax")
    data_path, meta_dir = make_flood_fixture(jax_root, size=32, n_per_disaster=3)
    port_path = str(tmp_path_factory.mktemp("port") / "data")
    shutil.copytree(data_path, port_path)  # each package's artifacts in its own models/

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLOODGAN_PHASE_STEP", "0")
        first = JaxModel(model="PairedAttention", data_path=data_path, num_epochs=2, topography="dem",
                         save_model_interval=1, metadata_dir=meta_dir, **KW)
        first.train_paired()
        ckpt1 = glob.glob(f"{data_path}/models/*epoch1*.ckpt")
        assert len(ckpt1) == 1
        resumed_jax = JaxModel(data_path=data_path, load_pretrained_model=True, pretrained_model_path=ckpt1[0],
                               save_model_interval=1, metadata_dir=meta_dir, **KW)
        resumed_jax.train_paired()
    shutil.copy(ckpt1[0], port_path)
    port_ckpt1 = os.path.join(port_path, os.path.basename(ckpt1[0]))
    resumed_port = Model(data_path=port_path, load_pretrained_model=True, pretrained_model_path=port_ckpt1,
                         save_model_interval=1, metadata_dir=os.path.join(port_path, "metadata"), device="cpu", **KW)
    resumed_port.train_paired()
    return {"first": first, "jax": resumed_jax, "port": resumed_port, "data_path": data_path,
            "port_path": port_path, "meta_dir": meta_dir}


def test_port_resumes_a_jax_checkpoint(runs):
    port, first = runs["port"], runs["first"]
    assert (port.model, port.topography, port.num_epochs, port.starting_epoch) == ("pairedattention", "dem", 2, 2)
    for k, v in port.all_losses.items():
        assert len(v) == 2 and v[0] == first.all_losses[k][0], k


@pytest.mark.parametrize("key", ["all_losses_discriminator_real", "all_losses_discriminator_synthetic",
                                 "all_losses_generator_synthetic", "all_l1_losses_generator_synthetic"])
def test_epoch2_losses_after_resuming_agree(runs, key):
    got, want = runs["port"].all_losses[key][1], runs["jax"].all_losses[key][1]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=TOL_AFTER_ADAM)


def test_port_checkpoint_loads_in_jax(runs):
    port_ckpts = glob.glob(f"{runs['port_path']}/models/*epoch2*.ckpt")
    assert len(port_ckpts) == 1
    meta, _ = load_checkpoint(port_ckpts[0])
    back = JaxModel(data_path=runs["data_path"], load_pretrained_model=True, pretrained_model_path=port_ckpts[0],
                    training_model=False, metadata_dir=runs["meta_dir"], **KW)
    assert (back.model, back.topography, back.starting_epoch) == ("pairedattention", "dem", 3)
    assert back.all_losses == runs["port"].all_losses == meta["all_losses"]
    # The restored generator is the port's, bit for bit.
    import jax

    for (path, a), name in zip(jax.tree_util.tree_flatten_with_path(back.state.gen_params["conv1"])[0],
                               ("bias", "weight")):
        t = getattr(runs["port"].trainer.generator.conv1, name).detach().numpy()
        want = t if name == "bias" else np.transpose(t, (2, 3, 1, 0))
        assert np.asarray(a).tobytes() == np.ascontiguousarray(want).tobytes(), path


def test_artifact_names_match_jax(runs):
    jax_names = sorted(_untimed(p) for p in glob.glob(f"{runs['data_path']}/models/*.ckpt"))
    port_names = sorted(_untimed(p) for p in glob.glob(f"{runs['port_path']}/models/*.ckpt"))
    assert port_names == ["PairedAttention_epoch2_demTopography_nepal-floodingData_sameDEM_resizeNone_cropNone"]
    assert port_names[0] in jax_names
    port, jax_model = runs["port"], runs["jax"]
    for save_type, info in (("model", ""), ("figure", "losses"), ("image", "training"), ("metric", "")):
        a, b = port.create_path(save_type, info), jax_model.create_path(save_type, info)
        assert re.sub(r"date[0-9-]+", "", a.replace(runs["port_path"], "")) == \
            re.sub(r"date[0-9-]+", "", b.replace(runs["data_path"], ""))


def test_plots_write_their_artifacts(runs):
    pytest.importorskip("matplotlib")
    port = runs["port"]
    port.plot_losses()
    port.plot_sample_images(num_images=1, use_test_data=False)
    assert glob.glob(f"{runs['port_path']}/figures/PairedAttention_losses_*.png")
    assert glob.glob(f"{runs['port_path']}/images/PairedAttention_validation*.png")


def test_not_ported_paths_name_their_roadmap_items(runs, tmp_path):
    kw = dict(data_path=runs["port_path"], metadata_dir=os.path.join(runs["port_path"], "metadata"),
              device="cpu", **KW)
    for extra, item in ((dict(model="PairedAttention", num_data_devices=2), "item 12"),
                        (dict(model="PairedAttention", remat=True), "item 1"),
                        (dict(model="CycleGAN", remat=True), "item 1")):
        with pytest.raises(NotImplementedError, match=item):
            Model(**extra, **kw)
    from floodgan_tpu_torch.api.segmentation import SegmentationModel

    with pytest.raises(NotImplementedError, match="item 1"):  # calculate_metrics (item 6) is ported
        SegmentationModel(remat=True, skip_data=True, verbose=False, device="cpu")


def test_model_without_device_needs_the_card(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(model="PairedAttention", data_path=runs["port_path"],
              metadata_dir=os.path.join(runs["port_path"], "metadata"), **KW)


def test_sigterm_writes_a_resume_checkpoint(runs, monkeypatch):
    """A SIGTERM (here: its handler raising mid-epoch) saves the epoch
    reached, then re-raises as KeyboardInterrupt."""
    port_path = runs["port_path"]
    m = Model(model="PairedAttention", data_path=port_path, num_epochs=3, topography="dem",
              save_model_interval=5, metadata_dir=os.path.join(port_path, "metadata"), device="cpu",
              **{k: v for k, v in KW.items() if k != "verbose"})
    calls = []

    def step(*a, **k):
        calls.append(1)
        if len(calls) == 3:  # the first step of epoch 2
            import signal

            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return real(*a, **k)

    real = m.trainer.train_step
    monkeypatch.setattr(m.trainer, "train_step", step)
    before = set(glob.glob(f"{port_path}/models/*.ckpt"))
    with pytest.raises(KeyboardInterrupt):
        m.train_paired()
    new = set(glob.glob(f"{port_path}/models/*.ckpt")) - before
    assert len(new) == 1 and "_epoch1_" in new.pop()
