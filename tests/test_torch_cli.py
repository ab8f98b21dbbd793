"""The port's two CLIs on the CPU, against the JAX package's.

- ``python -m floodgan_tpu_torch.cli.train`` on tests/fixtures.py's 32^2
  dataset with ``--device cpu``: its epochs, one ``.ckpt`` each, the
  verbose lines and a ``--profile_dir`` trace; the checks of
  floodgan_tpu/cli/train.py:46-50.
- ``python -m floodgan_tpu_torch.cli.predict`` against the root
  predict.py on the same checkpoint, read back with
  ``matplotlib.pyplot.imread``.  Each PNG holds exactly the bytes
  matplotlib's ``imsave`` makes of its package's float output (floor of
  x * 255); the two packages' float outputs agree within 1e-5, so the
  pixels are equal except where the two floats straddle a multiple of
  1/255, and there they differ by one level.
- ``--segmentation_model_path`` reads its checkpoint before predicting.
- Without ``--device`` both CLIs need the card.
"""

import contextlib
import glob
import importlib.util
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from floodgan_tpu_torch.cli import predict as cli_predict
from floodgan_tpu_torch.cli import train as cli_train
from floodgan_tpu_torch.utils.png import imsave_rgb, rgba_bytes

from fixtures import make_flood_fixture

ROOT = Path(__file__).resolve().parents[1]
TOL_FORWARD = 1e-5  # the two packages' generator outputs in [0, 1]


def _flags(data_path, meta_dir, *extra):
    return ["--model=PairedAttention", "--dataset_subset=usa", "--dataset_dem=same", f"--data_path={data_path}",
            f"--metadata_dir={meta_dir}", "--topography=all", "--batch_size=2", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    data_path, meta_dir = make_flood_fixture(tmp_path_factory.mktemp("cli"), size=32, n_per_disaster=3)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model = cli_train.main(_flags(data_path, meta_dir, "--num_epochs=2", "--save_model_interval=1",
                                      "--verbose", "--device=cpu", f"--profile_dir={data_path}/profile"))
    return {"model": model, "stdout": out.getvalue(), "data_path": data_path, "meta_dir": meta_dir,
            "ckpts": sorted(glob.glob(f"{data_path}/models/*.ckpt"))}


def test_train_cli_runs_its_epochs_and_checkpoints(trained):
    model = trained["model"]
    assert model.device.type == "cpu" and model.current_epoch == 2
    assert all(len(v) == 2 and np.all(np.isfinite(v)) for v in model.all_losses.values())
    assert [os.path.basename(p).split("_date")[0] for p in trained["ckpts"]] == [
        f"PairedAttention_epoch{e}_allTopography_usaData_sameDEM_resizeNone_cropNone" for e in (1, 2)]
    assert [s["samples"] for s in model.epoch_stats] == [6, 6]
    assert [s["post_cache_hits"] for s in model.epoch_stats] == [0, 3]


def test_train_cli_verbose_lines(trained):
    text = trained["stdout"]
    for line in ("Setting up the PairedAttention model...", "Beginning training PairedAttention:", "2 epochs",
                 "Starting from epoch 1", "All topographical factors will be input to the model",
                 "Dataset: 3 batches of 2 from 'usa' with 'same' DEM", "Model saved every 1 epochs"):
        assert line in text, line
    assert text.count("| Discriminator real loss = ") == 2
    assert text.count("Saving PairedAttention model to ") == 2
    assert "Epoch 1 (" in text and "Epoch 2 (" in text


def test_train_cli_writes_a_profile(trained):
    """The Chrome trace holds the trainer's spans: a train.step range for
    each of the 2 epochs' 3 steps, with its updates."""
    with open(f"{trained['data_path']}/profile/trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    for span in ("train.step", "train.g_forward", "train.d_update", "train.g_update"):
        assert names.count(span) == 6, span


def test_train_cli_resumes_from_its_checkpoint(trained):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        resumed = cli_train.main(_flags(trained["data_path"], trained["meta_dir"], "--load_pretrained_model",
                                        f"--pretrained_model_path={trained['ckpts'][0]}", "--device=cpu",
                                        "--verbose"))
    assert resumed.starting_epoch == 2 and resumed.current_epoch == 2
    assert "Continuing training PairedAttention:" in out.getvalue()
    for k, v in resumed.all_losses.items():
        assert v[0] == trained["model"].all_losses[k][0] and np.isfinite(v[1])


def test_train_cli_checks_the_pretrained_path(trained, tmp_path):
    base = _flags(trained["data_path"], trained["meta_dir"], "--device=cpu", "--load_pretrained_model")
    with pytest.raises(ValueError, match="Provide a saved model"):
        cli_train.main(base)
    with pytest.raises(FileNotFoundError, match="Saved model not found"):
        cli_train.main(base + [f"--pretrained_model_path={tmp_path}/missing.ckpt"])


def _jax_predict_module():
    spec = importlib.util.spec_from_file_location("jax_predict_cli", ROOT / "predict.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _float_outputs(engine_cls, ckpt, inputs, tiff):
    engine = engine_cls.from_checkpoint(ckpt, batch_size=len(inputs), image_size=32, **(
        {"device": "cpu"} if engine_cls.__module__.startswith("floodgan_tpu_torch") else {}))
    stacks = np.stack([np.asarray(tiff.imread(f), np.float32) for f in inputs])
    out = engine.predict(engine.preprocess(stacks, resize=32))
    return np.clip(np.asarray(out.cpu() if torch.is_tensor(out) else out), 0, 1)


def test_predict_cli_pixels_match_jax_predict(trained, tmp_path):
    import matplotlib.pyplot as plt

    from floodgan_tpu.data import tiff as jax_tiff
    from floodgan_tpu.serve import InferenceEngine as JaxEngine
    from floodgan_tpu_torch.data import tiff
    from floodgan_tpu_torch.serve import InferenceEngine

    ckpt = trained["ckpts"][-1]
    inputs = sorted(glob.glob(f"{trained['data_path']}/dataset_input/*_10m.tif"))[:3]
    ours = cli_predict.main(["--pretrained_model_path", ckpt, "--inputs", *inputs, "--output_dir",
                             str(tmp_path / "port"), "--resize", "32", "--batch_size", "2", "--device", "cpu"])
    _jax_predict_module().main(["--pretrained_model_path", ckpt, "--inputs", *inputs, "--output_dir",
                                str(tmp_path / "jax"), "--resize", "32", "--batch_size", "2"])
    assert [os.path.basename(p) for p in ours] == [
        os.path.basename(f)[:-4] + "_prediction.png" for f in inputs]

    want = _float_outputs(JaxEngine, ckpt, inputs, jax_tiff)
    got = _float_outputs(InferenceEngine, ckpt, inputs, tiff)
    np.testing.assert_allclose(got, want, atol=TOL_FORWARD)
    flips = 0
    for k, path in enumerate(ours):
        port_px = plt.imread(path)
        jax_px = plt.imread(str(tmp_path / "jax" / os.path.basename(path)))
        assert port_px.shape == jax_px.shape == (32, 32, 4)
        np.testing.assert_array_equal(port_px, rgba_bytes(got[k]) / np.float32(255))
        np.testing.assert_array_equal(jax_px, rgba_bytes(want[k]) / np.float32(255))
        differ = port_px != jax_px
        straddle = np.floor(got[k] * 255) != np.floor(want[k] * 255)
        assert not (differ[..., :3] & ~straddle).any()
        assert np.abs(port_px - jax_px).max() <= 1 / 255 + 1e-7
        flips += int(differ.sum())
    assert flips <= 0.01 * len(ours) * 32 * 32 * 3


def test_png_writer_matches_matplotlib_imsave(tmp_path, rng):
    import matplotlib.pyplot as plt

    img = rng.random((17, 23, 3), dtype=np.float32)
    img[0, 0] = [0.0, 1.0, 0.5]
    img[1, 1, 2] = np.nan
    img[2, 2] = np.nextafter(np.float32(1 / 255), np.float32(0))
    imsave_rgb(str(tmp_path / "port.png"), img)
    plt.imsave(str(tmp_path / "mpl.png"), img)
    np.testing.assert_array_equal(plt.imread(str(tmp_path / "port.png")), plt.imread(str(tmp_path / "mpl.png")))
    with pytest.raises(ValueError, match="0..1 range"):
        imsave_rgb(str(tmp_path / "bad.png"), img * 2)


def test_predict_cli_segmentation_waits_for_the_eval_slice(trained, tmp_path):
    """The eval slice has landed: ``--segmentation_model_path`` is read
    (tests/test_torch_eval.py holds its masks against predict.py), and a
    missing file raises before any PNG is written."""
    with pytest.raises(FileNotFoundError):
        cli_predict.main(["--pretrained_model_path", trained["ckpts"][-1], "--inputs", "x.tif",
                          "--output_dir", str(tmp_path), "--segmentation_model_path", str(tmp_path / "seg.ckpt"),
                          "--device", "cpu"])
    assert not glob.glob(str(tmp_path / "*.png"))


def test_clis_without_device_need_the_card(trained, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(_flags(trained["data_path"], trained["meta_dir"]))
    inputs = sorted(glob.glob(f"{trained['data_path']}/dataset_input/*_10m.tif"))[:1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_predict.main(["--pretrained_model_path", trained["ckpts"][-1], "--inputs", *inputs,
                          "--output_dir", str(tmp_path)])
