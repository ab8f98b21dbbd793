"""The port's evaluation path against the JAX package's, on the CPU.

- The metric suite: PSNR, SSIM and MS-SSIM within 1e-5 of JAX's; the
  port's MS-SSIM within 2e-5 of tests/test_metrics.py's float64 goldens
  and <= 1; confusion counts and ``MaskMetricsAccumulator.compute``
  exactly.
- LPIPS: ``fallback_weights`` bit for bit, the metric on them within 1e-5,
  and ``load_lpips``'s search order.
- ``make_eval_batch_metrics`` and its ``true_mask`` / ``with_true_mask``
  attributes against JAX's on the same U-Net weights.
- ``python -m floodgan_tpu_torch.cli.evaluate --calculate_metrics`` (and so
  ``Model.calculate_metrics``) against JAX's evaluate CLI on
  tests/fixtures.py's flood fixture: every CSV cell but ``Inference``;
  ``--plot_single_image`` pixel for pixel.
- ``python -m floodgan_tpu_torch.cli.predict --segmentation_model_path``
  against the root predict.py: the flood-mask PNGs pixel for pixel.
- The gray-colormap PNG writer against ``plt.imsave``.

Masks and confusion counts are compared exactly where no logit lies within
1e-4 of the threshold; the U-Net's last conv is scaled so that none does
(``sharpened_seg_checkpoint``), and each test checks it.
"""

import contextlib
import csv
import glob
import importlib.util
import io
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu.cli import evaluate as jax_evaluate
from floodgan_tpu.eval import lpips as jax_lpips
from floodgan_tpu.eval import metrics as jax_metrics
from floodgan_tpu.train.seg import SegTrainer as JaxSegTrainer
from floodgan_tpu_torch.api.model import METRIC_COLUMNS, Model
from floodgan_tpu_torch.api.segmentation import SegmentationModel
from floodgan_tpu_torch.cli import evaluate as cli_evaluate
from floodgan_tpu_torch.cli import predict as cli_predict
from floodgan_tpu_torch.data.transforms import denormalize
from floodgan_tpu_torch.eval import lpips, metrics
from floodgan_tpu_torch.utils import jax_params
from floodgan_tpu_torch.utils.png import gray_rgba_bytes, imsave_gray

from fixtures import make_flood_fixture
from test_metrics import _MS_SSIM_GOLDENS, _ms_ssim_golden_cases
from torch_seg_fixtures import few_torch_threads, jax_unet_params, loaded_jax_seg_init, port_seg_trainer, sharpened_seg_checkpoint

ROOT = Path(__file__).resolve().parents[1]
TOL_METRIC = 1e-5      # PSNR (relative), SSIM, MS-SSIM, LPIPS (absolute)
TOL_GOLDEN = 2e-5      # MS-SSIM against the float64 goldens
NEAR_THRESHOLD = 1e-4  # |logit| within which the two frameworks may split
IMAGE = "hurricane-harvey_00000000"  # a validation image of the flood fixture


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    yield from few_torch_threads()


# ------------------------------------------------------------ metric suite

@pytest.mark.parametrize("size,with_ms_ssim", [(192, True), (40, False)])
def test_image_metrics_match_jax(rng, size, with_ms_ssim):
    x = rng.random((2, size, size, 3), dtype=np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), -0.05, 1.05).astype(np.float32)  # clamped inside
    want = jax.device_get(jax_metrics.image_pair_metrics(jnp.asarray(x), jnp.asarray(y), with_ms_ssim=with_ms_ssim))
    got = metrics.image_pair_metrics(_t(x), _t(y), with_ms_ssim=with_ms_ssim)
    assert set(got) == set(want) == {"PSNR", "SSIM"} | ({"MS-SSIM"} if with_ms_ssim else set())
    np.testing.assert_allclose(got["PSNR"].numpy(), want["PSNR"], rtol=TOL_METRIC)
    for k in set(got) - {"PSNR"}:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=TOL_METRIC, err_msg=k)
    np.testing.assert_allclose(metrics.psnr(_t(x), _t(x.clip(0, 1) * 0.5)).numpy(),
                               np.asarray(jax_metrics.psnr(jnp.asarray(x), jnp.asarray(x.clip(0, 1) * 0.5))),
                               rtol=TOL_METRIC)


def test_ms_ssim_matches_the_float64_goldens():
    x, cases = _ms_ssim_golden_cases()
    assert metrics.MS_SSIM_MIN_SIDE == jax_metrics.MS_SSIM_MIN_SIDE == 176
    for name, y in cases.items():
        got = float(metrics.ms_ssim(_t(x[None]), _t(y[None]))[0])
        np.testing.assert_allclose(got, _MS_SSIM_GOLDENS[name], atol=TOL_GOLDEN, err_msg=name)
        assert got <= 1.0, name


def test_confusion_counts_and_accumulator_match_jax(rng):
    pred = (rng.random((3, 16, 20, 1)) > 0.4).astype(np.float32)
    true = (rng.random((3, 16, 20, 1)) > 0.6).astype(np.float32)
    per_image = metrics.confusion_counts_per_image(_t(pred), _t(true))
    np.testing.assert_array_equal(per_image.numpy(), np.asarray(jax_metrics._confusion_counts_per_image(pred, true)))
    np.testing.assert_array_equal(metrics.confusion_counts(_t(pred), _t(true)).numpy(),
                                  np.asarray(jax_metrics._confusion_counts(pred, true)))
    ours, theirs, by_update = (metrics.MaskMetricsAccumulator(), jax_metrics.MaskMetricsAccumulator(),
                               metrics.MaskMetricsAccumulator())
    ours.add_counts(per_image)
    theirs.add_counts(np.asarray(per_image))
    by_update.update(_t(pred), _t(true))
    np.testing.assert_array_equal(ours.counts, theirs.counts)
    np.testing.assert_array_equal(by_update.counts, theirs.counts)
    assert ours.compute() == theirs.compute()
    assert metrics.MaskMetricsAccumulator().compute() == jax_metrics.MaskMetricsAccumulator().compute()


# ------------------------------------------------------------------ LPIPS

def test_lpips_fallback_weights_are_jax_s_bit_for_bit():
    ours, theirs = lpips.fallback_weights(), jax_lpips.fallback_weights()
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and ours[k].tobytes() == theirs[k].tobytes(), k


@pytest.mark.parametrize("size", [64, 33])
def test_lpips_matches_jax(rng, size):
    w = lpips.fallback_weights()
    x = rng.random((2, size, size, 3), dtype=np.float32)  # [0, 1], as the eval loop feeds it
    y = rng.random((2, size, size, 3), dtype=np.float32)
    want = np.asarray(jax_lpips.LPIPS(w)(jnp.asarray(x), jnp.asarray(y)))
    got = lpips.LPIPS(w)(_t(x), _t(y)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL_METRIC)
    np.testing.assert_allclose(lpips.LPIPS(w)(_t(x), _t(x)).numpy(), 0.0, atol=1e-6)


def test_load_lpips_search_order(tmp_path, monkeypatch, rng):
    x = _t(rng.random((1, 64, 64, 3), dtype=np.float32))
    y = _t(rng.random((1, 64, 64, 3), dtype=np.float32))
    base = lpips.fallback_weights()
    files = {}
    for k, scale in (("explicit", 2.0), ("env", 3.0), ("asset", 4.0)):
        files[k] = str(tmp_path / f"{k}.npz")
        np.savez(files[k], **{n: (a * scale if n.startswith("lin") else a) for n, a in base.items()})

    def value(metric):
        return float(metric(x, y)[0])

    monkeypatch.setattr(lpips, "_warned", True)
    monkeypatch.setattr(lpips, "_asset_path", lambda: files["asset"])
    monkeypatch.setenv("FLOODGAN_LPIPS_WEIGHTS", files["env"])
    monkeypatch.setenv("FLOODGAN_LPIPS_FALLBACK", "1")
    fallback = value(lpips.LPIPS(base))
    np.testing.assert_allclose(value(lpips.load_lpips(files["explicit"])), 2 * fallback, rtol=1e-5)
    with pytest.raises(FileNotFoundError):
        lpips.load_lpips(str(tmp_path / "missing.npz"))
    np.testing.assert_allclose(value(lpips.load_lpips()), 3 * fallback, rtol=1e-5)
    monkeypatch.delenv("FLOODGAN_LPIPS_WEIGHTS")
    np.testing.assert_allclose(value(lpips.load_lpips()), 4 * fallback, rtol=1e-5)
    monkeypatch.setattr(lpips, "_asset_path", lambda: str(tmp_path / "none.npz"))
    assert value(lpips.load_lpips()) == fallback
    monkeypatch.delenv("FLOODGAN_LPIPS_FALLBACK")
    assert lpips.load_lpips() is None


# ------------------------------------------------------- fused eval block

@pytest.fixture(scope="module")
def eval_blocks():
    """The same U-Net weights (last conv scaled, logits away from 0) in
    JAX's fused eval block and the port's trainer; one batch of generator
    output and truth in [-1, 1], JAX's results on it, and the pixels whose
    port logit lies within NEAR_THRESHOLD of 0, per image, on either side.
    Only those may fall on opposite sides in the two frameworks: each moves
    one count from one cell to another (an L1 change of 2)."""
    _, params = jax_unet_params(seed=4)
    outc = params["outc"]
    outc["weight"], outc["bias"] = outc["weight"] * 100, outc["bias"] * 100
    jax_fn = jax_metrics.make_eval_batch_metrics(JaxSegTrainer()._predict_mask)
    port = port_seg_trainer(params)
    rng = np.random.default_rng(21)
    out, y = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    near = {k: (port.predict_logits(denormalize(_t(img))).abs() <= NEAR_THRESHOLD).sum(dim=(1, 2, 3)).numpy()
            for k, img in (("out", out), ("y", y))}
    want = jax.device_get(jax_fn(params, jnp.asarray(out), jnp.asarray(y), with_ms_ssim=False))
    return {"port": port, "out": out, "y": y, "near": near, "want": want,
            "want_true_mask": np.asarray(jax_fn.true_mask(params, jnp.asarray(y)))}


def test_eval_batch_metrics_match_jax(eval_blocks):
    b, port = eval_blocks, eval_blocks["port"]
    assert port.eval_batch_metrics is port.eval_batch_metrics  # built once, with the trainer
    near = b["near"]["out"] + b["near"]["y"]
    assert near.sum() <= 0.01 * b["out"][..., 0].size
    want_m, want_c = b["want"]
    got_m, got_c = port.eval_batch_metrics(_t(b["out"]), _t(b["y"]), with_ms_ssim=False)
    assert set(got_m) == set(want_m)
    np.testing.assert_allclose(got_m["PSNR"].numpy(), want_m["PSNR"], rtol=TOL_METRIC)
    np.testing.assert_allclose(got_m["SSIM"].numpy(), want_m["SSIM"], atol=TOL_METRIC)
    assert got_c.shape == (2, 4) and (got_c.sum(dim=1) == 32 * 32).all()
    assert (np.abs(got_c.numpy() - want_c).sum(axis=1) <= 2 * near).all(), (got_c, want_c, near)
    assert 0 < int(got_c[:, 0].sum()) < int(got_c.sum())  # both classes present


def test_eval_batch_metrics_attributes_match_jax(eval_blocks):
    """``true_mask`` against JAX's; ``with_true_mask`` on it equals the
    full call, and so JAX's full call up to the near-threshold pixels."""
    b, port = eval_blocks, eval_blocks["port"]
    fn = port.eval_batch_metrics
    out, y = _t(b["out"]), _t(b["y"])
    tm = fn.true_mask(y)
    far = (port.predict_logits(denormalize(y)).abs() > NEAR_THRESHOLD).numpy()
    np.testing.assert_array_equal(tm.numpy()[far], b["want_true_mask"][far])
    np.testing.assert_array_equal(tm.numpy(), port.predict_mask(denormalize(y)).numpy())
    a_m, a_c = fn(out, y, with_ms_ssim=False)
    b_m, b_c = fn.with_true_mask(out, y, tm, with_ms_ssim=False)
    np.testing.assert_array_equal(a_c.numpy(), b_c.numpy())
    for k in a_m:
        np.testing.assert_array_equal(a_m[k].numpy(), b_m[k].numpy())
    near = b["near"]["out"] + b["near"]["y"]
    assert (np.abs(b_c.numpy() - b["want"][1]).sum(axis=1) <= 2 * near).all()


# ------------------------------------------------------------------- CLIs

def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _gan_flags(data_path, meta_dir, ckpt):
    return ["--model=PairedAttention", "--dataset_subset=usa", "--dataset_dem=same", f"--data_path={data_path}",
            f"--metadata_dir={meta_dir}", "--topography=all", f"--pretrained_model_path={ckpt}"]


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """A seeded GAN .ckpt and a seg .ckpt written by the port; both
    packages' evaluate CLIs on them (metrics, then the four single-image
    PNGs), each writing into its own data directory."""
    roots = {k: str(tmp_path_factory.mktemp(k)) for k in ("port", "jax")}
    for r in roots.values():
        make_flood_fixture(r, size=32, n_per_disaster=3)
    meta_dir = os.path.join(roots["port"], "metadata")
    gan = Model(model="PairedAttention", dataset_subset="usa", dataset_dem="same", data_path=roots["port"],
                topography="all", resize=None, metadata_dir=meta_dir, device="cpu")
    gan_ckpt = gan.save_checkpoint(3)
    seg = SegmentationModel(data_path=roots["port"], skip_data=True, verbose=False, device="cpu")
    seg.trainer.model.load_state_dict(jax_params.state_dict_from_jax(seg.trainer.model, jax_unet_params(seed=2)[1]))
    seg_ckpt = sharpened_seg_checkpoint(seg.save_checkpoint(1), os.path.join(roots["port"], "seg.ckpt"))

    import floodgan_tpu.api as jax_api

    models, out = {}, io.StringIO()

    class Recorded(jax_api.Model):  # JAX's evaluate main() returns None
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            models["jax"] = self

    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        loaded_jax_seg_init(mp)
        mp.setattr(jax_api, "Model", Recorded)
        mp.setenv("FLOODGAN_LPIPS_FALLBACK", "1")
        mp.setattr(lpips, "_warned", True)
        mp.setattr(jax_lpips, "_warned", True)
        for pkg, main, extra in (("port", cli_evaluate.main, ["--device=cpu"]), ("jax", jax_evaluate.main, [])):
            flags = _gan_flags(roots[pkg], os.path.join(roots[pkg], "metadata"), gan_ckpt) + extra
            m = main(flags + ["--calculate_metrics", f"--segmentation_model_path={seg_ckpt}",
                              f"--image_name={IMAGE}", "--plot_single_image=output"])
            models[pkg] = models.get(pkg, m)
            for kind in ("input", "ground truth", "attention mask"):
                models[pkg].plot_image(IMAGE, plot_single_image=kind)
    yield {"roots": roots, "gan_ckpt": gan_ckpt, "seg_ckpt": seg_ckpt, "stdout": out.getvalue(), "models": models}
    for d in roots.values():  # checkpoints of 175 and 372 MB
        shutil.rmtree(d, ignore_errors=True)


def test_evaluate_cli_metric_csv_matches_jax(evaluated):
    port_model = evaluated["models"]["port"]
    seg = SegmentationModel(pretrained_model_path=evaluated["seg_ckpt"], skip_data=True, verbose=False, device="cpu")
    for batch in port_model.val_loader.epoch_iter(0):  # the precondition of exact mask counts
        for img in (denormalize(port_model.generate(batch["input"])[0]), denormalize(batch["output"])):
            assert float(seg.predict_logits(img).abs().min()) > NEAR_THRESHOLD
    (got_path,), (want_path,) = (glob.glob(f"{evaluated['roots'][k]}/metrics/*.csv") for k in ("port", "jax"))
    assert os.path.basename(got_path).split("_date")[0] == os.path.basename(want_path).split("_date")[0]
    got, want = _read_csv(got_path), _read_csv(want_path)
    assert got[0] == want[0] == [""] + list(METRIC_COLUMNS)
    assert got[1][0] == want[1][0] == "1"
    row = dict(zip(got[0][1:], zip(got[1][1:], want[1][1:])))
    assert row["MS-SSIM"] == ("", "")  # 32^2 is under MS_SSIM_MIN_SIDE: NaN, an empty cell, in both
    assert "MS-SSIM requires >=176px" in evaluated["stdout"]
    for k in ("PSNR", "SSIM", "LPIPS"):
        g, w = float(row[k][0]), float(row[k][1])
        assert np.isfinite(g) and abs(g - w) <= TOL_METRIC * (abs(w) if k == "PSNR" else 1.0), (k, g, w)
    for k in METRIC_COLUMNS[4:-1]:
        assert row[k][0] == row[k][1], k
    assert 0.0 < float(row["Accuracy"][0]) < 1.0 and float(row["Inference"][0]) > 0.0


def test_evaluate_cli_single_images_match_jax(evaluated):
    import matplotlib.pyplot as plt

    def pngs(pkg):
        root = evaluated["roots"][pkg]
        return {os.path.basename(p).split("_date")[0]: p for p in glob.glob(f"{root}/images/*.png")}

    got, want = pngs("port"), pngs("jax")
    assert sorted(got) == sorted(want) and len(got) == 4, (sorted(got), sorted(want))
    for name, path in got.items():
        a, b = plt.imread(path), plt.imread(want[name])
        assert a.shape == b.shape == (32, 32, 4), name
        if name.endswith(("_input.png", "_groundTruth.png")):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:  # generator output: floats within 1e-5 may straddle a level
            assert np.abs(a - b).max() <= 1 / 255 + 1e-7 and (a != b).mean() <= 0.01, name


def test_evaluate_cli_checks_its_flags(evaluated, tmp_path):
    flags = _gan_flags(evaluated["roots"]["port"], os.path.join(evaluated["roots"]["port"], "metadata"),
                       evaluated["gan_ckpt"]) + ["--device=cpu"]
    with pytest.raises(ValueError, match="segmentation model must be provided"):
        cli_evaluate.main(flags + ["--calculate_metrics"])
    with pytest.raises(FileNotFoundError, match="specify an image"):
        cli_evaluate.main(flags + ["--plot_single_image=output"])
    with pytest.raises(FileNotFoundError, match="Saved model not found"):
        cli_evaluate.main(flags[:-2] + [f"--pretrained_model_path={tmp_path}/missing.ckpt", "--device=cpu"])


def _jax_predict_module():
    spec = importlib.util.spec_from_file_location("jax_predict_cli", ROOT / "predict.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_predict_cli_flood_masks_match_jax_predict(evaluated, tmp_path, monkeypatch):
    import matplotlib.pyplot as plt

    from floodgan_tpu_torch.data import tiff
    from floodgan_tpu_torch.serve import InferenceEngine

    loaded_jax_seg_init(monkeypatch)
    root = evaluated["roots"]["port"]
    inputs = sorted(glob.glob(f"{root}/dataset_input/*_10m.tif"))[:3]
    flags = ["--pretrained_model_path", evaluated["gan_ckpt"], "--inputs", *inputs, "--resize", "32",
             "--batch_size", "2", "--segmentation_model_path", evaluated["seg_ckpt"]]
    with contextlib.redirect_stdout(io.StringIO()):
        written = cli_predict.main(flags + ["--output_dir", str(tmp_path / "port"), "--device", "cpu"])
        _jax_predict_module().main(flags + ["--output_dir", str(tmp_path / "jax")])
    masks = [p for p in written if p.endswith("_floodmask.png")]
    assert [os.path.basename(p) for p in masks] == [os.path.basename(f)[:-4] + "_floodmask.png" for f in inputs]

    engine = InferenceEngine.from_checkpoint(evaluated["gan_ckpt"], batch_size=1, image_size=32, device="cpu")
    seg = SegmentationModel(pretrained_model_path=evaluated["seg_ckpt"], skip_data=True, verbose=False, device="cpu")
    for f, path in zip(inputs, masks):
        out = engine.predict(engine.preprocess(np.asarray(tiff.imread(f), np.float32)[None], resize=32))
        logits = seg.predict_logits(out)  # one image per U-Net call, as the CLI makes it
        assert float(logits.abs().min()) > NEAR_THRESHOLD
        got, want = plt.imread(path), plt.imread(str(tmp_path / "jax" / os.path.basename(path)))
        assert got.shape == want.shape == (32, 32, 4)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[..., 0], (logits[0, :, :, 0] > 0).numpy().astype(np.float32))
    assert any(0 < plt.imread(p)[..., 0].mean() < 1 for p in masks)  # both classes


@pytest.mark.parametrize("reverse", [False, True])
def test_gray_png_writer_matches_matplotlib_imsave(tmp_path, rng, reverse):
    import matplotlib.pyplot as plt

    img = rng.random((13, 17), dtype=np.float32)
    img[0, :6] = [0.0, 1.0, 0.5, -0.25, 1.5, np.nextafter(np.float32(1), np.float32(0))]
    img[1, 1] = np.nan
    img[2, :4] = [1 / 256, np.nextafter(np.float32(1 / 256), np.float32(0)), 255 / 256, 0.999]
    cmap = "gray_r" if reverse else "gray"
    imsave_gray(str(tmp_path / "port.png"), img, reverse=reverse)
    plt.imsave(str(tmp_path / "mpl.png"), img, vmin=0, vmax=1, cmap=cmap)
    np.testing.assert_array_equal(plt.imread(str(tmp_path / "port.png")), plt.imread(str(tmp_path / "mpl.png")))
    mask = (rng.random((9, 11)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(gray_rgba_bytes(mask)[..., 0], mask * 255)
    with pytest.raises(ValueError, match="float"):
        imsave_gray(str(tmp_path / "bad.png"), mask.astype(np.uint8))
