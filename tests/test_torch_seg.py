"""The port's segmentation training, checkpoints, data and CLI against the
JAX package's, on the CPU.

- One ``SegTrainer`` step at 32^2, batch 2, f32, on the same weights:
  loss and accuracy within 1e-5 before the update, each gradient within
  1e-4 of its tensor's norm (with all-zero tied max-pool windows in the
  stem), and the step-2 loss within 2e-3 (after an Adam update rounding
  turns into +-lr, as tests/test_torch_train.py holds it).
- A seg ``.ckpt`` written by the port loads in JAX's ``SegmentationModel``
  and the reverse, every leaf bit for bit; a reference ``.pth.tar``
  migrates to the same file in both packages.
- The masks splits and loader, item for item.
- ``python -m floodgan_tpu_torch.cli.segment``: training, the metric CSV
  of a checkpoint equal to JAX's, and ``--plot_mask_image`` pixel for
  pixel (on the trained checkpoint with its logits scaled away from the
  threshold, ``sharpened_seg_checkpoint``).
"""

import contextlib
import csv
import glob
import io
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from floodgan_tpu.api.segmentation import SegmentationModel as JaxSeg
from floodgan_tpu.ckpt import load_checkpoint as jax_load_checkpoint
from floodgan_tpu.data import pipeline as jax_pipeline
from floodgan_tpu.data import splits as jax_splits
from floodgan_tpu.train.losses import bce_with_logits as jax_bce
from floodgan_tpu.train.optim import apply_adam
from floodgan_tpu.train.seg import SegTrainer as JaxSegTrainer
from floodgan_tpu.utils import migrate as jax_migrate
from floodgan_tpu_torch.api.segmentation import SegmentationModel
from floodgan_tpu_torch.ckpt import load_checkpoint, migrate
from floodgan_tpu_torch.cli import segment as cli_segment
from floodgan_tpu_torch.data import pipeline, splits
from floodgan_tpu_torch.models.unet import UNet
from floodgan_tpu_torch.train.seg import SegTrainer
from floodgan_tpu_torch.utils import jax_params
from floodgan_tpu_torch.utils.png import imsave_rgb

from fixtures import make_masks_fixture
from torch_seg_fixtures import big_tmp, few_torch_threads, jax_unet_params, loaded_jax_seg_init, port_seg_trainer, sharpened_seg_checkpoint

TOL_BEFORE_UPDATE = 1e-5
TOL_GRAD = 1e-4         # of each gradient tensor's norm
TOL_AFTER_ADAM = 2e-3
LR = 1e-4               # TrainConfig.seg_lr


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    yield from few_torch_threads()


@pytest.fixture(scope="module")
def unet():
    """One set of U-Net weights for the module, drawn from a seed."""
    return jax_unet_params(seed=1)[1]


@pytest.fixture(scope="module")
def masks(tmp_path_factory):
    data_path, meta_dir = make_masks_fixture(tmp_path_factory.mktemp("masks"), size=32, n=8, seed=11)
    return data_path, meta_dir


@pytest.fixture
def fast_jax_seg(monkeypatch):
    loaded_jax_seg_init(monkeypatch)


# ------------------------------------------------------------ train step

@pytest.fixture(scope="module")
def steps(unet):
    rng = np.random.default_rng(9)
    x = rng.random((2, 32, 32, 3), dtype=np.float32)
    m = (rng.random((2, 32, 32, 1)) > 0.5).astype(np.float32)
    jt = JaxSegTrainer()

    @jax.jit
    def loss_and_grad(p):
        def loss_fn(p):
            logits = jt._apply(p, jnp.asarray(x))
            return jax_bce(logits, jnp.asarray(m)), logits
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    params = jax.tree_util.tree_map(jnp.asarray, unet)
    (loss1, logits1), grads = loss_and_grad(params)
    params2, _ = apply_adam(jt.tx, params, jt.tx.init(params), grads, jnp.float32(LR))
    (loss2, _), _ = loss_and_grad(params2)

    port = port_seg_trainer(unet)
    with torch.no_grad():  # the stem's output: how many pooling windows tie at zero
        x1 = port.model.inc(torch.tensor(x).permute(0, 3, 1, 2))
    ties = int((F.max_pool2d(x1, 2) == 0).sum())
    m1 = port.train_step(x, m, LR)
    port_grads = {n: p.grad.clone() for n, p in port.model.named_parameters()}
    m2 = port.train_step(x, m, LR)
    # The same gradient in f64, the truth both f32 gradients are held to
    # first.  After each BN the per-channel gradient sums cancel, so an
    # activation that f32 rounds to the other side of a ReLU kink moves a
    # BN's gradient by up to ~1e-2 of its norm, in either package (seeds
    # 5 and 9 do that to JAX's).  These seeds are a case where neither
    # package's rounding crosses a kink.
    net64 = port_seg_trainer(unet).model.double()
    z = net64(torch.tensor(x, dtype=torch.float64).permute(0, 3, 1, 2))
    t = torch.tensor(m, dtype=torch.float64).permute(0, 3, 1, 2)
    (torch.clamp(z, min=0) - z * t + torch.log1p(torch.exp(-z.abs()))).mean().backward()
    f64 = {n: p.grad.float() for n, p in net64.named_parameters()}
    acc1 = float(jnp.mean(((jax.nn.sigmoid(logits1) > 0.5) == (m > 0.5)).astype(jnp.float32)))
    return {"jax": (float(loss1), acc1, float(loss2)), "port": (float(m1["loss"]), float(m1["accuracy"]),
            float(m2["loss"])), "jax_grads": jax_params.state_dict_from_jax(UNet(), grads),
            "port_grads": port_grads, "f64_grads": f64, "ties": ties, "windows": x1.numel() // 4}


def test_step1_loss_and_accuracy_match_jax(steps):
    (jl, ja, _), (pl, pa, _) = steps["jax"], steps["port"]
    np.testing.assert_allclose(pl, jl, rtol=TOL_BEFORE_UPDATE)
    np.testing.assert_allclose(pa, ja, atol=TOL_BEFORE_UPDATE)


def test_gradients_match_jax_with_tied_pool_windows(steps):
    assert steps["ties"] > 0.01 * steps["windows"], "the stem should hold all-zero tied windows"
    want, got = steps["jax_grads"], steps["port_grads"]
    assert set(want) == set(got)
    for name, g in got.items():
        ref = want[name]
        truth = steps["f64_grads"][name]
        assert float((g - truth).abs().max()) <= 1e-5 * float(ref.norm()), name
        assert float((ref - truth).abs().max()) <= 1e-5 * float(ref.norm()), name
        assert float((g - ref).abs().max()) <= TOL_GRAD * float(ref.norm()), name


def test_step2_loss_matches_jax(steps):
    np.testing.assert_allclose(steps["port"][2], steps["jax"][2], rtol=TOL_AFTER_ADAM)


def test_remat_and_bad_dtype_raise():
    with pytest.raises(NotImplementedError, match="item 1"):
        SegTrainer(device="cpu", remat=True)
    with pytest.raises(ValueError, match="compute_dtype"):
        SegTrainer(device="cpu", compute_dtype="float16")


def test_bf16_step_is_finite_and_moves_the_weights(unet):
    t = port_seg_trainer(unet, compute_dtype="bfloat16")
    before = {n: p.detach().clone() for n, p in t.model.named_parameters()}
    rng = np.random.default_rng(2)
    m = t.train_step(rng.random((2, 32, 32, 3), dtype=np.float32),
                     (rng.random((2, 32, 32, 1)) > 0.5).astype(np.float32), LR)
    assert np.isfinite(float(m["loss"])) and all(p.dtype == torch.float32 for p in t.model.parameters())
    assert all(not torch.equal(p, before[n]) for n, p in t.model.named_parameters())


# ------------------------------------------------------------ checkpoints

def _same_tree(a, b):
    fa, ta = jax.tree_util.tree_flatten_with_path(a)
    fb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), path


def test_port_seg_checkpoint_loads_in_jax_and_back(unet, big_tmp, fast_jax_seg):
    port = SegmentationModel(data_path=str(big_tmp), skip_data=True, verbose=False, device="cpu")
    port.trainer.model.load_state_dict(jax_params.state_dict_from_jax(port.trainer.model, unet))
    rng = np.random.default_rng(4)
    port.trainer.train_step(rng.random((1, 32, 32, 3), dtype=np.float32),
                            (rng.random((1, 32, 32, 1)) > 0.5).astype(np.float32), LR)
    port.all_losses, port.all_accuracies = [0.7], [0.5]
    path = port.save_checkpoint(1)
    assert os.path.basename(path).startswith("SegmentationModel_epoch0_usaData_date")  # not training: epoch - 1

    jax_model = JaxSeg(data_path=str(big_tmp), pretrained_model_path=path, skip_data=True, verbose=False)
    assert (jax_model.current_epoch, jax_model.all_losses, jax_model.all_accuracies) == (2, [0.7], [0.5])
    _same_tree(jax.device_get(jax_model.state.params), load_checkpoint(path)[1]["params"])
    assert int(jax_model.state.opt.count) == 1

    back = jax_model.save_checkpoint(1)
    _, raw_port = load_checkpoint(path)
    _, raw_jax = jax_load_checkpoint(back)
    _same_tree(raw_jax, raw_port)
    again = SegmentationModel(pretrained_model_path=back, skip_data=True, verbose=False, device="cpu")
    assert again.current_epoch == 2
    for (n, p), q in zip(port.trainer.model.named_parameters(), again.trainer.model.parameters()):
        assert torch.equal(p, q), n
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(port.trainer.opt.state[p][k], again.trainer.opt.state[q][k]), (n, k)


def test_reference_seg_checkpoint_migrates_like_jax(unet, big_tmp):
    net = jax_params.state_dict_from_jax(UNet(), unet)
    ref_sd = {}
    for i, (name, t) in enumerate(net.items()):  # the reference's names, its BN buffers between
        ref_sd[f"layer{i}.{name.rsplit('.', 1)[1]}"] = t
        if name.endswith("norm1.bias"):
            ref_sd[f"layer{i}.running_mean"] = torch.zeros_like(t)
            ref_sd[f"layer{i}.num_batches_tracked"] = torch.tensor(3)
    ref = str(big_tmp / "seg.pth.tar")
    torch.save({"model": ref_sd, "current_epoch": 4, "num_epochs": 9, "all_losses": [0.5, 0.4, 0.3],
                "all_accuracies": [0.6, 0.7, 0.8]}, ref)
    os.makedirs(big_tmp / "jax")
    jax_ref = shutil.copy(ref, big_tmp / "jax" / "seg.pth.tar")
    port_out = migrate.maybe_migrate(ref, kind="seg")
    jax_out = jax_migrate.maybe_migrate(str(jax_ref), "seg")
    assert port_out == ref + ".floodgan.ckpt"
    pm, praw = jax_load_checkpoint(port_out)
    jm, jraw = jax_load_checkpoint(jax_out)
    assert pm == jm == {"current_epoch": 4, "num_epochs": 9, "all_losses": [0.5, 0.4, 0.3],
                        "all_accuracies": [0.6, 0.7, 0.8]}
    _same_tree(praw, jraw)
    _same_tree(praw["params"], unet)


# ------------------------------------------------------------ data

def test_masks_splits_match_jax(masks):
    _, meta_dir = masks
    for train_on_all in (False, True):
        got = splits.determine_masks_dataset("USA", train_on_all, meta_dir)
        want = jax_splits.determine_masks_dataset("USA", train_on_all, meta_dir)
        assert [None if s is None else [(m.file_name, m.version) for m in s] for s in got] == \
            [None if s is None else [(m.file_name, m.version) for m in s] for s in want]
    assert [len(s) for s in splits.determine_masks_dataset("usa", False, meta_dir)] == [6, 1, 1]
    with pytest.raises(NotImplementedError):
        splits.determine_masks_dataset("harvey", False, meta_dir)


def test_masks_loader_matches_jax_item_for_item(masks):
    data_path, meta_dir = masks
    ours = pipeline.create_masks_dataset("usa", data_path, False, batch_size=2, metadata_dir=meta_dir, device="cpu")
    theirs = jax_pipeline.create_masks_dataset("usa", data_path, False, batch_size=2, metadata_dir=meta_dir)
    assert [len(l) for l in ours] == [len(l) for l in theirs] == [3, 1, 1]
    flipped = 0
    for a, b in zip(ours, theirs):
        for epoch in (0, 3):
            batches = list(zip(a.epoch_iter(epoch), b.epoch_iter(epoch)))
            assert len(batches) == len(a)
            for p, j in batches:
                assert p["names"] == j["names"]
                assert p["input"].dtype == p["output"].dtype == torch.float32
                np.testing.assert_array_equal(p["input"].numpy(), np.asarray(j["input"]))
                np.testing.assert_array_equal(p["output"].numpy(), np.asarray(j["output"]))
                flipped += sum("00000005" in n for n in p["names"])
    assert flipped == 2  # the one flipped sample, in both epochs of the train split
    on_all = pipeline.create_masks_dataset("usa", data_path, True, metadata_dir=meta_dir, device="cpu")
    assert on_all[1:] == (None, None) and len(on_all[0].dataset) == 8


# ------------------------------------------------------------ CLI

@pytest.fixture(scope="module")
def trained(masks, tmp_path_factory):
    data_path, meta_dir = masks
    root = str(tmp_path_factory.mktemp("seg_cli"))
    for d in ("masks_input", "masks_output", "metadata"):
        shutil.copytree(os.path.join(data_path, d), os.path.join(root, d))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model = cli_segment.main(["--train", "--dataset_subset=usa", f"--data_path={root}",
                                  f"--metadata_dir={root}/metadata", "--num_epochs=2", "--save_model_interval=1",
                                  "--verbose", "--device=cpu"])
    ckpts = sorted(glob.glob(f"{root}/models/*.ckpt"))
    sharp_dir = str(tmp_path_factory.mktemp("sharp"))
    sharp = sharpened_seg_checkpoint(ckpts[-1], os.path.join(sharp_dir, "seg.ckpt"))
    yield {"model": model, "root": root, "stdout": out.getvalue(), "ckpts": ckpts, "sharp": sharp}
    for d in (root, sharp_dir):  # 372 MB a checkpoint
        shutil.rmtree(d, ignore_errors=True)


def test_segment_cli_trains_and_checkpoints(trained):
    model = trained["model"]
    assert model.device.type == "cpu" and model.current_epoch == 2
    assert len(model.all_losses) == len(model.all_accuracies) == 2 and np.all(np.isfinite(model.all_losses))
    assert [os.path.basename(p).split("_date")[0] for p in trained["ckpts"]] == [
        f"SegmentationModel_epoch{e}_usaData" for e in (1, 2)]
    text = trained["stdout"]
    assert "Setting up the flood segmentation model..." in text
    assert text.count("Saving flood segmentation model to ") == 2 and "Epoch 2 (" in text
    meta, raw = load_checkpoint(trained["ckpts"][-1])
    assert meta["current_epoch"] == 3 and int(raw["opt"]["count"]) == 2 * 6  # 6 training samples, batch 1


def test_segment_cli_resumes_bit_for_bit(trained):
    model = trained["model"]
    again = SegmentationModel(pretrained_model_path=trained["ckpts"][-1], skip_data=True, verbose=False, device="cpu")
    assert (again.current_epoch, again.all_losses, again.all_accuracies) == \
        (3, model.all_losses, model.all_accuracies)
    for (n, p), q in zip(model.trainer.model.named_parameters(), again.trainer.model.parameters()):
        assert torch.equal(p, q), n
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(model.trainer.opt.state[p][k], again.trainer.opt.state[q][k]), (n, k)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_segment_cli_metrics_match_jax(trained, fast_jax_seg):
    pytest.importorskip("matplotlib")
    root, ckpt = trained["root"], trained["sharp"]
    flags = ["--dataset_subset=usa", f"--data_path={root}", f"--metadata_dir={root}/metadata",
             f"--pretrained_model_path={ckpt}"]
    with contextlib.redirect_stdout(io.StringIO()):
        port = cli_segment.main(flags + ["--device=cpu"])
    port_csv = glob.glob(f"{root}/metrics/*.csv")
    assert len(port_csv) == 1 and glob.glob(f"{root}/figures/*.png") and glob.glob(f"{root}/images/*.png")
    # The precondition of an exact comparison: no validation logit within rounding of 0.
    for batch in port.val_loader.epoch_iter(0):
        assert float(port.predict_logits(batch["input"]).abs().min()) > 1e-4
    os.rename(port_csv[0], port_csv[0] + ".port")
    with contextlib.redirect_stdout(io.StringIO()):
        jax_model = JaxSeg(dataset_subset="usa", data_path=root, metadata_dir=f"{root}/metadata",
                           pretrained_model_path=ckpt, verbose=False)
        jax_model.calculate_metrics()
    jax_csv = glob.glob(f"{root}/metrics/*.csv")
    got, want = _read_csv(port_csv[0] + ".port"), _read_csv(jax_csv[0])
    assert got[0] == want[0] == ["", "MSE", "Accuracy", "F1_Flood", "Precision_Flood", "Recall_Flood",
                                 "F1_No_Flood", "Precision_No_Flood", "Recall_No_Flood", "IoU_Flood",
                                 "IoU_No_Flood"]
    assert got == want


def test_segment_cli_plot_mask_image_matches_jax(trained, tmp_path, fast_jax_seg):
    plt = pytest.importorskip("matplotlib.pyplot")
    root, ckpt = trained["root"], trained["sharp"]
    img = np.random.default_rng(8).random((32, 32, 3), dtype=np.float32)
    src = str(tmp_path / "scene.png")
    imsave_rgb(src, img)
    with contextlib.redirect_stdout(io.StringIO()):
        port = cli_segment.main(["--dataset_subset=usa", f"--data_path={tmp_path}/port", f"--metadata_dir={root}/metadata",
                                 f"--pretrained_model_path={ckpt}",
                                 f"--plot_mask_image={src}", "--device=cpu"])
        JaxSeg(data_path=f"{tmp_path}/jax", pretrained_model_path=ckpt, skip_data=True,
               verbose=False).plot_mask_image(src)
    logits = port.predict_logits(plt.imread(src)[None, :, :, :3])
    assert float(logits.abs().min()) > 1e-4
    (got,), (want,) = glob.glob(f"{tmp_path}/port/images/SegmentationMask_scene_*.png"), \
        glob.glob(f"{tmp_path}/jax/images/SegmentationMask_scene_*.png")
    np.testing.assert_array_equal(plt.imread(got), plt.imread(want))
    assert set(np.unique(plt.imread(got)[..., 0])) <= {0.0, 1.0}


def test_segment_cli_checks_its_flags(tmp_path):
    with pytest.raises(ValueError, match="Provide a saved model"):
        cli_segment.main(["--dataset_subset=usa", f"--data_path={tmp_path}", "--device=cpu"])
    with pytest.raises(FileNotFoundError, match="Saved model not found"):
        cli_segment.main(["--dataset_subset=usa", f"--data_path={tmp_path}", "--device=cpu",
                          f"--pretrained_model_path={tmp_path}/missing.ckpt"])
