"""The compare CLI's ``two`` mode against the JAX package's, the training CLI
of every family, and the segment CLI's evaluate mode without matplotlib, on
the CPU.

- ``--compare two`` on two port-written PairedAttention ``.ckpt``s: both
  CSVs, every cell but ``Inference`` (tests/torch_compare_fixtures.py).
- ``python -m floodgan_tpu_torch.cli.train --model=...`` for each family:
  one epoch on the CPU, a ``.ckpt`` with the family's loss schema.
- ``python -m floodgan_tpu_torch.cli.segment`` without ``--train`` on a
  machine without matplotlib: one notice, no figures, the metric CSV.
"""

import glob
import os
import shutil
import sys

import numpy as np
import pytest

from floodgan_tpu_torch.api.model import Model, loss_keys
from floodgan_tpu_torch.api.segmentation import SegmentationModel
from floodgan_tpu_torch.cli import segment as cli_segment
from floodgan_tpu_torch.cli import train as cli_train
from floodgan_tpu_torch.utils import jax_params

from fixtures import make_flood_fixture, make_masks_fixture
from torch_compare_fixtures import check_csvs_match, read_csv, run_both_compare_clis
from torch_seg_fixtures import big_tmp, few_torch_threads, jax_unet_params, sharpened_seg_checkpoint  # noqa: F401

SIZE = 256


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    yield from few_torch_threads()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Data directories for both packages, two seeded PairedAttention
    .ckpts of topography all, and the seg .ckpt, all written by the port."""
    roots = {k: str(tmp_path_factory.mktemp(f"two_{k}")) for k in ("port", "jax")}
    for r in roots.values():
        make_flood_fixture(r, size=SIZE, n_per_disaster=3)
    kw = dict(model="PairedAttention", dataset_subset="usa", dataset_dem="same", data_path=roots["port"],
              metadata_dir=os.path.join(roots["port"], "metadata"), topography="all", resize=None, device="cpu")
    ckpts = {name: shutil.move(Model(seed=seed, **kw).save_checkpoint(1), os.path.join(roots["port"], f"{name}.ckpt"))
             for name, seed in (("first", 21), ("second", 40))}
    seg = SegmentationModel(data_path=roots["port"], skip_data=True, verbose=False, device="cpu")
    seg.trainer.model.load_state_dict(jax_params.state_dict_from_jax(seg.trainer.model, jax_unet_params(seed=2)[1]))
    seg_ckpt = sharpened_seg_checkpoint(seg.save_checkpoint(1), os.path.join(roots["port"], "seg.ckpt"))
    yield {"roots": roots, "ckpts": ckpts, "seg": seg_ckpt}
    for d in roots.values():  # two 175 MB GAN checkpoints and a 372 MB U-Net
        shutil.rmtree(d, ignore_errors=True)


def _compare(run, mode, paths, monkeypatch):
    meta = os.path.join(run["roots"]["port"], "metadata")
    flags = [f"--compare={mode}", "--dataset_subset=usa", "--dataset_dem=same", "--topography=all",
             f"--metadata_dir={meta}", "--calculate_metrics", f"--segmentation_model_path={run['seg']}", *paths]
    group, _ = run_both_compare_clis(run["roots"], flags, monkeypatch)
    return group


def test_two_comparison_csvs_match_jax(checkpoints, monkeypatch):
    paths = [f"--model_1_path={checkpoints['ckpts']['first']}", f"--model_2_path={checkpoints['ckpts']['second']}"]
    group = _compare(checkpoints, "two", paths, monkeypatch)
    assert list(group.models) == ["Model 1", "Model 2"]
    check_csvs_match(checkpoints["roots"], "two", "all", group, checkpoints["seg"], SIZE * SIZE)


@pytest.mark.parametrize("family,size", [("Pix2Pix", 256), ("CycleGAN", 32), ("AttentionGAN", 32),
                                         ("PairedAttention", 32)])
def test_train_cli_trains_every_family(big_tmp, family, size):
    data, meta = make_flood_fixture(big_tmp, size=size, n_per_disaster=3)
    model = cli_train.main([f"--model={family}", "--dataset_subset=usa", "--dataset_dem=same", f"--data_path={data}",
                            f"--metadata_dir={meta}", "--topography=all", "--batch_size=2", "--num_epochs=1",
                            "--save_model_interval=1", "--add_identity_loss", "--device=cpu"])
    keys = loss_keys(family, model.model_is_cycle)
    assert list(model.all_losses) == [f"all_{k}" for k in keys]
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in model.all_losses.values())
    (ckpt,) = glob.glob(os.path.join(data, "models", f"{family}_epoch1_*.ckpt"))
    assert ("identityTrue" in ckpt) == model.model_is_cycle
    resumed = Model(load_pretrained_model=True, pretrained_model_path=ckpt, dataset_subset="usa", dataset_dem="same",
                    data_path=data, metadata_dir=meta, resize=None, verbose=False, device="cpu")
    assert resumed.model == family.lower() and resumed.all_losses == model.all_losses


def test_segment_cli_writes_its_csv_without_matplotlib(big_tmp, monkeypatch, capsys):
    """Without matplotlib the evaluate mode skips the loss figure and the
    sample masks with one notice, and still writes the metric CSV."""
    data, meta = make_masks_fixture(str(big_tmp), size=32, n=6)
    seg = SegmentationModel(data_path=data, skip_data=True, verbose=False, device="cpu")
    ckpt = seg.save_checkpoint(1)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # find_spec -> None, import -> ImportError
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    cli_segment.main([f"--data_path={data}", "--dataset_subset=usa", f"--metadata_dir={meta}",
                      f"--pretrained_model_path={ckpt}", "--device=cpu"])
    out = capsys.readouterr().out
    assert out.count("matplotlib is not installed") == 1
    (csv_path,) = glob.glob(os.path.join(data, "metrics", "SegmentationModel_*.csv"))
    header, row = read_csv(csv_path)
    assert header[1:] == ["MSE", "Accuracy", "F1_Flood", "Precision_Flood", "Recall_Flood", "F1_No_Flood",
                          "Precision_No_Flood", "Recall_No_Flood", "IoU_Flood", "IoU_No_Flood"]
    assert all(0.0 <= float(v) <= 1.0 for v in row[1:])
    assert not glob.glob(os.path.join(data, "figures", "*")) and not glob.glob(os.path.join(data, "images", "*"))
