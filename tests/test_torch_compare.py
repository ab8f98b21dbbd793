"""``python -m floodgan_tpu_torch.cli.compare --compare models`` against the
JAX package's compare CLI, on the CPU.

- One port-written ``.ckpt`` of each family (PairedAttention, Pix2Pix,
  AttentionGAN, CycleGAN; seeded, topography "all") and a seg ``.ckpt``
  whose last conv is scaled away from the threshold; tests/fixtures.py's
  flood fixture at 256^2 (MS-SSIM needs 176).  Both packages' CLIs read the
  same files, so JAX's ``Model`` loads every family of the port's.
- The averaged and the per-disaster CSVs, every cell but ``Inference``
  (tests/torch_compare_fixtures.py); ``compare_output_images`` pixel for
  pixel but where the two generators' outputs straddle a level.
- The pandas-layout writers of ``utils/tables.py`` against pandas.
- The CLI's flag checks, and without a card ``ModelsGroup`` and the CLI
  raise.
"""

import glob
import os
import shutil

import numpy as np
import pandas as pd
import pytest

from floodgan_tpu.api import group as jax_group
from floodgan_tpu_torch.api.group import ModelsGroup
from floodgan_tpu_torch.api.model import Model
from floodgan_tpu_torch.api.segmentation import SegmentationModel
from floodgan_tpu_torch.cli import compare as cli_compare
from floodgan_tpu_torch.utils import jax_params
from floodgan_tpu_torch.utils.tables import write_indexed_csv, write_records_csv

from fixtures import make_flood_fixture
from torch_compare_fixtures import check_csvs_match, no_card, read_csv, run_both_compare_clis  # noqa: F401
from torch_seg_fixtures import few_torch_threads, jax_unet_params, sharpened_seg_checkpoint

SIZE = 256
IMAGE = "hurricane-harvey_00000001"  # a validation image of the flood fixture
FAMILIES = ("PairedAttention", "Pix2Pix", "AttentionGAN", "CycleGAN")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    yield from few_torch_threads()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Data directories for both packages, one seeded .ckpt per family and
    the seg .ckpt, all written by the port."""
    roots = {k: str(tmp_path_factory.mktemp(f"cmp_{k}")) for k in ("port", "jax")}
    for r in roots.values():
        make_flood_fixture(r, size=SIZE, n_per_disaster=3)
    kw = dict(dataset_subset="usa", dataset_dem="same", data_path=roots["port"],
              metadata_dir=os.path.join(roots["port"], "metadata"), topography="all", resize=None, device="cpu")
    ckpts = {m: Model(model=m, seed=11 + i, **kw).save_checkpoint(1) for i, m in enumerate(FAMILIES)}
    seg = SegmentationModel(data_path=roots["port"], skip_data=True, verbose=False, device="cpu")
    seg.trainer.model.load_state_dict(jax_params.state_dict_from_jax(seg.trainer.model, jax_unet_params(seed=2)[1]))
    seg_ckpt = sharpened_seg_checkpoint(seg.save_checkpoint(1), os.path.join(roots["port"], "seg.ckpt"))
    yield {"roots": roots, "ckpts": ckpts, "seg": seg_ckpt}
    for d in roots.values():  # GAN checkpoints of 175-650 MB and a 372 MB U-Net
        shutil.rmtree(d, ignore_errors=True)


def _flags(run, mode, paths):
    meta = os.path.join(run["roots"]["port"], "metadata")
    return [f"--compare={mode}", "--dataset_subset=usa", "--dataset_dem=same", "--topography=all",
            f"--metadata_dir={meta}", *paths]


@pytest.fixture(scope="module")
def compared(checkpoints):
    paths = [f"--{m.lower()}_path={checkpoints['ckpts'][m]}" for m in FAMILIES]
    extra = [f"--image_names={IMAGE}"] if _has_matplotlib() else []
    flags = _flags(checkpoints, "models", paths) + ["--calculate_metrics",
                                                    f"--segmentation_model_path={checkpoints['seg']}", *extra]
    with pytest.MonkeyPatch.context() as mp:
        group, stdout = run_both_compare_clis(checkpoints["roots"], flags, mp)
    return {**checkpoints, "group": group, "stdout": stdout}


def _has_matplotlib():
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def test_models_comparison_csvs_match_jax(compared):
    assert list(compared["group"].models) == list(FAMILIES)
    assert [type(m.trainer).__name__ for m in compared["group"].models.values()] == \
        ["PairedTrainer", "PairedTrainer", "CycleTrainer", "CycleTrainer"]
    check_csvs_match(compared["roots"], "models", "all", compared["group"], compared["seg"], SIZE * SIZE)
    (averaged,) = glob.glob(f"{compared['roots']['port']}/metrics/models_comparison_allTopography_*.csv")
    rows = read_csv(averaged)
    assert rows[0] == ["Model", "PSNR", "SSIM", "MS-SSIM", "LPIPS", "Inference", "MSE", "Accuracy", "F1_Flood",
                       "Precision_Flood", "Recall_Flood", "F1_No_Flood", "Precision_No_Flood", "Recall_No_Flood",
                       "IoU_Flood", "IoU_No_Flood"]
    assert [r[0] for r in rows[1:]] == list(FAMILIES)
    assert rows[1][5] == "" and float(rows[2][5]) > 0.0  # the first model's 3 timings all dropped as warm-up


def test_models_comparison_grouped_table_has_every_disaster(compared):
    (grouped,) = glob.glob(f"{compared['roots']['port']}/metrics/models_comparison_grouped_*.csv")
    rows = read_csv(grouped)
    assert rows[0] == ["Metric_Model", "hurricane-florence", "hurricane-harvey", "midwest-flooding"]
    assert len(rows) - 1 == 14 * len(FAMILIES)


def test_compare_output_images_match_jax(compared):
    plt = pytest.importorskip("matplotlib.pyplot")
    (got,) = glob.glob(f"{compared['roots']['port']}/images/models_comparison_{IMAGE}_*.png")
    (want,) = glob.glob(f"{compared['roots']['jax']}/images/models_comparison_{IMAGE}_*.png")
    a, b = plt.imread(got), plt.imread(want)
    assert a.shape == b.shape
    # generator outputs within 2e-4 may straddle a level of the 8-bit image
    assert np.abs(a - b).max() <= 1 / 255 + 1e-7 and (a != b).mean() <= 0.01


def test_crop_suffix_rule_matches_jax(monkeypatch):
    """``compare_output_images``' ``_<n>`` suffix picks crop quadrant n, as
    JAX's does: the (name, crop index) each package loads, recorded."""
    plt = pytest.importorskip("matplotlib.pyplot")
    calls = {}
    for pkg, cls, model_cls in (("port", ModelsGroup, Model), ("jax", jax_group.ModelsGroup, jax_group.Model)):
        def load(self, name, crop_index, pkg=pkg):
            calls.setdefault(pkg, []).append((name, crop_index))
            raise StopIteration

        monkeypatch.setattr(model_cls, "_load_named_image", load)
        group = object.__new__(cls)
        group.__dict__.update(models={"A": object.__new__(model_cls)}, compare="models", crop_index=2)
        for name in (IMAGE, IMAGE + "_3"):
            with pytest.raises(StopIteration):
                cls.compare_output_images(group, [name])
    plt.close("all")
    assert calls["port"] == calls["jax"] == [(IMAGE, 2), (IMAGE, 3)]


@pytest.mark.parametrize("mode,missing", [("models", "Pix2Pix, CycleGAN"), ("topography", "all, none, DEM"),
                                          ("two", "both models"), ("nothing", None)])
def test_compare_cli_checks_its_flags(checkpoints, mode, missing):
    from floodgan_tpu.cli import compare as jax_compare

    flags = [f"--data_path={checkpoints['roots']['port']}", "--dataset_subset=usa", "--dataset_dem=same",
             f"--compare={mode}", "--device=cpu"]
    for main, f in ((cli_compare.main, flags), (jax_compare.main, flags[:-1])):
        if missing is None:
            with pytest.raises(NotImplementedError, match="'models' 'topography' or 'two'"):
                main(f)
        else:
            with pytest.raises(ValueError, match=missing):
                main(f)
    p = checkpoints["ckpts"]["CycleGAN"]
    with pytest.raises(ValueError, match="segmentation model must be provided"):
        cli_compare.main(flags[:3] + ["--compare=two", f"--model_1_path={p}", f"--model_2_path={p}",
                                      "--calculate_metrics", "--topography=all", "--device=cpu",
                                      f"--metadata_dir={checkpoints['roots']['port']}/metadata"])


def test_missing_checkpoint_raises(checkpoints, tmp_path):
    with pytest.raises(FileNotFoundError, match="Saved Model 2 model not found"):
        ModelsGroup({"Model 1": checkpoints["ckpts"]["CycleGAN"], "Model 2": str(tmp_path / "none.ckpt")},
                    "two", "usa", "same", checkpoints["roots"]["port"], None, None, 0, "all",
                    metadata_dir=os.path.join(checkpoints["roots"]["port"], "metadata"), device="cpu")


def test_group_and_cli_without_device_need_the_card(checkpoints, no_card):
    p = checkpoints["ckpts"]["CycleGAN"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelsGroup({"Model 1": p, "Model 2": p}, "two", "usa", "same", checkpoints["roots"]["port"],
                    None, None, 0, "all")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_compare.main([f"--data_path={checkpoints['roots']['port']}", "--dataset_subset=usa",
                          "--dataset_dem=same", "--compare=two", f"--model_1_path={p}", f"--model_2_path={p}"])


# -------------------------------------------------------------- the writers

def test_indexed_csv_matches_pandas(tmp_path):
    rows = {"Model A": {"PSNR": 18.25, "SSIM": float("nan"), "IoU": 1 / 3},
            "B": {"PSNR": -0.1, "SSIM": 2e-17, "IoU": 123456789.125}}
    want = pd.DataFrame(rows).transpose()
    want.index.name = "Model"
    want.to_csv(tmp_path / "want.csv")
    write_indexed_csv(str(tmp_path / "got.csv"), rows, "Model")
    assert (tmp_path / "got.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()


def test_records_csv_matches_pandas(tmp_path):
    records = [{"Metric_Model": "SSIM_B", "x-1": 0.5, "y": float("nan")},
               {"Metric_Model": "F1_Flood_A", "x-1": 1e-9, "y": 7.0}]
    pd.DataFrame(records).sort_values(["Metric_Model"]).to_csv(tmp_path / "want.csv", index=False)
    write_records_csv(str(tmp_path / "got.csv"), sorted(records, key=lambda r: r["Metric_Model"]))
    assert (tmp_path / "got.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()
