"""The compare CLI's ``topography`` mode against the JAX package's, on the
CPU: six port-written PairedAttention ``.ckpt``s, one per ablation (all,
DEM, flow, river, map, none), each fed its channel slice of the 9-channel
stack through the port's ``data/transforms.slice_topography``.  Both CSVs,
every cell but ``Inference`` (tests/torch_compare_fixtures.py).
"""

import glob
import os
import shutil

import pytest

from floodgan_tpu_torch.api.model import Model
from floodgan_tpu_torch.api.segmentation import SegmentationModel
from floodgan_tpu_torch.utils import jax_params

from fixtures import make_flood_fixture
from torch_compare_fixtures import check_csvs_match, read_csv, run_both_compare_clis
from torch_seg_fixtures import few_torch_threads, jax_unet_params, sharpened_seg_checkpoint

SIZE = 256
ABLATIONS = {"all": "all", "dem": "dem", "flow": "flow", "river": "river", "map": "map", "none": None}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    yield from few_torch_threads()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Data directories for both packages, a seeded PairedAttention .ckpt
    per ablation and the seg .ckpt, all written by the port."""
    roots = {k: str(tmp_path_factory.mktemp(f"modes_{k}")) for k in ("port", "jax")}
    for r in roots.values():
        make_flood_fixture(r, size=SIZE, n_per_disaster=3)
    kw = dict(model="PairedAttention", dataset_subset="usa", dataset_dem="same", data_path=roots["port"],
              metadata_dir=os.path.join(roots["port"], "metadata"), resize=None, device="cpu")
    ckpts = {}
    for i, (flag, topography) in enumerate(ABLATIONS.items()):
        path = Model(topography=topography, seed=21 + i, **kw).save_checkpoint(1)
        ckpts[flag] = shutil.move(path, os.path.join(roots["port"], f"{flag}.ckpt"))
    seg = SegmentationModel(data_path=roots["port"], skip_data=True, verbose=False, device="cpu")
    seg.trainer.model.load_state_dict(jax_params.state_dict_from_jax(seg.trainer.model, jax_unet_params(seed=2)[1]))
    seg_ckpt = sharpened_seg_checkpoint(seg.save_checkpoint(1), os.path.join(roots["port"], "seg.ckpt"))
    yield {"roots": roots, "ckpts": ckpts, "seg": seg_ckpt}
    for d in roots.values():  # six 175 MB GAN checkpoints and a 372 MB U-Net
        shutil.rmtree(d, ignore_errors=True)


def _compare(run, mode, paths, monkeypatch):
    meta = os.path.join(run["roots"]["port"], "metadata")
    flags = [f"--compare={mode}", "--dataset_subset=usa", "--dataset_dem=same", "--topography=all",
             f"--metadata_dir={meta}", "--calculate_metrics", f"--segmentation_model_path={run['seg']}", *paths]
    group, _ = run_both_compare_clis(run["roots"], flags, monkeypatch)
    return group


def test_topography_comparison_csvs_match_jax(checkpoints, monkeypatch):
    paths = [f"--{flag}_topography_path={checkpoints['ckpts'][flag]}" for flag in ABLATIONS]
    group = _compare(checkpoints, "topography", paths, monkeypatch)
    assert list(group.models) == ["All", "DEM", "Flow accumulation", "Distance to rivers", "Map", "None"]
    assert [m.input_channels for m in group.models.values()] == [9, 4, 4, 4, 6, 3]
    check_csvs_match(checkpoints["roots"], "topography", "different", group, checkpoints["seg"], SIZE * SIZE)
    (averaged,) = glob.glob(f"{checkpoints['roots']['port']}/metrics/topography_comparison_differentTopography_*.csv")
    assert [r[0] for r in read_csv(averaged)[1:]] == list(group.models)
