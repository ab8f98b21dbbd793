"""Shared set-up of the comparison tests (test_torch_compare,
test_torch_compare_modes): both packages' compare CLIs on the same
checkpoints, and the cell-by-cell check of their CSVs."""

import contextlib
import csv
import glob
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu.cli import compare as jax_compare
from floodgan_tpu.eval import lpips as jax_lpips
from floodgan_tpu.train import cycle as jax_cycle
from floodgan_tpu.train import paired as jax_paired
import floodgan_tpu.ops as jax_ops
from floodgan_tpu_torch.cli import compare as cli_compare
from floodgan_tpu_torch.data.transforms import denormalize
from floodgan_tpu_torch.eval import lpips
from floodgan_tpu_torch.models.layers import Dropout

from torch_seg_fixtures import loaded_jax_seg_init

IMAGE_METRICS = ("PSNR", "SSIM", "MS-SSIM", "LPIPS")
TOL_METRIC = 1e-5      # PSNR (relative), SSIM, MS-SSIM, LPIPS (absolute)
NEAR_THRESHOLD = 1e-4  # |logit| within which the two frameworks may split


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _zero_init(cls, monkeypatch):
    """Replace a JAX trainer's ``init`` (an eager flax init of every
    network) by zeros of the same tree: the ``Model``s here are built from
    checkpoints, which overwrite every leaf."""
    orig = cls.init

    def init(self, rng, sample_input, sample_output):
        shapes = jax.eval_shape(lambda r, a, b: orig(self, r, a, b), rng, sample_input, sample_output)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    monkeypatch.setattr(cls, "init", init)


def run_both_compare_clis(roots, flags, monkeypatch):
    """The port's and JAX's compare CLIs with ``flags``, each writing into
    its own data directory (``roots``); Pix2Pix's dropout at rate 0 on both
    sides (bit parity of dropout masks across frameworks is impossible).
    Returns the port's ``ModelsGroup`` and both CLIs' stdout."""
    out = io.StringIO()
    loaded_jax_seg_init(monkeypatch)
    _zero_init(jax_paired.PairedTrainer, monkeypatch)
    _zero_init(jax_cycle.CycleTrainer, monkeypatch)
    monkeypatch.setattr(jax_ops, "dropout", lambda x, rate, rng, deterministic=False: x)
    monkeypatch.setattr(Dropout, "forward", lambda self, x, generator: x)
    monkeypatch.setenv("FLOODGAN_LPIPS_FALLBACK", "1")
    monkeypatch.setattr(lpips, "_warned", True)
    monkeypatch.setattr(jax_lpips, "_warned", True)
    with contextlib.redirect_stdout(out):
        group = cli_compare.main([f"--data_path={roots['port']}", *flags, "--device=cpu"])
        jax_compare.main([f"--data_path={roots['jax']}", *flags])
    return group, out.getvalue()


def near_threshold_pixels(group, seg_ckpt):
    """Per model, the pixels of its outputs and of the truth over the split
    whose U-Net logit lies within NEAR_THRESHOLD of 0 (the port's): only
    those may land on opposite sides of the mask threshold in the two
    frameworks, each moving one confusion count to a neighbouring cell."""
    from floodgan_tpu_torch.api.segmentation import SegmentationModel

    seg = SegmentationModel(pretrained_model_path=seg_ckpt, skip_data=True, verbose=False, device="cpu")
    near = {name: 0 for name in group.models}
    pixels = 0
    with pytest.MonkeyPatch.context() as mp:  # the outputs the CLIs scored: dropout at rate 0
        mp.setattr(Dropout, "forward", lambda self, x, generator: x)
        for batch in group.val_loader.epoch_iter(0):
            x, y = batch["input"], batch["output"]
            pixels += y.shape[0] * y.shape[1] * y.shape[2]
            inputs = group.extract_input_topography(x) if group.compare == "topography" else None
            truth = int((seg.predict_logits(denormalize(y)).abs() <= NEAR_THRESHOLD).sum())
            for name, model in group.models.items():
                out, _ = model.generate(inputs[name] if inputs is not None else x)
                near[name] += truth + int((seg.predict_logits(denormalize(out)).abs() <= NEAR_THRESHOLD).sum())
    return near, pixels


def check_csvs_match(roots, prefix, topography, group, seg_ckpt, pixels_per_image):
    """Both CSVs of one comparison (``topography`` is the word its file
    names carry; ``group`` is the port's ``ModelsGroup``), every cell but
    ``Inference``: the image metrics within TOL_METRIC; the mask metrics
    exactly, or, where some pixels of a model lie near the threshold
    (counted only if a mask cell differs), within 4 such pixels of an
    image's count each (a ratio of confusion counts moves by at most about
    2 / its denominator per flipped pixel, and each denominator holds at
    least half an image's pixels)."""
    near = {}
    for info in ("", "grouped_"):
        (got_path,) = glob.glob(f"{roots['port']}/metrics/{prefix}_comparison_{info}{topography}Topography_*.csv")
        (want_path,) = glob.glob(f"{roots['jax']}/metrics/{prefix}_comparison_{info}{topography}Topography_*.csv")
        assert os.path.basename(got_path).split("_date")[0] == os.path.basename(want_path).split("_date")[0]
        got, want = read_csv(got_path), read_csv(want_path)
        assert got[0] == want[0], (got[0], want[0])
        assert [r[0] for r in got] == [r[0] for r in want]
        header = got[0]
        for g_row, w_row in zip(got[1:], want[1:]):
            label = g_row[0]
            if info == "":
                model = label
            else:  # "<metric>_<model>"; metric names hold "_", model names do not
                model = next(m for m in group.models if label.endswith("_" + m))
            for col, g, w in zip(header[1:], g_row[1:], w_row[1:]):
                metric = col if info == "" else label[:-len(model) - 1]
                if metric == "Inference":  # NaN, an empty cell, for the first model under 6 images
                    assert (g == "") == (w == "") and (g == "" or min(float(g), float(w)) > 0.0), (label, g, w)
                    continue
                if metric in IMAGE_METRICS:
                    g, w = float(g), float(w)
                    assert np.isfinite(g) and abs(g - w) <= TOL_METRIC * (abs(w) if metric == "PSNR" else 1.0), \
                        (info, label, col, g, w)
                elif g != w:
                    near = near or near_threshold_pixels(group, seg_ckpt)[0]
                    assert abs(float(g) - float(w)) <= 8 * near[model] / pixels_per_image, (info, label, col, g, w)
        if info == "grouped_":
            keys = [r[0] for r in got[1:]]
            assert keys == sorted(keys)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
