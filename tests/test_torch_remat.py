"""Rematerialisation in the port's paired and segmentation trainers, and
its entry points, on the CPU (the cycle trainer: test_torch_remat_cycle.py;
against JAX: test_torch_remat_jax.py).

- Each policy against the same trainer without remat, from one seeded
  init and one batch, f32 and bf16: ``PairedTrainer`` (PairedAttention
  under ``boundaries`` and ``full`` at 32^2; Pix2Pix at 256^2 with dropout
  rate 0.5 under ``full`` and ``boundaries``, which for a generator
  without marks replays whole) and ``SegTrainer`` (32^2).  A recompute runs
  the same ops on the same inputs, so the step-1 losses are equal exactly;
  the step-1 gradients within 1e-6 of each tensor's norm and the step-2
  losses within rtol 1e-6 (tests/torch_remat_steps.py).  Pix2Pix's masks
  come from an explicit generator that no checkpoint stashes: the region
  rewinds it, so the recompute draws the forward's masks, and it ends
  where one forward leaves it.
- Unknown policies raise JAX's ``ValueError``; ``Model(remat=True)`` for
  the four families, ``SegmentationModel(remat=True)`` and both CLIs'
  ``--remat`` train.
"""

import contextlib
import glob
import io

import numpy as np
import pytest
import torch

from floodgan_tpu_torch.api.model import Model
from floodgan_tpu_torch.api.segmentation import SegmentationModel
from floodgan_tpu_torch.cli import segment as cli_segment
from floodgan_tpu_torch.cli import train as cli_train
from floodgan_tpu_torch.core import rng as port_rng
from floodgan_tpu_torch.train.cycle import CycleTrainer
from floodgan_tpu_torch.train.paired import PairedTrainer
from floodgan_tpu_torch.train.seg import SegTrainer

from fixtures import make_flood_fixture, make_masks_fixture
from torch_remat_steps import CH, SEG_LR, assert_same_step, baseline, batch, threads_and_warm_exp, two_steps


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from threads_and_warm_exp()

# ------------------------------------------------------ remat against none

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["boundaries", "full"])
def test_paired_attention_remat_equals_no_remat(policy, dtype):
    x, y = batch(32)
    make = lambda **kw: PairedTrainer("pairedattention", CH, compute_dtype=dtype, device="cpu", **kw)
    want = baseline(("pairedattention", dtype), make, x, y)
    assert_same_step(two_steps(lambda: make(remat=True, remat_policy=policy), x, y), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["full", "boundaries"])
def test_pix2pix_dropout_remat_equals_no_remat(policy, dtype):
    x, y = batch(256, batch=1)
    make = lambda **kw: PairedTrainer("pix2pix", CH, dropout_rate=0.5, compute_dtype=dtype, device="cpu", **kw)
    want = baseline(("pix2pix", dtype), make, x, y)
    assert_same_step(two_steps(lambda: make(remat=True, remat_policy=policy), x, y), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seg_remat_equals_no_remat(dtype):
    r = np.random.default_rng(9)
    x = r.random((2, 32, 32, 3), dtype=np.float32)
    m = (r.random((2, 32, 32, 1)) > 0.5).astype(np.float32)
    want = two_steps(lambda: SegTrainer(compute_dtype=dtype, device="cpu", seed=3), x, m, SEG_LR)
    got = two_steps(lambda: SegTrainer(compute_dtype=dtype, remat=True, device="cpu", seed=3), x, m, SEG_LR)
    assert_same_step(got, want)


def test_dropout_generator_is_rewound_and_ends_where_one_forward_leaves_it():
    x, _ = batch(256, batch=1)
    t = PairedTrainer("pix2pix", CH, dropout_rate=0.5, device="cpu", remat=True, remat_policy="full")
    xt = t._nchw(x)
    plain, rematted = port_rng.epoch(1, 0), port_rng.epoch(1, 0)
    want = t._gen_region(xt, plain)
    got = t.gen_apply(xt, rematted)
    got.sum().backward()  # the recompute draws again from the rewound state
    assert torch.equal(got, want)
    assert torch.equal(rematted.get_state(), plain.get_state())


# ------------------------------------------------------ the entry points

def test_unknown_policies_raise():
    with pytest.raises(ValueError, match="unknown remat_policy 'convs'"):
        PairedTrainer("pairedattention", CH, device="cpu", remat=True, remat_policy="convs")
    with pytest.raises(ValueError, match="unknown remat_policy 'segments'"):
        CycleTrainer("cyclegan", CH, (32, 32), device="cpu", remat=True, remat_policy="segments")


@pytest.fixture(scope="module")
def flood_data(tmp_path_factory):
    return make_flood_fixture(tmp_path_factory.mktemp("remat_data"), size=32, n_per_disaster=2)


@pytest.mark.parametrize("model,policy", [("PairedAttention", None), ("Pix2Pix", "full"), ("CycleGAN", None),
                                          ("AttentionGAN", "boundaries")])
def test_model_with_remat_trains(flood_data, model, policy):
    data_path, meta_dir = flood_data
    resize = 256 if model == "Pix2Pix" else None
    m = Model(model=model, dataset_subset="usa", dataset_dem="same", data_path=str(data_path), metadata_dir=meta_dir,
              topography="all", resize=resize, batch_size=2, num_epochs=1, remat=True, remat_policy=policy,
              device="cpu")
    assert m.trainer.remat
    assert m.trainer.remat_policy == policy or (
        policy is None and m.trainer.remat_policy == ("convs" if m.model_is_cycle else "boundaries"))
    (m.train_cycle if m.model_is_cycle else m.train_paired)()
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in m.all_losses.values())
    with pytest.raises(ValueError, match="unknown remat_policy"):
        Model(model=model, dataset_subset="usa", dataset_dem="same", data_path=str(data_path),
              metadata_dir=meta_dir, topography="all", resize=resize, remat=True, remat_policy="bogus",
              device="cpu")


def test_train_cli_remat_runs_an_epoch(flood_data):
    data_path, meta_dir = flood_data
    with contextlib.redirect_stdout(io.StringIO()):
        model = cli_train.main(["--model=AttentionGAN", "--dataset_subset=usa", "--dataset_dem=same",
                                f"--data_path={data_path}", f"--metadata_dir={meta_dir}", "--topography=all",
                                "--batch_size=2", "--remat", "--remat_policy=full", "--device=cpu"])
    assert model.trainer.remat and model.trainer.remat_policy == "full"
    assert all(np.isfinite(v[0]) for v in model.all_losses.values())


def test_segmentation_model_and_cli_with_remat(tmp_path):
    data_path, meta_dir = make_masks_fixture(tmp_path, size=32, n=4, seed=11)
    seg = SegmentationModel(remat=True, skip_data=True, verbose=False, device="cpu")
    assert seg.trainer.remat
    with contextlib.redirect_stdout(io.StringIO()):
        model = cli_segment.main(["--train", "--dataset_subset=usa", f"--data_path={data_path}",
                                  f"--metadata_dir={meta_dir}", "--num_epochs=1", "--remat", "--device=cpu"])
    assert model.trainer.remat and len(model.all_losses) == 1 and np.isfinite(model.all_losses[0])
    assert not glob.glob(f"{data_path}/models/*.ckpt")
