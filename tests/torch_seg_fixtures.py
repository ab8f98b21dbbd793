"""Shared set-up of the U-Net parity tests (test_torch_unet, test_torch_seg,
test_torch_eval): the JAX U-Net's parameters from a seed, as numpy, and the
port's U-Net and segmentation trainer carrying them."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu.models.unet import UNet as JaxUNet
from floodgan_tpu_torch.models.unet import UNet
from floodgan_tpu_torch.train.seg import SegTrainer
from floodgan_tpu_torch.utils import jax_params


@pytest.fixture
def big_tmp(tmp_path):
    """``tmp_path``, removed after the test: a full-width U-Net checkpoint
    (parameters and Adam moments) is 372 MB, and pytest keeps the
    temporary directories of its last three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def few_torch_threads(n=2):
    """Body of a module-scoped fixture: torch's CPU ops on ``n`` threads
    for the module, the previous count restored after it.  The U-Net's
    many small ops at these sizes gain little from more threads and lose
    much when pytest-xdist's workers share the cores; a fixed count also
    fixes the order of torch's CPU reductions on any machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def jax_unet_params(bilinear=False, seed=0):
    """(JAX UNet, a parameter tree of its shapes as numpy arrays drawn from
    ``np.random.default_rng(seed)``) in the reference init's distribution:
    conv weights N(0, 0.02), batch-norm scales 1 + 0.02 N(0, 1), and biases
    0.02 N(0, 1) (zero in the reference, drawn here so that they count).
    The shapes come from ``jax.eval_shape`` of the JAX init, which is much
    faster than running it."""
    model = JaxUNet(bilinear=bilinear)
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3))))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        mean = 1.0 if path[-1].key == "scale" else 0.0
        return (mean + 0.02 * rng.normal(size=leaf.shape)).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def loaded_jax_seg_init(monkeypatch):
    """Replace the JAX ``SegTrainer.init`` (an eager flax init of the
    U-Net, ~20 s on this CPU) by a zero state of the same tree.  Only for
    JAX ``SegmentationModel``s built from a checkpoint, which overwrite
    every leaf of the state with the file's."""
    from floodgan_tpu.train import seg as jax_seg

    _, params = jax_unet_params()
    zeros = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), params)
    monkeypatch.setattr(jax_seg.SegTrainer, "init",
                        lambda self, rng, sample: jax_seg.SegState(params=zeros, opt=self.tx.init(zeros)))


def sharpened_seg_checkpoint(src, dst, factor=100.0):
    """A copy of the seg ``.ckpt`` ``src`` at ``dst`` with the U-Net's last
    1x1 conv scaled by ``factor``: the same masks' signs, logits ``factor``
    times larger.  A briefly trained or random U-Net puts its logits near
    0.05, where some of a few thousand pixels fall within the two
    frameworks' rounding of the 0.5 threshold; scaled, the threshold
    compares exactly, as the tests of masks and confusion counts need."""
    from floodgan_tpu_torch.ckpt import load_checkpoint, save_checkpoint

    meta, raw = load_checkpoint(src)
    outc = raw["params"]["outc"]
    for leaf in ("weight", "bias"):
        outc[leaf] = (np.asarray(outc[leaf]) * np.float32(factor)).astype(np.float32)
    save_checkpoint(dst, meta, raw)
    return dst


def port_unet(params, bilinear=False):
    net = UNet(bilinear=bilinear)
    net.load_state_dict(jax_params.state_dict_from_jax(net, params))
    return net


def port_seg_trainer(params, **kw):
    t = SegTrainer(device="cpu", **kw)
    t.model.load_state_dict(jax_params.state_dict_from_jax(t.model, params))
    return t
