"""The port's image-space ops and input transforms against their JAX twins
(floodgan_tpu/ops/nn_ops.py, ops/resize.py, data/transforms.py), on the CPU
at f32.  Inputs come from numpy (seed 47); NHWC/HWIO on the JAX side,
NCHW/OIHW on the port's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from floodgan_tpu import ops as jops
from floodgan_tpu.data.transforms import apply_transformations_batch as j_transform
from floodgan_tpu.ops.resize import resize_bicubic_antialias as j_resize
from floodgan_tpu_torch.data.transforms import apply_transformations_batch, denormalize
from floodgan_tpu_torch.ops import nn_ops
from floodgan_tpu_torch.ops.resize import resize_bicubic_antialias


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.fixture(autouse=True)
def full_f32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("pad", [1, 3])
def test_reflect_pad2d(rng, pad):
    x = rng.standard_normal((2, 9, 11, 5), dtype=np.float32)
    want = jops.reflect_pad2d(jnp.asarray(x), pad)
    got = nn_ops.reflect_pad2d(nchw(x), pad)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


def test_reflect_conv2d(rng):
    x = rng.standard_normal((2, 12, 12, 16), dtype=np.float32)
    w = rng.standard_normal((3, 3, 16, 8), dtype=np.float32) * 0.1
    b = rng.standard_normal((8,), dtype=np.float32)
    want = jops.reflect_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pad=1)
    got = nn_ops.reflect_conv2d(
        nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b), pad=1
    )
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("stride,padding,k", [(2, 1, 3), (1, 0, 7), (1, 0, 1)])
def test_conv2d(rng, stride, padding, k):
    x = rng.standard_normal((2, 16, 16, 6), dtype=np.float32)
    w = rng.standard_normal((k, k, 6, 10), dtype=np.float32) * 0.1
    b = rng.standard_normal((10,), dtype=np.float32)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride, padding=padding)
    got = F.conv2d(
        nchw(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b),
        stride=stride, padding=padding,
    )
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-4)


def test_conv_transpose2d_output_padding(rng):
    x = rng.standard_normal((2, 8, 8, 16), dtype=np.float32)
    w = rng.standard_normal((3, 3, 16, 8), dtype=np.float32) * 0.1  # (kh, kw, Cin, Cout)
    b = rng.standard_normal((8,), dtype=np.float32)
    want = jops.conv_transpose2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=2, padding=1, output_padding=1
    )
    got = F.conv_transpose2d(
        nchw(x), torch.from_numpy(w.transpose(2, 3, 0, 1).copy()), torch.from_numpy(b),
        stride=2, padding=1, output_padding=1,
    )
    assert got.shape == (2, 8, 16, 16)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("in_hw,out_hw", [((64, 48), (32, 24)), ((16, 16), (24, 24)), ((20, 30), (20, 17))])
def test_resize_bicubic_antialias(rng, in_hw, out_hw):
    x = rng.random((2,) + in_hw + (3,), dtype=np.float32)
    want = j_resize(jnp.asarray(x), *out_hw)
    got = resize_bicubic_antialias(torch.from_numpy(x), *out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize(
    "topography,resize,crop",
    [("all", 24, 4), ("map", None, None), (None, 16, None), ("dem", None, 4), ("river", 32, None)],
)
def test_apply_transformations_batch(rng, topography, resize, crop):
    stacks = rng.random((4, 40, 40, 9), dtype=np.float32)
    images = rng.random((4, 40, 40, 3), dtype=np.float32)
    flip = np.array([True, False, True, False])
    crop_index = np.array([0, 3, 2, 1], np.int32)
    want_x, want_y = j_transform(
        stacks, images, flip, crop_index, topography=topography, resize=resize, crop=crop
    )
    got_x, got_y = apply_transformations_batch(
        stacks, images, flip, crop_index, topography=topography, resize=resize, crop=crop
    )
    assert got_x.shape == want_x.shape and got_y.shape == want_y.shape
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-5)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5)


def test_denormalize_clamps():
    x = torch.tensor([-3.0, -1.0, 0.0, 0.5, 1.0, 2.0])
    torch.testing.assert_close(denormalize(x), torch.tensor([0.0, 0.0, 0.5, 0.75, 1.0, 1.0]))
