"""The spatial axis of the port's mesh on the CPU: the partial instance-norm
forms, each halo'd layer alone on gloo ranks, and the refusals.

- K1s/K1a and K2s/K2a's plain versions over a plane's rows cut into 2, 3
  or 4 uneven shards: the shards' statistics summed, then the apply, equal
  the fused plain versions within 1e-6 in f32 (only the summation order
  differs) and 1e-12 in float64, with the activation and the residual on
  and off.  The backward zeroes g where |yhat| <= 1e-5, where the two
  orders may take opposite sides of the activation's kink.
- Every layer kind of the halo table (the k7 reflect stem and head,
  conv2/conv3, the trunk's reflect-pad-1 convs, the ConvTs, the PatchGAN's
  k4 s2 and k4 s1 convs, two k4 s1 convs in a row, the instance norm,
  Pix2Pix's k4 s2 p1 ConvT, the U-Net's k2 ConvT, k3 p1 conv and
  align-corners bilinear upsample, batch norm over data x spatial, and the
  rows gathered through a replicated level whose batch norm reduces over
  the data stripes alone, cut back to rows) on 2, 3 and 4 gloo ranks
  (tests/torch_spatial_workers.py) against the same layer on the whole
  image, float64: forward and input gradient within 1e-12, the ranks'
  output rows adding up to the whole output's (the k4 s1 convs leave the
  last shard one row short each), and each output contiguous (the IN
  kernels on the card refuse a view).
- Each network of the spatial axis (Pix2Pix, CycleGAN, the U-Net, the
  batch-norm PatchGAN) under ``set_spatial_mesh`` on a 1 x 2 mesh, float64,
  against the whole image: forward and input gradient within 1e-12, the
  parameter gradients summed over the ranks within 1e-10 of each tensor's
  norm; each trainer (CycleGAN, AttentionGAN, Pix2Pix) takes a step on it,
  its two ranks bit for bit equal.
- Refusals: a shard height a layer cannot take raises the ValueError that
  names it, for every network; a module with no spatial layer refuses a
  group; two NCCL ranks on one card are refused before any group starts
  (gloo ranks may share it).
"""

import os
import re
import threading

import numpy as np
import pytest
import torch

from floodgan_tpu_torch.models.layers import set_spatial_mesh
from floodgan_tpu_torch.models.registry import build_discriminator, build_generator
from floodgan_tpu_torch.models.unet import UNet
from floodgan_tpu_torch.ops import kernels
from floodgan_tpu_torch.parallel import mesh as mesh_lib
from floodgan_tpu_torch.parallel import spatial as sp

from torch_spatial_workers import (
    LAYER_KINDS,
    NETWORK_SHAPES,
    TRAINER_MODELS,
    layers_on_ranks,
    networks_on_ranks,
    run_ranks,
)

TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
TOL_LAYER = 1e-12
TOL_F64_GRAD = 1e-10
KINK = 1e-5
CUTS = {2: (0, 9, 23), 3: (0, 5, 14, 23), 4: (0, 4, 10, 17, 23)}  # rows of a 23-row plane
ACTS = {"none": (False, False, 0.0), "relu": (True, False, 0.0), "leaky+residual": (True, True, 0.2),
        "residual": (False, True, 0.0)}
LAYER_RUNS = {2: (4, 32), 4: (4, 32), 3: (3, 24)}  # spatial size: (ranks, image height)


def _plane_batch(dtype):
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.standard_normal((2, 3, 23, 7)) * 2 + 0.5).to(dtype)
    other = torch.from_numpy(r.standard_normal((2, 3, 23, 7))).to(dtype)
    return x, other


def _parts(t, shards):
    cuts = CUTS[shards]
    return [t[:, :, a:b] for a, b in zip(cuts, cuts[1:])]


def _summed_stats(x, shards):
    return sum(kernels.instance_norm_stats_plain(p) for p in _parts(x, shards))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("act", list(ACTS))
def test_partial_forward_forms_sum_to_the_fused_plain(dtype, shards, act):
    relu, with_res, slope = ACTS[act]
    x, res = _plane_batch(dtype)
    res = res if with_res else None
    stats = _summed_stats(x, shards)
    assert stats.shape == (2 * 2 * 3 + 1,) and float(stats[-1]) == 23
    got = torch.cat([kernels.instance_norm_apply_plain(p, stats, relu, r, slope)
                     for p, r in zip(_parts(x, shards), _parts(res, shards) if with_res else [None] * shards)], 2)
    want = kernels.instance_norm_act_plain(x, relu, res, slope)
    assert got.dtype == dtype
    assert float((got - want).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("act", ["none", "relu", "leaky"])
def test_partial_backward_forms_sum_to_the_fused_plain(dtype, shards, act):
    relu, slope = act != "none", 0.2 if act == "leaky" else 0.0
    x, g = _plane_batch(dtype)
    x32 = x.double()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    yhat = (x32 - mean) * torch.rsqrt(x32.var(dim=(2, 3), keepdim=True, unbiased=False) + kernels.EPS)
    if relu:
        g = g.masked_fill(yhat.abs() <= KINK, 0)
    stats = _summed_stats(x, shards)
    gsums = sum(kernels.instance_norm_bwd_stats_plain(p, q, stats, relu, slope)
                for p, q in zip(_parts(x, shards), _parts(g, shards)))
    assert gsums.shape == (2 * 2 * 3,)
    got = torch.cat([kernels.instance_norm_bwd_apply_plain(p, q, stats, gsums, relu, slope)
                     for p, q in zip(_parts(x, shards), _parts(g, shards))], 2)
    want = kernels.instance_norm_act_bwd_plain(x, g, relu, slope)
    assert float((got - want).abs().max()) <= TOL[dtype]


def test_the_cpu_launches_no_partial_kernel():
    x, g = _plane_batch(torch.float32)
    before = dict(kernels.LAUNCHES)
    stats = kernels.instance_norm_stats(x)
    kernels.instance_norm_apply(x, stats)
    kernels.instance_norm_bwd_apply(x, g, stats, kernels.instance_norm_bwd_stats(x, g, stats))
    assert kernels.LAUNCHES == before


# ------------------------------------------------------------ layers on ranks

@pytest.fixture(scope="module")
def layer_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("spatial_layers"))
    runs = {4: (out, (2, 4), (LAYER_RUNS[2][1], LAYER_RUNS[4][1])), 3: (out + "/s3", (3,), (LAYER_RUNS[3][1],))}
    os.makedirs(out + "/s3")
    failures = []

    def launch(world, args):
        try:
            run_ranks(layers_on_ranks, world, args=args)
        except Exception as e:  # re-raised below, on the test's thread
            failures.append(e)

    threads = [threading.Thread(target=launch, args=(w, a)) for w, a in runs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise failures[0]
    res = {}
    for world, (d, spatials, _) in runs.items():
        for r in range(world):
            for s, layers in torch.load(os.path.join(d, f"layers_rank{r}.pt")).items():
                res.setdefault(s, []).append(layers)
    return res


@pytest.mark.parametrize("spatial", [2, 3, 4])
@pytest.mark.parametrize("layer", LAYER_KINDS)
def test_each_layer_on_its_shards_equals_the_whole_image(layer_runs, spatial, layer):
    for ranks_view in layer_runs[spatial]:
        err, derr, counts, whole_rows, contiguous = ranks_view[layer]
        assert len(counts) == spatial and sum(counts) == whole_rows, counts
        assert contiguous  # the IN kernels on the card take whole contiguous NCHW planes
        assert err <= TOL_LAYER and derr <= TOL_LAYER, (err, derr)
    if "k4 s1" in layer:
        counts = layer_runs[spatial][0][layer][2]
        short = 2 if "twice" in layer else 1
        assert counts[-1] == counts[0] - short and len(set(counts[:-1])) == 1


# ------------------------------------------------------------ refusals

def _group(size=2, index=0):
    """A spatial group whose collectives must not run: the checks come first."""
    return sp.SpatialGroup(None, list(range(size)), index, "gloo")


@pytest.mark.parametrize("rows,layer", [(2, "conv1"), (6, "conv3"), (4, "trunk")])
def test_a_generator_shard_too_short_for_a_layer_raises_naming_it(rows, layer):
    gen = set_spatial_mesh(build_generator("pairedattention", 9), _group())
    with pytest.raises(ValueError, match=layer):
        gen(torch.zeros(1, 9, rows, 16))


@pytest.mark.parametrize("rows,layer", [(13, "conv0"), (14, "conv1"), (12, "conv2"), (16, "conv3/conv4")])
def test_a_patchgan_shard_too_short_for_a_layer_raises_naming_it(rows, layer):
    disc = set_spatial_mesh(build_discriminator("pairedattention", 12), _group())
    with pytest.raises(ValueError, match=layer):
        disc(torch.zeros(1, 12, rows, 64))


def test_the_shard_checks_take_the_sizes_the_jax_tests_run():
    for rows in (32, 128, 256):  # 64^2 over 2, 512 rows over 4, 512^2 over 2
        sp.check_generator_rows(rows)
        sp.check_patchgan_rows(rows)


# ------------------------------------------------------------ the networks of the spatial axis

@pytest.fixture(scope="module")
def network_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("spatial_networks"))
    run_ranks(networks_on_ranks, 2, args=(out,))
    return [torch.load(os.path.join(out, f"networks_rank{r}.pt")) for r in range(2)]


@pytest.mark.parametrize("net", list(NETWORK_SHAPES))
def test_each_network_on_its_shards_equals_the_whole_image(network_runs, net):
    """Forward, input gradient and the parameter gradients summed over the
    ranks, float64, 1 x 2 mesh; a conv bias that feeds a norm has a true
    gradient of 0, held to 1e-12 absolute."""
    for rank in network_runs:
        res = rank["networks"][net]
        assert sum(res["rows"]) == res["whole_rows"], res["rows"]
        assert res["err"] <= TOL_LAYER and res["derr"] <= TOL_LAYER, (res["err"], res["derr"])
        for name, (err, norm) in res["grads"].items():
            assert err <= max(TOL_F64_GRAD * norm, TOL_LAYER), (name, err, norm)


@pytest.mark.parametrize("model", list(TRAINER_MODELS))
def test_each_trainer_takes_a_step_on_a_spatial_mesh(network_runs, model):
    a, b = (rank["trainers"][model] for rank in network_runs)
    assert a == b  # losses and a digest of every parameter's bytes, bit for bit
    assert all(np.isfinite(v) for v in a["losses"].values())


# (network, spatial size, a shard it cannot take, the layer the error names);
# Pix2Pix takes any height divisible by 256 whose shard halves once.
TOO_SHORT = {
    "pix2pix": (lambda: build_generator("pix2pix", 9), 256, (1, 9, 1, 256), "down0_conv"),
    "cyclegan": (lambda: build_generator("cyclegan", 9), 2, (1, 9, 6, 16), "down2"),
    "unet": (lambda: UNet(), 2, (1, 3, 12, 16), "down3 (max-pool 2)"),
    "batch-norm PatchGAN": (lambda: build_discriminator("pix2pix", 12), 2, (1, 12, 16, 64), "conv3/conv4"),
}


@pytest.mark.parametrize("net", list(TOO_SHORT))
def test_a_network_shard_too_short_for_a_layer_raises_naming_it(net):
    build, size, shape, layer = TOO_SHORT[net]
    module = set_spatial_mesh(build(), _group(size))
    with pytest.raises(ValueError, match=re.escape(layer)):
        module(torch.zeros(shape))


def test_the_pix2pix_gather_level_is_a_rule_of_height_and_spatial_size():
    # Input shard rows H/S: the first down level that cannot halve them.
    assert {(h, s): sp.pix2pix_gather_level(h // s) for h, s in ((256, 2), (256, 4), (512, 2), (512, 4), (768, 3))} \
        == {(256, 2): 7, (256, 4): 6, (512, 2): 8, (512, 4): 7, (768, 3): 8}
    assert sp.pix2pix_gather_level(2) == 1 and sp.pix2pix_gather_level(6) == 1 and sp.pix2pix_gather_level(1) == 0


def test_a_module_without_a_spatial_layer_refuses_a_group():
    with pytest.raises(ValueError, match="does not run on the rows"):
        set_spatial_mesh(torch.nn.Conv2d(3, 3, 3), _group())
    set_spatial_mesh(torch.nn.Conv2d(3, 3, 3), None)  # no group: nothing to refuse


def test_two_nccl_ranks_on_one_card_are_refused_before_the_group(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL takes one rank per card"):
        mesh_lib.check_devices(2, "cuda", backend="nccl", devices=[0, 0])
    with pytest.raises(ValueError, match="NCCL takes one rank per card"):
        mesh_lib.spawn(_never_runs, 2, device_type="cuda", backend="nccl", cards=[0, 0])
    mesh_lib.check_devices(2, "cuda", backend="gloo", devices=[0, 0])  # gloo ranks may share a card
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        mesh_lib.check_devices(2, "cuda", backend="gloo", devices=[0, 1])


def _never_runs(rank, device):
    raise AssertionError("a refused spawn started a rank")


def test_row_stripes_tile_the_height():
    assert [sp.row_stripe(512, s, 4) for s in range(4)] == [(0, 128), (128, 256), (256, 384), (384, 512)]
    with pytest.raises(ValueError, match="divisible by num_spatial_devices"):
        sp.row_stripe(30, 0, 4)
