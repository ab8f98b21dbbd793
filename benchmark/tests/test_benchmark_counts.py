"""The benchmark's own operation and byte counts, from the configurations'
layer tables, against what the plain reference runs: FlopCounterMode
over its steps and forward, and the instance norms and reflect pads it
calls, forward and backward, at a small size."""

from __future__ import annotations

import contextlib
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_fixtures import CPU, few_threads, small_cell
from benchlib import counts, inputs, weights
from reference import nets, steps

few_threads()


def _batches(config, seed):
    return [(x.permute(0, 3, 1, 2).contiguous(), y.permute(0, 3, 1, 2).contiguous())
            for x, y in inputs.train_pool(config, 1, seed, CPU)]


def _step(config, state, batches):
    if config["step"] == "paired":
        return steps.paired_steps(state, batches, config["recipe"])
    return steps.cycle_steps(state, batches, config["recipe"], block=config["batch"])


@pytest.mark.parametrize("name", ["pairedattention.train", "attentiongan.train"])
def test_train_flops_are_flop_counter_modes(name):
    config = small_cell(name).config
    state = weights.make_state(config, 21, CPU)
    batches = _batches(config, 21)
    with FlopCounterMode(display=False) as counter:
        _step(config, state, batches)
    assert counts.work(config, "train").flops == counter.get_total_flops()


def test_serve_flops_are_flop_counter_modes():
    config = small_cell("pairedattention.serve_tiles").config
    gen = weights.make_state(config, 22, CPU, only={"generator"})["generator"]
    tiles = inputs.tile_pool(config, 3, 22, CPU)
    with FlopCounterMode(display=False) as counter:
        steps.serve_outputs(gen, tiles)
    assert counts.work(config, "serve").flops * 3 == counter.get_total_flops()


class _Tally:
    """The elements the reference's instance norms and reflect pads read and
    write, forward and, through hooks on their outputs, backward."""

    def __init__(self):
        self.w = counts.Work()

    @contextlib.contextmanager
    def watching(self, elem):
        norm, pad = nets.instance_norm, nets.reflect_pad

        def instance_norm(x, slope=None, residual=None):
            y = norm(x, slope, residual)
            n, planes = x.numel(), x.shape[0] * x.shape[1]
            grad = y.requires_grad
            self.w.in_fwd_sites += 1
            self.w.in_fwd_bytes += (3 if residual is not None else 2) * n * elem + (planes * 8 if grad else 0)
            if grad:
                y.register_hook(lambda g: self._in_bwd(n, planes, elem))
            return y

        def reflect_pad(x, p):
            y = pad(x, p)
            self.w.pad_fwd_sites += 1
            self.w.pad_fwd_bytes += (x.numel() + y.numel()) * elem
            if x.requires_grad:
                y.register_hook(lambda g: self._pad_bwd(x.numel(), y.numel(), elem))
            return y

        nets.instance_norm, nets.reflect_pad = instance_norm, reflect_pad
        try:
            yield self
        finally:
            nets.instance_norm, nets.reflect_pad = norm, pad

    def _in_bwd(self, n, planes, elem):
        self.w.in_bwd_sites += 1
        self.w.in_bwd_bytes += 3 * n * elem + planes * 8

    def _pad_bwd(self, plain, padded, elem):
        self.w.pad_bwd_sites += 1
        self.w.pad_bwd_bytes += (plain + padded) * elem


@pytest.mark.parametrize("name", ["pairedattention.train", "attentiongan.train"])
def test_train_bytes_are_the_references_sites(name):
    config = small_cell(name).config
    state = weights.make_state(config, 23, CPU)
    batches = _batches(config, 23)
    with _Tally().watching(counts.DTYPE_BYTES[config["compute_dtype"]]) as tally:
        _step(config, state, batches)
    assert tally.w == dataclasses.replace(counts.work(config, "train"), flops=0.0)


def test_sites_of_the_full_size_steps():
    """At 512^2, batch 8: the kernels' launch counts a step (K1 34 / K2 34 /
    K6 19 paired, 112 / 112 / 78 AttentionGAN, the kernels' launch counts a step on the card) and
    the bytes chip_smoke.py's bounds are of (K1 1.8111 ms, K2 2.4462 ms,
    K6 0.8947 ms at 3.35 TB/s over the paired step's sites)."""
    paired = counts.work(small_cell("pairedattention.train").config | {"image_size": 512, "batch": 8}, "train")
    cycle = counts.work(small_cell("attentiongan.train").config | {"image_size": 512, "batch": 8}, "train")
    assert (paired.in_fwd_sites, paired.in_bwd_sites, paired.pad_bwd_sites) == (34, 34, 19)
    assert (cycle.in_fwd_sites, cycle.in_bwd_sites, cycle.pad_bwd_sites) == (112, 112, 78)
    hbm = 3.35e12  # the statistics' bytes (8 a plane), no part of chip_smoke's bounds, are 1e-4 of these
    assert paired.in_fwd_bytes / hbm == pytest.approx(1.8111e-3, rel=1e-3)
    assert paired.in_bwd_bytes / hbm == pytest.approx(2.4462e-3, rel=1e-3)
    assert paired.pad_bwd_bytes / hbm == pytest.approx(0.8947e-3, rel=1e-4)
    # tools/bench.py's FlopCounterMode over the program's own paired step reads 1.59 TFLOP a sample.
    assert paired.flops / 8 == pytest.approx(1.593e12, rel=2e-3)
