"""The port's entry points (floodgan_tpu_torch/tools/dryrun.py) against
the root __graft_entry__.py, on the CPU.

- The phase layouts: for n = 2, 4 and 8 ranks, each phase's data stripes
  D, spatial ranks S, global batch and image H x W are those of the JAX dry
  run's sharded arrays (a shard's rows and samples of the global shape):
  ``_mesh_and_batches`` for paired and cycle, the batch over the whole
  mesh for seg and eval, the spatial phase's mesh and images.  The one
  difference is the cycle phase's height where S > 1: the port's PatchGAN
  refuses JAX's 16-row shard, and the phase takes the least it accepts.
- ``python -m floodgan_tpu_torch.tools.dryrun 4 --device cpu`` (its
  ``main``) passes all five phases on 4 gloo ranks.
- ``entry()``'s function gives a (1, 3, 512, 512) image.
- NCCL ranks that do not fit the cards are refused before any process
  starts, never run on gloo instead; an explicit gloo backend puts the
  ranks round the cards.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as jax_entry
from floodgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from floodgan_tpu.parallel.mesh import shard_images as jax_shard_images
from floodgan_tpu_torch.parallel import mesh as mesh_lib
from floodgan_tpu_torch.parallel.spatial import check_patchgan_rows
from floodgan_tpu_torch.tools import dryrun

from torch_seg_fixtures import few_torch_threads


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from few_torch_threads()


def _layout_of(sharded) -> dict:
    """D, S, batch, H, W of a JAX (batch, H, W, C) array sharded over a
    (data, spatial) mesh."""
    batch, h, w, c = sharded.shape
    shard = sharded.sharding.shard_shape(sharded.shape)
    return dict(D=batch // shard[0], S=h // shard[1], batch=batch, H=h, W=w)


def _jax_layouts(n: int) -> dict:
    from jax.sharding import NamedSharding, PartitionSpec

    layouts = {}
    for phase, size in (("paired", 64), ("cycle", 32)):
        _, _, _, _, xs, _ = jax_entry._mesh_and_batches(n, size)
        layouts[phase] = _layout_of(xs)
    mesh = jax_entry._mesh_and_batches(n, 64)[0]
    data_only = NamedSharding(mesh, PartitionSpec(("data", "spatial")))
    for phase in ("seg", "eval"):
        layouts[phase] = _layout_of(jax.device_put(jnp.zeros((n, 64, 64, 3)), data_only))
    spatial = 4 if n % 4 == 0 else 2  # __graft_entry__.py:270-275
    layouts["spatial"] = _layout_of(jax_shard_images(jnp.zeros((n // spatial, 64 * spatial, 32, 9)),
                                                     jax_make_mesh(n, spatial=spatial)))
    return layouts


@pytest.mark.parametrize("n", [2, 4, 8])
def test_phase_layouts_match_jax(n):
    want = _jax_layouts(n)
    for phase in dryrun.PHASES:
        got = dryrun.phase_layout(phase, n)
        if phase == "cycle" and got["S"] > 1:
            jax_rows = want[phase]["H"] // want[phase]["S"]
            with pytest.raises(ValueError, match="conv3/conv4"):
                check_patchgan_rows(jax_rows)
            check_patchgan_rows(dryrun.CYCLE_SHARD_ROWS)
            with pytest.raises(ValueError):
                check_patchgan_rows(dryrun.CYCLE_SHARD_ROWS - 8)
            want[phase]["H"] = dryrun.CYCLE_SHARD_ROWS * got["S"]
        assert got == want[phase], (phase, n)


def test_four_gloo_ranks_pass_every_phase(monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # read by each rank's process
    seconds = dryrun.main(["4", "--device", "cpu"])
    assert list(seconds) == list(dryrun.PHASES)
    out = capsys.readouterr().out
    for phase in dryrun.PHASES:
        assert f"dryrun: {phase} ok" in out


def test_entry_gives_the_generators_image():
    fn, args = dryrun.entry(device="cpu")
    generator, x = args
    assert x.shape == (1, 9, 512, 512) and all(bool((p == 0).all()) for p in generator.parameters())
    with torch.no_grad():
        out = fn(*args)
    assert out.shape == (1, 3, 512, 512) and bool(torch.isfinite(out).all())


def _no_spawn(*args, **kwargs):
    raise AssertionError("a process was started")


@pytest.mark.parametrize("cards", [0, 1])
def test_nccl_that_does_not_fit_is_refused_before_any_spawn(monkeypatch, cards):
    monkeypatch.setattr(mesh_lib, "spawn", _no_spawn)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(ValueError, match=f"requested 2 devices, have {cards}"):
        dryrun.dryrun_multichip(2, "cuda")
    with pytest.raises(ValueError, match=f"requested 2 devices, have {cards}"):
        dryrun.dryrun_multichip(2, "cuda", backend="nccl")


def test_explicit_gloo_shares_one_card(monkeypatch):
    calls = []
    monkeypatch.setattr(mesh_lib, "spawn", lambda fn, n, **kw: calls.append((n, kw)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    dryrun.dryrun_multichip(2, "cuda", backend="gloo")
    assert [kw["args"][0] for _, kw in calls] == list(dryrun.PHASES)
    assert all(n == 2 and kw["backend"] == "gloo" and kw["cards"] == [0, 0] and kw["device_type"] == "cuda"
               for n, kw in calls)
