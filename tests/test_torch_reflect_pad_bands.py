"""K6's band plan (ops/kernels.py: reflect_pad_bands), on the CPU.

The kernel (csrc/reflect_pad.cu) folds each band of a plane's output rows
from one span of g that a bulk copy stages in shared memory, widened to
whole 16-byte chunks.  This file holds the plan that the wrapper passes to
it, over every reflect-pad shape that chip_smoke.py runs on the card (its
PAD_SITES, PAD_EDGES, pad_band_edges and PAD_AT_END): a band's span holds
every padded row that its rows fold from; the bands cover the plane
exactly once; no aligned window reaches past g's first or last 16-byte
chunk, and each fits its stage with the shifted reads' slack; and folding
each band from the bytes of its window alone, in the kernel's order, gives
``reflect_pad_bwd_plain`` and JAX's adjoint
(floodgan_tpu/ops/fused_grads.py: _rp_axis_adjoint, _rp_bwd) bit for bit,
in f32 and bf16.  JAX's adjoint pads each axis evenly, so shapes with
uneven pads are held against the plain version alone.  The kernel itself
is held against the plain version on the card by chip_smoke.py.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floodgan_tpu.ops import fused_grads as jfg
from floodgan_tpu_torch.ops import kernels

from torch_seg_fixtures import few_torch_threads

SEED = 47
_spec = importlib.util.spec_from_file_location(
    "chip_smoke_shapes", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# (label, shape, pads, planes the fold test runs): the sites at one or two
# planes (the plan does not depend on the count), the edge shapes whole.
CASES = (
    [(f"site {label}", shape, pads, 2) for label, shape, pads, _, _ in smoke.PAD_SITES]
    + [(f"edge {i}", shape, pads, shape[0] * shape[1]) for i, (shape, pads) in enumerate(smoke.PAD_EDGES)]
    + [(f"band edge {size} {i}", shape, pads, shape[0] * shape[1])
       for size in (2, 4) for i, (shape, pads) in enumerate(smoke.pad_band_edges(size))]
    + [("at end of block", smoke.PAD_AT_END[0], smoke.PAD_AT_END[1], 15)]
)
DTYPES = (torch.float32, torch.bfloat16)
_INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from few_torch_threads()


def _plan(shape, pads, es):
    h, w = shape[2], shape[3]
    plan = kernels.reflect_pad_bands(h, w, tuple(pads), es)
    return plan, kernels.reflect_pad_band_spans(h, tuple(pads), plan.rows, plan.count)


def _folded_from(h, pads):
    """For each output row h, the padded rows that it folds from."""
    _, _, top, bottom = pads
    rows = {r: [r + top] for r in range(h)}
    for r in range(1, top + 1):
        rows[r].append(top - r)
    for r in range(h - 1 - bottom, h - 1):
        rows[r].append(2 * h - 2 + top - r)
    return rows


@pytest.mark.parametrize("es", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("label,shape,pads,_planes", CASES, ids=[c[0] for c in CASES])
def test_band_plan_covers_the_plane_and_stays_in_g(label, shape, pads, _planes, es):
    n, c, h, w = shape
    left, right, top, bottom = pads
    hp, wp = h + top + bottom, w + left + right
    plan, spans = _plan(shape, pads, es)
    # Every row in exactly one band, in order; the last band holds the rest.
    assert [r for h0, h1, _, _ in spans for r in range(h0, h1)] == list(range(h))
    assert len(spans) == plan.count >= 1
    assert all(h1 - h0 == plan.rows for h0, h1, _, _ in spans[:-1])
    assert plan.count == 1 or plan.rows > max(top, bottom)
    # A band's span holds every padded row that its rows fold from.
    folded = _folded_from(h, pads)
    for h0, h1, q0, q1 in spans:
        assert 0 <= q0 < q1 <= hp
        assert all(q0 <= q < q1 for r in range(h0, h1) for q in folded[r]), (h0, h1, q0, q1)
    # The stages and the barriers fit a block's shared memory: two stages
    # where two fit (all but the widest f32 edge shape), else one.
    assert kernels._BARRIER_BYTES + plan.stages * plan.stage_bytes <= kernels.SHARED_MEMORY_MAX
    two_fit = kernels._BARRIER_BYTES + 2 * plan.stage_bytes <= kernels.SHARED_MEMORY_MAX
    assert plan.stages == (2 if two_fit else 1) and plan.stage_bytes % 128 == 0
    assert plan.stages == (1 if (w, es) == (5000, 4) else 2)
    # Each window (every plane, g at every byte offset its element allows)
    # stays inside g's first and last 16-byte chunks, and the stage holds it
    # with the 16 bytes of the shifted reads past its end.
    planes = n * c
    plane_bytes, row_bytes = hp * wp * es, wp * es
    p = np.arange(planes, dtype=np.int64)
    for off in range(0, 15, es):
        g_lo, g_hi = off // 16 * 16, (off + planes * plane_bytes + 15) // 16 * 16
        for _, _, q0, q1 in spans:
            start = off + p * plane_bytes + q0 * row_bytes
            lo, hi = kernels.reflect_pad_band_window(start, q1 - q0, wp, es)
            assert lo.min() >= g_lo and hi.max() <= g_hi
            head = start - lo
            assert ((head + (q1 - q0) * row_bytes + 15) // 16 * 16 + 16 <= plan.stage_bytes).all()
            assert (hi - lo <= plan.stage_bytes - 16).all()


def _fold_band(span, h0, h1, q0, h, w, pads):
    """The kernel's fold of output rows [h0, h1) from their span (planes,
    q1 - q0, wp): H first, then W, each add in float rounded to the dtype."""
    left, right, top, bottom = pads
    dt = span.dtype
    s = span.float()

    def add(a, b):
        return (a + b).to(dt).float()

    hs = torch.arange(h0, h1)
    f = s[:, hs + top - q0]
    up = (hs >= 1) & (hs <= top)
    if up.any():
        f[:, up] = add(f[:, up], s[:, top - hs[up] - q0])
    down = (hs >= h - 1 - bottom) & (hs <= h - 2)
    if down.any():
        f[:, down] = add(f[:, down], s[:, 2 * h - 2 + top - hs[down] - q0])
    ws = torch.arange(w)
    d = f[:, :, ws + left]
    lc = (ws >= 1) & (ws <= left)
    if lc.any():
        d[:, :, lc] = add(d[:, :, lc], f[:, :, left - ws[lc]])
    rc = (ws >= w - 1 - right) & (ws <= w - 2)
    if rc.any():
        d[:, :, rc] = add(d[:, :, rc], f[:, :, 2 * w - 2 + left - ws[rc]])
    return d.to(dt)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _rp_bwd(g, pad_h, pad_w):
    """fused_grads._rp_bwd with a pad for each axis (NHWC)."""
    return jfg._rp_axis_adjoint(jfg._rp_axis_adjoint(g, pad_h, 1), pad_w, 2)


def _jax_adjoint(g: torch.Tensor, pads) -> torch.Tensor:
    """The bits of JAX's _rp_bwd of g (NCHW, one even pad an axis), in g's
    dtype, back in NCHW."""
    left, _, top, _ = pads
    ints = np.int32 if g.dtype == torch.float32 else np.int16
    bits = g.permute(0, 2, 3, 1).contiguous().view(_INT[g.dtype]).numpy()
    a = jnp.asarray(bits.view(np.float32 if g.dtype == torch.float32 else jnp.bfloat16))
    out = np.array(_rp_bwd(a, top, left))
    return torch.from_numpy(out.view(ints)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("label,shape,pads,planes", CASES, ids=[c[0] for c in CASES])
def test_folding_each_band_from_its_window_is_bit_for_bit(label, shape, pads, planes, dtype):
    _, _, h, w = shape
    left, right, top, bottom = pads
    hp, wp = h + top + bottom, w + left + right
    es = torch.empty((), dtype=dtype).element_size()
    rng = np.random.default_rng(SEED)
    numel = planes * hp * wp
    off = (7 * es) % 16  # g a few bytes into its block, as the card's edge cases put it
    block = torch.from_numpy(rng.standard_normal(numel + 32 // es, dtype=np.float32)).to(dtype)
    g = block[off // es:off // es + numel].view(1, planes, hp, wp)
    memory = block.view(torch.uint8)
    plan, spans = _plan(shape, pads, es)
    folded = []
    for h0, h1, q0, q1 in spans:
        span = g[0, :, q0:q1]
        # The span as the kernel reads it: from its window's bytes, at the
        # span's offset in the window (the first, second and last planes).
        for p in sorted({0, min(1, planes - 1), planes - 1}):
            start = off + (p * hp + q0) * wp * es
            lo, hi = kernels.reflect_pad_band_window(start, q1 - q0, wp, es)
            window = memory[lo:hi]
            staged = window[start - lo:start - lo + (q1 - q0) * wp * es].view(dtype).view(q1 - q0, wp)
            assert torch.equal(staged.view(_INT[dtype]), span[p].view(_INT[dtype]))
        folded.append(_fold_band(span, h0, h1, q0, h, w, pads))
    got = torch.cat(folded, dim=1).view(1, planes, h, w)
    want = kernels.reflect_pad_bwd_plain(g, pads)
    assert torch.equal(got.view(_INT[dtype]), want.view(_INT[dtype])), f"{plan}: not the plain version's bits"
    if left == right and top == bottom:
        assert torch.equal(got.view(_INT[dtype]), _jax_adjoint(g, pads)), f"{plan}: not JAX's bits"


def test_a_band_wider_than_shared_memory_is_refused():
    """A padded row too wide for a stage raises before the kernel (a CUDA
    tensor is faked by its device attribute); the widest rows of the main
    paths (the 1030 f32 columns of the 1024^2 head) take stages of ~33 KB."""

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    g = torch.zeros((1, 1, 4, 60002)).as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.reflect_pad_bwd(g, (1, 1, 1, 1))
    assert kernels.reflect_pad_bands(1024, 1024, (3, 3, 3, 3), 4).stage_bytes <= kernels.REFLECT_STAGE_BYTES
