"""The ``spatial`` axis of the mesh: image height sharded over ranks.

GSPMD partitions the JAX package's convolutions over H and inserts every
halo exchange and the cross-shard norm statistics itself
(floodgan_tpu/parallel/mesh.py:11-16).  The port writes them out:

- rank ``s`` of a spatial group of ``S`` holds rows ``[s·h, (s+1)·h)`` of
  each image of its data stripe (``row_stripe``, h = H/S);
- ``halo_pad`` extends a shard by the rows a convolution reads beyond it:
  from its neighbours inside the image (``HaloPad``, whose backward sends
  each halo's gradient back and adds it into the rows it came from), and
  by reflect or zero padding at the image's own top and bottom edge only;
- the layers in their row-sharded form, each exact against the same
  layer on the whole image: the reflect pad of the reflect convolutions
  (``reflect_pad2d``), the zero-padded strided and stride-1 convolutions
  (``conv2d_rows``), the k3 s2 p1 op1 transposed convolution of the ResNet
  generators (``conv_transpose2d_rows``), the k4 s2 p1 one of Pix2Pix
  (``conv_transpose2d_k4_rows``) and the U-Net's align-corners bilinear
  upsample (``bilinear_2x_rows``); the U-Net's k2 s2 transposed
  convolution, its max-pools and every 1x1 or pixel-wise op are local;
- ``gather_rows`` makes a shard's image whole on every rank of the group
  (its backward a reduce-scatter) and ``slice_rows`` cuts a replicated
  image back to this rank's rows: the Pix2Pix U-Net runs its deepest
  levels, narrower than a shard, replicated (``pix2pix_gather_level``);
- the instance norms reduce their per-plane sums over the group
  (``ops.kernels.SpatialInstanceNormAct``), batch norm its channel sums
  over the mesh (``ops.nn_ops.batch_norm``), and a loss mean is the local
  sum over the global element count (``global_numel``).

A layer whose halo is wider than the shard next to it raises a
``ValueError`` that names the layer (``check_generator_rows``,
``check_cyclegan_rows``, ``check_patchgan_rows``, ``check_pix2pix_rows``,
``check_unet_rows``): JAX reshards there, the port does not, and it never
gathers a whole image on its own.

Every exchange and reduction of a layer is issued on every rank of the
group, in the same order; the group's timeout turns a mismatch into an
error instead of a hang.  The transport follows the group's backend: NCCL
moves device tensors (``dist.batch_isend_irecv``), gloo host copies.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from floodgan_tpu_torch.ops import kernels


def row_stripe(height: int, index: int, count: int) -> Tuple[int, int]:
    """Half-open [start, stop) row range of spatial rank ``index`` of
    ``count``: JAX's even split of H over the ``spatial`` axis."""
    if height % count:
        raise ValueError(f"image height {height} must be divisible by num_spatial_devices {count}")
    h = height // count
    return index * h, (index + 1) * h


class SpatialGroup:
    """One data stripe's spatial ranks: ``size`` of them, this rank's
    ``index``, the process ``group`` and its global ``ranks``, and the
    backend, which sets the transport."""

    def __init__(self, group, ranks: List[int], index: int, backend: str):
        self.group = group
        self.ranks = list(ranks)
        self.size = len(ranks)
        self.index = index
        self.backend = backend

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    def _host(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, in place."""
        if self._host(t):
            host = t.cpu()
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def exchange(self, to_prev: Optional[torch.Tensor], to_next: Optional[torch.Tensor],
                 from_prev: Optional[torch.Tensor], from_next: Optional[torch.Tensor]) -> None:
        """Send ``to_prev`` to the rank above and ``to_next`` to the rank
        below, and receive into ``from_prev`` and ``from_next`` (each None
        where there is no such neighbour, or nothing to move)."""
        ops, staged = [], []
        for t, peer, send in ((to_prev, -1, True), (to_next, 1, True), (from_prev, -1, False),
                              (from_next, 1, False)):
            if t is None:
                continue
            if send:
                buf = t.cpu().contiguous() if self._host(t) else t.contiguous()
            elif self._host(t):
                buf = torch.empty(t.shape, dtype=t.dtype)
                staged.append((buf, t))
            else:
                buf = t  # a fresh contiguous tensor
            ops.append((dist.isend if send else dist.irecv, buf, self.ranks[self.index + peer]))
        if not ops:
            return
        if self.backend == "nccl":
            works = dist.batch_isend_irecv([dist.P2POp(op, buf, peer, group=self.group) for op, buf, peer in ops])
        else:
            works = [op(buf, peer, group=self.group) for op, buf, peer in ops]
        for w in works:
            w.wait()
        for buf, t in staged:
            t.copy_(buf)

    def global_numel(self, t: torch.Tensor) -> torch.Tensor:
        """The element count of the whole tensor whose shard ``t`` is (the
        shards may differ in rows): a float64 scalar on ``t``'s device."""
        n = torch.tensor([float(t.numel())], dtype=torch.float64, device=t.device)
        return self.all_reduce_sum_(n)[0]


class HaloPad(torch.autograd.Function):
    """A shard extended by ``top`` rows above and ``bot`` below: inside the
    image the neighbours' boundary rows, at the image's top (bottom) edge
    ``edge_top`` (``edge_bot``) rows of reflect or zero padding.  The
    backward returns the halos' gradients to the ranks they came from,
    which add them into their boundary rows; a reflect edge adds its
    gradient into the rows it mirrors.  Every rank of the group runs the
    forward and the backward, so the exchanges pair up."""

    @staticmethod
    def forward(ctx, x, top, bot, edge_top, edge_bot, mode, group):
        n, c, h, w = x.shape
        up = 0 if group.first else top
        down = 0 if group.last else bot
        above = x.new_empty((n, c, up, w))
        below = x.new_empty((n, c, down, w))
        group.exchange(x[:, :, :bot] if not group.first and bot else None,
                       x[:, :, h - top:] if not group.last and top else None,
                       above if up else None, below if down else None)
        if group.first and edge_top:
            above = x[:, :, 1:edge_top + 1].flip(2) if mode == "reflect" else x.new_zeros((n, c, edge_top, w))
        if group.last and edge_bot:
            below = (x[:, :, h - 1 - edge_bot:h - 1].flip(2) if mode == "reflect"
                     else x.new_zeros((n, c, edge_bot, w)))
        ctx.args = (h, top, bot, mode, group, above.shape[2], below.shape[2])
        return torch.cat([above, x, below], 2)

    @staticmethod
    def backward(ctx, g):
        h, top, bot, mode, group, up, down = ctx.args
        g_above, dx, g_below = g[:, :, :up], g[:, :, up:up + h].clone(), g[:, :, up + h:]
        n, c, _, w = dx.shape
        from_next = g.new_empty((n, c, top, w)) if not group.last and top else None
        from_prev = g.new_empty((n, c, bot, w)) if not group.first and bot else None
        group.exchange(g_above if not group.first and top else None,
                       g_below if not group.last and bot else None, from_prev, from_next)
        if from_prev is not None:
            dx[:, :, :bot] += from_prev
        if from_next is not None:
            dx[:, :, h - top:] += from_next
        if mode == "reflect":
            if group.first and up:
                dx[:, :, 1:up + 1] += g_above.flip(2)
            if group.last and down:
                dx[:, :, h - 1 - down:h - 1] += g_below.flip(2)
        return dx, None, None, None, None, None, None


def halo_pad(x: torch.Tensor, top: int, bot: int, edge_top: int, edge_bot: int, mode: str,
             group: SpatialGroup, layer: str) -> torch.Tensor:
    """``x`` (N, C, h, W) with the rows a layer reads beyond its shard
    (``HaloPad``); raises naming ``layer`` where a neighbour's shard or this
    one is too short for the halo or the reflection."""
    h = x.shape[2]
    need = max(top, bot, edge_top + 1 if mode == "reflect" else 0, edge_bot + 1 if mode == "reflect" else 0, 1)
    if h < need:
        raise ValueError(f"{layer}: a shard of {h} rows is shorter than its halo and padding need ({need})")
    return HaloPad.apply(x, top, bot, edge_top, edge_bot, mode, group)


def reflect_pad2d(x: torch.Tensor, pad: int, group: SpatialGroup, layer: str = "reflect pad") -> torch.Tensor:
    """``ReflectionPad2d(pad)`` of the whole image, on this shard: ``pad``
    halo rows each side, reflected at the image's own edges, and W
    reflect-padded as it is (``kernels.reflect_pad``: its backward is K6,
    deterministic)."""
    return kernels.reflect_pad(halo_pad(x, pad, pad, pad, pad, "reflect", group, layer), (pad, pad, 0, 0))


def conv2d_rows(x: torch.Tensor, conv: torch.nn.Conv2d, top: int, bot: int, group: SpatialGroup,
                layer: str) -> torch.Tensor:
    """A zero-padded ``conv`` (its own stride and padding) of the whole
    image, on this shard: ``top``/``bot`` halo rows, the conv's H padding
    as zero rows at the image's edges, its W padding as it is.  The output
    rows are those whose window starts in this shard (k3 s2 p1: halo 1/0;
    k4 s2 p1: 1/1; k4 s1 p1: 1/2, and the last shard yields one row less)."""
    ph, pw = conv.padding
    ext = halo_pad(x, top, bot, ph, ph, "zeros", group, layer)
    return F.conv2d(ext, conv.weight, conv.bias, stride=conv.stride, padding=(0, pw))


def conv_transpose2d_rows(x: torch.Tensor, deconv: torch.nn.ConvTranspose2d, group: SpatialGroup,
                          layer: str) -> torch.Tensor:
    """The k3 s2 p1 op1 transposed ``deconv`` of the whole image, on this
    shard: one halo row below (none at the image's bottom), the transposed
    convolution as it is, the output cropped to 2h rows (a contiguous
    copy)."""
    h = x.shape[2]
    ext = halo_pad(x, 0, 1, 0, 0, "zeros", group, layer)
    y = F.conv_transpose2d(ext, deconv.weight, deconv.bias, stride=deconv.stride, padding=deconv.padding,
                           output_padding=deconv.output_padding)
    rows = deconv.stride[0] * h
    return y if y.shape[2] == rows else y[:, :, :rows].contiguous()  # the IN kernels take whole NCHW planes


def conv_transpose2d_k4_rows(x: torch.Tensor, deconv: torch.nn.ConvTranspose2d, group: SpatialGroup,
                             layer: str) -> torch.Tensor:
    """The k4 s2 p1 transposed ``deconv`` (Pix2Pix's ups) of the whole image,
    on this shard: one halo row each side (zero rows at the image's edges),
    then the transposed convolution with 3 rows of H padding instead of 1,
    which crops its output to the 2h rows of this shard (output row 2i - 1 +
    k of input row i, k < 4: rows [2sh, 2sh + 2h) read input rows
    [sh - 1, sh + h])."""
    ext = halo_pad(x, 1, 1, 1, 1, "zeros", group, layer)
    return F.conv_transpose2d(ext, deconv.weight, deconv.bias, stride=deconv.stride,
                              padding=(3, deconv.padding[1]))


def bilinear_2x_rows(x: torch.Tensor, height: int, group: SpatialGroup, layer: str) -> torch.Tensor:
    """``F.interpolate(scale_factor=2, mode="bilinear", align_corners=True)``
    of the whole ``height``-row image, on this shard.  Output row o reads
    source rows at the *global* coordinate o (H - 1) / (2H - 1), which lies
    in [sh - 1, sh + h] for this shard's rows [2sh, 2sh + 2h): one halo row
    each side inside the image, none at its edges.  W is interpolated as it
    is, H row by row with the global weights."""
    h = x.shape[2]
    lo = group.index * h
    up = 0 if group.first else 1
    ext = halo_pad(x, 1, 1, 0, 0, "zeros", group, layer)
    ext = F.interpolate(ext, size=(ext.shape[2], 2 * x.shape[3]), mode="bilinear", align_corners=True)
    scale = (height - 1) / (2 * height - 1) if height > 1 else 0.0
    src = torch.arange(2 * lo, 2 * (lo + h), dtype=torch.float64) * scale
    i0 = src.floor().long()
    frac = (src - i0).to(x.dtype).to(x.device).view(1, 1, -1, 1)
    i1 = torch.clamp(i0 + 1, max=height - 1)
    at = (i0 - lo + up).to(x.device), (i1 - lo + up).to(x.device)
    a, b = ext.index_select(2, at[0]), ext.index_select(2, at[1])
    return a * (1 - frac) + b * frac


class GatherRows(torch.autograd.Function):
    """The whole image from every rank's rows (an all-gather over the
    group, concatenated in rank order): the rows become replicated.  The
    backward is a reduce-scatter: each rank's gradient is that of its own
    share of the loss, so the group's gradients are summed and each rank
    keeps its rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.h = group, x.shape[2]
        host = group._host(x)
        part = x.cpu().contiguous() if host else x.contiguous()
        parts = [torch.empty_like(part) for _ in range(group.size)]
        dist.all_gather(parts, part, group=group.group)
        out = torch.cat(parts, 2)
        return out.to(x.device) if host else out

    @staticmethod
    def backward(ctx, g):
        total = ctx.group.all_reduce_sum_(g.contiguous().clone())
        lo = ctx.group.index * ctx.h
        return total[:, :, lo:lo + ctx.h].contiguous(), None


class SliceRows(torch.autograd.Function):
    """This rank's rows of a replicated image; the backward pads the
    gradient with zero rows to the whole image, locally (the sum over the
    group happens once, at the ``GatherRows`` the image came from)."""

    @staticmethod
    def forward(ctx, x, group):
        h = x.shape[2] // group.size
        ctx.lo, ctx.height = group.index * h, x.shape[2]
        return x[:, :, ctx.lo:ctx.lo + h].contiguous()

    @staticmethod
    def backward(ctx, g):
        dx = g.new_zeros((*g.shape[:2], ctx.height, g.shape[3]))
        dx[:, :, ctx.lo:ctx.lo + g.shape[2]] = g
        return dx, None


def gather_rows(x: torch.Tensor, group: SpatialGroup) -> torch.Tensor:
    """The whole image, replicated on every rank of ``group`` (``GatherRows``)."""
    return GatherRows.apply(x, group)


def slice_rows(x: torch.Tensor, group: SpatialGroup) -> torch.Tensor:
    """This rank's rows of a replicated image (``SliceRows``)."""
    return SliceRows.apply(x, group)


def global_mean(t: torch.Tensor, group: Optional[SpatialGroup]) -> torch.Tensor:
    """The mean of the whole tensor ``t`` is a shard of: this shard's sum
    over the global element count, so that the shares of the group add up
    to the mean (and their gradients to its gradient).  Without a group,
    ``t.mean()``."""
    if group is None:
        return t.mean()
    return t.sum() / group.global_numel(t).to(t.dtype)


def _rows_error(layer: str, h: int, need: str) -> ValueError:
    return ValueError(f"{layer}: a shard of {h} rows {need} (the port does not reshard as JAX does)")


def check_generator_rows(h: int, layers: Tuple[str, str, str] = ("conv1", "conv2", "conv3")) -> None:
    """The ResNet generators' constraints on their input's shard height
    (the attention generator's layer names by default, the CycleGAN
    generator's are conv_in, down1, down2): the k7 reflect stem reads 3
    rows beyond and reflects 3 (h >= 4), the two k3 s2 p1 downs (h and h/2
    even), the trunk's reflect-pad-1 convs at h/4 (h/4 >= 2)."""
    stem, down1, down2 = layers
    if h < 4:
        raise _rows_error(f"{stem} (reflect 3, k7)", h, "is shorter than 4")
    if h % 2:
        raise _rows_error(f"{down1} (k3 s2 p1)", h, "is odd")
    if (h // 2) % 2:
        raise _rows_error(f"{down2} (k3 s2 p1)", h // 2, "is odd")
    if h // 4 < 2:
        raise _rows_error("trunk (reflect 1, k3)", h // 4, "is shorter than 2")


def check_cyclegan_rows(h: int) -> None:
    """``check_generator_rows`` under the CycleGAN generator's names."""
    check_generator_rows(h, ("conv_in", "down1", "down2"))


def check_patchgan_rows(h: int) -> None:
    """The PatchGAN's constraints on its input's shard height, either norm:
    three k4 s2 p1 levels (h, h/2, h/4 even), then two k4 s1 p1 convs that
    read 2 rows below and each take one row off the last shard (h/8 >= 3)."""
    for level, layer in enumerate(("conv0 (k4 s2 p1)", "conv1 (k4 s2 p1)", "conv2 (k4 s2 p1)")):
        rows = h >> level
        if rows % 2:
            raise _rows_error(layer, rows, "is odd")
    if h // 8 < 3:
        raise _rows_error("conv3/conv4 (k4 s1 p1)", h // 8, "is shorter than 3")


PIX2PIX_LEVELS = 8


def pix2pix_gather_level(h: int) -> int:
    """The Pix2Pix U-Net's gather level for an input shard of ``h`` rows:
    the first down level i (0-7) whose k4 s2 p1 conv cannot halve its
    shard, because the shard's h / 2^i rows are odd or fewer than 2, or 8
    where every level halves.  Levels from there down to the innermost and
    back up run on the gathered image, replicated on every spatial rank;
    the rest on rows.  At H = 256: S = 2 gives 7 (the innermost conv on the
    gathered 2-row image), S = 4 gives 6; at H = 512, S = 2 gives 8."""
    for level in range(PIX2PIX_LEVELS):
        rows = h >> level
        if rows < 2 or (h % (2 << level)):
            return level
    return PIX2PIX_LEVELS


def check_pix2pix_rows(h: int) -> None:
    """The Pix2Pix U-Net's constraint on its input's shard height: at least
    the outermost down conv halves the shard (``pix2pix_gather_level`` >
    0); below that the port would gather the whole image, which it does
    not."""
    if pix2pix_gather_level(h) == 0:
        raise _rows_error("down0_conv (k4 s2 p1)", h, "is odd or shorter than 2")


UNET_POOLS = ("down1 (max-pool 2)", "down2 (max-pool 2)", "down3 (max-pool 2)", "down4 (max-pool 2)")


def check_unet_rows(h: int) -> None:
    """The segmentation U-Net's constraints on its input's shard height:
    four 2x2 max-pools (h, h/2, h/4, h/8 even: the shards' rows then meet
    at every skip without padding), and the 3x3 convs' one halo row at
    h/16 (h/16 >= 1)."""
    for level, layer in enumerate(UNET_POOLS):
        rows = h >> level
        if rows % 2 or rows < 2:
            raise _rows_error(layer, rows, "is odd or shorter than 2")
