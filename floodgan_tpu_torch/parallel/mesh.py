"""The ``(data, spatial)`` mesh across processes: the port of
floodgan_tpu/parallel/mesh.py.

The JAX package shards each batch over the ``data`` axis of a GSPMD mesh
and the image height over its ``spatial`` axis, replicates the parameters
and the optimizer state, and lets XLA insert every collective.  The port
runs one process per rank instead, in one ``torch.distributed`` process
group (NCCL on the card, gloo on the CPU).  Rank ``r`` of a ``D x S`` mesh
has data index ``r // S`` and spatial index ``r % S``, the device order of
JAX's ``np.array(devs).reshape(-1, spatial)``.

- ``DataMesh.shard_batch`` keeps this rank's contiguous stripe of a global
  batch, the samples GSPMD's process-major device order gives it
  (``multihost.process_stripe``), and ``shard_images`` also keeps its rows
  of each image, JAX's ``shard_images``;
- ``DataMesh.replicate_`` broadcasts parameters from rank 0 at start;
- the trainers all-reduce each network's gradients explicitly after their
  backward (``all_reduce_grads_``: one coalesced SUM over every rank,
  divided by the data size: the spatial ranks' partial gradients add up,
  the data ranks' gradients are averaged, JAX's psum-mean), and report
  loss means the same way;
- batch norm reads global-batch statistics through ``all_reduce_sum_``
  (``ops.nn_ops.batch_norm``: over data x spatial where a level's rows are
  sharded) or ``data_reduce_sum_`` (over the data stripes alone, where a
  level's rows are replicated on every spatial rank), as GSPMD's batch
  norm averages over the sharded batch;
- the cycle trainers' replay buffers gather a global batch over the data
  group (``all_gather``): the ranks with this rank's spatial index, whose
  stripes are the same rows of every image;
- with ``spatial > 1`` the mesh carries a ``parallel.spatial.SpatialGroup``
  per stripe: the halo exchanges of the convolutions and the cross-shard
  instance-norm statistics (``parallel.spatial``).

A collective moves device tensors on NCCL and host copies on gloo, which
has no CUDA send or receive: the transport follows the group's backend.
A process group is joined with ``init_process_group`` (an explicit
``tcp://`` address, world size and rank), or from a torchrun environment
with ``join_environment``; ``spawn`` starts one process per rank on this
host and fails as soon as any of them does.  Every group has a timeout,
so a collective that a dead peer never joins raises instead of waiting
forever.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from floodgan_tpu_torch.parallel.multihost import process_stripe
from floodgan_tpu_torch.parallel.spatial import SpatialGroup, row_stripe

DEFAULT_TIMEOUT_S = 600.0


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def check_devices(num_devices: int, device_type: str, backend: Optional[str] = None,
                  devices: Optional[Sequence[int]] = None) -> None:
    """One NCCL rank per card: more NCCL ranks than cards, or two on one
    card (NCCL refuses them), raise as JAX's ``make_mesh`` does.  Gloo
    ranks may share a card; CPU ranks are processes, not devices."""
    if device_type != "cuda":
        return
    have = torch.cuda.device_count()
    cards = list(range(num_devices)) if devices is None else list(devices)
    nccl = (backend or "nccl") == "nccl"
    if nccl and len(set(cards)) < len(cards):
        raise ValueError(f"NCCL takes one rank per card; cards {cards} repeat one (use the gloo backend "
                         "to put several ranks on one card)")
    if any(c >= have for c in cards) or (nccl and num_devices > have):
        raise ValueError(f"requested {num_devices} devices, have {have}")


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_device(device_type: str, card: int) -> torch.device:
    if device_type == "cuda":
        check_devices(card + 1, "cuda", backend="gloo")
        torch.cuda.set_device(card)
        return torch.device("cuda", card)
    return torch.device(device_type)


def init_process_group(world_size: int, rank: int, device_type: str, port: int,
                       timeout_s: float = DEFAULT_TIMEOUT_S, backend: Optional[str] = None,
                       card: Optional[int] = None) -> torch.device:
    """Join the ``world_size``-rank group at ``tcp://localhost:port`` as
    ``rank`` over ``backend`` (None: NCCL on the card, gloo on the CPU);
    returns this rank's device (on the card, card ``card``, by default card
    ``rank``, made the current one)."""
    device = _rank_device(device_type, rank if card is None else card)
    dist.init_process_group(
        backend or backend_for(device_type), init_method=f"tcp://localhost:{port}", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
    )
    return device


def join_environment(device_type: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S,
                     backend: Optional[str] = None) -> Optional[torch.device]:
    """Join the group a launcher such as torchrun describes (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) over
    ``backend`` (None: NCCL on the card, gloo on the CPU); returns this
    rank's device, or None where the environment names no group."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    device = _rank_device(device_type, int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    dist.init_process_group(backend or backend_for(device_type), init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def _rank_main(rank: int, fn: Callable, world_size: int, device_type: str, port: int, timeout_s: float,
               args: Sequence, backend: Optional[str], cards: Optional[Sequence[int]]) -> None:
    device = init_process_group(world_size, rank, device_type, port, timeout_s=timeout_s, backend=backend,
                                card=None if cards is None else cards[rank])
    try:
        fn(rank, device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: Sequence = (), device_type: str = "cuda",
          timeout_s: float = DEFAULT_TIMEOUT_S, join_timeout_s: Optional[float] = None,
          backend: Optional[str] = None, cards: Optional[Sequence[int]] = None) -> None:
    """Run ``fn(rank, device, *args)`` in ``world_size`` new processes, one
    per rank, in one group over localhost: over ``backend`` (None: NCCL on
    the card, gloo on the CPU), rank ``r`` on card ``cards[r]`` (None: card
    ``r``).  ``fn`` must be importable by name.  When a process fails the
    others are stopped and this raises; past ``join_timeout_s`` (None: no
    limit) all are killed and ``TimeoutError`` is raised."""
    import torch.multiprocessing as mp

    check_devices(world_size, device_type, backend=backend or backend_for(device_type), devices=cards)
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, device_type, free_port(), timeout_s, tuple(args), backend,
                          None if cards is None else tuple(cards)),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = None if join_timeout_s is None else time.monotonic() + join_timeout_s
    while not ctx.join(timeout=0.5):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(5)
            raise TimeoutError(f"{world_size} ranks did not finish within {join_timeout_s} s")


def make_mesh(num_devices: Optional[int] = None, spatial: int = 1, device=None) -> "DataMesh":
    """The ``(data, spatial)`` mesh over the process group this process has
    joined: ``num_devices`` ranks (None: the group's size), ``spatial`` of
    them per spatial group.  The validation of JAX's ``make_mesh``.  With
    ``spatial > 1`` every rank builds every data group and every spatial
    group, in one order (``dist.new_group`` is collective), each with
    ``DEFAULT_TIMEOUT_S``."""
    if spatial < 1 or (num_devices is not None and num_devices % spatial):
        raise ValueError(f"spatial={spatial} must divide the {num_devices}-device mesh")
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {num_devices}-rank mesh runs one process per rank: start them with "
            "floodgan_tpu_torch.parallel.mesh.spawn, python -m floodgan_tpu_torch.cli.train "
            "--num_data_devices D --num_spatial_devices S, or torchrun"
        )
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"requested {num_devices} devices, the process group has {world} ranks")
    if spatial < 1 or world % spatial:
        raise ValueError(f"spatial={spatial} must divide the {world}-device mesh")
    backend = dist.get_backend()
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    check_devices(world, device.type, backend=backend,
                  devices=[device.index] * world if device.type == "cuda" and backend != "nccl" else None)
    return DataMesh(device, spatial)


def _staged(t: torch.Tensor, backend: str, op: Callable[[torch.Tensor], None]) -> torch.Tensor:
    """``op(t)`` in place: on ``t`` itself, or on a host copy copied back
    where the backend is gloo and ``t`` lies on the card."""
    if backend == "gloo" and t.is_cuda:
        host = t.cpu()
        op(host)
        t.copy_(host)
    else:
        op(t)
    return t


class DataMesh:
    """This rank's view of the mesh: ``size`` data stripes and this rank's
    ``data_index``, ``spatial_size`` ranks per stripe and
    this rank's ``spatial_index``, its world ``rank`` among ``world_size``,
    its ``device``, the ``spatial`` group (None for ``spatial_size`` 1), the
    ``data_group`` of the ranks with its spatial index (None: the world)
    and the collectives the trainers call."""

    def __init__(self, device, spatial: int = 1):
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.world_size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.spatial_size = spatial
        self.size = self.world_size // spatial
        self.data_index, self.spatial_index = divmod(self.rank, spatial)
        self.spatial = None
        self.data_group = None
        if spatial > 1:
            timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
            # Every rank creates every group, data groups first, in one order.
            for s in range(spatial):
                group = dist.new_group(list(range(s, self.world_size, spatial)), timeout=timeout)
                if s == self.spatial_index:
                    self.data_group = group
            for d in range(self.size):
                ranks = list(range(d * spatial, (d + 1) * spatial))
                group = dist.new_group(ranks, timeout=timeout)
                if d == self.data_index:
                    self.spatial = SpatialGroup(group, ranks, self.spatial_index, self.backend)

    def stripe(self, global_batch: int) -> tuple:
        return process_stripe(global_batch, self.data_index, self.size)

    def shard_batch(self, t):
        """This rank's contiguous stripe of a global batch (leading axis)."""
        lo, hi = self.stripe(t.shape[0])
        return t[lo:hi]

    def shard_images(self, t):
        """JAX's ``shard_images`` for this rank: its stripe of a global NHWC
        batch, and of each image its rows ``[s·H/S, (s+1)·H/S)``."""
        t = self.shard_batch(t)
        if self.spatial_size == 1:
            return t
        lo, hi = row_stripe(t.shape[1], self.spatial_index, self.spatial_size)
        return t[:, lo:hi]

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over every rank (data x spatial), in place."""
        return _staged(t, self.backend, dist.all_reduce)

    def data_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data group (the ranks with this rank's
        spatial index), in place; over every rank without a spatial axis."""
        return _staged(t, self.backend, lambda u: dist.all_reduce(u, group=self.data_group))

    def all_reduce_grads_(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Every ``.grad`` of ``params`` replaced by its sum over the spatial
        ranks and its mean over the data stripes: one coalesced all-reduce
        over every rank, divided by the data size."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce_sum_(flat)
        flat.div_(self.size)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def mean(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Scalars (this rank's batch means, or with a spatial group its
        share of them) -> the global batch's means: summed over every rank,
        divided by the data size."""
        keys = list(values)
        stacked = torch.stack([values[k].detach().float() for k in keys])
        self.all_reduce_sum_(stacked)
        stacked.div_(self.size)
        return dict(zip(keys, stacked.unbind()))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch: every data stripe's ``t``, in stripe order,
        gathered over the data group, so that with a spatial axis each rank
        gathers the same rows of every image as its own."""
        if self.backend == "gloo" and t.is_cuda:
            return self.all_gather(t.cpu()).to(t.device)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.data_group)
        return torch.cat(parts)

    @torch.no_grad()
    def replicate_(self, *modules: torch.nn.Module) -> None:
        """Rank 0's parameters on every rank (one coalesced broadcast)."""
        params = [p for m in modules for p in m.parameters()]
        flat = torch.cat([p.reshape(-1) for p in params])
        _staged(flat, self.backend, lambda t: dist.broadcast(t, 0))
        for p, part in zip(params, flat.split([p.numel() for p in params])):
            p.copy_(part.view_as(p))

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (picklable) on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, 0, device=self.device if self.backend == "nccl" else None)
        return box[0]


def mean_grads(mesh, *modules: torch.nn.Module) -> None:
    """On a mesh, each module's gradients summed over the spatial ranks and
    averaged over the data stripes (one all-reduce a module); without one,
    nothing."""
    if mesh is not None:
        for m in modules:
            mesh.all_reduce_grads_(m.parameters())
