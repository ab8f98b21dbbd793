"""Data parallelism across processes: the port of the ``data`` axis of
floodgan_tpu/parallel/mesh.py.

The JAX package shards each batch over the ``data`` axis of a GSPMD mesh,
replicates the parameters and the optimizer state, and lets XLA insert the
gradient all-reduce.  The port runs one process per card instead, in one
``torch.distributed`` process group (NCCL on the card, gloo on the CPU):

- ``DataMesh.shard_batch`` keeps this rank's contiguous stripe of a global
  batch, the samples GSPMD's process-major device order gives it
  (``multihost.process_stripe``);
- ``DataMesh.replicate_`` broadcasts parameters from rank 0 at start;
- the trainers all-reduce each network's gradients explicitly after their
  backward (``all_reduce_grads_``: one coalesced SUM, divided by the world
  size, JAX's psum-mean), and report all-reduced loss means;
- batch norm reads global-batch statistics through ``all_reduce_sum_``
  (``ops.nn_ops.batch_norm``), as GSPMD's batch norm averages over the
  sharded batch.

The ``spatial`` axis (H sharded with halo exchanges and cross-shard norm
statistics) is not ported: ``make_mesh(spatial > 1)`` raises.

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

DEFAULT_TIMEOUT_S = 600.0


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def check_devices(num_devices: int, device_type: str) -> None:
    """One rank per card: ``num_devices`` above the cards present raises
    as JAX's ``make_mesh`` does.  CPU ranks are processes, not devices."""
    if device_type == "cuda":
        have = torch.cuda.device_count()
        if num_devices > have:
            raise ValueError(f"requested {num_devices} devices, have {have}")


def _spatial_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "spatial parallelism (num_spatial_devices > 1) is not ported to floodgan_tpu_torch yet: "
        "it waits for ROADMAP.md Queue 1 item 12 (Multi-GPU, the spatial axis)"
    )


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_device(device_type: str, local_rank: int) -> torch.device:
    if device_type == "cuda":
        check_devices(local_rank + 1, "cuda")
        torch.cuda.set_device(local_rank)
        return torch.device("cuda", local_rank)
    return torch.device(device_type)


def init_process_group(world_size: int, rank: int, device_type: str, port: int,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the ``world_size``-rank group at ``tcp://localhost:port`` as
    ``rank``; returns this rank's device (on the card, card ``rank``, made
    the current one)."""
    device = _rank_device(device_type, rank)
    dist.init_process_group(
        backend_for(device_type), init_method=f"tcp://localhost:{port}", world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return device


def join_environment(device_type: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[torch.device]:
    """Join the group a launcher such as torchrun describes (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); returns
    this rank's device, or None where the environment names no group."""
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    device = _rank_device(device_type, int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
    dist.init_process_group(backend_for(device_type), init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def _rank_main(rank: int, fn: Callable, world_size: int, device_type: str, port: int, timeout_s: float,
               args: Sequence) -> None:
    device = init_process_group(world_size, rank, device_type, port, timeout_s=timeout_s)
    try:
        fn(rank, device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: Sequence = (), device_type: str = "cuda",
          timeout_s: float = DEFAULT_TIMEOUT_S, join_timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, device, *args)`` in ``world_size`` new processes, one
    per rank (card ``rank`` on the card), in one group over localhost.
    ``fn`` must be importable by name.  When a process fails the others
    are stopped and this raises; past ``join_timeout_s`` (None: no limit)
    all are killed and ``TimeoutError`` is raised."""
    import torch.multiprocessing as mp

    check_devices(world_size, device_type)
    ctx = mp.start_processes(_rank_main, args=(fn, world_size, device_type, free_port(), timeout_s, tuple(args)),
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
    """The data mesh over the process group this process has joined:
    ``num_devices`` ranks (None: the group's size), one per card.  The
    validation of JAX's ``make_mesh``; ``spatial > 1`` is not ported."""
    if spatial < 1:
        raise ValueError(f"spatial={spatial} must divide the {num_devices}-device mesh")
    if spatial > 1:
        raise _spatial_not_ported()
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {num_devices}-rank data mesh runs one process per rank: start them with "
            "floodgan_tpu_torch.parallel.mesh.spawn, python -m floodgan_tpu_torch.cli.train "
            "--num_data_devices N, or torchrun"
        )
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"requested {num_devices} devices, the process group has {world} ranks")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    check_devices(world, device.type)
    return DataMesh(device)


class DataMesh:
    """This rank's view of the data axis: ``size`` ranks, this one's
    ``rank`` and ``device``, and the collectives the trainers call."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()

    def stripe(self, global_batch: int) -> tuple:
        return process_stripe(global_batch, self.rank, self.size)

    def shard_batch(self, t):
        """This rank's contiguous stripe of a global batch (leading axis)."""
        lo, hi = self.stripe(t.shape[0])
        return t[lo:hi]

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t)
        return t

    def all_reduce_grads_(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Every ``.grad`` of ``params`` replaced by its mean over the
        ranks: one coalesced all-reduce."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(self.size)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def mean(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Scalars (this rank's batch means) -> their means over the ranks,
        the global batch's means for equal stripes."""
        keys = list(values)
        stacked = torch.stack([values[k].detach().float() for k in keys])
        dist.all_reduce(stacked)
        stacked.div_(self.size)
        return dict(zip(keys, stacked.unbind()))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch: every rank's stripe, in rank order."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    @torch.no_grad()
    def replicate_(self, *modules: torch.nn.Module) -> None:
        """Rank 0's parameters on every rank (one coalesced broadcast)."""
        params = [p for m in modules for p in m.parameters()]
        flat = torch.cat([p.reshape(-1) for p in params])
        dist.broadcast(flat, 0)
        for p, part in zip(params, flat.split([p.numel() for p in params])):
            p.copy_(part.view_as(p))

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` (picklable) on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, 0, device=self.device if self.device.type == "cuda" else None)
        return box[0]


def mean_grads(mesh, *modules: torch.nn.Module) -> None:
    """On a mesh, each module's gradients averaged over the ranks (one
    all-reduce a module); without one, nothing."""
    if mesh is not None:
        for m in modules:
            mesh.all_reduce_grads_(m.parameters())
