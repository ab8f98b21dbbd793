"""Weight initialisation of the reference's ``initialise_weights``, the
batch-norm layer of the U-Net, the Pix2Pix U-Net and the BatchNorm
PatchGAN, Pix2Pix's dropout, and the switches that put a network on a
data mesh (``set_data_mesh``) or on the mesh's spatial axis
(``set_spatial_mesh``), every network on both.

Conv and transposed-conv weights ~ N(0, 0.02) with zero bias, batch-norm
scale ~ 1 + 0.02 N(0, 1) with zero bias (floodgan_tpu/models/layers.py:16-20,
``conv_init`` and ``bn_scale_init``).  The port's conv layers are plain
``nn.Conv2d`` and ``nn.ConvTranspose2d``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from floodgan_tpu_torch.ops import nn_ops


class BatchNorm2d(nn.Module):
    """BatchNorm2d permanently in training mode (``nn_ops.batch_norm``),
    with ``weight`` (the JAX ``scale``) and ``bias`` and no running
    statistics: they would never be read.  ``mesh`` (set by
    ``set_data_mesh``) makes the statistics the global batch's: summed
    over the data stripes, and with a ``spatial`` group (set by
    ``set_spatial_mesh``) over the spatial ranks too, whose rows together
    make each image.  ``forward(x, replicated=True)`` is for a level whose
    rows every spatial rank holds whole: it sums over the data stripes
    alone, since summing over the group would count each row S times."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.mesh = None
        self.spatial = None

    def forward(self, x: torch.Tensor, replicated: bool = False) -> torch.Tensor:
        mesh = self.mesh
        if mesh is None:
            reduce = None
        elif self.spatial is not None and not replicated:
            reduce = mesh.all_reduce_sum_
        else:
            reduce = mesh.data_reduce_sum_
        return nn_ops.batch_norm(x, self.weight, self.bias, reduce=reduce)


def set_data_mesh(module: nn.Module, mesh) -> nn.Module:
    """Every batch norm of ``module`` reads global-batch statistics over
    ``mesh`` (a ``parallel.mesh.DataMesh``, or None for the local batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.mesh = mesh
    return module


def set_spatial_mesh(module: nn.Module, group) -> nn.Module:
    """The twin of ``set_data_mesh`` for the mesh's spatial axis: every
    layer of ``module`` that reads a ``spatial`` group takes ``group`` (a
    ``parallel.spatial.SpatialGroup``, or None for whole images), so that
    ``module`` runs on this rank's rows of each image; each batch norm
    takes it beside its data mesh.  Every network of the port takes one; a
    module that does not read one raises rather than run on rows as if
    they were images."""
    if group is not None and not any(hasattr(m, "spatial") for m in module.modules()):
        raise ValueError(f"{type(module).__name__} does not run on the rows of a spatial group")
    for m in module.modules():
        if hasattr(m, "spatial"):
            m.spatial = group
    return module


class DropoutStream(NamedTuple):
    """One step's dropout draws on a mesh: every rank draws the global
    batch's mask (``global_batch`` images of ``row_count`` times its own
    rows) from ``generator`` and keeps its own part: images from ``start``
    on and, on the spatial axis, rows from ``row_index`` times its own on,
    so the ranks together draw what one process draws for the whole batch.
    A level whose rows are replicated draws with ``row_count`` 1."""

    generator: torch.Generator
    global_batch: int
    start: int
    row_index: int = 0
    row_count: int = 1


class Dropout(nn.Module):
    """``nn.Dropout`` as floodgan_tpu/models/layers.py:188-199 has it
    (``TorchDropout`` over ``ops.dropout``): inverted dropout, ``x / keep``
    where kept and 0 elsewhere, active in training and at inference alike.
    The reference pins the inference draws with a fixed seed, so the caller
    passes the ``torch.Generator`` (on ``x``'s device) the mask is drawn
    from.  Rate 0 is the identity and draws nothing."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator) -> torch.Tensor:
        """``generator``: a ``torch.Generator``, or a ``DropoutStream``."""
        if self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout at a rate above 0 draws its mask from a generator the caller passes")
        keep = 1.0 - self.rate
        if isinstance(generator, DropoutStream):
            n, c, h, w = x.shape
            shape = (generator.global_batch, c, h * generator.row_count, w)
            draws = torch.rand(shape, generator=generator.generator, device=x.device)
            lo = generator.row_index * h
            draws = draws[generator.start:generator.start + n, :, lo:lo + h]
        else:
            draws = torch.rand(x.shape, generator=generator, device=x.device)
        kept = draws < keep
        return torch.where(kept, x / keep, torch.zeros_like(x))


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every conv weight of ``module`` from N(0, 0.02) and every
    batch-norm scale from 1 + 0.02 N(0, 1), in module order, with
    ``generator`` (a CPU generator: the draws do not depend on the device
    the module lives on), and zero every bias."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator, dtype=torch.float32) * 0.02)
        elif isinstance(m, BatchNorm2d):
            m.weight.copy_(1.0 + 0.02 * torch.randn(m.weight.shape, generator=generator, dtype=torch.float32))
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    return module
