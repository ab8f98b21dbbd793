"""Paired adversarial training on the card: the port of
floodgan_tpu/train/paired.py for Pix2Pix and PairedAttention.

One ``train_step`` is the JAX ``_adversarial_update`` in image space:

  1. one generator forward, whose graph the G backward reuses;
  2. the D update on (x ⊕ synthetic.detach()) and (x ⊕ y), LSGAN targets
     0 and 1, loss (syn + real) · 0.5;
  3. the G update against the *updated* D, loss LSGAN(D(x ⊕ syn), 1) +
     100 · L1(syn, y).  Its backward takes only the generator's
     parameters as inputs, so it leaves no gradient in D's.

After a step every parameter's ``.grad`` holds that step's gradient, the
one Adam consumed.

Mixed precision follows paired.py:131-157.  The parameters are f32
masters.  Under ``compute_dtype="bfloat16"`` each generator read and each
D read runs in its own ``torch.autocast`` region, so the convolutions run
in bf16, and the generator input and the D input are cast to bf16
explicitly.  The IN statistics and the compose arithmetic stay f32 inside
the kernels.  The generator and D outputs are cast to f32, and the losses
are f32.  One region per read matters: autocast keeps the bf16 copies of
the weights for the life of a region, and the G update must read D's
updated weights.  Every step runs with TF32 off, so the f32 mode is true
f32.

Pix2Pix's dropout draws its masks from ``core.rng.epoch(epoch, step)`` on
the trainer's device, so a step's masks depend on (epoch, step) alone and
a resumed run draws what an unbroken run draws; ``generate``
draws from a fresh seed-47 generator on each call, the reference's
``manual_seed(47)`` before inference.  Its batch-norm PatchGAN reads the
synthetic and the real pairs separately: with batch statistics one 2B
read would not be the same function.

``remat=True`` recomputes the generator read in the backward
(``train.remat``): ``remat_policy="boundaries"`` (the default) one segment
at a time between the generator's ``seg_boundary`` marks, ``"full"`` the
whole read.  The checkpoint starts inside the read's autocast region, so
the recompute runs under the same policy, and Pix2Pix's dropout generator
is rewound at the start of the region, so the recompute draws the same
masks.

With a data ``mesh`` (``parallel.mesh.DataMesh``) each rank takes its
stripe of the global batch: after each backward the network's gradients
are averaged over the ranks before Adam, batch norm reads the global
batch's statistics, Pix2Pix's dropout draws the global batch's masks and
keeps its rows, and the losses returned are the global batch's means.
The ranks then hold the same parameters step after step.

On a mesh with a spatial axis (``mesh.spatial``) each rank takes its rows
of its stripe's images (``mesh.shard_images``): the generator and the D
run shard-wise (``models.layers.set_spatial_mesh``), each loss is this
rank's share of the global mean, and the gradient all-reduce sums the
spatial ranks' partial gradients and averages over the data stripes.
Pix2Pix's batch norms reduce over the data stripes and the spatial ranks
(over the stripes alone at the U-Net's replicated deep levels), and its
dropout draws the rows of the global batch's masks.  Every rank issues
the same exchanges in the same order: the D reads, the D-then-G backward
and a remat recompute all run on every rank.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from floodgan_tpu_torch.core.config import TrainConfig, _check_model, model_is_cycle
from floodgan_tpu_torch.core.device import full_f32, resolve_device
from floodgan_tpu_torch.core import rng
from floodgan_tpu_torch.models.layers import DropoutStream, init_weights, set_data_mesh, set_spatial_mesh
from floodgan_tpu_torch.models.registry import (
    build_discriminator,
    build_generator,
    generator_image,
    generator_is_segmented,
    generator_returns_mask,
)
from floodgan_tpu_torch.parallel.mesh import mean_grads
from floodgan_tpu_torch.train import remat as remat_lib
from floodgan_tpu_torch.train.losses import l1_loss, lsgan_mse
from floodgan_tpu_torch.train.optim import adam, apply_adam

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_nchw(a, device) -> torch.Tensor:
    """An NHWC batch (numpy or tensor) as a contiguous f32 NCHW tensor on
    ``device``."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a, np.float32))
    return t.to(device, torch.float32).permute(0, 3, 1, 2).contiguous()


class PairedTrainer:
    """The paired train step and inference forward of one model family.

    The generator and the conditional D (``input_channels + 3`` channels)
    are drawn by ``init_weights`` from ``core.rng.init(seed)``,
    generator first, unless ``gen_params`` / ``disc_params`` (state dicts)
    are given.  ``device=None`` means the card (the mesh's card with a
    ``mesh``), and raises when there is none; pass ``device="cpu"`` to run
    the plain PyTorch versions.
    """

    def __init__(
        self,
        model: str,
        input_channels: int,
        cfg: TrainConfig = TrainConfig(),
        dropout_rate: float = 0.5,
        compute_dtype: str = "float32",
        remat: bool = False,
        remat_policy: str = "boundaries",
        device=None,
        seed: int = 47,
        gen_params: Optional[Mapping[str, torch.Tensor]] = None,
        disc_params: Optional[Mapping[str, torch.Tensor]] = None,
        mesh=None,
    ):
        self.remat = remat
        self.remat_policy = remat_lib.check_policy(remat_policy, remat_lib.PAIRED_POLICIES)
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device, "PairedTrainer")
        model = _check_model(model)
        if model_is_cycle(model):
            raise ValueError(f"{model} trains with the cycle step, not the paired one")
        self.spatial = getattr(mesh, "spatial", None)  # a data-only mesh has none
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
        self.model = model
        self.cfg = cfg
        self.input_channels = input_channels
        self.compute_dtype = _DTYPES[compute_dtype]
        self.returns_mask = generator_returns_mask(model)
        self.segmented = generator_is_segmented(model)
        self.has_dropout = model == "pix2pix" and dropout_rate > 0
        generator = build_generator(model, input_channels, dropout_rate)
        discriminator = build_discriminator(model, input_channels + 3)
        draws = rng.init(seed)
        init_weights(generator, draws)
        init_weights(discriminator, draws)
        if gen_params is not None:
            generator.load_state_dict(gen_params)
        if disc_params is not None:
            discriminator.load_state_dict(disc_params)
        self.generator = generator.to(self.device)
        self.discriminator = discriminator.to(self.device)
        if mesh is not None:
            mesh.replicate_(self.generator, self.discriminator)
            set_data_mesh(self.generator, mesh)
            set_data_mesh(self.discriminator, mesh)
            set_spatial_mesh(self.generator, self.spatial)
            set_spatial_mesh(self.discriminator, self.spatial)
        self.gen_opt = adam(self.generator.parameters(), cfg.adam_b1, cfg.adam_b2)
        self.disc_opt = adam(self.discriminator.parameters(), cfg.adam_b1, cfg.adam_b2)

    def _nchw(self, a) -> torch.Tensor:
        return to_nchw(a, self.device)

    def _autocast(self):
        return torch.autocast(
            self.device.type, dtype=self.compute_dtype,
            enabled=self.compute_dtype != torch.float32,
        )

    def dropout_generator(self, epoch: int, step: int, local_batch: int = 0):
        """The generator of step ``step`` of epoch ``epoch``'s dropout masks
        on the trainer's device (None without dropout); on a mesh, the
        ``DropoutStream`` of this rank's ``local_batch`` images (and on a
        spatial axis, of its rows of them)."""
        if not self.has_dropout:
            return None
        g = rng.epoch(epoch, step, self.device)
        if self.mesh is None:
            return g
        stream = DropoutStream(g, local_batch * self.mesh.size, self.mesh.stripe(local_batch * self.mesh.size)[0])
        if self.spatial is not None:
            stream = stream._replace(row_index=self.spatial.index, row_count=self.spatial.size)
        return stream

    def _gen_region(self, x: torch.Tensor, dropout_generator=None) -> torch.Tensor:
        return generator_image(self.generator, self.returns_mask, x.to(self.compute_dtype), dropout_generator)

    def gen_apply(self, x: torch.Tensor, dropout_generator=None) -> torch.Tensor:
        """The generator's output image, f32 whatever the policy (NCHW),
        rematerialised when the trainer says so."""
        with self._autocast():
            if not self.remat:
                out = self._gen_region(x, dropout_generator)
            elif self.remat_policy == "boundaries" and self.segmented:
                out = generator_image(self.generator, self.returns_mask, x.to(self.compute_dtype),
                                      run=remat_lib.recompute)
            else:  # "full", and "boundaries" for a generator without marks
                g = dropout_generator.generator if isinstance(dropout_generator, DropoutStream) else dropout_generator
                out = remat_lib.recompute(remat_lib.replayable(self._gen_region, g), x, dropout_generator)
        return out.float()

    def disc_apply(self, x: torch.Tensor) -> torch.Tensor:
        """The D's patch logits, f32 whatever the policy (NCHW)."""
        with self._autocast():
            return self.discriminator(x.to(self.compute_dtype)).float()

    def train_step(self, input_stack, output_image, lr, epoch: int = 0, step: int = 0) -> Dict[str, torch.Tensor]:
        """One D-then-G step on an NHWC batch (numpy or tensor) at learning
        rate ``lr``; Pix2Pix's dropout masks are those of (``epoch``,
        ``step``).  On a mesh the batch is this rank's part
        (``mesh.shard_images`` of the global batch).  Returns the four
        losses under the JAX keys, as f32 scalars on the trainer's device."""
        cfg = self.cfg
        x = self._nchw(input_stack)
        y = self._nchw(output_image)
        with full_f32():
            synthetic = self.gen_apply(x, self.dropout_generator(epoch, step, x.shape[0]))

            # ---- discriminator update ----
            self.disc_opt.zero_grad(set_to_none=True)
            loss_d_syn = lsgan_mse(self.disc_apply(torch.cat([x, synthetic.detach()], 1)), 0.0, self.spatial)
            loss_d_real = lsgan_mse(self.disc_apply(torch.cat([x, y], 1)), 1.0, self.spatial)
            ((loss_d_syn + loss_d_real) * cfg.disc_weight).backward()
            mean_grads(self.mesh, self.discriminator)
            apply_adam(self.disc_opt, lr)

            # ---- generator update against the updated D ----
            self.gen_opt.zero_grad(set_to_none=True)
            loss_g_adv = lsgan_mse(self.disc_apply(torch.cat([x, synthetic], 1)), 1.0, self.spatial)
            loss_g_l1 = l1_loss(synthetic, y, self.spatial) * cfg.l1_weight
            (loss_g_adv + loss_g_l1).backward(inputs=list(self.generator.parameters()))
            mean_grads(self.mesh, self.generator)
            apply_adam(self.gen_opt, lr)

        losses = {
            "losses_discriminator_real": loss_d_real.detach(),
            "losses_discriminator_synthetic": loss_d_syn.detach(),
            "losses_generator_synthetic": loss_g_adv.detach(),
            "l1_losses_generator_synthetic": loss_g_l1.detach(),
        }
        return losses if self.mesh is None else self.mesh.mean(losses)

    @torch.no_grad()
    def generate(self, input_stack):
        """The inference forward with the f32 parameters (paired.py:344-350):
        NHWC stack in, (output (N,H,W,3), background mask (N,H,W) or None)
        out.  Pix2Pix's dropout draws from a fresh seed-47 generator, so
        every call with one input shape draws the same masks."""
        x = self._nchw(input_stack)
        # Inference reads its own batch's statistics, on whole images: one
        # rank alone may run it (a plot, an evaluation), so no collective.
        set_data_mesh(self.generator, None)
        set_spatial_mesh(self.generator, None)
        try:
            return self._generate(x)
        finally:
            set_data_mesh(self.generator, self.mesh)
            set_spatial_mesh(self.generator, self.spatial)

    def _generate(self, x: torch.Tensor):
        with full_f32():
            if self.returns_mask:
                out, mask = self.generator(x)
            else:
                g = rng.inference(self.device) if self.has_dropout else None
                out, mask = generator_image(self.generator, False, x, g), None
        return out.permute(0, 2, 3, 1), mask
