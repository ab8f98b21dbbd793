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

Rematerialisation (the JAX ``remat`` option) is not ported yet (ROADMAP.md
Queue 1 item 1).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from floodgan_tpu_torch.core.config import TrainConfig, _check_model, model_is_cycle
from floodgan_tpu_torch.core.device import full_f32, resolve_device
from floodgan_tpu_torch.core import rng
from floodgan_tpu_torch.models.layers import init_weights
from floodgan_tpu_torch.models.registry import (
    build_discriminator,
    build_generator,
    generator_image,
    generator_returns_mask,
)
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
    are given.  ``device=None`` means the card, and raises when there is
    none; pass ``device="cpu"`` to run the plain PyTorch versions.
    """

    def __init__(
        self,
        model: str,
        input_channels: int,
        cfg: TrainConfig = TrainConfig(),
        dropout_rate: float = 0.5,
        compute_dtype: str = "float32",
        device=None,
        seed: int = 47,
        gen_params: Optional[Mapping[str, torch.Tensor]] = None,
        disc_params: Optional[Mapping[str, torch.Tensor]] = None,
    ):
        self.device = resolve_device(device, "PairedTrainer")
        model = _check_model(model)
        if model_is_cycle(model):
            raise ValueError(f"{model} trains with the cycle step, not the paired one")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
        self.model = model
        self.cfg = cfg
        self.input_channels = input_channels
        self.compute_dtype = _DTYPES[compute_dtype]
        self.returns_mask = generator_returns_mask(model)
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
        self.gen_opt = adam(self.generator.parameters(), cfg.adam_b1, cfg.adam_b2)
        self.disc_opt = adam(self.discriminator.parameters(), cfg.adam_b1, cfg.adam_b2)

    def _nchw(self, a) -> torch.Tensor:
        return to_nchw(a, self.device)

    def _autocast(self):
        return torch.autocast(
            self.device.type, dtype=self.compute_dtype,
            enabled=self.compute_dtype != torch.float32,
        )

    def dropout_generator(self, epoch: int, step: int) -> Optional[torch.Generator]:
        """The generator of step ``step`` of epoch ``epoch``'s dropout masks
        on the trainer's device (None without dropout)."""
        return rng.epoch(epoch, step, self.device) if self.has_dropout else None

    def gen_apply(self, x: torch.Tensor, dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The generator's output image, f32 whatever the policy (NCHW)."""
        with self._autocast():
            out = generator_image(self.generator, self.returns_mask, x.to(self.compute_dtype), dropout_generator)
        return out.float()

    def disc_apply(self, x: torch.Tensor) -> torch.Tensor:
        """The D's patch logits, f32 whatever the policy (NCHW)."""
        with self._autocast():
            return self.discriminator(x.to(self.compute_dtype)).float()

    def train_step(self, input_stack, output_image, lr, epoch: int = 0, step: int = 0) -> Dict[str, torch.Tensor]:
        """One D-then-G step on an NHWC batch (numpy or tensor) at learning
        rate ``lr``; Pix2Pix's dropout masks are those of (``epoch``,
        ``step``).  Returns the four losses under the JAX keys, as f32
        scalars on the trainer's device."""
        cfg = self.cfg
        x = self._nchw(input_stack)
        y = self._nchw(output_image)
        with full_f32():
            synthetic = self.gen_apply(x, self.dropout_generator(epoch, step))

            # ---- discriminator update ----
            self.disc_opt.zero_grad(set_to_none=True)
            loss_d_syn = lsgan_mse(self.disc_apply(torch.cat([x, synthetic.detach()], 1)), 0.0)
            loss_d_real = lsgan_mse(self.disc_apply(torch.cat([x, y], 1)), 1.0)
            ((loss_d_syn + loss_d_real) * cfg.disc_weight).backward()
            apply_adam(self.disc_opt, lr)

            # ---- generator update against the updated D ----
            self.gen_opt.zero_grad(set_to_none=True)
            loss_g_adv = lsgan_mse(self.disc_apply(torch.cat([x, synthetic], 1)), 1.0)
            loss_g_l1 = l1_loss(synthetic, y) * cfg.l1_weight
            (loss_g_adv + loss_g_l1).backward(inputs=list(self.generator.parameters()))
            apply_adam(self.gen_opt, lr)

        return {
            "losses_discriminator_real": loss_d_real.detach(),
            "losses_discriminator_synthetic": loss_d_syn.detach(),
            "losses_generator_synthetic": loss_g_adv.detach(),
            "l1_losses_generator_synthetic": loss_g_l1.detach(),
        }

    @torch.no_grad()
    def generate(self, input_stack):
        """The inference forward with the f32 parameters (paired.py:344-350):
        NHWC stack in, (output (N,H,W,3), background mask (N,H,W) or None)
        out.  Pix2Pix's dropout draws from a fresh seed-47 generator, so
        every call with one input shape draws the same masks."""
        x = self._nchw(input_stack)
        with full_f32():
            if self.returns_mask:
                out, mask = self.generator(x)
            else:
                g = rng.inference(self.device) if self.has_dropout else None
                out, mask = generator_image(self.generator, False, x, g), None
        return out.permute(0, 2, 3, 1), mask
