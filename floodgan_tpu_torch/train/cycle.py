"""Cycle adversarial training on the card: the port of
floodgan_tpu/train/cycle.py (CycleGAN and AttentionGAN), image space only.

One ``train_step`` is the JAX step on NCHW tensors:

  forwards: syn_post = G_ab(real_pre), syn_pre = G_ba(real_post), each
            re-concatenated with the condition channels (``_c``), then
            rec_post = G_ab(syn_pre_c), rec_pre = G_ba(syn_post_c);
  G update first, against the *current* Ds: LSGAN(D_post(syn_post_c), 1)
            + LSGAN(D_pre(syn_pre_c), 1) + 10 L1(rec_pre, pre_rgb)
            + 10 L1(rec_post, post_rgb) (+ 5 L1(G_ab(real_post), post_rgb)
            + 5 L1(G_ba(real_pre), pre_rgb) with the identity loss).  Its
            backward takes both generators' parameters as inputs only, so
            it leaves no gradient in the Ds'; one Adam covers both
            generators;
  buffers:  each direction's 50-slot ``ImageBuffer`` takes the detached
            synthetics one item at a time, in batch order;
  D update: one read per D of the reals and the buffered synthetics
            concatenated on the batch axis (exact with instance norm),
            (real + synthetic) x 0.5 per direction; one Adam covers both Ds.

While a torch profiler records, a step records the spans
(``utils.profiling``) ``train.step``, numbered by the caller's ``step``,
and in it ``train.g_update``, ``train.replay`` (the buffers) and
``train.d_update``, each with its card time.

Both Ds read ``input_channels`` channels: a synthetic RGB image carries the
condition channels of its input.  Mixed precision is PairedTrainer's: f32
master parameters, one autocast region per generator or D read, f32 at
every boundary, TF32 off.  The buffers store ``compute_dtype`` (bf16 under
bf16: the D casts its input to bf16 anyway).

``remat=True`` recomputes each generator read in the backward
(``train.remat``), the identity passes included: ``remat_policy="convs"``
(the default) keeps the convolutions' outputs, ``"boundaries"`` the
segment ends, ``"full"`` the read's input only.  Each checkpoint starts
inside its read's autocast region.

With a data ``mesh`` (``parallel.mesh.DataMesh``) each rank takes its
stripe of the global batch; the gradients of each network are averaged
over the ranks before Adam, and the losses returned are the global
batch's means.  The buffers are replicated state updated with the global
batch, as JAX's are: each rank gathers every rank's synthetics, runs the
same draws and queries on them, and keeps its stripe of the result, so
the buffers stay identical on every rank.

On a mesh with a spatial axis (``mesh.spatial``) each rank takes its rows
of its stripe's images (``mesh.shard_images``): the four networks run
shard-wise (``models.layers.set_spatial_mesh``), each loss is this rank's
share of the global mean, and each buffer holds this rank's rows of its
images, (C, H/S, W), gathered over the data group (the ranks with this
rank's spatial index) so that every spatial rank queries the same images'
rows with the same draws and makes the same store and replace decisions.
Every rank issues the same exchanges in the same order: the four
generator reads, the D reads and a remat recompute all run on every rank.
``generate`` runs on whole images with no group.

The buffer's per-item draws (a uniform p and a slot) come from
``core.rng.epoch(epoch, step)`` on the host: the count is
known there, so a step's decisions need no device sync and depend on
(epoch, step) alone, and a resumed run draws what an unbroken run draws.
The JAX package's phase-space step and its stacked-generator ``vmap``
re-express the same math for the TPU and are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from floodgan_tpu_torch.core.config import TrainConfig, _check_model, model_is_cycle
from floodgan_tpu_torch.core.device import full_f32, resolve_device
from floodgan_tpu_torch.core import rng
from floodgan_tpu_torch.models.layers import init_weights, set_spatial_mesh
from floodgan_tpu_torch.models.registry import (
    build_discriminator,
    build_generator,
    generator_image,
    generator_returns_mask,
)
from floodgan_tpu_torch.parallel.mesh import mean_grads
from floodgan_tpu_torch.parallel.spatial import row_stripe
from floodgan_tpu_torch.train import remat as remat_lib
from floodgan_tpu_torch.train.losses import l1_loss, lsgan_mse
from floodgan_tpu_torch.train.optim import adam, apply_adam
from floodgan_tpu_torch.train.paired import _DTYPES, to_nchw
from floodgan_tpu_torch.utils.profiling import span


class ImageBuffer:
    """The reference's 50-image replay buffer as device state: ``images``
    (capacity, C, H, W) in the buffer's dtype and ``count``, the slots
    filled, an int kept on the host (floodgan_tpu/train/cycle.py:44-97).

    ``query_batch`` processes a batch one item at a time, in order, so an
    item may read a slot an earlier item of the same batch wrote.  Until
    the buffer is full an item is stored and returned; after that, with
    p > 0.5 it is stored at ``slot`` and the image it displaced is
    returned, otherwise it is returned and nothing is stored."""

    def __init__(self, capacity: int, shape: Sequence[int], dtype=torch.float32, device="cpu"):
        self.images = torch.zeros((capacity, *shape), dtype=dtype, device=device)
        self.count = 0

    @property
    def capacity(self) -> int:
        return self.images.shape[0]

    def draw(self, n: int, generator: torch.Generator) -> List[Tuple[float, int]]:
        """``n`` items' (p, slot) draws from a CPU ``generator``: p uniform
        in [0, 1), slot uniform over the capacity.  Every item draws both,
        full or not, so the stream does not depend on the buffer's state."""
        p = torch.rand(n, generator=generator, dtype=torch.float64)
        slot = torch.randint(0, self.capacity, (n,), generator=generator)
        return list(zip(p.tolist(), slot.tolist()))

    @torch.no_grad()
    def query_batch(self, images: torch.Tensor, draws: Sequence[Tuple[float, int]]) -> torch.Tensor:
        """(B, C, H, W) synthetics in, the (B, C, H, W) images the D reads
        out, in ``images``' dtype; ``draws`` holds one (p, slot) per item."""
        if len(draws) != images.shape[0]:
            raise ValueError(f"{images.shape[0]} images but {len(draws)} draws")
        out = []
        for img, (p, slot) in zip(images, draws):
            if self.count < self.capacity:
                self.images[self.count].copy_(img)
                self.count += 1
                out.append(img)
            elif p > 0.5:
                old = self.images[slot].to(img.dtype, copy=True)
                self.images[slot].copy_(img)
                out.append(old)
            else:
                out.append(img)
        return torch.stack(out)


class CycleTrainer:
    """The cycle train step and inference forward of one cycle family.

    ``image_hw`` (the whole image's) sizes the replay buffers; on a spatial
    axis each holds this rank's ``buffer_rows`` of it.  The four networks are drawn by
    ``init_weights`` from ``core.rng.init(seed)`` in the
    order G_ab, G_ba, D_pre, D_post (the JAX package splits its init key in
    that order).  ``device=None`` means the card (the mesh's card with a
    ``mesh``), and raises when there is none; pass ``device="cpu"`` to run
    the plain PyTorch versions.
    """

    def __init__(
        self,
        model: str,
        input_channels: int,
        image_hw: Tuple[int, int],
        cfg: TrainConfig = TrainConfig(),
        add_identity_loss: bool = False,
        compute_dtype: str = "float32",
        remat: bool = False,
        remat_policy: str = "convs",
        device=None,
        seed: int = 47,
        mesh=None,
    ):
        self.remat = remat
        self.remat_policy = remat_lib.check_policy(remat_policy, remat_lib.CYCLE_POLICIES)
        self.mesh = mesh
        self.spatial = getattr(mesh, "spatial", None)  # a data-only mesh has none
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device, "CycleTrainer")
        model = _check_model(model)
        if not model_is_cycle(model):
            raise ValueError(f"{model} trains with the paired step, not the cycle one")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
        self.model = model
        self.cfg = cfg
        self.input_channels = input_channels
        self.has_condition = input_channels > 3
        self.add_identity_loss = add_identity_loss
        self.compute_dtype = _DTYPES[compute_dtype]
        self.returns_mask = generator_returns_mask(model)
        draws = rng.init(seed)
        nets = {}
        for name in ("gen_ab", "gen_ba"):
            nets[name] = init_weights(build_generator(model, input_channels), draws)
        for name in ("disc_pre", "disc_post"):
            nets[name] = init_weights(build_discriminator(model, input_channels), draws)
        self.gen_ab, self.gen_ba = nets["gen_ab"].to(self.device), nets["gen_ba"].to(self.device)
        self.disc_post, self.disc_pre = nets["disc_post"].to(self.device), nets["disc_pre"].to(self.device)
        if mesh is not None:
            mesh.replicate_(self.gen_ab, self.gen_ba, self.disc_post, self.disc_pre)
            for net in (self.gen_ab, self.gen_ba, self.disc_post, self.disc_pre):
                set_spatial_mesh(net, self.spatial)
        self.gen_params = list(self.gen_ab.parameters()) + list(self.gen_ba.parameters())
        self.gen_opt = adam(self.gen_params, cfg.adam_b1, cfg.adam_b2)
        self.disc_opt = adam(list(self.disc_post.parameters()) + list(self.disc_pre.parameters()),
                             cfg.adam_b1, cfg.adam_b2)
        h, w = self.image_hw = tuple(image_hw)
        self.buffer_rows = None  # the rows of each buffered image this rank holds (None: all)
        if self.spatial is not None:
            self.buffer_rows = row_stripe(h, self.spatial.index, self.spatial.size)
            h = self.buffer_rows[1] - self.buffer_rows[0]
        shape = (input_channels, h, w)
        self.pre_buffer = ImageBuffer(cfg.buffer_size, shape, self.compute_dtype, self.device)
        self.post_buffer = ImageBuffer(cfg.buffer_size, shape, self.compute_dtype, self.device)

    def _autocast(self):
        return torch.autocast(
            self.device.type, dtype=self.compute_dtype,
            enabled=self.compute_dtype != torch.float32,
        )

    def _gen_region(self, generator: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        return generator_image(generator, self.returns_mask, x.to(self.compute_dtype))

    def gen_apply(self, generator: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        """A generator's output image, f32 whatever the policy (NCHW),
        rematerialised when the trainer says so."""
        with self._autocast():
            if not self.remat:
                out = self._gen_region(generator, x)
            elif self.remat_policy == "boundaries":
                out = generator_image(generator, self.returns_mask, x.to(self.compute_dtype),
                                      run=remat_lib.recompute)
            else:
                out = remat_lib.recompute(self._gen_region, generator, x, policy=self.remat_policy)
        return out.float()

    def disc_apply(self, discriminator: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        """A D's patch logits, f32 whatever the policy (NCHW)."""
        with self._autocast():
            return discriminator(x.to(self.compute_dtype)).float()

    def train_step(self, input_stack, output_image, lr, epoch: int = 0, step: int = 0) -> Dict[str, torch.Tensor]:
        """One G-then-D step on an NHWC batch (numpy or tensor) at learning
        rate ``lr``; the buffers' draws are those of (``epoch``, ``step``).
        On a mesh the batch is this rank's part (``mesh.shard_images`` of
        the global batch).
        Returns the losses under the JAX keys, as f32 scalars on the
        trainer's device."""
        cfg, dev = self.cfg, self.device
        with span("train.step", ident=step, device=dev):
            real_pre = to_nchw(input_stack, dev)
            y = to_nchw(output_image, dev)
            conditions = real_pre[:, 3:]

            def with_cond(rgb):
                return torch.cat([rgb, conditions], 1) if self.has_condition else rgb

            real_post = with_cond(y)
            pre_rgb, post_rgb = real_pre[:, :3], y
            gen, sp = self.gen_apply, self.spatial
            with full_f32():
                with span("train.g_update", device=dev):  # against the current Ds
                    self.gen_opt.zero_grad(set_to_none=True)
                    syn_post_c = with_cond(gen(self.gen_ab, real_pre))
                    syn_pre_c = with_cond(gen(self.gen_ba, real_post))
                    rec_post = gen(self.gen_ab, syn_pre_c)
                    rec_pre = gen(self.gen_ba, syn_post_c)
                    post_gen = lsgan_mse(self.disc_apply(self.disc_post, syn_post_c), 1.0, sp)
                    pre_gen = lsgan_mse(self.disc_apply(self.disc_pre, syn_pre_c), 1.0, sp)
                    pre_to_post = l1_loss(rec_pre, pre_rgb, sp) * cfg.cycle_weight
                    post_to_pre = l1_loss(rec_post, post_rgb, sp) * cfg.cycle_weight
                    total = post_gen + pre_gen + pre_to_post + post_to_pre
                    losses = {
                        "losses_generator_post": post_gen,
                        "losses_generator_pre": pre_gen,
                        "losses_pre_to_post_cycle": pre_to_post,
                        "losses_post_to_pre_cycle": post_to_pre,
                    }
                    if self.add_identity_loss:
                        identity_post = l1_loss(gen(self.gen_ab, real_post), post_rgb, sp) * cfg.identity_weight
                        identity_pre = l1_loss(gen(self.gen_ba, real_pre), pre_rgb, sp) * cfg.identity_weight
                        total = total + identity_post + identity_pre
                        losses["losses_identity_post"] = identity_post
                        losses["losses_identity_pre"] = identity_pre
                    total.backward(inputs=self.gen_params)
                    mean_grads(self.mesh, self.gen_ab, self.gen_ba)
                    apply_adam(self.gen_opt, lr)

                with span("train.replay", device=dev):
                    buffered_pre, buffered_post = self._query_buffers(syn_pre_c.detach(), syn_post_c.detach(),
                                                                      epoch, step)
                b = real_pre.shape[0]

                with span("train.d_update", device=dev):
                    self.disc_opt.zero_grad(set_to_none=True)
                    pred_pre = self.disc_apply(self.disc_pre, torch.cat([real_pre, buffered_pre.float()], 0))
                    pred_post = self.disc_apply(self.disc_post, torch.cat([real_post, buffered_post.float()], 0))
                    real_pre_loss, syn_pre_loss = lsgan_mse(pred_pre[:b], 1.0, sp), lsgan_mse(pred_pre[b:], 0.0, sp)
                    real_post_loss = lsgan_mse(pred_post[:b], 1.0, sp)
                    syn_post_loss = lsgan_mse(pred_post[b:], 0.0, sp)
                    ((real_pre_loss + syn_pre_loss) * cfg.disc_weight
                     + (real_post_loss + syn_post_loss) * cfg.disc_weight).backward()
                    mean_grads(self.mesh, self.disc_post, self.disc_pre)
                    apply_adam(self.disc_opt, lr)

        losses.update({
            "losses_discriminator_pre_real": real_pre_loss,
            "losses_discriminator_post_real": real_post_loss,
            "losses_discriminator_pre_synthetic": syn_pre_loss,
            "losses_discriminator_post_synthetic": syn_post_loss,
        })
        losses = {k: v.detach() for k, v in losses.items()}
        return losses if self.mesh is None else self.mesh.mean(losses)

    def _query_buffers(self, syn_pre: torch.Tensor, syn_post: torch.Tensor, epoch: int, step: int):
        """The images each D reads beside the reals: each buffer queried
        with the batch's detached synthetics and the (epoch, step) draws.
        On a mesh the query runs on the global batch gathered over the
        data group (on a spatial axis, of this rank's rows) on every rank,
        which keeps its stripe."""
        if self.mesh is not None:
            syn_pre, syn_post = self.mesh.all_gather(syn_pre), self.mesh.all_gather(syn_post)
        draws = rng.epoch(epoch, step)
        b = syn_pre.shape[0]
        pre = self.pre_buffer.query_batch(syn_pre, self.pre_buffer.draw(b, draws))
        post = self.post_buffer.query_batch(syn_post, self.post_buffer.draw(b, draws))
        if self.mesh is not None:
            pre, post = self.mesh.shard_batch(pre), self.mesh.shard_batch(post)
        return pre, post

    @torch.no_grad()
    def generate(self, input_stack, direction: str = "ab"):
        """The inference forward of G_ab (``direction="ab"``) or G_ba with
        the f32 parameters (cycle.py:481-483): NHWC stack in, (output
        (N,H,W,3), background mask (N,H,W) or None) out."""
        generator = {"ab": self.gen_ab, "ba": self.gen_ba}[direction]
        # On whole images, with no collective: one rank alone may run it.
        set_spatial_mesh(generator, None)
        try:
            with full_f32():
                res = generator(to_nchw(input_stack, self.device))
        finally:
            set_spatial_mesh(generator, self.spatial)
        out, mask = res if self.returns_mask else (res, None)
        return out.permute(0, 2, 3, 1), mask
