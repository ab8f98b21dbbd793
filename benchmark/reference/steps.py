"""The plain reference of the timed paths: the paired and the cycle train
steps of the reference recipe (models/model.py of
Natasha-R/Flood-Prediction-GAN) and the serving forward.

Each train function runs its steps from the given parameters over the
given batches, in f32 or a control precision, and returns what the
benchmark compares: every step's losses under the program's keys, every
leaf's first gradient (on the host) and its norm, and the norm of every
leaf's change over all the steps (and the cycle step's replay buffers
after them).  Adam is written out here (torch's and optax's form: bias-
corrected moments, eps outside the square root).

The cycle step runs in blocks of images: every operation of it is per
image (instance norms, per-image losses that are means), so summing the
blocks' gradients, each loss scaled by its share of the batch, is the
whole batch's step.  The replay buffers hold their images in f32; their
draws are worked out again from (epoch, step) as the program's stream
defines them (a splitmix64 seed of a CPU ``torch.Generator``; a float64
p and a slot per item, the pre buffer's first).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from reference import nets
from reference.precision import matmul_precision, quantizer

Batch = Tuple[torch.Tensor, torch.Tensor]  # (input stack, target RGB), NCHW f32


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], b1: float, b2: float, eps: float):
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


def lsgan(pred: torch.Tensor, target: float) -> torch.Tensor:
    return (pred - target).square().mean()


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def _leaves(state: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Dict[str, torch.Tensor]]:
    return {net: {k: v.detach().clone().float().requires_grad_() for k, v in params.items()}
            for net, params in state.items()}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def _flat(net: str, d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{net}.{k}": v for k, v in d.items()}


class _Run:
    """The readings kept over a run of steps."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]]):
        self.start = {f"{n}.{k}": v.detach().clone() for n, d in params.items() for k, v in d.items()}
        self.losses: List[Dict[str, float]] = []
        self.grad_norms: Dict[str, float] = {}
        self.first_grads: Dict[str, torch.Tensor] = {}

    def grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """Keep the first step's gradients (flat names) and their norms."""
        if len(self.losses) == 0:
            self.grad_norms.update(_norms(grads))
            self.first_grads.update({k: v.detach().float().cpu() for k, v in grads.items()})

    def finish(self, params) -> dict:
        end = {f"{n}.{k}": v.detach() for n, d in params.items() for k, v in d.items()}
        return {"losses": self.losses, "grad_norms": self.grad_norms, "grads": self.first_grads,
                "change_norms": _norms({k: end[k] - self.start[k] for k in end})}


def paired_steps(state: Dict[str, Dict[str, torch.Tensor]], batches: Sequence[Batch], recipe: dict,
                 precision: str = "float32") -> dict:
    """The paired step (``state``: "generator" and "discriminator"): the D
    update on (x, G(x)) and (x, y), then the G update against the updated
    D, LSGAN + ``l1_weight`` L1, each followed by Adam at ``recipe["lr"]``."""
    quant = quantizer(precision)
    params = _leaves(state)
    gen, disc = params["generator"], params["discriminator"]
    adam = {k: Adam(v, recipe["b1"], recipe["b2"], recipe["eps"]) for k, v in params.items()}
    run = _Run(params)
    with matmul_precision(precision):
        for x, y in batches:
            syn, _ = nets.generator(gen, x, quant)
            d_syn = lsgan(nets.discriminator(disc, torch.cat([x, syn.detach()], 1), quant), 0.0)
            d_real = lsgan(nets.discriminator(disc, torch.cat([x, y], 1), quant), 1.0)
            g = torch.autograd.grad((d_syn + d_real) * recipe["disc_weight"], list(disc.values()))
            run.grads(_flat("discriminator", dict(zip(disc, g))))
            adam["discriminator"].step(disc, dict(zip(disc, g)), recipe["lr"])

            g_adv = lsgan(nets.discriminator(disc, torch.cat([x, syn], 1), quant), 1.0)
            g_l1 = l1(syn, y) * recipe["l1_weight"]
            g = torch.autograd.grad(g_adv + g_l1, list(gen.values()))
            run.grads(_flat("generator", dict(zip(gen, g))))
            adam["generator"].step(gen, dict(zip(gen, g)), recipe["lr"])
            run.losses.append({
                "losses_discriminator_real": float(d_real.detach()),
                "losses_discriminator_synthetic": float(d_syn.detach()),
                "losses_generator_synthetic": float(g_adv.detach()),
                "l1_losses_generator_synthetic": float(g_l1.detach()),
            })
    return run.finish(params)


_MASK64 = (1 << 64) - 1


def _mix(*words: int) -> int:
    z = 0x9E3779B97F4A7C15
    for w in words:
        z = (z + (w & _MASK64) + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


class ReplayBuffer:
    """The 50-image replay buffer: an item is stored and returned until the
    buffer is full; after that, with p > 0.5 it replaces the image at
    ``slot``, which is returned, and otherwise it is returned itself."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.images: List[torch.Tensor] = []

    def query(self, batch: torch.Tensor, draws: torch.Generator) -> torch.Tensor:
        p = torch.rand(batch.shape[0], generator=draws, dtype=torch.float64).tolist()
        slot = torch.randint(0, self.capacity, (batch.shape[0],), generator=draws).tolist()
        out = []
        for img, pi, si in zip(batch, p, slot):
            if len(self.images) < self.capacity:
                self.images.append(img.clone())
                out.append(img)
            elif pi > 0.5:
                out.append(self.images[si])
                self.images[si] = img.clone()
            else:
                out.append(img)
        return torch.stack(out)

    def stored(self) -> torch.Tensor:
        """The stored images, (n, C, H, W) f32 on the host."""
        return torch.stack([img.cpu() for img in self.images]) if self.images else torch.zeros(0, 1, 1, 1)


def cycle_steps(state: Dict[str, Dict[str, torch.Tensor]], batches: Sequence[Batch], recipe: dict,
                precision: str = "float32", block: int = 2) -> dict:
    """The cycle step (``state``: "gen_ab", "gen_ba", "disc_pre",
    "disc_post"): the G update against the current Ds (LSGAN on both
    directions' synthetics + ``cycle_weight`` L1 of both
    reconstructions; one Adam over both generators), the replay buffers,
    then the D update on the reals and the buffered synthetics (one Adam
    over both Ds).  Batch ``i`` is step ``i`` of epoch 0."""
    quant = quantizer(precision)
    params = _leaves(state)
    g_ab, g_ba, d_pre, d_post = (params[k] for k in ("gen_ab", "gen_ba", "disc_pre", "disc_post"))
    gens = {**_flat("gen_ab", g_ab), **_flat("gen_ba", g_ba)}
    discs = {**_flat("disc_pre", d_pre), **_flat("disc_post", d_post)}
    adam_g = Adam(gens, recipe["b1"], recipe["b2"], recipe["eps"])
    adam_d = Adam(discs, recipe["b1"], recipe["b2"], recipe["eps"])
    buffers = ReplayBuffer(recipe["buffer_size"]), ReplayBuffer(recipe["buffer_size"])
    run = _Run(params)
    cw, dw = recipe["cycle_weight"], recipe["disc_weight"]
    with matmul_precision(precision):
        for step, (x, y) in enumerate(batches):
            b = x.shape[0]
            cond = x[:, 3:]
            real_post_all = torch.cat([y, cond], 1)
            losses = dict.fromkeys(("losses_generator_post", "losses_generator_pre",
                                    "losses_pre_to_post_cycle", "losses_post_to_pre_cycle",
                                    "losses_discriminator_pre_real", "losses_discriminator_post_real",
                                    "losses_discriminator_pre_synthetic",
                                    "losses_discriminator_post_synthetic"), 0.0)
            grads = {k: torch.zeros_like(v) for k, v in gens.items()}
            syn_pre_all, syn_post_all = [], []
            for lo in range(0, b, block):
                sl = slice(lo, min(lo + block, b))
                share = (sl.stop - sl.start) / b
                real_pre, real_post, c = x[sl], real_post_all[sl], cond[sl]
                syn_post_c = torch.cat([nets.generator(g_ab, real_pre, quant)[0], c], 1)
                syn_pre_c = torch.cat([nets.generator(g_ba, real_post, quant)[0], c], 1)
                rec_post = nets.generator(g_ab, syn_pre_c, quant)[0]
                rec_pre = nets.generator(g_ba, syn_post_c, quant)[0]
                terms = {
                    "losses_generator_post": lsgan(nets.discriminator(d_post, syn_post_c, quant), 1.0),
                    "losses_generator_pre": lsgan(nets.discriminator(d_pre, syn_pre_c, quant), 1.0),
                    "losses_pre_to_post_cycle": l1(rec_pre, real_pre[:, :3]) * cw,
                    "losses_post_to_pre_cycle": l1(rec_post, y[sl]) * cw,
                }
                g = torch.autograd.grad(sum(terms.values()) * share, list(gens.values()))
                for k, gi in zip(gens, g):
                    grads[k] += gi
                for k, v in terms.items():
                    losses[k] += float(v.detach()) * share
                syn_pre_all.append(syn_pre_c.detach())
                syn_post_all.append(syn_post_c.detach())
            run.grads(grads)
            adam_g.step(gens, grads, recipe["lr"])

            draws = torch.Generator().manual_seed(_mix(0, step))
            buffered_pre = buffers[0].query(torch.cat(syn_pre_all), draws)
            buffered_post = buffers[1].query(torch.cat(syn_post_all), draws)

            grads = {k: torch.zeros_like(v) for k, v in discs.items()}
            for lo in range(0, b, block):
                sl = slice(lo, min(lo + block, b))
                n, share = sl.stop - sl.start, (sl.stop - sl.start) / b
                pred_pre = nets.discriminator(d_pre, torch.cat([x[sl], buffered_pre[sl]], 0), quant)
                pred_post = nets.discriminator(d_post, torch.cat([real_post_all[sl], buffered_post[sl]], 0), quant)
                terms = {
                    "losses_discriminator_pre_real": lsgan(pred_pre[:n], 1.0),
                    "losses_discriminator_pre_synthetic": lsgan(pred_pre[n:], 0.0),
                    "losses_discriminator_post_real": lsgan(pred_post[:n], 1.0),
                    "losses_discriminator_post_synthetic": lsgan(pred_post[n:], 0.0),
                }
                g = torch.autograd.grad(sum(terms.values()) * dw * share, list(discs.values()))
                for k, gi in zip(discs, g):
                    grads[k] += gi
                for k, v in terms.items():
                    losses[k] += float(v.detach()) * share
            run.grads(grads)
            adam_d.step(discs, grads, recipe["lr"])
            run.losses.append(losses)
    out = run.finish(params)
    out["buffers"] = {k: buf.stored() for k, buf in zip(("pre_buffer", "post_buffer"), buffers)}
    return out


@torch.no_grad()
def serve_outputs(gen: Dict[str, torch.Tensor], tiles: torch.Tensor, precision: str = "float32",
                  block: int = 8) -> torch.Tensor:
    """The served images of ``tiles`` (N, H, W, C normalised stacks): the
    generator's image, denormalised, (N, H, W, 3), in blocks of
    ``block`` tiles."""
    quant = quantizer(precision)
    outs = []
    with matmul_precision(precision):
        for lo in range(0, tiles.shape[0], block):
            x = tiles[lo:lo + block].float().permute(0, 3, 1, 2).contiguous()
            outs.append(nets.denormalize(nets.generator(gen, x, quant)[0]).permute(0, 2, 3, 1))
    return torch.cat(outs)
