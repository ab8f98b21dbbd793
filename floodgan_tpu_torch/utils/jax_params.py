"""Carry parameters and Adam state between the JAX package's trees and
the port's modules, in both directions.

A JAX parameter tree is what ``AttentionGenerator.init(...)["params"]``
(or the PatchGAN's, or the U-Net's) returns, with numpy arrays (or anything
``np.asarray`` takes) as leaves:
  conv weights   HWIO                  <-> OIHW        (transpose 3, 2, 0, 1)
  convT weights  (kh, kw, C_in, C_out) <-> (C_in, C_out, kh, kw)
                                                      (transpose 2, 3, 0, 1;
                 no spatial flip: the JAX twin flips inside the op)
  biases         as they are
  BN ``scale``   <-> ``weight`` (BN ``bias`` as it is)
The trunk is stored stacked, ``trunk/conv{1,2}_{weight,bias}`` with a
leading block axis; block i is ``trunk.blocks.i``.

Adam: optax's ``ScaleByAdamState{count, mu, nu}`` (``count`` a 0-d int32,
``mu``/``nu`` trees shaped like the parameters) is torch Adam's per
parameter ``{step, exp_avg, exp_avg_sq}``, as
floodgan_tpu/utils/torch_export.py:64-76 maps it.  torch creates its state
at the first step, so ``count == 0`` is "no state".

The cycle trainer's state is the JAX ``CycleState``: both generators
(``{ab, ba}``) and both Ds (``{post, pre}``), an Adam over each pair with
one ``count``, and the two replay buffers (``{images, count}``, images
NHWC).  On a spatial axis a trainer's buffers hold its rows of each image
(``CycleTrainer.buffer_rows``): its tree holds those rows
(``cycle_buffer_rows`` says which, for ``ckpt.sharded``), and loading a
whole tree keeps them.

Key order does not matter to either reader; ``ckpt.save_checkpoint``
writes every map's keys sorted, as JAX does.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from floodgan_tpu_torch.ckpt.checkpoint import BF16Array
from floodgan_tpu_torch.models.layers import BatchNorm2d


def _jax_node(tree: Mapping, module_name: str, jax_leaves) -> Dict[str, np.ndarray]:
    """The arrays ``jax_leaves`` of one port module in the JAX tree."""
    parts = module_name.split(".")
    if parts[0] == "trunk":  # trunk.blocks.<i>.conv<j>
        i, conv = int(parts[2]), parts[3]
        return {leaf: np.asarray(tree["trunk"][f"{conv}_{leaf}"])[i] for leaf in jax_leaves}
    node = tree
    for p in parts:
        node = node[p]
    return {leaf: np.asarray(node[leaf]) for leaf in jax_leaves}


def _modules(model: nn.Module):
    """(module name, {torch leaf: (JAX leaf, JAX -> torch permutation or
    None)}) of each parameterised module, in registration order: convs
    (weight, and bias where the conv has one) and batch norms (the JAX
    ``scale`` is torch's ``weight``)."""
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            perm = (2, 3, 0, 1) if isinstance(mod, nn.ConvTranspose2d) else (3, 2, 0, 1)
            leaves = {"weight": ("weight", perm)}
            if mod.bias is not None:
                leaves["bias"] = ("bias", None)
            yield name, leaves
        elif isinstance(mod, BatchNorm2d):
            yield name, {"weight": ("scale", None), "bias": ("bias", None)}


def state_dict_from_jax(model: nn.Module, tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params (a nested mapping of arrays) -> a ``state_dict`` for
    ``model`` (the generator, the PatchGAN or the U-Net).  Raises if a shape
    disagrees or a parameter of the model is missing from the tree."""
    sd: Dict[str, torch.Tensor] = {}
    params = dict(model.named_parameters())
    for name, leaves in _modules(model):
        try:
            node = _jax_node(tree, name, [j for j, _ in leaves.values()])
        except KeyError as e:
            raise KeyError(f"JAX params have no entry for {name!r}") from e
        for leaf, (jax_leaf, perm) in leaves.items():
            arr = node[jax_leaf] if perm is None else np.transpose(node[jax_leaf], perm)
            want = params[f"{name}.{leaf}"].shape
            if tuple(arr.shape) != tuple(want):
                raise ValueError(
                    f"{name}.{leaf}: the JAX array is {tuple(arr.shape)} in torch layout, "
                    f"the port wants {tuple(want)}"
                )
            sd[f"{name}.{leaf}"] = torch.tensor(arr, dtype=torch.float32)
    missing = set(model.state_dict()) - set(sd)
    if missing:
        raise KeyError(f"no JAX parameter for {sorted(missing)}")
    return sd


def jax_tree_from_state_dict(model: nn.Module, sd: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of ``state_dict_from_jax``: ``sd`` (tensors named as
    ``model``'s parameters, on any device) -> the JAX tree of numpy f32
    arrays, the trunk restacked.  The arrays are copies: later steps do not
    change them."""
    tree: dict = {}
    stacked: Dict[str, list] = {}
    for name, torch_leaves in _modules(model):
        leaves = {}
        for leaf, (jax_leaf, perm) in torch_leaves.items():
            arr = sd[f"{name}.{leaf}"].detach().cpu().numpy()
            leaves[jax_leaf] = arr.copy() if perm is None else np.ascontiguousarray(
                np.transpose(arr, np.argsort(perm)))
        parts = name.split(".")
        if parts[0] == "trunk":  # trunk.blocks.<i>.conv<j>, in block order
            for leaf, arr in leaves.items():
                stacked.setdefault(f"{parts[3]}_{leaf}", []).append(arr)
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaves
    if stacked:
        tree["trunk"] = {k: np.stack(v) for k, v in stacked.items()}
    return tree


def _adam_moments(model: nn.Module, opt: torch.optim.Adam):
    """(step count, mu tree, nu tree) of ``opt``'s state over ``model``'s
    parameters (zeros and count 0 before the first step)."""
    mu, nu, steps = {}, {}, set()
    for name, p in model.named_parameters():
        st = opt.state.get(p)
        if st:
            mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
            steps.add(int(st["step"]))
        else:
            mu[name], nu[name] = torch.zeros_like(p), torch.zeros_like(p)
            steps.add(0)
    if len(steps) != 1:
        raise ValueError(f"Adam's parameters were stepped unequally ({sorted(steps)}); optax keeps one count")
    return steps.pop(), jax_tree_from_state_dict(model, mu), jax_tree_from_state_dict(model, nu)


def adam_state_to_jax(model, opt: torch.optim.Adam) -> dict:
    """torch Adam's state over ``model``'s parameters -> optax's
    ``{count, mu, nu}`` (zeros and count 0 before the first step).
    ``model`` may be a mapping of names to modules that one Adam covers
    (the cycle step's two generators): ``mu`` and ``nu`` are then maps of
    those names, under one ``count``."""
    if isinstance(model, nn.Module):
        count, mu, nu = _adam_moments(model, opt)
    else:
        parts = {k: _adam_moments(m, opt) for k, m in model.items()}
        counts = {c for c, _, _ in parts.values()}
        if len(counts) != 1:
            raise ValueError(f"one Adam stepped its modules unequally ({sorted(counts)})")
        count = counts.pop()
        mu, nu = {k: v[1] for k, v in parts.items()}, {k: v[2] for k, v in parts.items()}
    return {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu}


def _load_adam(opt: torch.optim.Adam, parts, count: int) -> None:
    """Load optax moments into ``opt``: ``parts`` lists (module, mu tree,
    nu tree) in the order ``opt`` holds the modules' parameters.  ``count
    == 0`` clears the state; otherwise each parameter gets ``step = count``
    (a float32 tensor, as torch keeps it) and its two moments."""
    state, i = {}, 0
    if count:
        for model, mu_tree, nu_tree in parts:
            mu = state_dict_from_jax(model, mu_tree)
            nu = state_dict_from_jax(model, nu_tree)
            for name, _p in model.named_parameters():
                state[i] = {"step": torch.tensor(float(count), dtype=torch.float32),
                            "exp_avg": mu[name], "exp_avg_sq": nu[name]}
                i += 1
    # The optimizer's own groups: load_state_dict keeps their settings.
    opt.load_state_dict({"state": state, "param_groups": opt.state_dict()["param_groups"]})


def adam_state_from_jax(model: nn.Module, opt: torch.optim.Adam, jax_opt: Mapping) -> None:
    """Load optax's ``{count, mu, nu}`` into ``opt``, an Adam over
    ``model.parameters()`` built by ``train.optim.adam``."""
    _load_adam(opt, [(model, jax_opt["mu"], jax_opt["nu"])], int(np.asarray(jax_opt["count"])))


def paired_state_to_jax(trainer) -> dict:
    """A ``train.paired.PairedTrainer``'s whole state as the JAX
    ``PairedState`` tree: ``{gen_params, disc_params, gen_opt, disc_opt}``."""
    g, d = trainer.generator, trainer.discriminator
    return {
        "gen_params": jax_tree_from_state_dict(g, dict(g.named_parameters())),
        "disc_params": jax_tree_from_state_dict(d, dict(d.named_parameters())),
        "gen_opt": adam_state_to_jax(g, trainer.gen_opt),
        "disc_opt": adam_state_to_jax(d, trainer.disc_opt),
    }


@torch.no_grad()
def load_paired_state(trainer, raw: Mapping) -> None:
    """Load a JAX ``PairedState`` tree (as ``ckpt.load_checkpoint`` reads
    it) into a ``PairedTrainer``: both networks' parameters and both Adam
    states."""
    for module, opt, params_key, opt_key in (
        (trainer.generator, trainer.gen_opt, "gen_params", "gen_opt"),
        (trainer.discriminator, trainer.disc_opt, "disc_params", "disc_opt"),
    ):
        module.load_state_dict(state_dict_from_jax(module, raw[params_key]))
        adam_state_from_jax(module, opt, raw[opt_key])


def seg_state_to_jax(trainer) -> dict:
    """A ``train.seg.SegTrainer``'s state as the JAX ``SegState`` tree:
    ``{params, opt: {count, mu, nu}}``."""
    m = trainer.model
    return {"params": jax_tree_from_state_dict(m, dict(m.named_parameters())),
            "opt": adam_state_to_jax(m, trainer.opt)}


@torch.no_grad()
def load_seg_state(trainer, raw: Mapping) -> None:
    """Load a JAX ``SegState`` tree into a ``SegTrainer``: the U-Net's
    parameters and its Adam state."""
    trainer.model.load_state_dict(state_dict_from_jax(trainer.model, raw["params"]))
    adam_state_from_jax(trainer.model, trainer.opt, raw["opt"])


# The cycle trainer's networks under the JAX CycleState's keys, in the order
# its two Adams hold them.
_CYCLE_NETS = {
    "gen": ("gen_params", "gen_opt", (("ab", "gen_ab"), ("ba", "gen_ba"))),
    "disc": ("disc_params", "disc_opt", (("post", "disc_post"), ("pre", "disc_pre"))),
}
_BUFFERS = ("pre_buffer", "post_buffer")


def _buffer_to_jax(buffer) -> dict:
    """An ``ImageBuffer`` as the JAX ``ImageBuffer`` tree: ``images`` (cap,
    H, W, C) in the buffer's dtype (a ``BF16Array`` for bf16) and a 0-d int32
    ``count``."""
    images = buffer.images.permute(0, 2, 3, 1)
    if images.dtype == torch.bfloat16:
        images = BF16Array.from_tensor(images)
    else:
        images = np.ascontiguousarray(images.detach().cpu().numpy())
    return {"images": images, "count": np.asarray(buffer.count, np.int32)}


def _load_buffer(buffer, raw: Mapping, key: str, image_hw, rows=None) -> None:
    """Fill an ``ImageBuffer`` from a JAX buffer tree of whole ``image_hw``
    images, keeping rows [start, stop) of each where ``rows`` says so.
    Images written in the 2x2 phase layout (cap, H/2, W/2, 4C), as JAX
    writes them where its phase-space cycle step runs
    (floodgan_tpu/api/model.py:52-82), are depth-to-spaced back to (cap, H,
    W, C) first."""
    images = raw["images"]
    t = images.to_tensor() if isinstance(images, BF16Array) else torch.from_numpy(np.array(images))
    cap, c = buffer.images.shape[:2]
    h, w = image_hw
    n, a, b, d = t.shape
    if (n, a, b, d) == (cap, h // 2, w // 2, 4 * c) and (h, w) == (2 * a, 2 * b):
        t = t.reshape(n, a, b, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, c)
    elif (n, a, b, d) != (cap, h, w, c):
        raise ValueError(f"checkpoint {key} images {tuple(t.shape)} fit neither the buffer's "
                         f"{(cap, h, w, c)} nor its 2x2 phase layout")
    if rows is not None:
        t = t[:, rows[0]:rows[1]]
    buffer.images.copy_(t.permute(0, 3, 1, 2))
    buffer.count = int(np.asarray(raw["count"]))


def cycle_buffer_rows(trainer):
    """{path of each buffer's images in the ``CycleState`` tree: (start,
    stop, height)} where the trainer holds rows [start, stop) of each
    buffered image of ``height`` rows (a spatial axis); None where it holds
    them whole."""
    if trainer.buffer_rows is None:
        return None
    return {f"{key}/images": (*trainer.buffer_rows, trainer.image_hw[0]) for key in _BUFFERS}


def cycle_state_to_jax(trainer) -> dict:
    """A ``train.cycle.CycleTrainer``'s whole state as the JAX
    ``CycleState`` tree: ``gen_params`` ``{ab, ba}``, ``disc_params``
    ``{post, pre}``, the two Adams with one ``count`` each over those maps,
    and ``pre_buffer`` / ``post_buffer``."""
    state = {}
    for params_key, opt_key, names in _CYCLE_NETS.values():
        nets = {k: getattr(trainer, attr) for k, attr in names}
        state[params_key] = {k: jax_tree_from_state_dict(m, dict(m.named_parameters())) for k, m in nets.items()}
        state[opt_key] = adam_state_to_jax(nets, getattr(trainer, opt_key))
    for key in _BUFFERS:
        state[key] = _buffer_to_jax(getattr(trainer, key))
    return state


@torch.no_grad()
def load_cycle_state(trainer, raw: Mapping) -> None:
    """Load a JAX ``CycleState`` tree (as ``ckpt.load_checkpoint`` reads it)
    into a ``CycleTrainer``: the four networks, both Adams and both
    buffers."""
    for params_key, opt_key, names in _CYCLE_NETS.values():
        jax_opt = raw[opt_key]
        parts = []
        for k, attr in names:
            module = getattr(trainer, attr)
            module.load_state_dict(state_dict_from_jax(module, raw[params_key][k]))
            parts.append((module, jax_opt["mu"][k], jax_opt["nu"][k]))
        _load_adam(getattr(trainer, opt_key), parts, int(np.asarray(jax_opt["count"])))
    for key in _BUFFERS:
        _load_buffer(getattr(trainer, key), raw[key], key, trainer.image_hw, trainer.buffer_rows)
