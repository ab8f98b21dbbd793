"""Load reference (PyTorch research code) checkpoints: the paired and
segmentation halves of floodgan_tpu/utils/migrate.py.

The reference saves one torch pickle per interval (``.pth.tar``): for a
GAN, the config, starting_epoch, the loss history, and the ``generator`` /
``discriminator`` state dicts with their two Adam state dicts; for the
U-Net, its ``model`` state dict, current_epoch, num_epochs and the loss and
accuracy histories.  The port's modules register their parameters in the
reference's order, so the tensors map by position, and the Adam entries by
the same positions.  ``maybe_migrate`` converts such a file once into a
``.ckpt`` beside it.  Cycle-family files wait for ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from floodgan_tpu_torch.ckpt.checkpoint import save_checkpoint
from floodgan_tpu_torch.core.config import TOPOGRAPHY_CHANNELS, _check_model, model_is_cycle
from floodgan_tpu_torch.models.registry import build_discriminator, build_generator
from floodgan_tpu_torch.models.unet import UNet
from floodgan_tpu_torch.utils.jax_params import jax_tree_from_state_dict

_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def is_torch_checkpoint(path: str) -> bool:
    """True when ``path`` is a torch save rather than a msgpack ``.ckpt``:
    torch >= 1.6 saves are zip archives (``PK\\x03\\x04``), older ones raw
    pickles (``\\x80``); a ``.ckpt`` starts with a msgpack map marker."""
    with open(path, "rb") as f:
        head = f.read(4)
    return head.startswith(b"PK\x03\x04") or head[:1] == b"\x80"


def _by_position(module: torch.nn.Module, ref_sd: Dict[str, torch.Tensor], what: str):
    """The reference's parameters (buffers skipped), in their order, under
    ``module``'s parameter names."""
    ref = [ref_sd[k] for k in ref_sd if not k.endswith(_BUFFERS)]
    names = [n for n, _ in module.named_parameters()]
    if len(ref) != len(names):
        raise ValueError(f"{what}: the reference file has {len(ref)} parameters, the port's module {len(names)}")
    out = {}
    for name, (_, p), t in zip(names, module.named_parameters(), ref):
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{what}: {name} is {tuple(t.shape)} in the file, {tuple(p.shape)} in the port")
        out[name] = t.detach().float()
    return out


def _fresh_adam(module: torch.nn.Module) -> Dict:
    """optax's ``{count, mu, nu}`` before the first step: count 0, zeros."""
    zeros = {n: torch.zeros_like(p) for n, p in module.named_parameters()}
    return {"count": np.asarray(0, np.int32), "mu": jax_tree_from_state_dict(module, zeros),
            "nu": jax_tree_from_state_dict(module, zeros)}


def _adam_tree(module: torch.nn.Module, opt_sd: Dict, what: str) -> Dict:
    """optax ``{count, mu, nu}`` from a torch Adam state dict over
    ``module``'s parameters (the reference's single param group)."""
    indices: List[int] = [i for g in opt_sd.get("param_groups", []) for i in g["params"]]
    entries = [opt_sd.get("state", {}).get(i) for i in indices]
    names = [n for n, _ in module.named_parameters()]
    if len(entries) != len(names):
        raise ValueError(f"{what}: the optimizer holds {len(entries)} parameters, the module {len(names)}")
    if all(e is None for e in entries):
        return _fresh_adam(module)
    if any(e is None for e in entries):
        missing = [n for n, e in zip(names, entries) if e is None]
        raise ValueError(f"{what}: optimizer state missing for {missing}")
    count = int(entries[-1]["step"])
    mu = {n: e["exp_avg"].float() for n, e in zip(names, entries)}
    nu = {n: e["exp_avg_sq"].float() for n, e in zip(names, entries)}
    return {"count": np.asarray(count, np.int32), "mu": jax_tree_from_state_dict(module, mu),
            "nu": jax_tree_from_state_dict(module, nu)}


def migrate_gan(in_path: str, out_path: str) -> str:
    """Convert a reference paired-GAN ``.pth.tar`` into a ``.ckpt``."""
    saved = torch.load(in_path, map_location="cpu", weights_only=True)
    model = _check_model(saved["model"])
    if model_is_cycle(model):
        raise NotImplementedError(
            f"{model} checkpoints wait for the cycle family (ROADMAP.md Queue 1, item 9)"
        )
    channels = TOPOGRAPHY_CHANNELS[saved["topography"]]
    gen = build_generator(model, channels)
    disc = build_discriminator(model, channels + 3)
    state = {
        "disc_opt": _adam_tree(disc, saved["optimizer_discriminator"], "discriminator"),
        "disc_params": jax_tree_from_state_dict(disc, _by_position(disc, saved["discriminator"], "discriminator")),
        "gen_opt": _adam_tree(gen, saved["optimizer_generator"], "generator"),
        "gen_params": jax_tree_from_state_dict(gen, _by_position(gen, saved["generator"], "generator")),
    }
    meta = {
        "model": model,
        "starting_epoch": int(saved["starting_epoch"]),
        "num_epochs": int(saved["num_epochs"]),
        "topography": saved["topography"],
        "all_losses": {k: [float(x) for x in v] for k, v in saved["all_losses"].items()},
        "add_identity_loss": bool(saved["add_identity_loss"]),
    }
    save_checkpoint(out_path, meta, state)
    print(f"migrated {in_path} -> {out_path} ({model}, epoch {meta['starting_epoch']})")
    return out_path


def migrate_seg(in_path: str, out_path: str) -> str:
    """Convert a reference segmentation ``.pth.tar`` (its ``model`` state
    dict, ``unet_spec`` order) into a ``.ckpt`` with a fresh Adam state, as
    floodgan_tpu/utils/migrate.py:199-216 does."""
    saved = torch.load(in_path, map_location="cpu", weights_only=True)
    if not isinstance(saved.get("model"), dict):
        raise ValueError(f"{in_path} holds no segmentation U-Net state dict under 'model'")
    unet = UNet()
    state = {
        "opt": _fresh_adam(unet),
        "params": jax_tree_from_state_dict(unet, _by_position(unet, saved["model"], "segmentation U-Net")),
    }
    meta = {
        "current_epoch": int(saved["current_epoch"]),
        "num_epochs": int(saved["num_epochs"]),
        "all_losses": [float(x) for x in saved["all_losses"]],
        "all_accuracies": [float(x) for x in saved["all_accuracies"]],
    }
    save_checkpoint(out_path, meta, state)
    print(f"migrated {in_path} -> {out_path} (segmentation, epoch {meta['current_epoch']})")
    return out_path


def maybe_migrate(path: str, kind: str = "gan") -> str:
    """``path`` itself for a ``.ckpt``.  For a reference torch file (``kind``
    "gan" or "seg"), the path of ``<path>.floodgan.ckpt``, converted on the
    first load and reused while it is newer than the source.  (The JAX
    version also takes resize and crop, which size the cycle family's image
    buffers.)"""
    if not is_torch_checkpoint(path):
        return path
    out = path + ".floodgan.ckpt"
    if os.path.isfile(out) and os.path.getmtime(out) >= os.path.getmtime(path):
        return out
    print(f"Reference (PyTorch) checkpoint detected - migrating to {out}")
    return migrate_seg(path, out) if kind == "seg" else migrate_gan(path, out)
