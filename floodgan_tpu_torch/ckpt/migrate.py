"""Load reference (PyTorch research code) checkpoints: the port of
floodgan_tpu/utils/migrate.py.

The reference saves one torch pickle per interval (``.pth.tar``): for a
paired GAN, the config, starting_epoch, the loss history, and the
``generator`` / ``discriminator`` state dicts with their two Adam state
dicts; for a cycle GAN, the ``pre_to_post_generator``,
``post_to_pre_generator``, ``post_discriminator`` and ``pre_discriminator``
state dicts, with one Adam over both generators (ab's parameters, then
ba's) and one over both Ds (post's, then pre's); for the U-Net, its
``model`` state dict, current_epoch, num_epochs and the loss and accuracy
histories.  The port's modules register their parameters in the
reference's order, so the tensors map by position, and the Adam entries by
the same positions.  The reference never saves its replay buffers: a cycle
file gets empty f32 buffers (count 0) at the image size ``resize`` and
``crop`` give.  ``maybe_migrate`` converts such a file once into a
``.ckpt`` beside it.

    python -m floodgan_tpu_torch.ckpt.migrate gan ref.pth.tar out.ckpt --resize 512 --crop 4
    python -m floodgan_tpu_torch.ckpt.migrate seg ref.pth.tar out.ckpt
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from floodgan_tpu_torch.ckpt.checkpoint import save_checkpoint
from floodgan_tpu_torch.core.config import TOPOGRAPHY_CHANNELS, TrainConfig, _check_model, model_is_cycle
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


def _adam_tree(module: torch.nn.Module, opt_sd: Dict, what: str, offset: int = 0, modules: int = 1) -> Dict:
    """optax ``{count, mu, nu}`` from a torch Adam state dict over
    ``module``'s parameters: the ``offset``-th of the ``modules`` equal
    modules whose parameters the optimizer holds in turn."""
    indices: List[int] = [i for g in opt_sd.get("param_groups", []) for i in g["params"]]
    names = [n for n, _ in module.named_parameters()]
    if len(indices) != modules * len(names):
        raise ValueError(f"{what}: the optimizer holds {len(indices)} parameters, the modules "
                         f"{modules} x {len(names)}")
    indices = indices[offset * len(names):(offset + 1) * len(names)]
    entries = [opt_sd.get("state", {}).get(i) for i in indices]
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


def _params(module: torch.nn.Module, saved: Dict, key: str) -> Dict:
    return jax_tree_from_state_dict(module, _by_position(module, saved[key], key))


def _cycle_state(saved: Dict, gen: torch.nn.Module, disc: torch.nn.Module, channels: int, size: int) -> Dict:
    """The JAX ``CycleState`` tree of a reference cycle file."""
    state = {}
    for params_key, opt_key, module, opt_name, groups in (
        ("gen_params", "gen_opt", gen, "optimizer_generator",
         (("ab", "pre_to_post_generator"), ("ba", "post_to_pre_generator"))),
        ("disc_params", "disc_opt", disc, "optimizer_discriminator",
         (("post", "post_discriminator"), ("pre", "pre_discriminator"))),
    ):
        state[params_key] = {k: _params(module, saved, ref) for k, ref in groups}
        trees = {k: _adam_tree(module, saved[opt_name], ref, offset=i, modules=2)
                 for i, (k, ref) in enumerate(groups)}
        state[opt_key] = {"count": trees[groups[0][0]]["count"],
                          "mu": {k: t["mu"] for k, t in trees.items()},
                          "nu": {k: t["nu"] for k, t in trees.items()}}
    for key in ("pre_buffer", "post_buffer"):
        state[key] = {"count": np.asarray(0, np.int32),
                      "images": np.zeros((TrainConfig().buffer_size, size, size, channels), np.float32)}
    return state


def migrate_gan(in_path: str, out_path: str, resize: Optional[int] = 256, crop: Optional[int] = None) -> str:
    """Convert a reference GAN ``.pth.tar`` into a ``.ckpt``; ``resize``
    and ``crop`` size a cycle file's replay buffers."""
    saved = torch.load(in_path, map_location="cpu", weights_only=True)
    model = _check_model(saved["model"])
    channels = TOPOGRAPHY_CHANNELS[saved["topography"]]
    gen = build_generator(model, channels)
    if model_is_cycle(model):
        size = resize or 256
        if crop:
            size //= int(np.sqrt(crop))
        state = _cycle_state(saved, gen, build_discriminator(model, channels), channels, size)
    else:
        disc = build_discriminator(model, channels + 3)
        state = {
            "disc_opt": _adam_tree(disc, saved["optimizer_discriminator"], "discriminator"),
            "disc_params": _params(disc, saved, "discriminator"),
            "gen_opt": _adam_tree(gen, saved["optimizer_generator"], "generator"),
            "gen_params": _params(gen, saved, "generator"),
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


def maybe_migrate(path: str, kind: str = "gan", resize: Optional[int] = 256, crop: Optional[int] = None) -> str:
    """``path`` itself for a ``.ckpt``.  For a reference torch file (``kind``
    "gan" or "seg"), the path of ``<path>.floodgan.ckpt``, converted on the
    first load and reused while it is newer than the source; ``resize`` and
    ``crop`` size a cycle file's replay buffers."""
    if not is_torch_checkpoint(path):
        return path
    out = path + ".floodgan.ckpt"
    if os.path.isfile(out) and os.path.getmtime(out) >= os.path.getmtime(path):
        return out
    print(f"Reference (PyTorch) checkpoint detected - migrating to {out}")
    return migrate_seg(path, out) if kind == "seg" else migrate_gan(path, out, resize, crop)


def main(argv=None) -> str:
    """The migrate CLI (floodgan_tpu/utils/migrate.py:255-267); returns the
    ``.ckpt`` written."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("kind", choices=["gan", "seg"])
    p.add_argument("torch_checkpoint")
    p.add_argument("output_checkpoint")
    p.add_argument("--resize", type=int, default=256)
    p.add_argument("--crop", type=int, default=None)
    args = p.parse_args(argv)
    if args.kind == "gan":
        return migrate_gan(args.torch_checkpoint, args.output_checkpoint, args.resize, args.crop)
    return migrate_seg(args.torch_checkpoint, args.output_checkpoint)


if __name__ == "__main__":
    main()
