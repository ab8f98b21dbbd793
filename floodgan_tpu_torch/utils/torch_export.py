"""Export a ``.ckpt`` back into the reference's (PyTorch) ``.pth.tar`` layout:
the port of floodgan_tpu/utils/torch_export.py, the inverse of
``ckpt/migrate.py``.

``export_gan_checkpoint`` writes a complete reference-schema file (the
config, epoch and loss history, the schedulers' ``last_epoch``, the model
state dicts and both Adam state dicts) that the reference's
``Model(load_pretrained_model=True)`` loads (reference models/model.py:
52-57, 127-148).  It reads a ``.ckpt`` of either package.

The port's modules register their parameters in the reference's order, so
the arrays come out of a port module (``utils/jax_params.py:
state_dict_from_jax``, which slices the stacked trunk into its blocks) in
the order the reference's state dicts and Adam indices follow; the names
they are saved under are the caller's.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from floodgan_tpu_torch.ckpt import load_checkpoint
from floodgan_tpu_torch.core.config import TOPOGRAPHY_CHANNELS, _check_model, model_is_cycle
from floodgan_tpu_torch.models.registry import build_discriminator, build_generator
from floodgan_tpu_torch.utils.jax_params import state_dict_from_jax


def ordered_arrays(module: nn.Module, tree: Mapping) -> List[torch.Tensor]:
    """The tensors of a JAX tree in ``module``'s registration order, in
    torch layout."""
    sd = state_dict_from_jax(module, tree)
    return [sd[n] for n, _ in module.named_parameters()]


def state_dict_from_params(module: nn.Module, tree: Mapping, torch_param_names: Sequence[str]) -> Dict[str, torch.Tensor]:
    """{torch_name: tensor} in registration order.  ``torch_param_names``
    comes from ``[n for n, _ in module.named_parameters()]`` of the module
    the file is for."""
    arrays = ordered_arrays(module, tree)
    if len(arrays) != len(torch_param_names):
        raise ValueError(
            f"spec has {len(arrays)} params, torch module has {len(torch_param_names)}"
        )
    return dict(zip(torch_param_names, arrays))


def _adam_state(module: nn.Module, mu_tree, nu_tree, count: int, offset: int = 0) -> Dict[int, dict]:
    mus = ordered_arrays(module, mu_tree)
    nus = ordered_arrays(module, nu_tree)
    return {
        offset + i: {"step": torch.tensor(float(count)), "exp_avg": m, "exp_avg_sq": v}
        for i, (m, v) in enumerate(zip(mus, nus))
    }


def _adam_dict(state: Dict[int, dict], n_params: int) -> dict:
    """torch Adam's ``state_dict()`` over ``n_params`` parameters, with the
    reference's hyper-parameters."""
    return {
        "state": state,
        "param_groups": [{"params": list(range(n_params)), "lr": 2e-4,
                          "betas": (0.5, 0.999), "eps": 1e-8, "weight_decay": 0,
                          "amsgrad": False, "maximize": False, "foreach": None,
                          "capturable": False, "differentiable": False, "fused": None}],
    }


def export_gan_checkpoint(
    ckpt_path: str, out_path: str, torch_module_names: Dict[str, Sequence[str]]
) -> str:
    """Write a reference-schema ``.pth.tar`` from a ``.ckpt``.

    ``torch_module_names`` maps the file's module keys (``generator`` and
    ``discriminator``, or for a cycle family ``pre_to_post_generator``,
    ``post_to_pre_generator``, ``post_discriminator`` and
    ``pre_discriminator``) to the parameter names of the modules the file
    is for, in registration order.  A cycle family's Adam holds both
    generators (A->B's parameters, then B->A's) and both Ds (post's, then
    pre's)."""
    meta, raw = load_checkpoint(ckpt_path)
    model = _check_model(meta["model"])
    channels = TOPOGRAPHY_CHANNELS[meta["topography"]]
    gen = build_generator(model, channels)
    disc = build_discriminator(model, channels if model_is_cycle(model) else channels + 3)

    saved = {
        "model": meta["model"],
        "starting_epoch": meta["starting_epoch"],
        "num_epochs": meta["num_epochs"],
        "topography": meta["topography"],
        "all_losses": meta["all_losses"],
        "add_identity_loss": meta["add_identity_loss"],
        "scheduler_generator": {"last_epoch": meta["starting_epoch"] - 1},
        "scheduler_discriminator": {"last_epoch": meta["starting_epoch"] - 1},
    }

    gp, dp = raw["gen_params"], raw["disc_params"]
    g_opt, d_opt = raw["gen_opt"], raw["disc_opt"]
    count_g = int(np.asarray(g_opt["count"]))
    count_d = int(np.asarray(d_opt["count"]))

    if model_is_cycle(model):
        for key, module, tree in (("pre_to_post_generator", gen, gp["ab"]), ("post_to_pre_generator", gen, gp["ba"]),
                                  ("post_discriminator", disc, dp["post"]), ("pre_discriminator", disc, dp["pre"])):
            saved[key] = state_dict_from_params(module, tree, torch_module_names[key])
        for key, module, opt, count, (first, second) in (
            ("optimizer_generator", gen, g_opt, count_g, ("ab", "ba")),
            ("optimizer_discriminator", disc, d_opt, count_d, ("post", "pre")),
        ):
            n = len(list(module.parameters()))
            saved[key] = _adam_dict({**_adam_state(module, opt["mu"][first], opt["nu"][first], count, 0),
                                     **_adam_state(module, opt["mu"][second], opt["nu"][second], count, n)}, 2 * n)
    else:
        saved["generator"] = state_dict_from_params(gen, gp, torch_module_names["generator"])
        saved["discriminator"] = state_dict_from_params(disc, dp, torch_module_names["discriminator"])
        for key, module, opt, count in (("optimizer_generator", gen, g_opt, count_g),
                                        ("optimizer_discriminator", disc, d_opt, count_d)):
            saved[key] = _adam_dict(_adam_state(module, opt["mu"], opt["nu"], count),
                                    len(list(module.parameters())))

    torch.save(saved, out_path)
    print(f"exported {ckpt_path} -> {out_path} ({meta['model']})")
    return out_path
