"""Carry generator weights from the JAX package's parameter tree into the
port's modules.

The input is the tree that the JAX ``AttentionGenerator.init(...)["params"]``
returns, with numpy arrays (or anything ``np.asarray`` takes) as leaves:
  conv weights   HWIO                  -> OIHW        (transpose 3, 2, 0, 1)
  convT weights  (kh, kw, C_in, C_out) -> (C_in, C_out, kh, kw)
                                                     (transpose 2, 3, 0, 1;
                 no spatial flip: the JAX twin flips inside the op)
  biases         as they are
The trunk is stored stacked, ``trunk/conv{1,2}_{weight,bias}`` with a
leading block axis; block i becomes ``trunk.blocks.i``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _jax_node(tree: Mapping, module_name: str) -> Dict[str, np.ndarray]:
    """The {weight, bias} arrays of one port conv module in the JAX tree."""
    parts = module_name.split(".")
    if parts[0] == "trunk":  # trunk.blocks.<i>.conv<j>
        i, conv = int(parts[2]), parts[3]
        stacked = tree["trunk"]
        return {
            "weight": np.asarray(stacked[f"{conv}_weight"])[i],
            "bias": np.asarray(stacked[f"{conv}_bias"])[i],
        }
    node = tree
    for p in parts:
        node = node[p]
    return {"weight": np.asarray(node["weight"]), "bias": np.asarray(node["bias"])}


def state_dict_from_jax(model: nn.Module, tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX generator params (a nested mapping of arrays) -> a ``state_dict``
    for ``model``.  Raises if a shape disagrees or a parameter of the model
    is missing from the tree."""
    sd: Dict[str, torch.Tensor] = {}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.ConvTranspose2d):
            perm = (2, 3, 0, 1)
        elif isinstance(mod, nn.Conv2d):
            perm = (3, 2, 0, 1)
        else:
            continue
        try:
            node = _jax_node(tree, name)
        except KeyError as e:
            raise KeyError(f"JAX params have no entry for {name!r}") from e
        for leaf, arr in (("weight", np.transpose(node["weight"], perm)), ("bias", node["bias"])):
            want = getattr(mod, leaf).shape
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
