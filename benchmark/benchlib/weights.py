"""The weights of a configuration, made on the device from the seed.

Every convolution weight of every network instance is drawn from N(0,
``init_std``) in one call of a ``torch.Generator`` on the device, in the
order of the configuration's ``instances`` and layer tables, and split
into the tensors; every bias is zero (the reference's initialisation).
The result is keyed as the configuration's tables name the layers, which
are the names the program's modules load and the reference reads.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

State = Dict[str, Dict[str, torch.Tensor]]


def shapes(layers: List[dict]) -> List[Tuple[str, Tuple[int, ...]]]:
    out = []
    for layer in layers:
        k = layer["k"]
        w = (layer["cin"], layer["cout"], k, k) if layer["op"] == "convT" else (layer["cout"], layer["cin"], k, k)
        out.append((f"{layer['name']}.weight", w))
        out.append((f"{layer['name']}.bias", (layer["cout"],)))
    return out


def make_state(config: dict, seed: int, device, only=None) -> State:
    """{instance: {parameter name: tensor}}, f32 on ``device``; ``only``
    keeps the named instances (the draws of the others are still made,
    so an instance's weights never depend on which are kept)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    entries = [(inst, name, shape) for inst, net in config["instances"].items()
               for name, shape in shapes(config["networks"][net]["layers"])]
    weights = [(inst, name, shape) for inst, name, shape in entries if name.endswith(".weight")]
    total = sum(torch.Size(s).numel() for _, _, s in weights)
    flat = torch.randn(total, generator=g, device=device).mul_(config["init_std"])
    state: State = {inst: {} for inst in config["instances"] if only is None or inst in only}
    offset = 0
    for inst, name, shape in weights:
        n = torch.Size(shape).numel()
        if inst in state:
            state[inst][name] = flat[offset:offset + n].view(shape)
        offset += n
    for inst, name, shape in entries:
        if inst in state and name.endswith(".bias"):
            state[inst][name] = torch.zeros(shape, device=device)
    return {inst: {name: d[name] for name, _ in shapes(config["networks"][config["instances"][inst]]["layers"])}
            for inst, d in state.items()}
