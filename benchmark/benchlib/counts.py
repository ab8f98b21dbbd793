"""The operations and bytes of a cell's work, worked out from its
configuration's layer tables, never from the program.

A network's table lists its convolutions in order (``op`` conv or convT,
channels, kernel, stride, zero ``pad``, a ``reflect`` pad before the
convolution, the input's size as ``image_size / in_div - in_minus``) and
the instance norm after each (``norm``: relu, leaky or residual).  A
configuration's ``reads`` list how often a step runs each network, at
what batch, and which gradients its backward needs.

- Operations: each convolution's multiply-adds times two, over its output
  (a transposed one over its input), once for the forward and once more
  for each of the two products of its backward that the step needs: the
  weight gradient where the read trains the network, the input gradient
  where anything before it needs one (the first layer's only where the
  read's input needs a gradient).  Nothing recomputed is counted; nor is
  the elementwise work.
- Bytes: each input byte read once and each output byte written once.
  An instance norm reads x (and the residual) and writes y, and where the
  step runs its backward writes each plane's (mean, inv) in f32; its
  backward reads x, the gradient and the statistics and writes dx.  A
  reflect pad reads x and writes the padded tensor; its backward reads the
  padded gradient and writes dx.
"""

from __future__ import annotations

import dataclasses
from typing import List

STATS_BYTES = 8  # an instance-norm plane's (mean, inv) in f32
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    in_fwd_bytes: float = 0.0
    in_bwd_bytes: float = 0.0
    pad_fwd_bytes: float = 0.0
    pad_bwd_bytes: float = 0.0
    in_fwd_sites: int = 0
    in_bwd_sites: int = 0
    pad_fwd_sites: int = 0
    pad_bwd_sites: int = 0

    def add(self, other: "Work", times: int = 1) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + times * getattr(other, f.name))

    @property
    def in_bytes(self) -> float:
        return self.in_fwd_bytes + self.in_bwd_bytes

    @property
    def pad_bytes(self) -> float:
        return self.pad_fwd_bytes + self.pad_bwd_bytes


def in_size(layer: dict, image_size: int) -> int:
    return image_size // layer["in_div"] - layer.get("in_minus", 0)


def out_size(layer: dict, image_size: int) -> int:
    h = in_size(layer, image_size)
    if layer["op"] == "convT":
        return (h - 1) * layer["stride"] - 2 * layer["pad"] + layer["k"] + layer.get("output_padding", 0)
    return (h + 2 * (layer["pad"] + layer.get("reflect", 0)) - layer["k"]) // layer["stride"] + 1


def conv_flops(layer: dict, image_size: int, batch: int) -> float:
    """One product of a convolution (the forward, or either product of its
    backward): 2 multiply-adds' worth over the output, or over the input of
    a transposed convolution."""
    side = in_size(layer, image_size) if layer["op"] == "convT" else out_size(layer, image_size)
    return 2.0 * batch * layer["cin"] * layer["cout"] * layer["k"] ** 2 * side * side


def read_work(layers: List[dict], image_size: int, batch: int, elem: int,
              input_grad: bool, weight_grad: bool) -> Work:
    """The work of one read of a network at ``batch`` images, with the
    backward that ``input_grad`` / ``weight_grad`` ask for."""
    w = Work()
    backward = input_grad or weight_grad
    for i, layer in enumerate(layers):
        f = conv_flops(layer, image_size, batch)
        input_grad_here = input_grad or (backward and i > 0)
        w.flops += f * (1 + weight_grad + input_grad_here)
        r = layer.get("reflect", 0)
        if r:
            side = in_size(layer, image_size)
            plain = batch * layer["cin"] * side * side
            padded = batch * layer["cin"] * (side + 2 * r) ** 2
            w.pad_fwd_bytes += (plain + padded) * elem
            w.pad_fwd_sites += 1
            if input_grad_here:
                w.pad_bwd_bytes += (padded + plain) * elem
                w.pad_bwd_sites += 1
        norm = layer.get("norm")
        if norm:
            side = out_size(layer, image_size)
            n = batch * layer["cout"] * side * side
            planes = batch * layer["cout"]
            w.in_fwd_bytes += (3 if norm == "residual" else 2) * n * elem + (planes * STATS_BYTES if backward else 0)
            w.in_fwd_sites += 1
            if backward:
                w.in_bwd_bytes += 3 * n * elem + planes * STATS_BYTES
                w.in_bwd_sites += 1
    return w


def work(config: dict, kind: str, batch: int = None, image_size: int = None, dtype: str = None) -> Work:
    """The work of one train step (``kind="train"``, in the compute dtype)
    or one served image's forward (``kind="serve"``, in the serving dtype)
    of ``config``, at its own batch and size unless others are given."""
    size = image_size or config["image_size"]
    if batch is None:
        batch = config["batch"] if kind == "train" else 1
    elem = DTYPE_BYTES[dtype or config["compute_dtype" if kind == "train" else "serve_dtype"]]
    total = Work()
    for read in config["reads"][kind]:
        layers = config["networks"][read["net"]]["layers"]
        total.add(read_work(layers, size, batch * read["batch_factor"], elem,
                            read["input_grad"], read["weight_grad"]), read["count"])
    return total
