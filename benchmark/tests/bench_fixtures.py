"""Small configurations of the benchmark's cells for the CPU tests: the
published widths, a 32^2 image and a batch of 2."""

from __future__ import annotations

import copy

import torch

from benchlib import spec

SIZE, BATCH = 32, 2
CPU = torch.device("cpu")


def small_cell(name: str, **params):
    cell = spec.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["image_size"], cell.config["batch"] = SIZE, BATCH
    cell.params.update(pool_batches=cell.params.get("checked_steps", 2), pool_tiles=4, warmup_batches=1, clients=4,
                       rate_per_s=20.0, **params)
    return cell


def few_threads():
    torch.set_num_threads(2)
