"""The program under test, reached through its public API alone: the
trainers' ``train_step``, the serving engine and its micro-batcher, their
modules' ``load_state_dict``, the optimizers' state, ``stats()`` and the
kernels' launch counters.  Every import of ``floodgan_tpu_torch`` is
here."""

from __future__ import annotations

from typing import Dict

import torch

BUFFERS = ("pre_buffer", "post_buffer")  # a cycle trainer's replay buffers, in the order it queries them


# The configuration's recipe keys under TrainConfig's names.
RECIPE = {"gan_lr": "lr", "adam_b1": "b1", "adam_b2": "b2", "l1_weight": "l1_weight",
          "cycle_weight": "cycle_weight", "disc_weight": "disc_weight", "buffer_size": "buffer_size"}


def build_trainer(config: dict, device):
    """The configuration's trainer with the configuration's recipe, its
    weights still the program's own initialisation (``load`` replaces
    them)."""
    from floodgan_tpu_torch.core.config import TrainConfig

    cfg = TrainConfig(**{f: config["recipe"][k] for f, k in RECIPE.items() if k in config["recipe"]})
    if config["step"] == "paired":
        from floodgan_tpu_torch.train.paired import PairedTrainer

        return PairedTrainer(config["model"], config["input_channels"], cfg, compute_dtype=config["compute_dtype"],
                             device=device)
    from floodgan_tpu_torch.train.cycle import CycleTrainer

    s = config["image_size"]
    return CycleTrainer(config["model"], config["input_channels"], (s, s), cfg,
                        add_identity_loss=config["recipe"]["identity_loss"],
                        compute_dtype=config["compute_dtype"], device=device)


def modules(trainer, config: dict) -> Dict[str, torch.nn.Module]:
    """The trainer's networks by the configuration's instance names, which
    are the trainers' attribute names."""
    return {inst: getattr(trainer, inst) for inst in config["instances"]}


def load(trainer, config: dict, state) -> None:
    for inst, module in modules(trainer, config).items():
        module.load_state_dict(state[inst])


def first_steps(trainer, config: dict, pool, steps: int) -> dict:
    """The program's readings over its first ``steps`` steps, through the
    window's own call and feed: every step's losses, each leaf's first
    gradient as Adam holds it after one step (its first moment over 1 -
    b1; on the host) and its norm, and the norm of each leaf's change over
    the steps; and a cycle trainer's replay buffers after them (each filled
    slot's image, on the host)."""
    mods = modules(trainer, config)
    name = {id(p): f"{inst}.{k}" for inst, m in mods.items() for k, p in m.named_parameters()}
    start = {name[id(p)]: p.detach().clone() for m in mods.values() for p in m.parameters()}
    losses, grad_norms, grads = [], {}, {}
    lr, b1 = config["recipe"]["lr"], config["recipe"]["b1"]
    for i in range(steps):
        x, y = pool[i % len(pool)]
        out = trainer.train_step(x, y, lr, epoch=0, step=i)
        losses.append({k: float(v) for k, v in out.items()})
        if i == 0:
            for opt in (trainer.gen_opt, trainer.disc_opt):
                for p, st in opt.state.items():
                    g = st["exp_avg"] / (1.0 - b1)
                    grad_norms[name[id(p)]] = float(torch.linalg.vector_norm(g))
                    grads[name[id(p)]] = g.float().cpu()
    change = {name[id(p)]: float(torch.linalg.vector_norm(p.detach() - start[name[id(p)]]))
              for m in mods.values() for p in m.parameters()}
    readings = {"losses": losses, "grad_norms": grad_norms, "grads": grads, "change_norms": change}
    buffers = {k: getattr(trainer, k) for k in BUFFERS if hasattr(trainer, k)}
    if buffers:
        readings["buffers"] = {k: b.images[:b.count].to("cpu", copy=True) for k, b in buffers.items()}
    return readings


def build_engine(config: dict, gen_state, device):
    """The serving engine of the configuration's generator (its first
    generator instance) at the configuration's batch and size; it warms
    its own shape up (``aot``)."""
    from floodgan_tpu_torch.serve import InferenceEngine

    return InferenceEngine(config["model"], gen_state, config["topography"], batch_size=config["batch"],
                           image_size=config["image_size"], compute_dtype=config["serve_dtype"],
                           wire_dtype=config["serve_dtype"], device=device)


def frontend(engine, max_delay_ms: float):
    from floodgan_tpu_torch.serve import BatchingFrontend

    return BatchingFrontend(engine, max_delay_ms=max_delay_ms)


def launches() -> Dict[str, int]:
    from floodgan_tpu_torch.ops import kernels

    return dict(kernels.LAUNCHES)
