"""Rank functions of the port's data-parallel tests (test_torch_parallel.py,
test_torch_sharded_ckpt.py).  ``parallel.mesh.spawn`` starts each rank in a
new process, which imports its function from here by name.

A step case is a dict: ``model``, ``size``, ``batch`` (the global batch),
``kw`` (trainer keywords such as remat) and optionally ``init``, a file
holding the generator's and the D's state dicts.  ``run_case`` runs it
in this process, on a mesh or without one, from the seeded batch
``case_batch`` gives: two steps, the losses of each, every gradient of
step 1 and, for a cycle model, the buffers after each step.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from floodgan_tpu_torch.parallel import mesh as mesh_lib

CH = 9
LR = 2e-4
JOIN_TIMEOUT_S = 240.0
GROUP_TIMEOUT_S = 120.0


def run_ranks(fn, world: int, args=()) -> None:
    """``fn(rank, device, *args)`` on ``world`` gloo ranks of this host,
    joined with a timeout; raises when a rank fails."""
    mesh_lib.spawn(fn, world, args=args, device_type="cpu", timeout_s=GROUP_TIMEOUT_S, join_timeout_s=JOIN_TIMEOUT_S)


def case_batch(size: int, batch: int, seed: int = 47):
    r = np.random.default_rng(seed)
    return (r.standard_normal((batch, size, size, CH), dtype=np.float32) * 0.3,
            r.standard_normal((batch, size, size, 3), dtype=np.float32) * 0.3)


def _trainer(case, mesh):
    from floodgan_tpu_torch.train.cycle import CycleTrainer
    from floodgan_tpu_torch.train.paired import PairedTrainer

    kw = dict(case.get("kw", {}))
    if case["model"] in ("cyclegan", "attentiongan"):
        return CycleTrainer(case["model"], CH, (case["size"], case["size"]), device="cpu", mesh=mesh, **kw)
    if "init" in case:
        init = torch.load(case["init"])
        kw.update(gen_params=init["gen"], disc_params=init["disc"])
    return PairedTrainer(case["model"], CH, device="cpu", mesh=mesh, **kw)


def _nets(t):
    if hasattr(t, "generator"):
        return {"gen": t.generator, "disc": t.discriminator}
    return {"gen_ab": t.gen_ab, "gen_ba": t.gen_ba, "disc_post": t.disc_post, "disc_pre": t.disc_pre}


def run_case(case, mesh=None) -> dict:
    x, y = case_batch(case["size"], case["batch"])
    if mesh is not None:
        lo, hi = mesh.stripe(case["batch"])
        x, y = x[lo:hi], y[lo:hi]
    t = _trainer(case, mesh)
    out = {"losses": [], "buffers": []}
    for step in range(2):
        m = t.train_step(x, y, LR, epoch=1, step=step)
        out["losses"].append({k: float(v) for k, v in m.items()})
        if step == 0:
            out["grads"] = {f"{k}.{n}": p.grad.clone() for k, net in _nets(t).items()
                            for n, p in net.named_parameters()}
        if hasattr(t, "pre_buffer"):
            out["buffers"].append({k: (getattr(t, k).images.clone(), getattr(t, k).count)
                                   for k in ("pre_buffer", "post_buffer")})
    out["params"] = {f"{k}.{n}": p.detach().clone() for k, net in _nets(t).items() for n, p in net.named_parameters()}
    return out


def batch_norm_f64(mesh=None) -> dict:
    """A float64 batch norm of a seeded (4, 3, 5, 5) batch, on this rank's
    stripe with a mesh: its output rows, x's gradient rows, and the scale's
    and bias's gradients summed over the ranks, for the loss sum(y * w)."""
    from floodgan_tpu_torch.ops.nn_ops import batch_norm

    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((4, 3, 5, 5)) * 2 + 1)
    w = torch.from_numpy(r.standard_normal((4, 3, 5, 5)))
    scale = torch.from_numpy(1 + 0.1 * r.standard_normal(3)).requires_grad_(True)
    bias = torch.from_numpy(0.1 * r.standard_normal(3)).requires_grad_(True)
    if mesh is not None:
        x, w = mesh.shard_batch(x), mesh.shard_batch(w)
    x.requires_grad_(True)
    y = batch_norm(x, scale, bias, reduce=None if mesh is None else mesh.all_reduce_sum_)
    (y * w).sum().backward()
    grads = torch.stack([scale.grad, bias.grad])
    if mesh is not None:
        mesh.all_reduce_sum_(grads)
    return {"y": y.detach(), "dx": x.grad, "dscale_dbias": grads}


def step_cases(rank: int, device, out_dir: str, cases: dict) -> None:
    """Every case on this rank's stripe, and ``batch_norm_f64``; the
    results to ``rank{r}.pt``."""
    torch.set_num_threads(2)
    mesh = mesh_lib.make_mesh(dist.get_world_size(), device=device)
    results = {name: run_case(case, mesh) for name, case in cases.items()}
    results["batch_norm_f64"] = batch_norm_f64(mesh)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def failing_rank(rank: int, device) -> None:
    """Rank 1 dies; rank 0 waits for it in a collective it never joins."""
    if rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    dist.barrier()


def model_train(rank: int, device, out_dir: str, kwargs: dict) -> None:
    """``Model(**kwargs)`` on this rank, trained; rank 0 saves its loss
    history, the paths it checkpointed and its final trainer state."""
    from floodgan_tpu_torch.api.model import Model
    from floodgan_tpu_torch.utils.jax_params import cycle_state_to_jax, paired_state_to_jax

    torch.set_num_threads(2)
    model = Model(device=str(device), **kwargs)
    (model.train_cycle if model.model_is_cycle else model.train_paired)()
    state = (cycle_state_to_jax if model.model_is_cycle else paired_state_to_jax)(model.trainer)
    torch.save({"all_losses": model.all_losses, "state": state, "epoch_stats": model.epoch_stats},
               os.path.join(out_dir, f"model_rank{rank}.pt"))
