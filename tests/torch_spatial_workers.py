"""Rank functions of the port's spatial-axis tests (test_torch_spatial*.py).
``parallel.mesh.spawn`` starts each rank in a new process, which imports
its function from here by name; each writes its results to
``{out_dir}/{tag}_rank{r}.pt`` for the test process to read.

- ``layer_errors``: every halo'd layer kind of the paired path, alone, on
  the rank's rows against the same layer on the whole image in float64:
  the forward's and the input gradient's largest differences, and the
  rows of the rank's output (the PatchGAN's k4 s1 p1 convs leave the last
  shard fewer);
- ``step_case``: a PairedAttention step case (``make_batch``) on the mesh or
  in one process: the losses of two steps, a digest of the parameters
  after, and the generator's forward before the first step;
- ``step1_grads``: step 1's gradients with no update between the D and the
  G loss, in f32 and in float64 (the exact gradients);
- ``model_ranks``: ``Model`` trained on the mesh, and its height check.
"""

import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from floodgan_tpu_torch.ops import nn_ops
from floodgan_tpu_torch.parallel import mesh as mesh_lib
from floodgan_tpu_torch.parallel import spatial as sp

CH = 9
LR = 2e-4
JOIN_TIMEOUT_S = 240.0
GROUP_TIMEOUT_S = 120.0


def run_ranks(fn, world: int, args=()) -> None:
    """``fn(rank, device, *args)`` on ``world`` gloo ranks of this host."""
    mesh_lib.spawn(fn, world, args=args, device_type="cpu", timeout_s=GROUP_TIMEOUT_S, join_timeout_s=JOIN_TIMEOUT_S)


def make_batch(batch: int, height: int, width: int, seed: int = 47):
    """A seeded NHWC (input stack, target image) pair."""
    r = np.random.default_rng(seed)
    return (r.standard_normal((batch, height, width, CH), dtype=np.float32) * 0.3,
            r.standard_normal((batch, height, width, 3), dtype=np.float32) * 0.3)


# ------------------------------------------------------------ layers alone

def _layer_kinds():
    """{name: (module, fn(module, x, group))}: a layer of the paired path on
    the whole image (group None) or on this rank's rows."""
    torch.manual_seed(0)

    def reflect_k7(m, x, g):
        return m(F.pad(x, (3, 3, 3, 3), mode="reflect") if g is None else sp.reflect_pad2d(x, 3, g, "stem"))

    def reflect_k3(m, x, g):
        if g is None:
            return m(F.pad(x, (1, 1, 1, 1), mode="reflect"))
        return nn_ops.reflect_conv2d(x, m.weight, m.bias, 1, spatial=g, layer="trunk")

    def rows(top, bot):
        return lambda m, x, g: m(x) if g is None else sp.conv2d_rows(x, m, top, bot, g, "conv")

    def deconv(m, x, g):
        return m(x) if g is None else sp.conv_transpose2d_rows(x, m, g, "deconv")

    def two_s1(m, x, g):
        if g is None:
            return m[1](m[0](x))
        return sp.conv2d_rows(sp.conv2d_rows(x, m[0], 1, 2, g, "conv3"), m[1], 1, 2, g, "conv4")

    def inorm(m, x, g):
        return nn_ops.instance_norm_act(x, relu=True, negative_slope=0.2, residual=x * 0.5, spatial=g)

    return {
        "stem reflect 3 + k7": (nn.Conv2d(4, 5, 7), reflect_k7),
        "conv2/conv3 k3 s2 p1": (nn.Conv2d(4, 5, 3, stride=2, padding=1), rows(1, 0)),
        "trunk reflect 1 + k3": (nn.Conv2d(4, 5, 3), reflect_k3),
        "ConvT k3 s2 p1 op1": (nn.ConvTranspose2d(4, 5, 3, stride=2, padding=1, output_padding=1), deconv),
        "PatchGAN k4 s2 p1": (nn.Conv2d(4, 5, 4, stride=2, padding=1), rows(1, 1)),
        "PatchGAN k4 s1 p1": (nn.Conv2d(4, 5, 4, stride=1, padding=1), rows(1, 2)),
        "PatchGAN k4 s1 p1 twice": (nn.ModuleList([nn.Conv2d(4, 4, 4, padding=1), nn.Conv2d(4, 5, 4, padding=1)]),
                                    two_s1),
        "instance norm + leaky + residual": (nn.Identity(), inorm),
    }


LAYER_KINDS = tuple(_layer_kinds())


def _gathered_rows(n: int, group) -> list:
    counts = [torch.zeros(1, dtype=torch.long) for _ in range(group.size)]
    dist.all_gather(counts, torch.tensor([n]), group=group.group)
    return [int(c) for c in counts]


def layer_errors(group, height: int) -> dict:
    """{layer: (forward err, input-gradient err, rows of each rank, whole
    image's rows, whether the rank's output is contiguous)} on this rank's rows of a seeded (2, 4, height, 6) float64
    batch, against the layer on the whole batch."""
    out = {}
    for name, (module, fn) in _layer_kinds().items():
        module = module.double()
        r = torch.Generator().manual_seed(1)
        x = torch.randn(2, 4, height, 6, generator=r, dtype=torch.float64)
        whole = x.clone().requires_grad_()
        y = fn(module, whole, None)
        w = torch.randn(y.shape, generator=r, dtype=torch.float64)
        (y * w).sum().backward()
        lo, hi = sp.row_stripe(height, group.index, group.size)
        part = x[:, :, lo:hi].clone().requires_grad_()
        ys = fn(module, part, group)
        counts = _gathered_rows(ys.shape[2], group)
        start = sum(counts[:group.index])
        (ys * w[:, :, start:start + ys.shape[2]]).sum().backward()
        err = float((ys - y[:, :, start:start + ys.shape[2]]).abs().max())
        derr = float((part.grad - whole.grad[:, :, lo:hi]).abs().max())
        out[name] = (err, derr, counts, y.shape[2], ys.is_contiguous())
    return out


def layers_on_ranks(rank: int, device, out_dir: str, spatials, heights) -> None:
    """``layer_errors`` on a mesh of each spatial size, to ``layers_rank{r}.pt``."""
    torch.set_num_threads(1)
    res = {}
    for s, height in zip(spatials, heights):
        mesh = mesh_lib.make_mesh(dist.get_world_size(), spatial=s, device=device)
        res[s] = layer_errors(mesh.spatial, height)
    torch.save(res, os.path.join(out_dir, f"layers_rank{rank}.pt"))


# ------------------------------------------------------------ the step

def step_case(case: dict, mesh=None) -> dict:
    """Two PairedAttention steps of ``case`` (``batch``, ``height``,
    ``width``, ``kw`` trainer keywords) from the seed-47 init on this rank's
    part of the batch, or on all of it without a
    mesh: each step's losses, step 1's gradients, the parameters after, and
    the generator's forward on the batch before step 1 (this rank's rows)."""
    from floodgan_tpu_torch.train.paired import PairedTrainer

    x, y = make_batch(case["batch"], case["height"], case["width"])
    if mesh is not None:
        x, y = mesh.shard_images(x), mesh.shard_images(y)
    t = PairedTrainer("pairedattention", CH, device="cpu", mesh=mesh, **case.get("kw", {}))
    with torch.no_grad():
        forward = t.generator(t._nchw(x))[0]
    out = {"losses": [], "forward": forward}
    for step in range(2):
        m = t.train_step(x, y, LR, epoch=1, step=step)
        out["losses"].append({k: float(v) for k, v in m.items()})
    out["params"] = digest(p for net in (t.generator, t.discriminator) for p in net.parameters())
    return out


def digest(tensors) -> str:
    """A SHA-256 of the tensors' bytes, in order: equal digests are equal
    tensors, bit for bit, without a file of them."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def steps_on_ranks(rank: int, device, out_dir: str, tag: str, cases: dict) -> None:
    """Each case on its mesh (``case["spatial"]`` ranks per stripe); the
    results to ``{tag}_rank{r}.pt``.  The all-reduced gradients are the
    same on every rank: rank 0 alone saves them."""
    torch.set_num_threads(1)
    res = {}
    for name, case in cases.items():
        mesh = mesh_lib.make_mesh(dist.get_world_size(), spatial=case["spatial"], device=device)
        res[name] = step_case(case, mesh)
        res[name]["mesh"] = (mesh.data_index, mesh.spatial_index)
        if case.get("step1_grads"):
            grads = {dtype: step1_grads(case, mesh, dtype) for dtype in (torch.float32, torch.float64)}
            if rank == 0:
                res[name]["grads32"], res[name]["grads64"] = grads[torch.float32], grads[torch.float64]
    torch.save(res, os.path.join(out_dir, f"{tag}_rank{rank}.pt"))


def step1_grads(case: dict, mesh=None, dtype=torch.float64) -> dict:
    """Step 1's gradients of ``case`` in ``dtype``, from the seed-47 init,
    with no update between them: the G loss and the D loss both read the
    initial D (the trainer's G loss reads the updated D, where Adam turns a
    rounding-size difference into +-lr).  On a mesh the rank's part, its
    gradients all-reduced as the trainer does (``mean_grads``).  In float64
    these are the exact gradients that the f32 ones approximate."""
    from floodgan_tpu_torch.parallel.mesh import mean_grads
    from floodgan_tpu_torch.train.paired import PairedTrainer, to_nchw

    x, y = make_batch(case["batch"], case["height"], case["width"])
    if mesh is not None:
        x, y = mesh.shard_images(x), mesh.shard_images(y)
    t = PairedTrainer("pairedattention", CH, device="cpu", mesh=mesh, **case.get("kw", {}))
    gen, disc = t.generator.to(dtype), t.discriminator.to(dtype)
    group = None if mesh is None else mesh.spatial
    x, y = to_nchw(x, "cpu").to(dtype), to_nchw(y, "cpu").to(dtype)
    # f32 reads the generator as the trainer does (remat included); float64
    # directly (remat recomputes the same function).
    syn = t.gen_apply(x) if dtype == torch.float32 else gen(x)[0]

    def lsgan(p, target):
        return sp.global_mean((p - target) ** 2, group)

    g_loss = lsgan(disc(torch.cat([x, syn], 1)), 1.0) + 100.0 * sp.global_mean((syn - y).abs(), group)
    d_loss = (lsgan(disc(torch.cat([x, syn.detach()], 1)), 0.0) + lsgan(disc(torch.cat([x, y], 1)), 1.0)) * 0.5
    g_loss.backward(inputs=list(gen.parameters()), retain_graph=True)
    d_loss.backward(inputs=list(disc.parameters()))
    mean_grads(mesh, gen, disc)
    return {f"{k}.{n}": p.grad for k, net in (("gen", gen), ("disc", disc)) for n, p in net.named_parameters()}


def model_ranks(rank: int, device, out_dir: str, kwargs: dict) -> None:
    """``Model(**kwargs)`` trained on this rank; its loss history, a digest
    of its state's leaves and its sample counts to ``model_rank{r}.pt``;
    then the refusal of a height the shards cannot take."""
    from floodgan_tpu_torch.api.model import Model
    from floodgan_tpu_torch.utils.jax_params import paired_state_to_jax

    torch.set_num_threads(1)
    model = Model(device=str(device), **kwargs)
    model.train_paired()
    state = paired_state_to_jax(model.trainer)
    res = {"all_losses": model.all_losses, "state": _tree_digest(state),
           "samples": [s["samples"] for s in model.epoch_stats],
           "mesh": (model.mesh.data_index, model.mesh.spatial_index)}
    try:
        Model(device=str(device), **dict(kwargs, resize=40))
    except ValueError as e:
        res["refusal"] = str(e)
    dist.barrier()
    torch.save(res, os.path.join(out_dir, f"model_rank{rank}.pt"))


def _tree_digest(tree) -> dict:
    """{path: SHA-256 of the leaf's bytes} of a state tree (numpy leaves, or
    ``BF16Array``s, whose ``bits`` are hashed)."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else str(k): d for k, v in tree.items() for p, d in _tree_digest(v).items()}
    leaf = getattr(tree, "bits", tree)
    return {"": hashlib.sha256(np.ascontiguousarray(leaf).tobytes()).hexdigest()}
