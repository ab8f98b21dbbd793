"""Rank functions of the port's spatial-axis tests (test_torch_spatial*.py).
``parallel.mesh.spawn`` starts each rank in a new process, which imports
its function from here by name; each writes its results to
``{out_dir}/{tag}_rank{r}.pt`` for the test process to read.

- ``layer_errors``: every halo'd layer kind, alone, on
  the rank's rows against the same layer on the whole image in float64:
  the forward's and the input gradient's largest differences, and the
  rows of the rank's output (the PatchGAN's k4 s1 p1 convs leave the last
  shard fewer);
- ``step_case``: a paired step case (``make_batch``; PairedAttention or
  Pix2Pix) on the mesh or
  in one process: the losses of two steps, a digest of the parameters
  after, and the generator's forward before the first step;
- ``step1_grads``: step 1's gradients with no update between the D and the
  G loss, in f32 and in float64 (the exact gradients);
- ``model_ranks``: ``Model`` trained on the mesh, and its height check;
- ``networks_on_ranks``, ``cycle_on_ranks``, ``pix2pix_on_ranks``,
  ``seg_on_ranks``: the networks and trainers beyond PairedAttention on
  their shards (forwards, steps, float64 gradients);
- ``resume_ranks``: ``Model`` resumed from ``.sharded`` directories on the
  spatial axis.
"""

import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from floodgan_tpu_torch.models.layers import BatchNorm2d
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

def _layer_kinds(mesh=None):
    """{name: (module, fn(module, x, group))}: a layer on the whole image
    (group None) or on this rank's rows of it (``mesh``'s spatial group;
    the batch norms reduce over ``mesh``)."""
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

    def deconv_k4(m, x, g):
        return m(x) if g is None else sp.conv_transpose2d_k4_rows(x, m, g, "up")

    def bilinear(m, x, g):
        if g is None:
            return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        return sp.bilinear_2x_rows(x, x.shape[2] * g.size, g, "up (bilinear 2x)")

    def bn(m, x, g):
        m.mesh, m.spatial = (None, None) if g is None else (mesh, g)
        return m(x * 1.5 + 0.25)

    def gathered_bn(m, x, g):
        # The Pix2Pix pattern: rows gathered, a replicated level (a conv and
        # a batch norm over the data stripes alone), cut back to rows.
        if g is None:
            return m[1](m[0](x))
        m[1].mesh, m[1].spatial = mesh, g
        return sp.slice_rows(m[1](m[0](sp.gather_rows(x, g)), replicated=True), g)

    def local(m, x, g):
        return m(x)

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
        "Pix2Pix ConvT k4 s2 p1": (nn.ConvTranspose2d(4, 5, 4, stride=2, padding=1), deconv_k4),
        "U-Net ConvT k2 s2": (nn.ConvTranspose2d(4, 5, 2, stride=2), local),
        "U-Net k3 p1 conv": (nn.Conv2d(4, 5, 3, padding=1), rows(1, 1)),
        "bilinear 2x align corners": (nn.Identity(), bilinear),
        "batch norm over data x spatial": (BatchNorm2d(4), bn),
        "gather, batch norm over data, slice": (nn.ModuleList([nn.Conv2d(4, 4, 3, padding=1), BatchNorm2d(4)]),
                                                gathered_bn),
    }


LAYER_KINDS = tuple(_layer_kinds())


def _gathered_rows(n: int, group) -> list:
    counts = [torch.zeros(1, dtype=torch.long) for _ in range(group.size)]
    dist.all_gather(counts, torch.tensor([n]), group=group.group)
    return [int(c) for c in counts]


def layer_errors(mesh, height: int) -> dict:
    """{layer: (forward err, input-gradient err, rows of each rank, whole
    image's rows, whether the rank's output is contiguous)} on this rank's rows of a seeded (2, 4, height, 6) float64
    batch, against the layer on the whole batch."""
    out = {}
    group = mesh.spatial
    for name, (module, fn) in _layer_kinds(mesh).items():
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
        res[s] = layer_errors(mesh, height)
    torch.save(res, os.path.join(out_dir, f"layers_rank{rank}.pt"))


# ------------------------------------------------------------ the step

def paired_trainer(case: dict, mesh=None):
    """The paired trainer of ``case["model"]`` (PairedAttention by default)
    from the seed-47 init; Pix2Pix at ``case["dropout"]``."""
    from floodgan_tpu_torch.train.paired import PairedTrainer

    model = case.get("model", "pairedattention")
    kw = dict(case.get("kw", {}), dropout_rate=case["dropout"]) if model == "pix2pix" else case.get("kw", {})
    return PairedTrainer(model, CH, device="cpu", mesh=mesh, **kw)


def _without_dropout(generator, x):
    """The generator's image with its dropout sites at rate 0 (JAX's forward
    runs with masks the port cannot draw)."""
    from floodgan_tpu_torch.models.layers import Dropout

    drops = [m for m in generator.modules() if isinstance(m, Dropout)]
    rates = [m.rate for m in drops]
    for m in drops:
        m.rate = 0.0
    try:
        out = generator(x)
    finally:
        for m, rate in zip(drops, rates):
            m.rate = rate
    return out[0] if isinstance(out, tuple) else out


def step_case(case: dict, mesh=None) -> dict:
    """Two paired steps of ``case`` (``batch``, ``height``, ``width``, ``kw``
    trainer keywords; ``paired_trainer``) from the seed-47 init on this
    rank's part of the batch, or on all of it without a mesh: each step's
    losses, the parameters after, and the generator's forward on the batch
    before step 1 (this rank's rows; dropout at rate 0)."""
    x, y = make_batch(case["batch"], case["height"], case["width"])
    if mesh is not None:
        x, y = mesh.shard_images(x), mesh.shard_images(y)
    t = paired_trainer(case, mesh)
    with torch.no_grad():
        forward = _without_dropout(t.generator, t._nchw(x))
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
    from floodgan_tpu_torch.models.registry import generator_image
    from floodgan_tpu_torch.parallel.mesh import mean_grads
    from floodgan_tpu_torch.train.paired import to_nchw

    x, y = make_batch(case["batch"], case["height"], case["width"])
    if mesh is not None:
        x, y = mesh.shard_images(x), mesh.shard_images(y)
    t = paired_trainer(case, mesh)
    gen, disc = t.generator.to(dtype), t.discriminator.to(dtype)
    group = None if mesh is None else mesh.spatial
    x, y = to_nchw(x, "cpu").to(dtype), to_nchw(y, "cpu").to(dtype)
    drop = t.dropout_generator(1, 0, x.shape[0])  # step 1's masks
    # f32 reads the generator as the trainer does (remat included); float64
    # directly (remat recomputes the same function).
    syn = t.gen_apply(x, drop) if dtype == torch.float32 else generator_image(gen, t.returns_mask, x, drop)

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


# ------------------------------------------------------------ whole networks

# name: (input shape N, C, H, W, float64) of each network of the spatial
# axis beyond PairedAttention, at the least size its shard checks take at S = 2.
NETWORK_SHAPES = {
    "pix2pix": (1, CH, 256, 256),
    "cyclegan": (2, CH, 32, 16),
    "unet": (2, 3, 32, 16),
    "batch-norm PatchGAN": (2, CH + 3, 48, 24),
}
TRAINER_MODELS = {"cyclegan": (48, 24), "attentiongan": (48, 24), "pix2pix": (256, 256)}


def build_network(name: str):
    """A network of ``NETWORK_SHAPES``, seeded, in float64."""
    from floodgan_tpu_torch.models.layers import init_weights
    from floodgan_tpu_torch.models.registry import build_discriminator, build_generator
    from floodgan_tpu_torch.models.unet import UNet

    module = {"pix2pix": lambda: build_generator("pix2pix", CH, 0.0),
              "cyclegan": lambda: build_generator("cyclegan", CH),
              "unet": lambda: UNet(),
              "unet bilinear": lambda: UNet(bilinear=True),
              "batch-norm PatchGAN": lambda: build_discriminator("pix2pix", CH + 3)}[name]()
    return init_weights(module, torch.Generator().manual_seed(3)).double()


def _output(module, x):
    out = module(x)
    return out[0] if isinstance(out, tuple) else out


def network_errors(name: str, mesh, shape) -> dict:
    """The network on this rank's part (stripe and rows) of a seeded
    float64 batch against the whole batch in this process: the forward's
    largest difference, the input gradient's, and the parameter gradients'
    (summed over the spatial ranks and averaged over the stripes as the
    trainers do, so D times the whole batch's) with each tensor's norm."""
    from floodgan_tpu_torch.models.layers import set_data_mesh, set_spatial_mesh
    from floodgan_tpu_torch.parallel.mesh import mean_grads

    r = torch.Generator().manual_seed(11)
    x = torch.randn(shape, generator=r, dtype=torch.float64)
    module = build_network(name)
    whole = x.clone().requires_grad_()
    y = _output(module, whole)
    w = torch.randn(y.shape, generator=r, dtype=torch.float64)
    (y * w).sum().backward()
    want = {k: p.grad / mesh.size for k, p in module.named_parameters()}
    module.zero_grad(set_to_none=True)
    set_data_mesh(module, mesh)
    set_spatial_mesh(module, mesh.spatial)
    b0, b1 = mesh.stripe(shape[0])
    lo, hi = sp.row_stripe(shape[2], mesh.spatial_index, mesh.spatial_size)
    part = x[b0:b1, :, lo:hi].clone().requires_grad_()
    ys = _output(module, part)
    counts = _gathered_rows(ys.shape[2], mesh.spatial)
    start = sum(counts[:mesh.spatial_index])
    (ys * w[b0:b1, :, start:start + ys.shape[2]]).sum().backward()
    mean_grads(mesh, module)
    return {"err": float((ys - y[b0:b1, :, start:start + ys.shape[2]]).detach().abs().max()),
            "derr": float((part.grad - whole.grad[b0:b1, :, lo:hi]).abs().max()),
            "grads": {k: (float((p.grad - want[k]).abs().max()), float(want[k].norm()))
                      for k, p in module.named_parameters()},
            "rows": counts, "whole_rows": y.shape[2]}


def trainer_step(model: str, mesh) -> dict:
    """One step of ``model``'s trainer on this rank's part of a seeded
    global batch of 2: the losses and a digest of the parameters after."""
    from floodgan_tpu_torch.train.cycle import CycleTrainer
    from floodgan_tpu_torch.train.paired import PairedTrainer

    h, w = TRAINER_MODELS[model]
    x, y = (mesh.shard_images(a) for a in make_batch(2, h, w))
    if model == "pix2pix":
        t = PairedTrainer(model, CH, device="cpu", mesh=mesh)
        nets = (t.generator, t.discriminator)
    else:
        t = CycleTrainer(model, CH, (h, w), device="cpu", mesh=mesh)
        nets = (t.gen_ab, t.gen_ba, t.disc_post, t.disc_pre)
    losses = {k: float(v) for k, v in t.train_step(x, y, LR, epoch=1, step=0).items()}
    return {"losses": losses, "params": digest(p for net in nets for p in net.parameters())}


def networks_on_ranks(rank: int, device, out_dir: str) -> None:
    """``network_errors`` of every network of ``NETWORK_SHAPES`` and
    ``trainer_step`` of every trainer of ``TRAINER_MODELS`` on a 1 x 2 mesh,
    to ``networks_rank{r}.pt``."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(dist.get_world_size(), spatial=2, device=device)
    res = {"networks": {name: network_errors(name, mesh, shape) for name, shape in NETWORK_SHAPES.items()},
           "trainers": {model: trainer_step(model, mesh) for model in TRAINER_MODELS}}
    torch.save(res, os.path.join(out_dir, f"networks_rank{rank}.pt"))


# ------------------------------------------------------------ the cycle step

def cycle_trainer(case: dict, mesh=None, seed: int = 47):
    from floodgan_tpu_torch.core.config import TrainConfig
    from floodgan_tpu_torch.train.cycle import CycleTrainer

    return CycleTrainer(case["model"], CH, (case["height"], case["width"]),
                        cfg=TrainConfig(buffer_size=case.get("buffer_size", 50)), device="cpu", seed=seed, mesh=mesh,
                        **case.get("kw", {}))


def cycle_nets(t) -> dict:
    return {"gen_ab": t.gen_ab, "gen_ba": t.gen_ba, "disc_post": t.disc_post, "disc_pre": t.disc_pre}


def cycle_case(case: dict, mesh=None) -> dict:
    """Two cycle steps of ``case`` (``model``,
    ``batch``, ``height``, ``width``, ``kw`` trainer keywords,
    ``buffer_size``) from the seed-47 init on this rank's part of the
    batch, or all of it without a mesh: each step's losses and the buffers
    after it (this rank's rows), G_ab's forward on the batch before step 1
    (this rank's rows) and a digest of the parameters after."""
    x, y = make_batch(case["batch"], case["height"], case["width"])
    if mesh is not None:
        x, y = mesh.shard_images(x), mesh.shard_images(y)
    t = cycle_trainer(case, mesh)
    with torch.no_grad():
        forward = t.gen_ab(t_nchw(x))
    out = {"losses": [], "buffers": [], "forward": forward[0] if isinstance(forward, tuple) else forward}
    for step in range(2):
        m = t.train_step(x, y, LR, epoch=1, step=step)
        out["losses"].append({k: float(v) for k, v in m.items()})
        out["buffers"].append({k: (getattr(t, k).images.clone(), getattr(t, k).count)
                               for k in ("pre_buffer", "post_buffer")})
    out["params"] = digest(p for net in cycle_nets(t).values() for p in net.parameters())
    return out


def t_nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous()


def cycle_step1_grads(case: dict, mesh=None) -> dict:
    """Step 1's gradients of ``case`` in float64 from the seed-47 init: the
    G loss against the current Ds, the D loss on the reals and G's
    synthetics (what the buffers return at step 1, before they are full),
    the trainer's loss terms and weights; on a mesh the rank's part, its
    gradients summed over the spatial ranks and averaged over the stripes
    as the trainer does (``mean_grads``).  These are the exact gradients."""
    from floodgan_tpu_torch.parallel.mesh import mean_grads

    x, y = make_batch(case["batch"], case["height"], case["width"])
    if mesh is not None:
        x, y = mesh.shard_images(x), mesh.shard_images(y)
    t = cycle_trainer(case, mesh)
    nets = {k: n.double() for k, n in cycle_nets(t).items()}
    g = None if mesh is None else mesh.spatial
    real_pre, post_rgb = t_nchw(x).double(), t_nchw(y).double()

    def gen(net, a):
        out = nets[net](a)
        return out[0] if isinstance(out, tuple) else out

    def with_cond(rgb):
        return torch.cat([rgb, real_pre[:, 3:]], 1)

    def mean(v):
        return sp.global_mean(v, g)

    syn_post, syn_pre = with_cond(gen("gen_ab", real_pre)), with_cond(gen("gen_ba", with_cond(post_rgb)))
    total = (mean((nets["disc_post"](syn_post) - 1) ** 2) + mean((nets["disc_pre"](syn_pre) - 1) ** 2)
             + 10.0 * mean((gen("gen_ba", syn_post) - real_pre[:, :3]).abs())
             + 10.0 * mean((gen("gen_ab", syn_pre) - post_rgb).abs()))
    if case.get("kw", {}).get("add_identity_loss"):
        total = total + 5.0 * mean((gen("gen_ab", with_cond(post_rgb)) - post_rgb).abs()) \
            + 5.0 * mean((gen("gen_ba", real_pre) - real_pre[:, :3]).abs())
    real_post = with_cond(post_rgb)
    d_total = ((mean((nets["disc_pre"](real_pre) - 1) ** 2) + mean(nets["disc_pre"](syn_pre.detach()) ** 2)) * 0.5
               + (mean((nets["disc_post"](real_post) - 1) ** 2) + mean(nets["disc_post"](syn_post.detach()) ** 2)) * 0.5)
    gens = [p for k in ("gen_ab", "gen_ba") for p in nets[k].parameters()]
    total.backward(inputs=gens)
    d_total.backward(inputs=[p for k in ("disc_post", "disc_pre") for p in nets[k].parameters()])
    mean_grads(mesh, *nets.values())
    return {f"{k}.{n}": p.grad for k, net in nets.items() for n, p in net.named_parameters()}


def cycle_on_ranks(rank: int, device, out_dir: str, tag: str, cases: dict) -> None:
    """Each case on its mesh (``case["spatial"]`` ranks per stripe),
    with step 1's float64 gradients where ``case["grads"]``; the results
    to ``{tag}_rank{r}.pt`` (the all-reduced gradients from rank 0 alone:
    every rank holds the same)."""
    torch.set_num_threads(1)
    res = {}
    for name, case in cases.items():
        mesh = mesh_lib.make_mesh(dist.get_world_size(), spatial=case["spatial"], device=device)
        res[name] = cycle_case(case, mesh)
        res[name]["mesh"] = (mesh.data_index, mesh.spatial_index)
        if case.get("grads"):
            grads = cycle_step1_grads(case, mesh)
            if rank == 0:
                res[name]["grads64"] = grads
    torch.save(res, os.path.join(out_dir, f"{tag}_rank{rank}.pt"))


# ------------------------------------------------------------ Pix2Pix

def pix2pix_on_ranks(rank: int, device, out_dir: str, tag: str, cases: dict, networks: dict) -> None:
    """Each Pix2Pix step case (``step_case``, with step 1's float64
    gradients where ``case["grads"]``) on its mesh, and ``network_errors``
    of each of ``networks`` ({name: (spatial, network, shape)}); the
    results to ``{tag}_rank{r}.pt`` (gradients from rank 0 alone)."""
    torch.set_num_threads(1)
    res = {}
    for name, case in cases.items():
        mesh = mesh_lib.make_mesh(dist.get_world_size(), spatial=case["spatial"], device=device)
        res[name] = step_case(case, mesh)
        res[name]["mesh"] = (mesh.data_index, mesh.spatial_index)
        if case.get("grads"):
            grads = step1_grads(case, mesh, torch.float64)
            if rank == 0:
                res[name]["grads64"] = grads
    for name, (spatial, network, shape) in networks.items():
        mesh = mesh_lib.make_mesh(dist.get_world_size(), spatial=spatial, device=device)
        res[name] = network_errors(network, mesh, shape)
    torch.save(res, os.path.join(out_dir, f"{tag}_rank{rank}.pt"))


# ------------------------------------------------------------ the U-Net

def seg_batch(batch: int, size: int, seed: int = 5):
    """A seeded NHWC (image, {0, 1} mask) pair."""
    r = np.random.default_rng(seed)
    return (r.standard_normal((batch, size, size, 3), dtype=np.float32) * 0.5,
            (r.random((batch, size, size, 1)) > 0.6).astype(np.float32))


def seg_case(case: dict, mesh=None) -> dict:
    """``SegTrainer`` (seed 47, f32) on this rank's part of a seeded batch
    of ``case["batch"]`` at ``case["size"]``, or all of it without a mesh:
    the logits before step 1 (this rank's part), two steps' metrics and a
    digest of the parameters after."""
    from floodgan_tpu_torch.train.seg import SegTrainer

    x, t = seg_batch(case["batch"], case["size"])
    if mesh is not None:
        x, t = mesh.shard_images(x), mesh.shard_images(t)
    tr = SegTrainer(device="cpu", mesh=mesh)
    out = {"logits": tr.predict_logits(x), "metrics": []}
    for _ in range(2):
        out["metrics"].append({k: float(v) for k, v in tr.train_step(x, t, 1e-4).items()})
    out["params"] = digest(tr.model.parameters())
    return out


def seg_step1_grads(case: dict, mesh=None) -> dict:
    """Step 1's U-Net gradients in float64 (the BCE of the seeded batch):
    on a mesh this rank's part, summed over the spatial ranks and averaged
    over the stripes (``mean_grads``); the exact gradients."""
    from floodgan_tpu_torch.parallel.mesh import mean_grads
    from floodgan_tpu_torch.train.losses import bce_with_logits
    from floodgan_tpu_torch.train.seg import SegTrainer

    x, t = seg_batch(case["batch"], case["size"])
    if mesh is not None:
        x, t = mesh.shard_images(x), mesh.shard_images(t)
    tr = SegTrainer(device="cpu", mesh=mesh)
    model = tr.model.double()
    loss = bce_with_logits(model(t_nchw(x).double()), t_nchw(t).double(), None if mesh is None else mesh.spatial)
    loss.backward()
    mean_grads(mesh, model)
    return {k: p.grad for k, p in model.named_parameters()}


def seg_on_ranks(rank: int, device, out_dir: str, tag: str, cases: dict, networks: dict) -> None:
    """Each U-Net case (``seg_case`` and ``seg_step1_grads``) on its mesh, and
    ``network_errors`` of each of ``networks`` ({name: (spatial, network,
    shape)}); the results to ``{tag}_rank{r}.pt`` (gradients from rank 0
    alone)."""
    torch.set_num_threads(1)
    res = {}
    for name, case in cases.items():
        mesh = mesh_lib.make_mesh(dist.get_world_size(), spatial=case["spatial"], device=device)
        res[name] = seg_case(case, mesh)
        res[name]["mesh"] = (mesh.data_index, mesh.spatial_index)
        grads = seg_step1_grads(case, mesh)
        if rank == 0:
            res[name]["grads64"] = grads
    for name, (spatial, network, shape) in networks.items():
        mesh = mesh_lib.make_mesh(dist.get_world_size(), spatial=spatial, device=device)
        res[name] = network_errors(network, mesh, shape)
    torch.save(res, os.path.join(out_dir, f"{tag}_rank{rank}.pt"))


def resume_ranks(rank: int, device, out_dir: str, kwargs: dict, ckpt_dirs: list, families: dict) -> None:
    """``Model(**kwargs)`` resumed from each of ``ckpt_dirs`` on this rank:
    a digest of each leaf of its state (its buffers hold this rank's rows)
    and the rows it holds; then ``Model(**kwargs, **families[name])``
    trained for its epochs: its loss history; to ``resume_rank{r}.pt``."""
    from floodgan_tpu_torch.api.model import Model
    from floodgan_tpu_torch.utils.jax_params import cycle_state_to_jax

    torch.set_num_threads(1)
    res = {"resumed": [], "trained": {}}
    for d in ckpt_dirs:
        model = Model(device=str(device), load_pretrained_model=True, pretrained_model_path=d, **kwargs)
        res["resumed"].append({"state": _tree_digest(cycle_state_to_jax(model.trainer)),
                               "rows": model.trainer.buffer_rows, "starting_epoch": model.starting_epoch,
                               "mesh": (model.mesh.data_index, model.mesh.spatial_index)})
    for name, kw in families.items():
        model = Model(device=str(device), **dict(kwargs, **kw))
        (model.train_cycle if model.model_is_cycle else model.train_paired)()
        res["trained"][name] = model.all_losses
    dist.barrier()
    torch.save(res, os.path.join(out_dir, f"resume_rank{rank}.pt"))
