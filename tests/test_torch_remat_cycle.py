"""Rematerialisation in the port's cycle trainer, on the CPU.

- Each policy against the same trainer without remat, from one seeded
  init and one batch, f32 and bf16: CycleGAN with the identity loss and
  AttentionGAN, each of ``convs``, ``boundaries`` and ``full`` at 32^2.
  Step-1 losses equal exactly, step-1 gradients within 1e-6 of each
  tensor's norm, step-2 losses within rtol 1e-6
  (tests/torch_remat_steps.py).
- ``convs`` keeps every convolution's output: counted at the dispatcher,
  its backward runs no ``aten.convolution`` again, and the IN forward runs
  twice as often as without remat; ``full`` re-runs every convolution.
- One AttentionGAN step launches +25 IN forwards and +1 compose forward
  per generator read under each policy, and no backward kernel more often:
  every segment's last op that saves a tensor for the backward is an IN
  or the compose (an autograd Function packs its saved tensors after its
  forward ran), so early stop leaves nothing out.
"""

import contextlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from floodgan_tpu_torch.ops import kernels
from floodgan_tpu_torch.train import remat
from floodgan_tpu_torch.train.cycle import CycleTrainer

from torch_remat_steps import CH, LR, assert_same_step, baseline, batch, threads_and_warm_exp, two_steps


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from threads_and_warm_exp()

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["convs", "boundaries", "full"])
@pytest.mark.parametrize("model", ["cyclegan", "attentiongan"])
def test_cycle_remat_equals_no_remat(model, policy, dtype):
    x, y = batch(32)
    identity = model == "cyclegan"
    make = lambda **kw: CycleTrainer(model, CH, (32, 32), add_identity_loss=identity, compute_dtype=dtype,
                                     device="cpu", **kw)
    want = baseline((model, dtype), make, x, y)
    assert_same_step(two_steps(lambda: make(remat=True, remat_policy=policy), x, y), want)


# ------------------------------------------------------ what a policy re-runs

class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _count_in_forwards():
    calls = {"in": 0}
    real = kernels.instance_norm_act_fwd

    def counted(*a, **k):
        calls["in"] += 1
        return real(*a, **k)

    kernels.instance_norm_act_fwd = counted
    try:
        yield calls
    finally:
        kernels.instance_norm_act_fwd = real


def _read_and_backward(policy, dtype):
    """(aten ops, IN forwards) of one CycleGAN generator read and its
    backward under ``policy`` (None: no remat)."""
    kw = {} if policy is None else {"remat": True, "remat_policy": policy}
    t = CycleTrainer("cyclegan", CH, (32, 32), compute_dtype=dtype, device="cpu", **kw)
    x = torch.from_numpy(batch(32)[0]).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    with _count_in_forwards() as calls, _OpCounter() as ops:
        t.gen_apply(t.gen_ab, x).sum().backward()
    return ops.counts, calls["in"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convs_saves_the_convolutions_and_recomputes_the_norms(dtype):
    conv = torch.ops.aten.convolution.default
    plain_ops, plain_in = _read_and_backward(None, dtype)
    convs_ops, convs_in = _read_and_backward("convs", dtype)
    full_ops, full_in = _read_and_backward("full", dtype)
    assert plain_ops[conv] == 24  # 3 down, 18 in the trunk, 2 up, the RGB head
    assert convs_ops[conv] == plain_ops[conv]
    assert full_ops[conv] == 2 * plain_ops[conv]
    assert plain_in == 23 and convs_in == full_in == 2 * 23
    assert remat.CONV_OPS == {conv}


# ------------------------------------------------------ launches per policy

@pytest.mark.parametrize("policy", ["convs", "boundaries", "full"])
def test_recompute_adds_one_generator_forward_per_read(policy):
    calls = {}
    names = ("instance_norm_act_fwd", "instance_norm_act_bwd", "attention_compose_fwd", "attention_compose_bwd")
    reals = {n: getattr(kernels, n) for n in names}

    def counting(n):
        def f(*a, **k):
            calls[n] = calls.get(n, 0) + 1
            return reals[n](*a, **k)
        return f

    x, y = batch(32)
    got = {}
    try:
        for n in names:
            setattr(kernels, n, counting(n))
        for kw in ({}, {"remat": True, "remat_policy": policy}):
            calls.clear()
            CycleTrainer("attentiongan", CH, (32, 32), device="cpu", **kw).train_step(x, y, LR)
            got[bool(kw)] = dict(calls)
    finally:
        for n in names:
            setattr(kernels, n, reals[n])
    assert got[False] == {"instance_norm_act_fwd": 112, "instance_norm_act_bwd": 112,
                          "attention_compose_fwd": 4, "attention_compose_bwd": 4}
    assert got[True] == {"instance_norm_act_fwd": 112 + 4 * 25, "instance_norm_act_bwd": 112,
                         "attention_compose_fwd": 4 + 4, "attention_compose_bwd": 4}


