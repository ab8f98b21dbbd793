"""Shared pieces of the remat tests (test_torch_remat.py,
test_torch_remat_cycle.py, test_torch_remat_jax.py): a seeded batch, two
steps of a trainer with their step-1 gradients, and the check that a
rematerialised step equals the plain one."""

import numpy as np
import torch

from floodgan_tpu_torch.train.paired import PairedTrainer
from floodgan_tpu_torch.train.seg import SegTrainer

from torch_seg_fixtures import few_torch_threads

LR = 2e-4
SEG_LR = 1e-4
CH = 9
TOL_SAME_GRAD = 1e-6     # of each tensor's norm, remat against no remat
TOL_SAME_STEP2 = 1e-6    # rtol


def threads_and_warm_exp():
    """Body of a module fixture: torch on two threads; the first torch.exp
    of a process can come out up to 4e-5 off with the CPU build of torch
    2.13 (see tests/test_torch_kernels.py), so one call is discarded."""
    torch.exp(torch.randn(1 << 20))
    yield from few_torch_threads()


def batch(size, batch=2, seed=47):
    r = np.random.default_rng(seed)
    return (r.standard_normal((batch, size, size, CH), dtype=np.float32) * 0.3,
            r.standard_normal((batch, size, size, 3), dtype=np.float32) * 0.3)


def nets(t):
    if isinstance(t, SegTrainer):
        return {"unet": t.model}
    if isinstance(t, PairedTrainer):
        return {"gen": t.generator, "disc": t.discriminator}
    return {"gen_ab": t.gen_ab, "gen_ba": t.gen_ba, "disc_post": t.disc_post, "disc_pre": t.disc_pre}


def two_steps(make, x, y, lr=LR):
    """Two steps of the trainer ``make()`` builds on one batch: the losses
    of each, and every gradient of step 1."""
    t = make()
    if isinstance(t, SegTrainer):
        steps = [t.train_step(x, y, lr) for _ in range(1)]
    else:
        steps = [t.train_step(x, y, lr, epoch=1, step=0)]
    grads = {f"{k}.{n}": p.grad.clone() for k, m in nets(t).items() for n, p in m.named_parameters()}
    steps.append(t.train_step(x, y, lr) if isinstance(t, SegTrainer) else t.train_step(x, y, lr, epoch=1, step=1))
    return [{k: float(v) for k, v in m.items()} for m in steps], grads


def assert_same_step(got, want):
    """Step-1 losses equal, step-1 gradients within TOL_SAME_GRAD of each
    norm, step-2 losses within rtol TOL_SAME_STEP2."""
    (g_losses, g_grads), (w_losses, w_grads) = got, want
    assert g_losses[0] == w_losses[0]
    assert set(g_grads) == set(w_grads)
    for name, g in g_grads.items():
        err = float((g - w_grads[name]).abs().max())
        assert err <= TOL_SAME_GRAD * max(float(w_grads[name].norm()), 1e-30), name
    for k, v in w_losses[1].items():
        np.testing.assert_allclose(g_losses[1][k], v, rtol=TOL_SAME_STEP2, err_msg=k)


BASELINES = {}


def baseline(key, make, x, y, lr=LR):
    """``two_steps`` of the trainer without remat, once per key."""
    if key not in BASELINES:
        BASELINES[key] = two_steps(make, x, y, lr)
    return BASELINES[key]
