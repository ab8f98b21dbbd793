"""Training traffic: the configuration's trainer stepped over a pool of
distinct batches, taken in turn, for the whole window.

Set-up builds the trainer, loads the seeded weights, makes the pool and
runs the first ``checked_steps`` steps through the window's own call on
the pool's first batches (they warm every shape up), keeping the
program's readings of them.  The window then steps on from there; its
rate is all the samples over all the time, ending in a synchronize.  A
traced run profiles ``trace_steps`` steps from ``trace_at`` of the way
in (the per-layer rate leaves the slice's steps and time out).  Once
the window has closed and the peak memory is read, the
program's state is freed and the reference runs the same first steps
from the same weights.

Parameters (the mix's file, the cell's over it): ``pool_batches``,
``checked_steps``, ``trace_steps``, ``trace_at``.
"""

from __future__ import annotations

import gc
import json
import math
import time

import torch

from benchlib import checks, inputs, program, weights
from benchlib.outcome import Outcome
from benchlib.trace import Slice
from reference import steps as ref_steps


def reference_readings(config: dict, seed: int, n: int, device, precision: str = "float32") -> dict:
    """The reference's readings of the first ``n`` steps from the seed's
    weights over the seed's first batches."""
    state = weights.make_state(config, seed, device)
    pool = inputs.train_pool(config, n, seed, device)
    batches = [(x.permute(0, 3, 1, 2).contiguous(), y.permute(0, 3, 1, 2).contiguous()) for x, y in pool]
    del pool
    if config["step"] == "paired":
        return ref_steps.paired_steps(state, batches, config["recipe"], precision)
    return ref_steps.cycle_steps(state, batches, config["recipe"], precision)


def program_readings(config: dict, seed: int, n: int, device, pool_batches: int = None, phases=None):
    """(trainer, pool, readings of its first ``n`` steps) from the seed;
    each phase's seconds are appended to ``phases``."""
    phases = [] if phases is None else phases
    t = time.perf_counter()

    def phase(name: str) -> None:
        nonlocal t
        _sync(device)
        now = time.perf_counter()
        phases.append((name, now - t))
        t = now

    trainer = program.build_trainer(config, device)
    phase("trainer")
    program.load(trainer, config, weights.make_state(config, seed, device))
    phase("weights")
    pool = inputs.train_pool(config, pool_batches or n, seed, device)
    phase("pool")
    readings = program.first_steps(trainer, config, pool, n)
    phase("checked steps")
    return trainer, pool, readings


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device) -> Outcome:
    config, p = cell.config, cell.params
    n = p["checked_steps"]
    if p["pool_batches"] < n:
        raise ValueError(f"the checked steps ({n}) need as many distinct batches, the pool has {p['pool_batches']}")
    phases = []
    trainer, pool, prog = program_readings(config, seed, n, device, p["pool_batches"], phases)
    lr = config["recipe"]["lr"]
    launches0 = program.launches()
    _sync(device)

    step = n

    def train(count: int):
        nonlocal step
        for _ in range(count):
            x, y = pool[step % len(pool)]
            out = trainer.train_step(x, y, lr, epoch=0, step=step)
            step += 1
        return out

    window_start = time.perf_counter()
    sl, traced, traced_s, summary = None, 0, 0.0, None
    while time.perf_counter() - window_start < seconds:
        if trace and sl is None and time.perf_counter() - window_start >= p["trace_at"] * seconds:
            sl = Slice()
            sl.start()
            losses = train(p["trace_steps"])
            summary = sl.stop()
            traced, traced_s = p["trace_steps"], sl.ended - sl.began
        else:
            losses = train(1)
    _sync(device)
    window_s = time.perf_counter() - window_start
    steps = step - n
    finite = all(math.isfinite(float(v)) for v in losses.values())
    launched = {k: v - launches0[k] for k, v in program.launches().items() if v != launches0[k]}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    del trainer, pool, losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference_readings(config, seed, n, device)
    reference_s = time.perf_counter() - t
    numbers = checks.train_numbers(prog, ref)
    return Outcome(
        window_start=window_start,
        end_to_end={"train_samples_per_s": steps * config["batch"] / window_s},
        attempted=steps,
        failed=0 if finite else 1,
        memory_peak_bytes=peak,
        numbers=numbers,
        window={"seconds": window_s, "steps": steps, "samples": steps * config["batch"], "traced_steps": traced,
                "untraced_seconds": window_s - traced_s, "untraced_steps": steps - traced},
        trace=summary,
        info=[f"set-up phases s: {', '.join(f'{k} {v:.3f}' for k, v in phases)}; reference {reference_s:.3f}",
              f"window: {steps} steps of {config['batch']} in {window_s!r} s",
              f"kernel launches over the window: {launched}",
              f"readings: {json.dumps(numbers)}; {json.dumps(checks.train_detail(prog, ref))}",
              f"program losses of the checked steps: {prog['losses']}",
              f"reference losses of the checked steps: {ref['losses']}"],
    )
