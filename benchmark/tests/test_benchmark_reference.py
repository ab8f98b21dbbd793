"""The plain reference against the program's CPU path, at a small size:
both configurations' networks forward, and their train steps in f32 from
the same weights over the same batches."""

from __future__ import annotations

import pytest
import torch

from bench_fixtures import CPU, few_threads, small_cell
from benchlib import inputs, program, weights
from reference import nets, steps

few_threads()


@pytest.mark.parametrize("name", ["pairedattention.train", "attentiongan.train"])
def test_networks_forward(name):
    cell = small_cell(name)
    config = dict(cell.config, compute_dtype="float32")
    state = weights.make_state(config, 11, CPU)
    trainer = program.build_trainer(config, CPU)
    program.load(trainer, config, state)
    x, y = inputs.train_pool(config, 1, 11, CPU)[0]
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    mods = program.modules(trainer, config)
    gen, disc = next(iter(mods)), list(mods)[-1]
    d_in = torch.cat([x, y], 1) if config["step"] == "paired" else torch.cat([y, x[:, 3:]], 1)
    with torch.no_grad():
        out, mask = mods[gen](x)
        want_out, want_mask = nets.generator(state[gen], x)
        logits, want_logits = mods[disc](d_in), nets.discriminator(state[disc], d_in)
    torch.testing.assert_close(out, want_out, rtol=0, atol=1e-5)
    torch.testing.assert_close(mask, want_mask, rtol=0, atol=1e-6)
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["pairedattention.train", "attentiongan.train"])
def test_train_step_f32(name):
    cell = small_cell(name)
    config = dict(cell.config, compute_dtype="float32")
    state = weights.make_state(config, 12, CPU)
    trainer = program.build_trainer(config, CPU)
    program.load(trainer, config, state)
    pool = inputs.train_pool(config, 1, 12, CPU)
    prog = program.first_steps(trainer, config, pool, 1)
    batches = [(x.permute(0, 3, 1, 2).contiguous(), y.permute(0, 3, 1, 2).contiguous()) for x, y in pool]
    run = steps.paired_steps if config["step"] == "paired" else steps.cycle_steps
    ref = run(state, batches, config["recipe"])
    assert prog["losses"][0].keys() == ref["losses"][0].keys()
    for k, v in ref["losses"][0].items():
        assert prog["losses"][0][k] == pytest.approx(v, rel=1e-4), k
    assert prog["grad_norms"].keys() == ref["grad_norms"].keys()
    floor = sorted(ref["grad_norms"].values())[len(ref["grad_norms"]) // 2]
    for k, v in ref["grad_norms"].items():
        assert abs(prog["grad_norms"][k] - v) <= 1e-4 * max(v, floor), k


def test_cycle_blocks_are_the_whole_batch():
    """The cycle reference's blocks of images sum to the step on the whole
    batch: every operation of it is per image."""
    cell = small_cell("attentiongan.train")
    config = cell.config
    state = weights.make_state(config, 13, CPU)
    batches = [(x.permute(0, 3, 1, 2).contiguous(), y.permute(0, 3, 1, 2).contiguous())
               for x, y in inputs.train_pool(config, 1, 13, CPU)]
    whole = steps.cycle_steps(state, batches, config["recipe"], block=2)
    split = steps.cycle_steps(state, batches, config["recipe"], block=1)
    for k, v in whole["losses"][0].items():
        assert split["losses"][0][k] == pytest.approx(v, rel=1e-5), k
    floor = sorted(whole["grad_norms"].values())[len(whole["grad_norms"]) // 2]
    for k, v in whole["grad_norms"].items():
        assert abs(split["grad_norms"][k] - v) <= 1e-4 * max(v, floor), k


def test_serve_outputs_are_the_engine_forward():
    cell = small_cell("pairedattention.serve_tiles")
    config = cell.config
    gen = weights.make_state(config, 14, CPU, only={"generator"})["generator"]
    engine = program.build_engine(config, gen, CPU)
    tiles = inputs.tile_pool(config, 2, 14, CPU)
    torch.testing.assert_close(engine.predict(tiles), steps.serve_outputs(gen, tiles), rtol=0, atol=1e-5)
