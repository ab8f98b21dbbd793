"""The readings that the limits of a cell's check are set from, at the
cell's own size, in one process on the card.

    python3 benchmark/tools/control.py --workload pairedattention.train --seeds 1 2 3 4 5 6
        [--control-seeds 1 2 3]

For every seed, the program's sound readings: a training cell's first
steps through ``train_step`` against the reference's; a serving cell's
answers to every tile of its pool through the micro-batcher against the
reference's images.  For each control seed besides:

- the control, the reference in the program's place computed in the
  nearest precision below the configuration's: fp8 for bfloat16 training,
  TF32 for f32 serving;
- a training cell's fault of a step that leaves half of its batch out:
  the program stepped on the first half of each batch (the mean taken over
  it), against the reference's whole batch.  (A step that returns its
  state unchanged reads 1 on ``change`` by its definition, with no run.)
- a cycle cell's fault of replay buffers that, once full, never swap an
  image in: the program with every draw's p set to 0.

One JSON line a seed.  The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def train_readings(cell, seed: int, control: bool, device) -> dict:
    from benchlib import checks, program, spec, weights

    drv = spec.loop(cell)
    config, p = cell.config, cell.params
    n, b = p["checked_steps"], config["batch"]
    t = time.perf_counter()
    trainer, pool, prog = drv.program_readings(config, seed, n, device)
    del trainer
    ref = drv.reference_readings(config, seed, n, device)
    out = {"seed": seed, "sound": checks.train_numbers(prog, ref), "sound_detail": checks.train_detail(prog, ref)}
    if control:
        ctrl = drv.reference_readings(config, seed, n, device, "fp8")
        out["control"] = checks.train_numbers(ctrl, ref)
        out["control_detail"] = checks.train_detail(ctrl, ref)
        trainer = program.build_trainer(config, device)
        program.load(trainer, config, weights.make_state(config, seed, device))
        half = program.first_steps(trainer, config, [(x[:b // 2], y[:b // 2]) for x, y in pool], n)
        del trainer
        out["half_batch"] = checks.train_numbers(half, ref)
        out["half_batch_detail"] = checks.train_detail(half, ref)
        if config["step"] == "cycle":
            from floodgan_tpu_torch.train.cycle import ImageBuffer

            query = ImageBuffer.query_batch
            ImageBuffer.query_batch = lambda self, images, draws: query(self, images, [(0.0, s) for _, s in draws])
            try:
                trainer = program.build_trainer(config, device)
                program.load(trainer, config, weights.make_state(config, seed, device))
                broken = program.first_steps(trainer, config, pool, n)
                del trainer
            finally:
                ImageBuffer.query_batch = query
            out["no_replay"] = checks.train_numbers(broken, ref)
            out["no_replay_detail"] = checks.train_detail(broken, ref)
    out["seconds"] = time.perf_counter() - t
    return out


def serve_readings(cell, seed: int, control: bool, device) -> dict:
    import numpy as np
    import torch

    from benchlib import serving, weights
    from reference import steps as ref_steps

    t = time.perf_counter()
    served = serving.Served(cell.config, cell.params, seed, device)
    answers = serving.Answers()
    for k, tile in enumerate(served.tiles):
        answers.track(k, k, served.frontend.submit(tile))
    answers.wait(len(served.tiles), serving.GRACE_S)
    served.close()
    out = {"seed": seed, "sound": serving.answer_numbers(cell.config, cell.params, seed, device, answers,
                                                         len(served.tiles))}
    if control:
        config = cell.config
        gen = next(iter(config["instances"]))
        state = weights.make_state(config, seed, device, only={gen})[gen]
        tiles = torch.from_numpy(np.stack(served.tiles)).to(device)
        want = ref_steps.serve_outputs(state, tiles, "float32")
        got = ref_steps.serve_outputs(state, tiles, "tf32")
        out["control"] = {"answer": float((got - want).abs().max())}
    out["seconds"] = time.perf_counter() - t
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    from benchlib import device, spec

    cell = spec.load_cell(args.workload)
    device.require_cards(cell.chips)
    import torch

    dev = torch.device("cuda", 0)
    print(device.card_label(0), flush=True)
    readings = train_readings if cell.params["loop"] == "train" else serve_readings
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, seed in args.control_seeds, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
