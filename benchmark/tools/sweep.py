"""The sweep that finds the open-loop knee of a serving cell: one set-up,
then one window at each rate, in one process on the card.

    python3 benchmark/tools/sweep.py --workload pairedattention.serve_tiles --seed 7
        --seconds 15 --rates 30 36 40 44 48 52

Prints one JSON line a rate: the latency percentiles, the medians of the
first and second half of the requests (a backlog that grows over the
window makes the second the larger), the requests unanswered when the
window closed, and the batches' occupancy.  The knee is the highest rate
without a growing backlog; the cell's rate is about four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    from benchlib import device, serving, spec

    cell = spec.load_cell(args.workload)
    device.require_cards(cell.chips)
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    drv = spec.loop(cell)
    served = serving.Served(cell.config, cell.params, args.seed, dev)
    print(device.card_label(0), flush=True)
    for i, rate in enumerate(args.rates):
        w = drv.window(served, rate, args.seconds, args.seed + i, cell.params)
        lat = w["latency_s"] * 1e3
        print(json.dumps({
            "rate_per_s": rate, "requests": w["n"], "failed": w["n"] - len(w["answers"].answer),
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "first_half_median_ms": w["first_half_median_s"] * 1e3,
            "second_half_median_ms": w["second_half_median_s"] * 1e3,
            "unanswered_at_close": w["unfinished_at_close"],
            "occupancy": w["slots"] / max(1, w["batches"] * w["batch_size"]),
            "answered_per_s": len(w["answers"].answer) / args.seconds,
        }), flush=True)
    served.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
