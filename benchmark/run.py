"""The benchmark of the PyTorch port, one cell per run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names its configuration and its traffic mix, whose
files, and the loop the mix names, are found by name (benchlib/spec.py).
The run makes the weights and the inputs on the card from ``--seed``,
warms up the cell's own shapes, measures for ``--seconds``, checks what
the timed path produced against the plain reference, and prints as its
last line one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, read from a profiled slice of the window), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number
compared beside its limit (also the last lines on standard error).

It exits with code 2, printing no result, where there is no card or too
few, and with code 3 where the process loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def per_layer(cell, outcome, kind: str) -> dict:
    """Each per-layer metric of the cell that its reader finds something to
    read for."""
    from benchlib import device, spec

    ctx = SimpleNamespace(config=cell.config, params=cell.params, window=outcome.window,
                          counters=outcome.counters, trace=outcome.trace,
                          peak_tflops=lambda precision: device.peak_tflops(kind, precision),
                          hbm_bytes_per_s=device.HBM_BYTES_PER_S)
    out = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"], cell.bench_dir)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def measure(cell, seed: int, seconds: float, trace: bool, dev, kind: str, label: str) -> dict:
    """Run the cell on ``dev`` and make the result line (with ``checks``
    last); earlier lines and the numbers beside their limits are printed."""
    from benchlib import checks, device, spec
    from benchlib.trace import breakdown

    before_loop = time.perf_counter() - CLOCK0
    outcome = spec.loop(cell).run(cell, seed, seconds, trace, dev)
    setup_s = outcome.window_start - CLOCK0
    if trace:
        metrics = per_layer(cell, outcome, kind)
    else:
        values = {**outcome.end_to_end, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    ok, shown = checks.judge(outcome.numbers, cell.limits)
    dev_info = {"platform": "gpu", "kind": kind, "count": cell.chips,
                "memory_peak_bytes": outcome.memory_peak_bytes, "card": label,
                "power_limit_w": device.power_limit_w(label),
                "peak_tflops": {p: device.peak_tflops(kind, p) for p in ("bf16", "tf32", "f32")}}
    result = {"correct": ok and outcome.failed == 0, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": dev_info}
    if trace:
        if outcome.trace is None:
            raise RuntimeError("the traced run has no slice")
        dev_info.update(busy_s=outcome.trace.busy_s, window_s=outcome.trace.window_s)
        result["breakdown"] = breakdown(outcome.trace)
    result["checks"] = shown
    print(f"{cell.name} seed {seed}: setup_s {setup_s!r}, of which {before_loop:.3f} before the loop "
          "(imports, the card's name and limit)")
    for line in outcome.info:
        print(line)
    sys.stdout.flush()
    checks.print_numbers(shown)
    return result


def main(argv=None) -> int:
    args = parse(argv)
    from benchlib import device, guard, spec

    cell = spec.load_cell(args.workload)
    device.require_cards(cell.chips)
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = measure(cell, args.seed, args.seconds, bool(args.trace), dev, torch.cuda.get_device_name(0),
                     device.card_label(0))
    guard.check()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
