"""Serving benchmark: the engine's latency and throughput at fixed batch
shapes, or the micro-batcher under concurrent clients.

    python -m floodgan_tpu_torch.tools.serve_bench [--model pairedattention] [--size 512]
        [--batches 1 8] [--iters 20] [--device cpu]
    python -m floodgan_tpu_torch.tools.serve_bench --frontend [--clients 1 8 32]
        [--requests_per_client 20] [--max_delay_ms 5]

The counterpart of tools/serve_bench.py, with its flags and its output: one
JSON line per configuration, after a line naming the device.  The weights
are a seeded init of the port's own trainer for ``--model`` (seed 0); a
cycle family serves its A->B generator, as ``InferenceEngine`` does.

- Engine mode: one ``InferenceEngine`` per ``--batches`` entry, timed by
  ``engine.benchmark(iters)`` (host clock, each call waited for, the input
  already on the device).
- ``--frontend``: one engine at ``max(--batches)``; for each client count
  a fresh ``BatchingFrontend``, one warm-up request outside the clock, then
  that many threads each sending ``--requests_per_client`` sequential
  single-image requests.  Per-request p50/p99 wall latency, images/s over
  the run's wall time, and the frontend's mean batch occupancy.  A client
  that raises fails the run: its first exception is raised again after the
  threads are joined.

It runs on the card unless ``--device cpu`` is given, and raises where
there is none.  ``main`` returns the printed JSON lines, as dicts.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

from floodgan_tpu_torch.core.config import _check_model, model_is_cycle
from floodgan_tpu_torch.core.device import resolve_device
from floodgan_tpu_torch.serve import BatchingFrontend, InferenceEngine

REQUEST_TIMEOUT_S = 600.0  # a request that takes longer fails the run instead of hanging it


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", default="pairedattention",
                   help="pix2pix, cyclegan, attentiongan or pairedattention (case-insensitive)")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--dtype", default="bfloat16",
                   help="accepted and printed; serving runs in f32 whatever it says, in both packages "
                        "(the engine's compute_dtype changes nothing)")
    p.add_argument("--wire_dtype", default="float32",
                   help="host->device input transfer dtype (bfloat16 halves wire bytes)")
    p.add_argument("--frontend", action="store_true",
                   help="bench the BatchingFrontend micro-batcher under concurrent client threads "
                        "(p50/p99 per-request latency + aggregate throughput) instead of the bare engine")
    p.add_argument("--clients", type=int, nargs="+", default=[1, 8, 32],
                   help="frontend mode: concurrent client thread counts")
    p.add_argument("--requests_per_client", type=int, default=20)
    p.add_argument("--max_delay_ms", type=float, default=5.0)
    p.add_argument("--device", default=None, help="cpu for the plain versions; default: the card")
    return p


def seeded_generator(model: str, device: torch.device) -> dict:
    """The generator ``state_dict`` of a seed-0 trainer of ``model`` (for a
    cycle family, the A->B generator's)."""
    from floodgan_tpu_torch.train.cycle import CycleTrainer
    from floodgan_tpu_torch.train.paired import PairedTrainer

    if model_is_cycle(model):
        trainer = CycleTrainer(model, 9, (64, 64), device=device, seed=0)
        return trainer.gen_ab.state_dict()
    return PairedTrainer(model, 9, device=device, seed=0).generator.state_dict()


def _emit(line: dict) -> dict:
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, "serve_bench")
    model = _check_model(args.model)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{kind}: {args.model} {args.size}^2, serving in f32", flush=True)
    gen_params = seeded_generator(model, device)
    if args.frontend:
        return run_frontend(args, model, gen_params, device)
    lines = []
    for b in args.batches:
        engine = InferenceEngine(
            model, gen_params, "all", batch_size=b, image_size=args.size,
            compute_dtype=args.dtype, wire_dtype=args.wire_dtype, device=device,
        )
        stats = engine.benchmark(iters=args.iters)
        lines.append(_emit({
            "metric": f"{args.model} {args.size}^2 serve batch {b}",
            "latency_ms": round(stats["latency_ms"], 3),
            "images_per_sec": round(stats["images_per_sec"], 2),
            "dtype": args.dtype,
            "wire_dtype": args.wire_dtype,
        }))
    return lines


def run_frontend(args, model: str, gen_params, device) -> list:
    """The micro-batcher under 1, 8, 32, ... concurrent clients (module
    docstring).  One engine batch shape serves every client count: the
    frontend zero-pads partial batches."""
    engine = InferenceEngine(
        model, gen_params, "all", batch_size=max(args.batches), image_size=args.size,
        compute_dtype=args.dtype, wire_dtype=args.wire_dtype, device=device,
    )
    stack = np.random.default_rng(47).standard_normal(engine.input_shape, dtype=np.float32)
    lines = []
    for n_clients in args.clients:
        lock = threading.Lock()
        latencies, errors = [], []
        frontend = BatchingFrontend(engine, max_delay_ms=args.max_delay_ms)
        try:
            frontend.predict(stack, timeout=REQUEST_TIMEOUT_S)  # the first batch, outside the clock

            def client():
                mine = []
                try:
                    for _ in range(args.requests_per_client):
                        t0 = time.perf_counter()
                        frontend.predict(stack, timeout=REQUEST_TIMEOUT_S)
                        mine.append(time.perf_counter() - t0)
                except Exception as e:  # raised again after the join
                    with lock:
                        errors.append(e)
                with lock:
                    latencies.extend(mine)

            threads = [threading.Thread(target=client) for _ in range(n_clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            stats = frontend.stats()
        finally:
            frontend.close()
        if errors:
            raise errors[0]

        lat_ms = np.sort(np.array(latencies)) * 1e3
        total = n_clients * args.requests_per_client
        lines.append(_emit({
            "metric": f"{args.model} {args.size}^2 frontend batch<= {engine.batch_size} clients {n_clients}",
            "p50_ms": round(float(np.percentile(lat_ms, 50)), 2),
            "p99_ms": round(float(np.percentile(lat_ms, 99)), 2),
            "images_per_sec": round(total / wall, 2),
            "mean_batch_occupancy": round(stats["mean_occupancy"], 3),
            "max_delay_ms": args.max_delay_ms,
            "requests": total,
            "dtype": args.dtype,
            "wire_dtype": args.wire_dtype,
        }))
    return lines


if __name__ == "__main__":
    main()
