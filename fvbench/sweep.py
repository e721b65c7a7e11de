"""Find a serving cell's knee once, by a sweep of offered rates on the card:

    python3 -m fvbench.sweep --workload <serving cell> --seed <n> --seconds <s> --rates 40 80 ...

One process builds and warms the cell, then offers each rate in turn for
`--seconds` with the cell's lengths and mels, and prints a line per rate:
latency p50 and p95 from the due time, failures, and the backlog (requests
due but not done) after the first second and at the window's end.  The knee
is the highest rate with no failure whose backlog at the end is no larger
than after the first second; the cell's mix file then states its rate as a
number.  Runs no check: the cell's own runs do.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)

    from fvbench.run import cache_dirs

    cache_dirs()
    import torch

    from fvbench import common, program, traffic
    from fvbench.drivers import serve
    from fvbench.registry import Registry

    cell = Registry.load().cell(args.workload)
    if not torch.cuda.is_available():
        print("fvbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    cfg = cell.config
    common.set_precision(cfg["dtype"], cfg["tf32"])
    ctx = common.Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=False,
                         device=torch.device("cuda", 0), t_start=time.perf_counter())
    mix = cell.mix
    params = ctx.serving_params()
    synth, batcher = serve.build(ctx, program.serving_generator(cell, params, ctx.device).inference)
    worst = traffic.quantile_lengths(mix["lengths"], int(max(args.rates) * args.seconds))
    serve.warm(ctx, synth, worst)
    pool = traffic.MelPool(mix["mel"], args.seed)
    for rate in args.rates:
        due_rel = traffic.arrivals(dict(mix["arrivals"], rate=rate), args.seconds, args.seed)
        Ts = traffic.lengths(mix["lengths"], len(due_rel), args.seed)
        mels = pool.many(Ts)
        serve.reset(ctx.record)
        _, due, done, failed, late, backlog, _ = serve.offer(ctx, batcher, mels, due_rel, set())
        lat = np.array([np.inf if f or d is None else (d - u) * 1e3
                        for u, d, f in zip(due, done, failed)])
        rows = [c[2] for c in ctx.record["forward_calls"]]
        print(json.dumps({
            "rate": rate, "requests": len(Ts), "failed": int(np.sum(~np.isfinite(lat))),
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "backlog_1s": backlog.get("1s"), "backlog_end": backlog["end"],
            "late_p99_ms": float(np.percentile(late, 99) * 1e3),
            "rows_per_forward": float(np.mean(rows)) if rows else None,
            "audio_s_per_s": float(np.sum(Ts)) * cfg["hop_size"] / cfg["sample_rate"]
            / args.seconds}), flush=True)
    batcher.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
