"""Run one cell of `BENCHMARK.json` once:

    python3 -m fvbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights from the seed on the card, the program built, the cell's
shapes warmed), then the measured window, then the check of what the
window produced against the plain reference.  The last line of standard
output is one JSON object: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` `breakdown`, and last `checks`: each number
compared with its limit (also the last lines of standard error).

Exits non-zero, printing no result, without a CUDA device (or fewer than the
cell asks for), and when the process holds JAX or the JAX package once the
window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fastvocoder_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark's process may
    not hold, each compared whole (`fastvocoder_tpu_torch` is not
    `fastvocoder_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs() -> None:
    """Keep every build and kernel cache in fixed directories inside the
    checkout: the program builds its CUDA libraries under `build/` beside its
    package (`ops/_build.py`); Triton's and torch's extension caches are
    pointed there too."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")


def execute(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            forward_override=None):
    """Run `cell` once on `device`; -> the driver's context."""
    import importlib

    from fvbench import common

    cfg = cell.config
    print(f"set-up: imports at {time.perf_counter() - t_start:.3f} s", file=sys.stderr)
    common.set_precision(cfg["dtype"], cfg["tf32"])
    ctx = common.Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device,
                         t_start=t_start, forward_override=forward_override)
    importlib.import_module(f"fvbench.drivers.{cell.mix['driver']}").run(ctx)
    return ctx


def result(ctx, registry) -> dict:
    """The result line's object; `checks` last."""
    import torch

    from fvbench import readers

    cell = ctx.cell
    correct = ctx.failed == 0 and all(
        v <= cell.limits[k] for k, v in ctx.checks.items())
    if ctx.trace:
        run = readers.Run(ctx)
        metrics = {}
        for m in cell.per_layer:
            value = registry.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": ctx.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
              else "cpu",
              "count": cell.chips, "memory_peak_bytes": ctx.memory_peak}
    out = {"correct": bool(correct), "attempted": ctx.attempted, "failed": ctx.failed,
           "metrics": metrics, "device": device}
    if ctx.summary is not None:
        device["busy_s"] = ctx.summary.busy_s
        device["window_s"] = ctx.summary.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in ctx.summary.device_ops],
                            "idle_gaps": [list(x) for x in ctx.summary.idle_gaps]}
    # a check that could not be made (a request that never came) reads as over any limit
    out["checks"] = {k: {"value": v if math.isfinite(v) else 1e300, "limit": cell.limits[k]}
                     for k, v in ctx.checks.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    import torch

    from fvbench.registry import Registry

    registry = Registry.load()
    cell = registry.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"fvbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                  T_START)
    held = forbidden_modules()
    if held:
        print(f"fvbench: the process holds {held}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    out = result(ctx, registry)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
