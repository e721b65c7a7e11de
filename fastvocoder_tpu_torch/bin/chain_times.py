"""Times of the residual-stack chain forward (kernel 2) and of the two
backward kernels, float32 (3, 5) and bf16 (3b, 5b), by pass, of the package
in any checkout, on one NVIDIA GPU.

    python3 fastvocoder_tpu_torch/bin/chain_times.py --root <checkout> --label <name>
        [--json <path>] [--events]

Run as a file, once per checkout: it puts `--root` first on the module path
and imports that checkout's `fastvocoder_tpu_torch`, so two commits (for
example the parent unpacked with `git archive` under `build/`) are compared
in one call by running it on each in turns.  With seeded weights:

* the chain forward at Basis-MelGAN light's shapes, batch 1 and 32 (with a
  kept `ChainTable` where the checkout has one), and the host time of one
  forward wrapper call at (1, 64, 256), the device idle when it starts
  (median of 60), with the operands checked and packed on every call and
  with a kept table (CUDA events, 20 calls after 3);
* at the shapes of the training paths (32 crops of 140 frames), the chain
  backward (3 stacks, K = 3, dilations 1, 3, 9) at Basis-MelGAN light's two
  stages and MelGAN original's four, the MRF backward (kernels 3, 7, 11,
  dilations 1, 3, 5) at HiFiGAN light's four, each in float32 and bf16: the
  ms of one call (CUDA events, 5 calls after 2), the bound of its form (every
  product three times at 495 TFLOP/s; the bf16 forms two times in the
  recompute and the adjoints, 7/9 of it) and the device time of one call by
  pass from torch.profiler's events, in launch order: a conv launch of the
  chain is the 1x1 conv's adjoint or the dilated and skip adjoint in turn,
  the MRF's conv2's or conv1's adjoint, its weight gradients dW2 and dW1.
  With `--events` it also prints every launch of one call in order, with
  its pass and device ms.

L2 is not flushed between calls.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

TF32_FLOP_PER_S = 495e12
BATCH = 32
CHAIN_STAGES = (("Basis-MelGAN", ((560, 256), (2240, 256))),
                ("MelGAN", ((1400, 256), (8400, 128), (16800, 64), (33600, 32))))
MRF_STAGES = (("HiFiGAN", ((1120, 128), (5600, 64), (16800, 32), (33600, 16))),)
STACK_DILATIONS, STACK_K = (1, 3, 9), 3
KERNELS, DILATIONS = (3, 7, 11), (1, 3, 5)

# (substring of a kernel's name, pass), first match wins; a pair of passes
# alternates in launch order
PASSES = (("widen", "widen bf16 inputs"), ("narrow", "round outputs to bf16"),
          ("pack_kernel", "pack weights"), ("wgrad_reduce", "weight gradient: reduce"),
          ("stack_kernel", "recompute"), ("pair_kernel", "recompute"),
          ("fold_kernel", "reflect-pad fold"), ("divide_kernel", "g / branches"),
          ("sum_kernel", "sum of branches' dx"))
ALTERNATING = {"resstack_bwd": {"conv_kernel": ("1x1 adjoint", "dilated and skip adjoint"),
                                "wgrad_kernel": ("weight gradients", "weight gradients")},
               "mrf_bwd": {"conv_kernel": ("conv2 adjoint", "conv1 adjoint"),
                           "wgrad_kernel": ("weight gradient dW2", "weight gradient dW1")}}


def _seeded(torch, g, *shape, fan_in):
    return ((torch.rand(shape, generator=g) * 2 - 1) / np.sqrt(fan_in)).cuda()


def stacks_at(torch, C: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return [(_seeded(torch, g, STACK_K, C, C, fan_in=STACK_K * C),
             _seeded(torch, g, C, fan_in=STACK_K * C), d, _seeded(torch, g, 1, C, C, fan_in=C),
             _seeded(torch, g, C, fan_in=C), _seeded(torch, g, 1, C, C, fan_in=C),
             _seeded(torch, g, C, fan_in=C)) for d in STACK_DILATIONS]


def resblocks_at(torch, C: int):
    g = torch.Generator().manual_seed(C)
    return [[(_seeded(torch, g, K, C, C, fan_in=C * K), _seeded(torch, g, C, fan_in=C * K), d,
              _seeded(torch, g, K, C, C, fan_in=C * K), _seeded(torch, g, C, fan_in=C * K))
             for d in DILATIONS] for K in KERNELS]


def to_bf16(ops):
    if isinstance(ops, (list, tuple)):
        return [to_bf16(o) for o in ops]
    return ops.bfloat16() if hasattr(ops, "dtype") else ops


def pass_of(name: str, family: str, seen: dict) -> str:
    for key, label in PASSES:
        if key in name:
            return label
    for key, labels in ALTERNATING.get(family, {}).items():
        if key in name:
            i = seen.get(key, 0)
            seen[key] = i + 1
            return labels[i % 2]
    return "other: " + name[:60]


def by_pass(torch, fn, family: str, n: int = 3, launches=None) -> dict:
    """Device ms of one call of fn by pass, from torch.profiler's events of n
    calls in launch order; `launches`, if a list, gets (pass, kernel name,
    ms) of each launch of the first call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    out, seen = {}, {}
    for i, e in enumerate(events):
        label = pass_of(e.name, family, seen)
        ms = (e.time_range.end - e.time_range.start) / 1e3
        out[label] = out.get(label, 0.0) + ms / n
        if launches is not None and i < len(events) // n:
            launches.append((label, e.name, ms))
    return out


def forward_times(torch, r, label: str) -> None:
    """Kernel 2 at Basis-MelGAN light's shapes and the host time of a call."""

    def ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 20

    def host_us(fn, n=60):
        """median host time of one call, the device idle when it starts"""
        for _ in range(5):
            fn()
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return float(np.median(ts)) * 1e6

    C = 256
    stacks = stacks_at(torch, C, 0)
    for B, T in ((1, 2340), (1, 9360), (32, 560), (32, 2240)):
        x = 0.3 * torch.randn(B, T, C, device="cuda")
        kw = {"table": r.ChainTable(stacks, x.device)} if hasattr(r, "ChainTable") else {}
        t = ms(lambda: r.fused_residual_stacks_cuda(x, stacks, **kw))
        print(f"[{label}] fused_resstack ({B}, {T}, {C}): forward {t:.4f} ms", flush=True)
    x = 0.3 * torch.randn(1, 64, C, device="cuda")
    line = (f"[{label}] host us a call at (1, 64, 256): operands each call "
            f"{host_us(lambda: r.fused_residual_stacks_cuda(x, stacks)):.1f}")
    if hasattr(r, "ChainTable"):
        t = r.ChainTable(stacks, x.device)
        line += f", kept table {host_us(lambda: r.fused_residual_stacks_cuda(x, stacks, t)):.1f}"
    print(line, flush=True)


def backward_times(torch, r, fm, label: str, events: bool) -> list:
    """Kernels 3, 3b, 5 and 5b at the training paths' shapes, by pass."""

    def ms(fn, iters=5, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    runs = []
    for model, shapes in CHAIN_STAGES:
        for T, C in shapes:
            flops = 3 * 2 * BATCH * T * len(STACK_DILATIONS) * (STACK_K + 2) * C * C
            runs.append((model, "resstack_bwd", (T, C), stacks_at(torch, C, C), flops,
                         r.fused_residual_stacks_vjp_cuda, r.fused_residual_stacks_vjp_bf16_cuda))
    for model, shapes in MRF_STAGES:
        for T, C in shapes:
            flops = 3 * 2 * BATCH * T * len(DILATIONS) * 2 * sum(KERNELS) * C * C
            runs.append((model, "mrf_bwd", (T, C), resblocks_at(torch, C), flops,
                         fm.fused_mrf_stage_vjp_cuda, fm.fused_mrf_stage_vjp_bf16_cuda))
    rows = []
    for model, family, (T, C), ops, flops, f32, bf16 in runs:
        g = torch.Generator().manual_seed(T + C)
        x = (0.3 * torch.randn(BATCH, T, C, generator=g)).cuda()
        cot = torch.randn(BATCH, T, C, generator=g).cuda()
        xb, cb, ob = x.bfloat16(), cot.bfloat16(), to_bf16(ops)
        bound3 = 3 * flops / TF32_FLOP_PER_S * 1e3
        for form, fn in (("float32", lambda: f32(x, ops, cot)),
                         ("bf16", lambda: bf16(xb, ob, cb))):
            t = ms(fn)
            launches = [] if events else None
            passes = by_pass(torch, fn, family, launches=launches)
            for name, kernel, lms in launches or ():
                print(f"[{label}]     {form} ({T}, {C}) {name}: {lms:.4f} ms  {kernel[:90]}")
            bound = bound3 * 7 / 9 if form == "bf16" else bound3
            rows.append({"label": label, "model": model, "kernel": family, "form": form,
                         "shape": [BATCH, T, C], "ms": t, "bound_3xtf32_ms": bound3,
                         "bound_ms": bound, "passes": passes})
            print(f"[{label}] {family} {form} {model} ({BATCH}, {T}, {C}): {t:.3f} ms, "
                  f"bound {bound:.3f} ms (3xTF32 {bound3:.3f}), share {bound / t:.3f}; "
                  + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()), flush=True)
        del x, cot, xb, cb, ob
        torch.cuda.empty_cache()
    for family, form in (("resstack_bwd", "float32"), ("resstack_bwd", "bf16"),
                         ("mrf_bwd", "float32"), ("mrf_bwd", "bf16")):
        for model in sorted({r_["model"] for r_ in rows if r_["kernel"] == family}):
            sel = [r_ for r_ in rows if (r_["kernel"], r_["form"], r_["model"]) ==
                   (family, form, model)]
            t, b = sum(r_["ms"] for r_ in sel), sum(r_["bound_ms"] for r_ in sel)
            passes = {}
            for r_ in sel:
                for k, v in r_["passes"].items():
                    passes[k] = passes.get(k, 0.0) + v
            print(f"[{label}] {family} {form} {model} summed: {t:.3f} ms, bound {b:.3f} ms, "
                  f"share {b / t:.3f}; " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()),
                  flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--json", default="")
    ap.add_argument("--events", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch

    from fastvocoder_tpu_torch.ops import _build
    from fastvocoder_tpu_torch.ops import fused_mrf as fm
    from fastvocoder_tpu_torch.ops import fused_resstack as r

    if not torch.cuda.is_available():
        print("chain_times: CUDA is not available", file=sys.stderr)
        return 2
    _build.build_all()
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[{args.label}] {card.strip()}", flush=True)
    forward_times(torch, r, args.label)
    rows = backward_times(torch, r, fm, args.label, args.events)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card.strip(), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
