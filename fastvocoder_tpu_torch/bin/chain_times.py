"""Times of the residual-stack chain forward (kernel 2), of the bf16 forward
forms 2b, 4b and 6b, and of the two backward kernels, float32 (3, 5) and
bf16 (3b, 5b), by pass, of the package in any checkout, on one NVIDIA GPU.

    python3 fastvocoder_tpu_torch/bin/chain_times.py --root <checkout> --label <name>
        [--parts forward,bf16_forward,backward] [--forms 2b,4b,6b] [--json <path>]
        [--against <path>] [--events]

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
  its pass and device ms.  Beside each, as a yardstick the port calls only
  under `--fused_train 0` and never as the kernel's replacement, the ms of
  the same stage's forward and backward through the module path under
  autograd (`stage_modules`: the port's `ResidualStack` / `ResBlock1`
  modules in the fused form holding the same weights, cuDNN convs with
  their (B, T, C) transposes, in bf16 the modules' `compute_dtype` casts),
  the gradients of x and of every weight and bias, CUDA events as the
  kernels';
* the bf16 forward forms at the shapes of their rows in PERF.md, batch 1
  and 32 (`BF16_FORWARD`): 2b (seeded stacks, K = 3, dilations 1, 3, 9)
  at Basis-MelGAN light's and MelGAN original's stages, 4b (seeded
  branches, kernels 3, 7, 11, dilations 1, 3, 5) at HiFiGAN light's, 6b on
  HiFiGAN light's release tail and on a seeded tail of HiFiGAN large's
  width (64 -> 32 channels, the width that keeps the five launches: 4b's
  C = 32 branches, k 4, stride 2, a 7-tap head).  For each shape: the device ms of one call
  (torch.profiler's kernels, 10 calls, kept tables) beside the CUDA events'
  ms of a loop of calls (which at batch 1 may time the host), the bf16
  bound (the products at 989 TFLOP/s or the bf16 bytes at 3.35 TB/s, 6b's
  head at the 67 TFLOP/s float32 rate), the max error against
  the plain version run in float64 on the same bf16 input (of its peak),
  the same for the plain bf16 version, a digest of the float32 form's
  output (2, 4, 6) on the same input widened, and, as a yardstick the port
  never calls, the device ms of the same stage as a cuDNN sequence: bf16
  `F.conv1d` calls in NCW layout (6b: `F.conv_transpose1d` first) with the
  leaky-relu, pad, residual and mean steps between them.  `--against`
  takes the `--json` of a run on another checkout and prints, per shape,
  whether the float32 digests are the same and the ratio of the bf16
  forms' device times.  4b's device ms at batch 1 and 6b's at both
  batches are also printed by kernel (the pair launches, the branch mean,
  the tail's launches).  `--forms` keeps the bf16 forward forms named.

L2 is not flushed between calls.
"""

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
BYTES_PER_S = 3.35e12
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
# (form, model, shapes): the bf16 forward forms' rows of PERF.md, batch 1
# and the training crops' batch of 32 (6b: a batch-32 inference of the tail)
BF16_FORWARD = (
    ("2b", "Basis-MelGAN", ((1, 2340, 256), (1, 9360, 256), (32, 560, 256), (32, 2240, 256))),
    ("2b", "MelGAN", ((1, 5850, 256), (1, 35100, 128), (1, 70200, 64), (1, 140400, 32),
                      (32, 1400, 256), (32, 8400, 128), (32, 16800, 64), (32, 33600, 32))),
    ("4b", "HiFiGAN", ((1, 4680, 128), (1, 23400, 64), (1, 70200, 32), (32, 1120, 128),
                       (32, 5600, 64), (32, 16800, 32), (32, 33600, 16))),
    ("6b", "HiFiGAN", ((1, 70200, 32), (32, 16800, 32))),
    ("6b", "HiFiGAN large", ((1, 70200, 64),)),
)
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


def large_tail_at(torch):
    """A seeded tail of HiFiGAN large's width (conf/hifigan/large.yaml's last
    stage and head): up (4, 64, 32), stride 2, padding 1, `resblocks_at(32)`,
    post (7, 32, 1)."""
    g = torch.Generator().manual_seed(64)
    return (_seeded(torch, g, 4, 64, 32, fan_in=128), _seeded(torch, g, 32, fan_in=128), 2, 1,
            resblocks_at(torch, 32), _seeded(torch, g, 7, 32, 1, fan_in=224),
            _seeded(torch, g, 1, fan_in=224))


def stage_modules(torch, family: str, ops, bf16: bool):
    """The stage of `ops` as the port's modules in the fused form, on the
    card, computing in bf16 with `bf16`: -> (fn(x (B, T, C)) -> y, the
    modules' parameters).  The chain is its stacks in turn, the MRF stage
    its blocks' mean, as `models.layers`' module path runs them."""
    from fastvocoder_tpu_torch.models.layers import ResBlock1, ResidualStack

    dt = torch.bfloat16 if bf16 else None

    def load(conv, k, b):
        with torch.no_grad():
            conv.weight.copy_(k.permute(2, 1, 0))
            conv.bias.copy_(b)

    if family == "resstack_bwd":
        mods = []
        for kd, bd, d, k1, b1, ks, bs in ops:
            m = ResidualStack(kd.shape[1], kernel_size=kd.shape[0], dilation=d,
                              compute_dtype=dt).cuda()
            for conv, k, b in ((m.conv_dilated, kd, bd), (m.conv_1x1, k1, b1), (m.skip, ks, bs)):
                load(conv, k, b)
            mods.append(m)

        def run(x):
            for m in mods:
                x = m(x)
            return x
    else:
        mods = []
        for pairs in ops:
            m = ResBlock1(pairs[0][0].shape[1], kernel_size=pairs[0][0].shape[0],
                          dilations=[p[2] for p in pairs], compute_dtype=dt).cuda()
            for (k1, b1, _, k2, b2), c1, c2 in zip(pairs, m.convs1, m.convs2):
                load(c1, k1, b1)
                load(c2, k2, b2)
            mods.append(m)

        def run(x):
            return sum(m(x) for m in mods) / len(mods)
    return run, [p for m in mods for p in m.parameters()]


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

    def module_path(family, ops, x, cot, bf16):
        run, params = stage_modules(torch, family, ops, bf16)
        xr = x.detach().requires_grad_(True)
        return lambda: torch.autograd.grad(run(xr), [xr] + params, cot)

    rows = []
    for model, family, (T, C), ops, flops, f32, bf16 in runs:
        g = torch.Generator().manual_seed(T + C)
        x = (0.3 * torch.randn(BATCH, T, C, generator=g)).cuda()
        cot = torch.randn(BATCH, T, C, generator=g).cuda()
        xb, cb, ob = x.bfloat16(), cot.bfloat16(), to_bf16(ops)
        bound3 = 3 * flops / TF32_FLOP_PER_S * 1e3
        for form, fn, yardstick in (
                ("float32", lambda: f32(x, ops, cot), module_path(family, ops, x, cot, False)),
                ("bf16", lambda: bf16(xb, ob, cb), module_path(family, ops, xb, cb, True))):
            t = ms(fn)
            cudnn = ms(yardstick)
            del yardstick
            launches = [] if events else None
            passes = by_pass(torch, fn, family, launches=launches)
            for name, kernel, lms in launches or ():
                print(f"[{label}]     {form} ({T}, {C}) {name}: {lms:.4f} ms  {kernel[:90]}")
            bound = bound3 * 7 / 9 if form == "bf16" else bound3
            rows.append({"label": label, "model": model, "kernel": family, "form": form,
                         "shape": [BATCH, T, C], "ms": t, "bound_3xtf32_ms": bound3,
                         "bound_ms": bound, "passes": passes, "module_path_ms": cudnn})
            print(f"[{label}] {family} {form} {model} ({BATCH}, {T}, {C}): {t:.3f} ms, "
                  f"bound {bound:.3f} ms (3xTF32 {bound3:.3f}), share {bound / t:.3f}; "
                  f"module path (cuDNN, forward and backward) {cudnn:.3f} ms; "
                  + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()), flush=True)
        del x, cot, xb, cb, ob
        torch.cuda.empty_cache()
    for family, form in (("resstack_bwd", "float32"), ("resstack_bwd", "bf16"),
                         ("mrf_bwd", "float32"), ("mrf_bwd", "bf16")):
        for model in sorted({r_["model"] for r_ in rows if r_["kernel"] == family}):
            sel = [r_ for r_ in rows if (r_["kernel"], r_["form"], r_["model"]) ==
                   (family, form, model)]
            t, b = sum(r_["ms"] for r_ in sel), sum(r_["bound_ms"] for r_ in sel)
            cudnn = sum(r_["module_path_ms"] for r_ in sel)
            passes = {}
            for r_ in sel:
                for k, v in r_["passes"].items():
                    passes[k] = passes.get(k, 0.0) + v
            print(f"[{label}] {family} {form} {model} summed: {t:.3f} ms, bound {b:.3f} ms, "
                  f"share {b / t:.3f}, module path {cudnn:.3f} ms; "
                  + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()), flush=True)
    return rows


def to_f64(ops):
    if isinstance(ops, (list, tuple)):
        return [to_f64(o) for o in ops]
    return ops.double() if hasattr(ops, "dtype") else ops


def device_ms(torch, fn, n: int, tries: int = 5) -> float:
    """Device ms of one call of fn: its kernels' durations summed
    (torch.profiler), over n calls after one.  A profile that lost kernels
    (fewer than n times those of a profiled call alone, which happens) is
    taken again, up to `tries` times."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(calls):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return [e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    for _ in range(tries):
        per_call = len(kernels(1))
        got = kernels(n)
        if per_call > 0 and len(got) == n * per_call:
            return sum(got) / 1e3 / n
    raise RuntimeError(f"torch.profiler lost kernels in {tries} profiles")


def kernel_ms(torch, fn, n: int = 10) -> dict:
    """Device ms of one call of fn by kernel (its name up to the template
    arguments), from torch.profiler's events of n calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            found = re.search(r"(\w+)\s*[<(]", e.name.replace("(anonymous namespace)::", ""))
            name = found.group(1) if found else e.name[:40]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / n
    return out


def events_ms(torch, fn, iters: int, warmup: int) -> float:
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


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def _conv_w(torch, k):
    """(K, Cin, Cout) float32 -> torch's (Cout, Cin, K) in bf16."""
    return k.permute(2, 1, 0).contiguous().bfloat16()


def cudnn_chain(torch, stacks):
    """2b's stage as cuDNN bf16 convs in NCW layout: fn(x (B, C, T) bf16)."""
    import torch.nn.functional as F

    ws = [(_conv_w(torch, kd), bd.bfloat16(), d, (kd.shape[0] - 1) // 2 * d, _conv_w(torch, k1),
           b1.bfloat16(), _conv_w(torch, ks), bs.bfloat16())
          for kd, bd, d, k1, b1, ks, bs in stacks]

    def run(h):
        for kd, bd, d, m, k1, b1, ks, bs in ws:
            t = F.pad(F.leaky_relu(h, 0.2), (m, m), mode="reflect")
            t = F.leaky_relu(F.conv1d(t, kd, bd, dilation=d), 0.2)
            h = F.conv1d(t, k1, b1) + F.conv1d(h, ks, bs)
        return h
    return run


def cudnn_mrf(torch, resblocks, slope: float = 0.1):
    """4b's stage as cuDNN bf16 convs in NCW layout: fn(x (B, C, T) bf16)."""
    import torch.nn.functional as F

    ws = [[(_conv_w(torch, k1), b1.bfloat16(), d, _conv_w(torch, k2), b2.bfloat16())
           for k1, b1, d, k2, b2 in pairs] for pairs in resblocks]

    def run(x):
        acc = None
        for pairs in ws:
            h = x
            for k1, b1, d, k2, b2 in pairs:
                t = F.conv1d(F.leaky_relu(h, slope), k1, b1, padding=(k1.shape[2] - 1) * d // 2,
                             dilation=d)
                h = h + F.conv1d(F.leaky_relu(t, slope), k2, b2, padding=(k2.shape[2] - 1) // 2)
            acc = h if acc is None else acc + h
        return acc / len(ws)
    return run


def cudnn_tail(torch, ops):
    """6b as cuDNN bf16 calls in NCW layout: fn(x (B, C_in, T_in) bf16)."""
    import torch.nn.functional as F

    k_up, b_up, stride, pad, blocks, k_post, b_post = ops
    w_up = k_up.permute(1, 2, 0).contiguous().bfloat16()  # (Cin, Cout, K)
    b_up = None if b_up is None else b_up.bfloat16()
    mrf = cudnn_mrf(torch, blocks)
    w_post, b_post = _conv_w(torch, k_post), None if b_post is None else b_post.bfloat16()

    def run(x):
        T = x.shape[2] * stride
        extra = max(T - ((x.shape[2] - 1) * stride - 2 * pad + k_up.shape[0]), 0)
        h = F.conv_transpose1d(F.leaky_relu(x, 0.1), w_up, b_up, stride=stride, padding=pad,
                               output_padding=extra)[:, :, :T]
        h = F.leaky_relu(mrf(h), 0.01)
        return torch.tanh(F.conv1d(h, w_post, b_post, padding=(k_post.shape[0] - 1) // 2))
    return run


def bf16_forward_times(torch, r, fm, ft, label: str, root: str, forms=("2b", "4b", "6b")
                       ) -> list:
    """2b, 4b and 6b (those in `forms`) at `BF16_FORWARD`'s shapes (module
    docstring)."""
    from fastvocoder_tpu_torch.hparams import load_model_config
    from fastvocoder_tpu_torch.models.factory import load_generator

    cfg = load_model_config("hifigan", os.path.join(root, "conf", "hifigan", "light.yaml"))
    hifi, _ = load_generator(os.path.join(root, "docs", "checkpoints",
                                          "hifigan_light_clean2.npz"), cfg, torch.device("cuda"))
    tail_ops = hifi.tail_operands()
    rows = []
    for form, model, shapes in BF16_FORWARD:
        if form not in forms:
            continue
        for B, T, C in shapes:
            g = torch.Generator().manual_seed(B * T + C)
            xb = (0.3 * torch.randn(B, T, C, generator=g)).cuda().bfloat16()
            if form == "2b":
                ops = stacks_at(torch, C, C)
                table = r.ChainTable(ops, xb.device, torch.bfloat16)
                run = lambda: r.fused_residual_stacks_bf16_cuda(xb, ops, table)  # noqa: E731
                f32 = lambda x: r.fused_residual_stacks_cuda(x, ops)  # noqa: E731
                plain, yardstick = r.fused_residual_stacks_plain, cudnn_chain(torch, ops)
                flops = 2 * B * T * len(ops) * (STACK_K + 2) * C * C
                weights = len(ops) * ((STACK_K + 2) * C * C + 3 * C)
                nbytes = 2 * (2 * B * T * C + weights)
                mrf_flops, core_flops = flops, 0
                args = (ops,)
            elif form == "4b":
                ops = resblocks_at(torch, C)
                table = fm.StageTable(ops, None, xb.device, torch.bfloat16)
                run = lambda: fm.fused_mrf_stage_bf16_cuda(xb, ops, None, table)  # noqa: E731
                f32 = lambda x: fm.fused_mrf_stage_cuda(x, ops)  # noqa: E731
                plain, yardstick = fm.fused_mrf_stage_plain, cudnn_mrf(torch, ops)
                taps = sum(k1.shape[0] + k2.shape[0] for pairs in ops for k1, _, _, k2, _ in pairs)
                flops = 2 * B * T * taps * C * C
                nbytes = 2 * (2 * B * T * C + taps * C * C + 2 * len(ops) * len(ops[0]) * C)
                mrf_flops, core_flops = flops, 0
                args = (ops,)
            else:
                ops = tail_ops if model == "HiFiGAN" else large_tail_at(torch)
                k_up, b_up, stride, _, blocks, k_post, b_post = ops
                table = ft.TailTable(*ops, xb.device, torch.bfloat16)
                run = lambda: ft.fused_hifigan_tail_bf16_cuda(xb, *ops, table=table)  # noqa: E731
                f32 = lambda x: ft.fused_hifigan_tail_cuda(x, *ops)  # noqa: E731
                plain, yardstick = ft.fused_hifigan_tail_plain, cudnn_tail(torch, ops)
                To, Co = stride * T, k_up.shape[2]
                taps = sum(k1.shape[0] + k2.shape[0] for pairs in blocks
                           for k1, _, _, k2, _ in pairs)
                # the upsample's bf16 operands count at the tensor cores' rate, as
                # the MRF's; the head (CUDA cores) at the float32 rate
                mrf_flops = 2 * B * To * (taps * Co + (k_up.shape[0] // stride) * C) * Co
                core_flops = 2 * B * To * k_post.shape[0] * Co * k_post.shape[2]
                flops = mrf_flops + core_flops
                nbytes = 2 * (B * T * C + B * To * k_post.shape[2] + taps * Co * Co) + 4 * (
                    k_up.numel() + k_post.numel())
                args = ops
            batch1 = B == 1
            with torch.inference_mode():
                ms = device_ms(torch, run, 10 if batch1 else 3)
                ev = events_ms(torch, run, 20 if batch1 else 5, 3 if batch1 else 2)
                xn = xb.transpose(1, 2).contiguous()
                cudnn = device_ms(torch, lambda: yardstick(xn), 10 if batch1 else 3)
                y64 = plain(xb.double(), *to_f64(args)).double()
                peak = y64.abs().max().item()
                err = ((run().double() - y64).abs().max() / peak).item()
                err_plain = ((plain(xb, *args).double() - y64).abs().max() / peak).item()
                y32 = f32(xb.float())
                parts = kernel_ms(torch, run) if form == "6b" or form == "4b" and batch1 else {}
                torch.cuda.synchronize()
            bound = max(nbytes / BYTES_PER_S, mrf_flops / BF16_FLOP_PER_S
                        + core_flops / F32_FLOP_PER_S) * 1e3
            by = "bytes" if nbytes / BYTES_PER_S * 1e3 >= bound else "operations"
            row = {"label": label, "form": form, "model": model, "shape": [B, T, C], "ms": ms,
                   "events_ms": ev, "bound_ms": bound, "bound_by": by, "share": bound / ms,
                   "err_f64": err, "plain_err_f64": err_plain, "f32_digest": digest(y32),
                   "cudnn_sequence_ms": cudnn, "kernels_ms": parts}
            rows.append(row)
            print(f"[{label}] {form} {model} ({B}, {T}, {C}): device {ms:.4f} ms (events "
                  f"{ev:.4f}), bf16 bound {bound:.4f} ms ({by}), share {bound / ms:.3f}; "
                  f"against float64 {err:.3e} of the peak (plain bf16 {err_plain:.3e}); "
                  f"float32 form {digest(y32)}; cuDNN sequence {cudnn:.4f} ms"
                  + "".join(f"; {k} {v:.4f}" for k, v in parts.items()), flush=True)
            del xb, y64, y32
            torch.cuda.empty_cache()
    return rows


def compare(rows, against: str, label: str) -> None:
    """Per shape of the bf16 forward forms: float32 digests and time ratio
    against the rows of another checkout's run."""
    with open(against) as f:
        other = {(o["form"], o["model"], tuple(o["shape"])): o
                 for o in json.load(f)["rows"] if "f32_digest" in o}
    for row in rows:
        o = other.get((row["form"], row["model"], tuple(row["shape"])))
        if o is None or "f32_digest" not in row:
            continue
        same = "same" if o["f32_digest"] == row["f32_digest"] else "DIFFERENT"
        print(f"[{label} vs {o['label']}] {row['form']} {row['model']} {tuple(row['shape'])}: "
              f"float32 output {same}; bf16 form {row['ms']:.4f} against {o['ms']:.4f} ms "
              f"({o['ms'] / row['ms']:.2f}x), error against float64 {row['err_f64']:.3e} "
              f"against {o['err_f64']:.3e} ({row['err_f64'] / max(o['err_f64'], 1e-30):.2f}x)",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--parts", default="forward,bf16_forward,backward")
    ap.add_argument("--forms", default="2b,4b,6b", help="bf16 forward forms to time")
    ap.add_argument("--json", default="")
    ap.add_argument("--against", default="", help="--json of a run on another checkout")
    ap.add_argument("--events", action="store_true")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    sys.path.insert(0, args.root)
    import torch

    from fastvocoder_tpu_torch.ops import _build
    from fastvocoder_tpu_torch.ops import fused_mrf as fm
    from fastvocoder_tpu_torch.ops import fused_resstack as r
    from fastvocoder_tpu_torch.ops import fused_tail as ft

    if not torch.cuda.is_available():
        print("chain_times: CUDA is not available", file=sys.stderr)
        return 2
    _build.build_all()
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[{args.label}] {card.strip()}", flush=True)
    rows = []
    if "forward" in parts:
        forward_times(torch, r, args.label)
    if "bf16_forward" in parts:
        rows += bf16_forward_times(torch, r, fm, ft, args.label, os.path.abspath(args.root),
                                   tuple(args.forms.split(",")))
    if "backward" in parts:
        rows += backward_times(torch, r, fm, args.label, args.events)
    if args.against:
        compare(rows, args.against, args.label)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card.strip(), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
