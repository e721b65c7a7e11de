#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`fastvocoder_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `fastvocoder_tpu_torch/csrc/` with
`nvcc`, holds each against its plain PyTorch version at its paths' shapes
and times both, then drives each ported model at full width on its release
checkpoint (`docs/checkpoints/`) through the entry points a user calls:

  * Basis-MelGAN light: `Synthesizer`, the RTF protocol of `bin/test.py`,
    the HTTP server of `bin/serve.py` (kernels: basis_decode,
    fused_resstack);
  * HiFiGAN light: the same three (kernels: fused_mrf, fused_tail);
  * MultiBand-HiFiGAN light: `Synthesizer` and the RTF protocol (kernel:
    fused_mrf).

Launch counts are zeroed before each path and read right after it; the run
fails if a kernel of the path was not launched.  A profile of one batch-1
inference of each of the first two models closes the run.

Output: the card's name and power limit, a log per phase, then one JSON line
with the kernels (launches, error, times, bound) and, last, one JSON line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when CUDA
is unavailable, when the port is not beside this script, or when any phase
fails.  Needs one GPU; uses no network (the server binds 127.0.0.1).
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "docs", "checkpoints", "basis_melgan_clean2.npz")
CONF = os.path.join(ROOT, "conf", "basis-melgan", "light.yaml")
HIFI_CKPT = os.path.join(ROOT, "docs", "checkpoints", "hifigan_light_clean2.npz")
HIFI_CONF = os.path.join(ROOT, "conf", "hifigan", "light.yaml")
MB_CKPT = os.path.join(ROOT, "docs", "checkpoints", "mb_hifigan_light_clean.npz")
MB_CONF = os.path.join(ROOT, "conf", "multiband-hifigan", "light.yaml")
MEL_FRAMES = 585  # the RTF protocol's utterance (bench.py's eval set)
HOP = 240

# H100 SXM published peaks at the full 700 W (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12  # float32 on the CUDA cores, no tensor cores

# tolerances against the plain versions (both sides float32, TF32 off):
# decode: twice the worst-case rounding of its 2C-term dot products;
# chain: 3e-4 of the output's magnitude (isolated rows near the leaky-relu
# kink may flip branch, as in tests/test_fused_resstack.py), and 90 % of
# rows within 3e-6 of it; MRF stage: the chain's maximum, rows within 1e-5
# (chains of 6 convs of up to 11 C taps, 2816 products a row at C = 256);
# tail (after tanh): 1e-4, rows within 1e-5; whole model GPU vs CPU: 1e-4
# of the peak.  tests/test_torch_kernels_cuda.py holds the same bounds.
CHAIN_TOL, CHAIN_ROW_TOL, MODEL_TOL = 3e-4, 3e-6, 1e-4
MRF_TOL, MRF_ROW_TOL, TAIL_TOL, TAIL_ROW_TOL = 3e-4, 1e-5, 1e-4, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def mel_like_bench(frames: int, seed: int) -> np.ndarray:
    """A seeded (frames, 80) mel in [0, 1], as bench.py builds its eval set."""
    rng = np.random.default_rng(seed)
    return np.clip(0.5 + 0.25 * rng.standard_normal((frames, 80)), 0.0, 1.0).astype(np.float32)


def cuda_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_basis_decode(torch, F, basis):
    """Kernel 1 against its plain version; -> entry for the kernels line."""
    from fastvocoder_tpu_torch.ops.basis_decode import basis_decode_cuda, basis_decode_plain

    dev = basis.device
    eps = float(np.finfo(np.float32).eps)
    g = torch.Generator().manual_seed(1)
    worst = 0.0
    for B, Fr in ((1, 9360), (32, 1024), (3, 77)):
        w = torch.relu(torch.randn(B, Fr, basis.shape[1], generator=g)).to(dev)
        got = basis_decode_cuda(w, basis)
        want = basis_decode_plain(w, basis)
        torch.cuda.synchronize()
        bound = 4 * basis.shape[1] * eps * basis_decode_plain(w.abs(), basis.abs())
        err = (got - want).abs()
        ok = bool(torch.all(err <= bound))
        log(f"  basis_decode B={B} F={Fr}: max abs {err.max().item():.3e}, "
            f"max rel {(err.max() / want.abs().max()).item():.3e}, within bound {ok}")
        if not ok:
            raise AssertionError(f"basis_decode disagrees with its plain version at B={B} F={Fr}")
        worst = max(worst, err.max().item())

    B, Fr, C = 1, F, basis.shape[1]
    L = basis.shape[0]
    hop = L // 2
    w = torch.relu(torch.randn(B, Fr, C, generator=g)).to(dev)
    wt = w.transpose(1, 2)
    kernel = basis.t()[:, None, :].contiguous()  # (C, 1, L) for conv_transpose1d
    lib = torch.nn.functional.conv_transpose1d(wt, kernel, stride=hop)[:, 0]
    err_lib = (lib - basis_decode_cuda(w, basis)).abs().max().item()
    log(f"  basis_decode vs conv_transpose1d yardstick: max abs {err_lib:.3e}")
    ms = cuda_ms(lambda: basis_decode_cuda(w, basis))
    plain = cuda_ms(lambda: basis_decode_plain(w, basis))
    library = cuda_ms(lambda: torch.nn.functional.conv_transpose1d(wt, kernel, stride=hop))
    nbytes = 4 * (B * Fr * C + L * C + B * (Fr + 1) * hop)
    flops = 2 * 2 * B * (Fr + 1) * hop * C
    bms, by = bound_ms(nbytes, flops)
    log(f"  basis_decode (1, {Fr}, {C}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"conv_transpose1d {library:.4f} ms, bound {bms:.4f} ms ({by})")
    return {
        "name": "basis_decode", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/basis_decode.cu",
        "replaces": "fastvocoder_tpu/ops/basis_decode.py:116",
        "shape": f"W (1, {Fr}, {C}), basis ({L}, {C})",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bms,
        "bound_by": by, "library_ms": library,
    }


def check_fused_resstack(torch, gen, T_main):
    """Kernel 2 against its plain version with the release weights of both
    stages; -> entry for the kernels line."""
    from fastvocoder_tpu_torch.ops.fused_resstack import (
        fused_residual_stacks_cuda,
        fused_residual_stacks_plain,
    )

    dev = next(gen.parameters()).device
    g = torch.Generator().manual_seed(2)
    worst = 0.0
    for stage, B, T in ((0, 1, 2340), (1, 1, 9360), (0, 4, 2340), (1, 4, 9360), (0, 2, 40), (1, 1, 10)):
        stacks = [m.chain_operands() for m in gen.stacks[stage]]
        C = stacks[0][0].shape[1]
        x = (0.3 * torch.randn(B, T, C, generator=g)).to(dev)
        got = fused_residual_stacks_cuda(x, stacks)
        want = fused_residual_stacks_plain(x, stacks)
        torch.cuda.synchronize()
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs()
        rows_ok = (err.amax(dim=(0, 2)) <= CHAIN_ROW_TOL * scale).float().mean().item()
        log(f"  fused_resstack stage {stage} B={B} T={T}: max abs {err.max().item():.3e}, "
            f"max rel {(err.max() / scale).item():.3e} (tol {CHAIN_TOL * scale:.3e}), "
            f"rows within {CHAIN_ROW_TOL * scale:.1e}: {rows_ok:.4f}")
        if err.max().item() > CHAIN_TOL * scale or rows_ok <= 0.9:
            raise AssertionError(f"fused_resstack disagrees with its plain version at B={B} T={T}")
        worst = max(worst, err.max().item())

    times = {}
    for stage, T in ((0, T_main // 4), (1, T_main)):
        stacks = [m.chain_operands() for m in gen.stacks[stage]]
        x = (0.3 * torch.randn(1, T, stacks[0][0].shape[1], generator=g)).to(dev)
        times[T] = (cuda_ms(lambda: fused_residual_stacks_cuda(x, stacks), iters=20, warmup=3),
                    cuda_ms(lambda: fused_residual_stacks_plain(x, stacks), iters=20, warmup=3))
        log(f"  fused_resstack (1, {T}, 256): kernel {times[T][0]:.4f} ms, plain {times[T][1]:.4f} ms")
    stacks = [m.chain_operands() for m in gen.stacks[1]]
    n, K, C = len(stacks), stacks[0][0].shape[0], stacks[0][0].shape[1]
    T = T_main
    nbytes = 4 * (2 * T * C + n * ((K + 2) * C * C + 3 * C))
    flops = 2 * T * n * (K + 2) * C * C
    bms, by = bound_ms(nbytes, flops)
    log(f"  fused_resstack (1, {T}, {C}) bound {bms:.4f} ms ({by})")
    return {
        "name": "fused_resstack", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/fused_resstack.cu",
        "replaces": "fastvocoder_tpu/ops/fused_resstack.py:153",
        "shape": f"x (1, {T}, {C}), 3 stacks K=3 d=1,3,9 (stage 2 of 2)",
        "max_abs_err": worst, "ms": times[T][0], "plain_ms": times[T][1],
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "stage1_ms": times[T // 4][0], "stage1_plain_ms": times[T // 4][1],
    }


def rows_close(got, want, tol: float, row_tol: float):
    """(max abs error, its bound, share of rows within row_tol, ok): max abs
    within tol and 90 % of rows within row_tol, both scaled by the output's
    magnitude."""
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs()
    rows_ok = (err.amax(dim=(0, 2)) <= row_tol * scale).float().mean().item()
    worst = err.max().item()
    return worst, tol * scale, rows_ok, worst <= tol * scale and rows_ok > 0.9


def mrf_work(B: int, T: int, blocks) -> tuple:
    """(bytes, FLOP) of one MRF stage: x read and y written once, every
    weight read once; 2 FLOP per multiply-add of every conv."""
    C = blocks[0][0][0].shape[1]
    taps = sum(k1.shape[0] + k2.shape[0] for pairs in blocks for k1, _, _, k2, _ in pairs)
    weights = sum(k1.numel() + b1.numel() + k2.numel() + b2.numel()
                  for pairs in blocks for k1, b1, _, k2, b2 in pairs)
    return 4 * (2 * B * T * C + weights), 2 * B * T * taps * C * C


def seeded_resblocks(torch, C: int, dev, seed: int, kernels=(3, 7, 11), dilations=(1, 3, 5)):
    """ResBlock1 branches with torch's default conv init, from a seed."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan_in):
        return ((torch.rand(shape, generator=g) * 2 - 1) / np.sqrt(fan_in)).to(dev)

    return [[(u(K, C, C, fan_in=C * K), u(C, fan_in=C * K), d, u(K, C, C, fan_in=C * K),
              u(C, fan_in=C * K)) for d in dilations] for K in kernels]


def check_fused_mrf(torch, gen, frames: int):
    """Kernel 4 against its plain version: the release weights of HiFiGAN
    light's three MRF stages at one utterance's shapes, at batch 4 and at
    lengths whose tiles touch both sequence edges, and C = 256 (HiFiGAN
    large's widest stage) with seeded weights; times at the utterance's
    shapes.  -> entry for the kernels line."""
    from fastvocoder_tpu_torch.ops.fused_mrf import fused_mrf_stage_cuda, fused_mrf_stage_plain

    dev = next(gen.parameters()).device
    g = torch.Generator().manual_seed(4)
    stages = [[b.mrf_operands() for b in blocks] for blocks in gen.mrfs[:-1]]
    rates = gen.cfg.upsample_rates
    lengths = [frames * int(np.prod(rates[: i + 1])) for i in range(len(stages))]
    cases = [(blocks, B, T) for blocks, T0 in zip(stages, lengths)
             for B, T in ((1, T0), (4, T0), (1, 1), (2, 7), (1, 50))]
    cases.append((seeded_resblocks(torch, 256, dev, 5), 1, frames * rates[0]))
    worst = 0.0
    for blocks, B, T in cases:
        C = blocks[0][0][0].shape[1]
        x = (0.3 * torch.randn(B, T, C, generator=g)).to(dev)
        got = fused_mrf_stage_cuda(x, blocks)
        want = fused_mrf_stage_plain(x, blocks)
        torch.cuda.synchronize()
        err, tol, rows_ok, ok = rows_close(got, want, MRF_TOL, MRF_ROW_TOL)
        log(f"  fused_mrf ({B}, {T}, {C}): max abs {err:.3e} (tol {tol:.3e}), "
            f"rows within {MRF_ROW_TOL:.0e} of the peak: {rows_ok:.4f}")
        if not ok:
            raise AssertionError(f"fused_mrf disagrees with its plain version at ({B}, {T}, {C})")
        worst = max(worst, err)

    per_stage, total = [], {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    for blocks, T in zip(stages + [seeded_resblocks(torch, 256, dev, 5)],
                         lengths + [frames * rates[0]]):
        C = blocks[0][0][0].shape[1]
        x = (0.3 * torch.randn(1, T, C, generator=g)).to(dev)
        ms = cuda_ms(lambda: fused_mrf_stage_cuda(x, blocks), iters=20, warmup=3)
        plain = cuda_ms(lambda: fused_mrf_stage_plain(x, blocks), iters=20, warmup=3)
        nbytes, flops = mrf_work(1, T, blocks)
        bms, by = bound_ms(nbytes, flops)
        log(f"  fused_mrf (1, {T}, {C}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {bms:.4f} ms ({by}, {flops / 1e9:.2f} GFLOP)")
        per_stage.append({"shape": [1, T, C], "ms": ms, "plain_ms": plain, "bound_ms": bms})
        if C != 256:  # the main path's stages
            for k, v in (("ms", ms), ("plain_ms", plain), ("bytes", nbytes), ("flops", flops)):
                total[k] += v
    bms, by = bound_ms(total["bytes"], total["flops"])
    return {
        "name": "fused_mrf", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/fused_mrf.cu",
        "replaces": "fastvocoder_tpu/ops/fused_mrf.py:112",
        "shape": "HiFiGAN light's 3 MRF stages of a 585-frame utterance, summed: "
                 + ", ".join(str(tuple(s["shape"])) for s in per_stage[:-1]),
        "max_abs_err": worst, "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": bms, "bound_by": by, "library_ms": None, "stages": per_stage,
    }


def check_fused_tail(torch, gen, frames: int):
    """Kernel 6 against its plain version: HiFiGAN light's release tail at
    one utterance's shape, at batch 2 with a short input and at T_in = 1,
    and HiFiGAN large's 64 -> 32 tail with seeded weights; times at the
    utterance's shape.  -> entry for the kernels line."""
    from fastvocoder_tpu_torch.ops.fused_tail import (
        fused_hifigan_tail_cuda,
        fused_hifigan_tail_plain,
    )

    dev = next(gen.parameters()).device
    g = torch.Generator().manual_seed(6)
    light = gen.tail_operands()
    T_main = frames * int(np.prod(gen.cfg.upsample_rates[:-1]))
    gl = torch.Generator().manual_seed(7)

    def u(*shape, fan_in):
        return ((torch.rand(shape, generator=gl) * 2 - 1) / np.sqrt(fan_in)).to(dev)

    large = (u(4, 64, 32, fan_in=128), u(32, fan_in=128), 2, 1,
             seeded_resblocks(torch, 32, dev, 8), u(7, 32, 1, fan_in=224), u(1, fan_in=224))
    worst = 0.0
    for ops, B, T_in in ((light, 1, T_main), (light, 2, 35), (light, 1, 1), (large, 1, T_main)):
        cin = ops[0].shape[1]
        x = (0.3 * torch.randn(B, T_in, cin, generator=g)).to(dev)
        got = fused_hifigan_tail_cuda(x, *ops)
        want = fused_hifigan_tail_plain(x, *ops)
        torch.cuda.synchronize()
        err, tol, rows_ok, ok = rows_close(got, want, TAIL_TOL, TAIL_ROW_TOL)
        log(f"  fused_tail ({B}, {T_in}, {cin}) -> {tuple(got.shape)}: max abs {err:.3e} "
            f"(tol {tol:.3e}), rows within {TAIL_ROW_TOL:.0e}: {rows_ok:.4f}")
        if got.shape != (B, 2 * T_in, 1) or not ok:
            raise AssertionError(
                f"fused_tail disagrees with its plain version at ({B}, {T_in}, {cin})")
        worst = max(worst, err)

    x = (0.3 * torch.randn(1, T_main, 32, generator=g)).to(dev)
    ms = cuda_ms(lambda: fused_hifigan_tail_cuda(x, *light), iters=20, warmup=3)
    plain = cuda_ms(lambda: fused_hifigan_tail_plain(x, *light), iters=20, warmup=3)
    k_up, b_up, stride, _, blocks, k_post, b_post = light
    T = stride * T_main
    C = k_up.shape[2]
    mrf_bytes, mrf_flops = mrf_work(1, T, blocks)
    # read x and every weight once, write the waveform once
    nbytes = mrf_bytes - 4 * 2 * T * C + 4 * (x.numel() + k_up.numel() + b_up.numel()
                                             + k_post.numel() + b_post.numel() + T)
    flops = (mrf_flops + 2 * T * (k_up.shape[0] // stride) * k_up.shape[1] * C
             + 2 * T * k_post.shape[0] * C * k_post.shape[2])
    bms, by = bound_ms(nbytes, flops)
    log(f"  fused_tail (1, {T_main}, 32) -> (1, {T}, 1): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {bms:.4f} ms ({by}, {flops / 1e9:.2f} GFLOP)")
    return {
        "name": "fused_tail", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/fused_tail.cu",
        "replaces": "fastvocoder_tpu/ops/fused_tail.py:80",
        "shape": f"x (1, {T_main}, 32) -> (1, {T}, 1), HiFiGAN light's last stage and head",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None,
    }


def kernel_class(name: str) -> str:
    for key, label in (("fused_resstacks_kernel", "fused_resstack kernel"),
                       ("basis_decode_kernel", "basis_decode kernel"),
                       ("mrf_pair_kernel", "fused_mrf kernel"),
                       ("mrf_mean_kernel", "fused_mrf kernel"),
                       ("tail_upsample_kernel", "fused_tail kernel"),
                       ("tail_pair_kernel", "fused_tail kernel"),
                       ("tail_head_kernel", "fused_tail kernel")):
        if key in name:
            return label
    low = name.lower()
    if any(k in low for k in ("conv", "cudnn", "xmma", "gemm", "implicit", "winograd", "fft")):
        return "library convs (conv_pre, up_<i> outside the kernels)"
    return "elementwise, pads, copies"


def profile_inference(torch, synth, mel: np.ndarray, n: int = 10) -> None:
    """Device time by kernel over n batch-1 inferences, and the device's idle
    share of the window, from torch.profiler's CUDA (CUPTI) events."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        synth.test_rtf(mel)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            synth.test_rtf(mel)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    log(f"  {n} inferences of {mel.shape[0]} frames: host wall {wall_ms / n:.4f} ms each")
    if not kernels:
        log("  torch.profiler shows no device events: device time not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    by_class, by_name = {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        by_class[kernel_class(e.name)] = by_class.get(kernel_class(e.name), 0.0) + d
        by_name[e.name] = by_name.get(e.name, 0.0) + d
    log(f"  device busy {busy / 1e3 / n:.4f} ms per inference, {len(kernels) / n:.1f} device "
        f"ops per inference; idle share of the device window {1 - busy / window:.4f}")
    for k, v in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"  {k}: {v / 1e3 / n:.4f} ms per inference ({v / busy:.3f} of busy)")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {v / 1e3 / n:.4f} ms  {k[:110]}")


def post(url: str, mel: np.ndarray):
    buf = io.BytesIO()
    np.save(buf, mel)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, np.load(io.BytesIO(r.read()))


def synthesizer_phase(torch, count_path, Synthesizer, model: str, ckpt: str, conf: str,
                      kernels, expect: tuple):
    """Synthesizer on the card (bias + utterance) against the CPU plain
    path; -> the card's Synthesizer and the mel."""
    log(f"[{model}: Synthesizer]")
    synth = Synthesizer(ckpt, conf, model)
    mel = mel_like_bench(MEL_FRAMES, 0)
    t0 = time.perf_counter()
    est, est_remove, bias = count_path(f"{model} Synthesizer", lambda: synth.synthesize(mel),
                                       kernels)
    log(f"  synthesize (585 frames, bias + utterance): {time.perf_counter() - t0:.3f} s "
        f"(first call), wav {est.shape}")
    ref = Synthesizer(ckpt, conf, model, device="cpu").synthesize(mel)
    for name, got, want in zip(("est", "est-bias", "bias"), (est, est_remove, bias), ref):
        err = float(np.abs(got - want).max())
        tol = MODEL_TOL * max(1.0, float(np.abs(want).max()))
        finite = bool(np.isfinite(got).all())
        log(f"  {name}: shape {got.shape}, peak {np.abs(want).max():.3f}, GPU vs CPU plain path "
            f"max abs {err:.3e} (tol {tol:.3e}), finite {finite}")
        if got.shape != want.shape or not finite or err > tol:
            raise AssertionError(f"{model} Synthesizer {name} disagrees with the CPU plain path")
    if est.shape != expect:
        raise AssertionError(f"{model} waveform shape {est.shape}, want {expect}")
    return synth, mel


def rtf_phase(count_path, run_test, model: str, ckpt: str, conf: str, kernels) -> float:
    """The RTF protocol of bin/test.py over 4 utterances; it writes
    pattern-subtracted wavs for Basis-MelGAN only."""
    log(f"[{model}: RTF protocol (bin/test.py)]")
    with tempfile.TemporaryDirectory() as d:
        for i, frames in enumerate((585, 585, 320, 700)):
            np.save(os.path.join(d, f"utt{i}.npy"), mel_like_bench(frames, 10 + i).T)
        rtf = count_path(f"{model} RTF", lambda: run_test([
            "--checkpoint_path", ckpt, "--file_path", d, "--config", conf, "--model_name", model,
        ]), kernels)
        wavs = sorted(f for f in os.listdir(d) if f.endswith(".wav"))
    log(f"  rtf {rtf!r} over 4 utterances ({len(wavs)} wavs written)")
    if not (np.isfinite(rtf) and rtf > 0 and len(wavs) == (4 if model == "basis-melgan" else 0)):
        raise AssertionError(f"{model} RTF protocol failed")
    return rtf


def serving_phase(count_path, run_serve, ServingModel, model: str, ckpt: str, conf: str,
                  kernels) -> None:
    """4 concurrent HTTP requests, twice, against a direct ServingModel call."""
    log(f"[{model}: HTTP serving (bin/serve.py)]")
    lengths = (60, 130, 300, 585)
    req_mels = [mel_like_bench(n, 20 + i) for i, n in enumerate(lengths)]
    results = [None] * len(req_mels)

    def serve_all():
        httpd, batcher = run_serve(
            ["--checkpoint_path", ckpt, "--config", conf, "--model_name", model, "--port", "0"],
            block=False,
        )
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}"

            def one(i):
                results[i] = post(url + "/synthesize", req_mels[i])

            for rnd in ("cold", "warm"):  # the cold round meets every shape first
                threads = [threading.Thread(target=one, args=(i,)) for i in range(len(req_mels))]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300)
                log(f"  {rnd} round: 4 concurrent requests answered in "
                    f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                return json.loads(r.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.close()

    health = count_path(f"{model} HTTP serving", serve_all, kernels)
    log(f"  healthz {health}")
    direct = ServingModel(ckpt, conf, model)(req_mels)
    for i, n in enumerate(lengths):
        if results[i] is None:
            raise AssertionError(f"request {i} got no answer")
        status, wav = results[i]
        err = float(np.abs(wav - direct[i]).max())
        tol = MODEL_TOL * max(1.0, float(np.abs(direct[i]).max()))
        log(f"  request T={n}: status {status}, wav {wav.shape}, vs ServingModel max abs {err:.3e} (tol {tol:.3e})")
        if status != 200 or wav.shape != (n * HOP,) or not np.isfinite(wav).all() or err > tol:
            raise AssertionError(f"served request {i} is wrong")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from fastvocoder_tpu_torch.bin.serve import run_serve
    from fastvocoder_tpu_torch.bin.synthesize import Synthesizer
    from fastvocoder_tpu_torch.bin.test import run_test
    from fastvocoder_tpu_torch.ops import _build
    from fastvocoder_tpu_torch.serving import ServingModel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("[build]")
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"  built {sorted(reports) or 'nothing (up to date)'} in {time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[kernels against their plain versions]")
    basis_gen = Synthesizer(CKPT, CONF, "basis-melgan").generator
    hifi_gen = Synthesizer(HIFI_CKPT, HIFI_CONF, "hifigan").generator
    F_main = MEL_FRAMES * 16
    with torch.inference_mode():
        entries = [check_basis_decode(torch, F_main, basis_gen.basis_signal.basis),
                   check_fused_resstack(torch, basis_gen, F_main),
                   check_fused_mrf(torch, hifi_gen, MEL_FRAMES),
                   check_fused_tail(torch, hifi_gen, MEL_FRAMES)]
    launches = {e["name"]: 0 for e in entries}

    def count_path(name, fn, kernels):
        """Run one path with every count zeroed; fail if it launched none
        of `kernels`."""
        _build.launch_counts.clear()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: _build.launch_counts[k] for k in launches}
        log(f"  launches on the {name} path: {counts}")
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"{name} path never launched {missing}")
        for k, v in counts.items():
            launches[k] += v
        return out

    basis = ("basis_decode", "fused_resstack")
    hifi = ("fused_mrf", "fused_tail")
    wav_len = (MEL_FRAMES * HOP,)
    basis_synth, mel = synthesizer_phase(torch, count_path, Synthesizer, "basis-melgan", CKPT,
                                         CONF, basis, ((MEL_FRAMES * 16 - 1) * 15 + 30,))
    rtfs = {"basis-melgan": rtf_phase(count_path, run_test, "basis-melgan", CKPT, CONF, basis)}
    serving_phase(count_path, run_serve, ServingModel, "basis-melgan", CKPT, CONF, basis)

    hifi_synth, _ = synthesizer_phase(torch, count_path, Synthesizer, "hifigan", HIFI_CKPT,
                                      HIFI_CONF, hifi, wav_len)
    rtfs["hifigan"] = rtf_phase(count_path, run_test, "hifigan", HIFI_CKPT, HIFI_CONF, hifi)
    serving_phase(count_path, run_serve, ServingModel, "hifigan", HIFI_CKPT, HIFI_CONF, hifi)

    synthesizer_phase(torch, count_path, Synthesizer, "multiband-hifigan", MB_CKPT, MB_CONF,
                      ("fused_mrf",), wav_len)
    rtfs["multiband-hifigan"] = rtf_phase(count_path, run_test, "multiband-hifigan", MB_CKPT,
                                          MB_CONF, ("fused_mrf",))
    log(f"  rtf by model: {rtfs}")

    for model, synth in (("basis-melgan", basis_synth), ("hifigan", hifi_synth)):
        log(f"[profile: {model} batch-1 inference on the device]")
        profile_inference(torch, synth, mel)

    for e in entries:
        e["launches"] = launches[e["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
