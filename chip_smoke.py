#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`fastvocoder_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `fastvocoder_tpu_torch/csrc/` with
`nvcc`, holds each against its plain PyTorch version at its paths' shapes
and times both.  The four kernels that contract on the tensor cores in
3xTF32 (the MRF stage's and the residual-stack chain's, forward and
backward) are also held at shapes on the edges of their tiles at every
width, their error against a float64 run of the plain version is printed
beside the float32 plain version's own, and they get two bounds: the float32
rate of the CUDA cores, as every kernel, and a third of the tensor cores'
TF32 rate.  The tail kernel, whose MRF contracts the same way, gets both
bounds too, is held on the edges of its tiles at C_out = 16 and 32, and its
MRF launches are timed beside kernel 4 on the same MRF; the decode is also
timed at the training batch's shape.  Then the script drives each ported
model at full width on its release checkpoint (`docs/checkpoints/`)
through the entry points a user calls:

  * Basis-MelGAN light: `Synthesizer`, the RTF protocol of `bin/test.py`,
    the HTTP server of `bin/serve.py` (kernels: basis_decode,
    fused_resstack);
  * HiFiGAN light: the same three (kernels: fused_mrf, fused_tail);
  * MultiBand-HiFiGAN light: `Synthesizer` and the RTF protocol (kernel:
    fused_mrf);
  * MelGAN original: the same three as Basis-MelGAN (kernel: fused_resstack
    at C = 256, 128, 64, 32), and a profile of one inference with kernel
    2's time at each width beside its bounds;
  * NHV: the generator on the card against the CPU with the same sources,
    the card's own impulse train against the CPU's, `Synthesizer` with f0,
    the RTF protocol and the HTTP server (no kernel of ours: cuDNN convs and
    cuFFT, as the JAX package runs NHV as XLA).

Then bf16 serving (`compute_dtype=torch.bfloat16`, the bf16 forms of
kernels 1, 2, 4 and 6), after the bf16 forms are held against their plain
versions (the same bf16 arithmetic) at the float32 phases' shapes, on the
edges of their tiles and, for kernel 2, at batch 32, each timed against its
bf16 bound (its error against float64 printed beside the float32 kernel's):

  * every family's `Synthesizer` in bf16 on the release weights, on the
    card and on the CPU, beside float32 on both, launching the bf16 forms
    and no float32 form;
  * the RTF protocol in bf16 for Basis-MelGAN light, HiFiGAN light and
    MelGAN, beside the float32 RTF of the same run;
  * `bin/serve.py --bf16 1` for Basis-MelGAN light, 4 concurrent requests;
  * the JAX package's bf16 gate on random init at full width, every family;
  * a profile of one bf16 batch-1 inference of Basis-MelGAN and HiFiGAN.

Then it trains, at full width and the reference's batch (32 crops of 140
frames, float32, TF32 off), on a corpus it writes from a seed in the format
the data pipeline reads:

  * HiFiGAN light: `bin/train.py::run_train` for 6 steps, 2 pre-adversarial
    and 4 GAN steps with the full-size discriminator, a validation pass and
    a checkpoint (kernels: fused_mrf, fused_mrf_bwd); then one GAN step on
    the card against the same step on the CPU through the plain versions;
  * Basis-MelGAN light: `run_train` for 4 pre-adversarial steps with the
    weight L1 (kernels: fused_resstack, fused_resstack_bwd, basis_decode);
    the same one-step comparison;
  * MelGAN original: `run_train` with `--use_mpd 1`, 2 pre-adversarial and
    2 GAN steps against MSD + MFD + MPD (kernels: fused_resstack,
    fused_resstack_bwd at every width); one GAN step with the MPD on the
    card against the CPU, at a batch of MELGAN_CPU_BATCH crops;
  * NHV: `run_train` for 2 pre-adversarial steps on the corpus's f0 files;
  * ms a step of each step kind, and a profile of one HiFiGAN GAN step, of
    one Basis-MelGAN pre-adversarial step and of one MelGAN GAN step with
    the MPD;
  * bf16 mixed-precision training (`--mixprecision 1`), after the bf16
    forms of the backward kernels (3b, 5b) are held against their plain
    versions at the training stages' shapes and on the edges of their tiles
    (each one's error against float64 beside its plain version's) and timed
    against their bounds: `run_train` for HiFiGAN light (2 + 4 steps;
    kernels fused_mrf_bf16, fused_mrf_bwd_bf16), Basis-MelGAN light (4
    steps; fused_resstack_bf16, fused_resstack_bwd_bf16, basis_decode_bf16)
    and MelGAN original with the MPD (1 + 2 steps), launching no float32
    form, each checkpoint synthesized in bf16; one step of each in bf16
    against float32 on the card and on the CPU (the card's gradients may
    deviate from float32 by at most twice the CPU's), ms a step in bf16
    beside float32 of the same call, and a profile of one bf16 HiFiGAN GAN
    step.

Launch counts are zeroed before each path and read right after it; the run
fails if a kernel of the path was not launched.  A profile of one batch-1
inference of each of the first two models closes the run (MelGAN's and
NHV's come with their phases).

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
import re
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
MELGAN_CKPT = os.path.join(ROOT, "docs", "checkpoints", "melgan_clean.npz")
MELGAN_CONF = os.path.join(ROOT, "conf", "melgan", "original.yaml")
NHV_CKPT = os.path.join(ROOT, "docs", "checkpoints", "nhv_clean.npz")
NHV_CONF = os.path.join(ROOT, "conf", "nhv", "default.yaml")
NHV_F0_HZ = 220.0  # bench.py:116-119's contour
MELGAN_CPU_BATCH = 4  # MelGAN's GAN step with the MPD on the CPU: 4 crops, not 32
MEL_FRAMES = 585  # the RTF protocol's utterance (bench.py's eval set)
HOP = 240

# H100 SXM published peaks at the full 700 W (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12  # float32 on the CUDA cores, no tensor cores
PEAK_TF32_FLOP_PER_S = 495e12  # dense TF32 on the tensor cores
PEAK_BF16_FLOP_PER_S = 989e12  # dense bf16 on the tensor cores

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
# backward kernels against their plain VJPs, each gradient relative to its
# own peak.  Where a pre-activation lies within rounding distance of the
# leaky-relu kink, kernel and cuDNN may take different slopes (about one
# element in 1e5 against cuDNN's float32 convs): dx then differs over the
# rows the later adjoint convs spread that element to (27 in the chain) by a
# share of a weight's size, and dW and db by one row's term of their sums.
# So: every row of dx within BWD_DX_TOL, 90 % of the rows within
# BWD_DX_ROW_TOL, every dW and db within BWD_W_TOL.
BWD_DX_TOL, BWD_DX_ROW_TOL, BWD_W_TOL = 5e-2, 1e-4, 3e-2
# one training step on the card against the same step on the CPU through the
# plain versions: every logged value within STEP_LOSS_RTOL; every gradient within
# STEP_GRAD_TOL of its peak (a gain's or bias's of its conv's weight
# gradient's peak, if larger): kink flips as above, and the log-magnitude
# STFT loss, which divides by magnitudes down to its clamp, is
# ill-conditioned in float32 (1e-3 between two float32 runs of the same
# step on the CPU, tests/test_torch_trainer.py)
STEP_LOSS_RTOL, STEP_GRAD_TOL = 1e-4, 1e-2
TRAIN_BATCH, TRAIN_FRAMES = 32, 140  # the reference's batch (hparams.py:50,72)
# the bf16 forms against the plain versions of the same bf16 arithmetic: the
# two sum in other orders, so elements near a bf16 rounding boundary or the
# leaky-relu kink round the other way and the difference travels through the
# later convs: within 1 % of the plain output's peak (the share of elements
# more than one bf16 ulp apart is printed).  A bf16 waveform: the JAX
# package's bf16 gate, max(2e-3, 1 % of the float32 peak), which it meets on
# random init (tests/test_quality_gate.py); on trained weights bf16 arithmetic
# costs more than the gate, in the JAX package too
# (tests/test_torch_bf16_models.py), so there the card is held to what the
# same arithmetic costs on the CPU (`bf16_release_phase`).
BF16_TOL = 1e-2
# the bf16 backward forms against their plain versions, both the float32 VJP
# of the bf16 inputs rounded to bf16 once: every element of a row of dx within
# one bf16 ulp of its own value plus the float32 forms' row tolerance, but for
# the rows a leaky-relu flip reaches (the float32 forms' share), dx, dW and db
# within the float32 forms' bounds; at the tiles' edges, against the plain
# version in float64, every element so near but those that taking the other
# slope at the pre-activations within KINK_BAND of their peak of the kink
# moves (`bf16_grads_against_f64`: the flips are found, not assumed)
BF16_BWD_ROWS, KINK_BAND = 0.9, 1e-5
# bf16 training: a step's gradients deviate from the float32 step's (same
# weights, same batch) on the card by at most BF16_STEP_RATIO times what the
# CPU's bf16 step deviates from the CPU's float32 step (relative RMS over all
# of the generator's or the discriminator's gradients), on BF16_CPU_BATCH
# crops (a CPU step of 32 takes minutes in bf16)
BF16_STEP_RATIO, BF16_CPU_BATCH = 2.0, 4


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


def bound_3xtf32_ms(nbytes: float, flops: float):
    """The bound of a kernel that computes every float32 product as three
    TF32 products on the tensor cores."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 3 * flops / PEAK_TF32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share(bound: float, ms: float) -> str:
    """A time's share of its bound, for a log line; a kernel faster than the
    bound it is set against is a fault of the bound."""
    if bound > ms:
        raise AssertionError(f"a kernel ran in {ms:.4f} ms, below its bound of {bound:.4f} ms")
    return f"{bound / ms:.3f}"


def check_basis_decode(torch, F, basis):
    """Kernel 1 against its plain version at the main path's shape, the
    training batch's, and lengths on both sides of its 16-frame tiles; times
    at the main path's (1, F, C) and the training batch's (32, 2240, C), with
    `conv_transpose1d` on the same inputs.  A batch-1 call's device work is
    shorter than the host's work to issue it, so CUDA events over a loop of
    calls time the host: each time is the device's (torch.profiler, the
    call's kernels summed), the events' rate a call beside it.  -> entry for
    the kernels line."""
    from fastvocoder_tpu_torch.ops.basis_decode import basis_decode_cuda, basis_decode_plain

    dev = basis.device
    eps = float(np.finfo(np.float32).eps)
    g = torch.Generator().manual_seed(1)
    worst = 0.0
    for B, Fr in ((1, 9360), (32, 2240), (32, 1024), (3, 77), (1, 1), (1, 15), (1, 16), (5, 63)):
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

    C, L = basis.shape[1], basis.shape[0]
    hop = L // 2
    kernel = basis.t()[:, None, :].contiguous()  # (C, 1, L) for conv_transpose1d
    times = {}
    for B, Fr in ((1, F), (TRAIN_BATCH, TRAIN_FRAMES * 16)):
        w = torch.relu(torch.randn(B, Fr, C, generator=g)).to(dev)
        wt = w.transpose(1, 2)
        lib = torch.nn.functional.conv_transpose1d(wt, kernel, stride=hop)[:, 0]
        err_lib = (lib - basis_decode_cuda(w, basis)).abs().max().item()
        fns = {"ms": lambda: basis_decode_cuda(w, basis),
               "plain_ms": lambda: basis_decode_plain(w, basis),
               "library_ms": lambda: torch.nn.functional.conv_transpose1d(wt, kernel, stride=hop)}
        got = {k: sum(device_ms_by_name(torch, fn, 20).values()) for k, fn in fns.items()}
        if min(got.values()) <= 0:
            raise AssertionError("torch.profiler saw no device time of the decode")
        calls = {k: cuda_ms(fn) for k, fn in fns.items()}
        nbytes = 4 * (B * Fr * C + L * C + B * (Fr + 1) * hop)
        flops = 2 * 2 * B * (Fr + 1) * hop * C
        bms, by = bound_ms(nbytes, flops)
        log(f"  basis_decode ({B}, {Fr}, {C}), device ms (a call in a loop): kernel "
            f"{got['ms']:.4f} ({calls['ms']:.4f}), plain {got['plain_ms']:.4f} "
            f"({calls['plain_ms']:.4f}), conv_transpose1d {got['library_ms']:.4f} "
            f"({calls['library_ms']:.4f}; max abs {err_lib:.3e} from the kernel); bound "
            f"{bms:.4f} ms ({by}): {share(bms, got['ms'])} of it")
        times[B] = {"shape": [B, Fr, C], **got, "bound_ms": bms, "bound_by": by,
                    "call_ms": calls["ms"], "plain_call_ms": calls["plain_ms"],
                    "library_call_ms": calls["library_ms"]}
    return {
        "name": "basis_decode", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/basis_decode.cu",
        "replaces": "fastvocoder_tpu/ops/basis_decode.py:121",
        "shape": f"W (1, {F}, {C}), basis ({L}, {C})",
        "max_abs_err": worst, **{k: v for k, v in times[1].items() if k != "shape"},
        "batch32": times[TRAIN_BATCH],
    }


# Rows a block of the chain kernels owns, by width (`csrc/mma_common.cuh`,
# `Tile`: 64 rows a warpgroup, one over the rows at C = 256, two below).
CHAIN_ROWS = {32: 128, 64: 128, 128: 128, 256: 64}


def chain_edge_shapes(C: int, least: int):
    """(B, T) on the edges of the chain kernels' tiles at width C: the least
    T (1 forwards, m + 1 = 10 backwards), one below, at and one above 64
    rows, one below and one above 128, one above a block's rows."""
    return [(1, least), (2, 63), (1, 64), (3, 65), (1, 127), (2, 129), (1, CHAIN_ROWS[C] + 1)]


def seeded_stacks(torch, C: int, dev, seed: int, dilations=(1, 3, 9), K: int = 3):
    """Residual stacks with torch's default conv init, from a seed."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan_in):
        return ((torch.rand(shape, generator=g) * 2 - 1) / np.sqrt(fan_in)).to(dev)

    return [(u(K, C, C, fan_in=C * K), u(C, fan_in=C * K), d, u(1, C, C, fan_in=C),
             u(C, fan_in=C), u(1, C, C, fan_in=C), u(C, fan_in=C)) for d in dilations]


def check_fused_resstack(torch, gen, T_main):
    """Kernel 2 against its plain version with the release weights of both
    stages, and with seeded weights at every width on the edges of its
    tiles; times with the chain's packed operands kept, as a served model
    keeps them, and the packing's own time.  -> entry for the kernels
    line."""
    from fastvocoder_tpu_torch.ops.fused_resstack import (
        KERNEL_WIDTHS,
        ChainTable,
        fused_residual_stacks_cuda,
        fused_residual_stacks_plain,
    )

    dev = next(gen.parameters()).device
    g = torch.Generator().manual_seed(2)
    worst = 0.0
    cases = [([m.chain_operands() for m in gen.stacks[stage]], B, T)
             for stage, B, T in ((0, 1, 2340), (1, 1, 9360), (0, 4, 2340), (1, 4, 9360),
                                 (0, 2, 40), (1, 1, 10))]
    for C in KERNEL_WIDTHS:
        stacks = seeded_stacks(torch, C, dev, 30 + C)
        cases += [(stacks, B, T) for B, T in chain_edge_shapes(C, 1)]
    for stacks, B, T in cases:
        C = stacks[0][0].shape[1]
        x = (0.3 * torch.randn(B, T, C, generator=g)).to(dev)
        got = fused_residual_stacks_cuda(x, stacks)
        want = fused_residual_stacks_plain(x, stacks)
        torch.cuda.synchronize()
        err, tol, rows_ok, ok = rows_close(got, want, CHAIN_TOL, CHAIN_ROW_TOL)
        if T > 1000 or T == 10:
            log(f"  fused_resstack ({B}, {T}, {C}): max abs {err:.3e} (tol {tol:.3e}), "
                f"rows within {CHAIN_ROW_TOL:.0e} of the peak: {rows_ok:.4f}")
        if not ok:
            raise AssertionError(f"fused_resstack disagrees with its plain version at ({B}, {T}, {C})")
        worst = max(worst, err)
    log(f"  fused_resstack: {len(cases)} shapes agree, among them every width at "
        f"(B, T) = {chain_edge_shapes(256, 1)} (C = 256; the edges of each width's own tiles)")

    times = {}
    for stage, T in ((0, T_main // 4), (1, T_main)):
        stacks = [m.chain_operands() for m in gen.stacks[stage]]
        C = stacks[0][0].shape[1]
        x = (0.3 * torch.randn(1, T, C, generator=g)).to(dev)
        table = ChainTable(stacks, dev)  # kept by the caller, as a served model keeps it
        ms = cuda_ms(lambda: fused_residual_stacks_cuda(x, stacks, table), iters=20, warmup=3)
        plain = cuda_ms(lambda: fused_residual_stacks_plain(x, stacks), iters=20, warmup=3)
        nbytes, flops = chain_work(1, T, stacks)
        bms, _ = bound_ms(nbytes, flops)
        b3, by = bound_3xtf32_ms(nbytes, flops)
        times[T] = (ms, plain, bms, b3)
        log(f"  fused_resstack (1, {T}, {C}): kernel {ms:.4f} ms, plain {plain:.4f} ms, float32 "
            f"bound {bms:.4f} ms, 3xTF32 bound {b3:.4f} ms ({by}, {flops / 1e9:.2f} GFLOP): "
            f"{share(b3, ms)} of it")
    pack_ms = cuda_ms(lambda: ChainTable(stacks, dev), iters=20, warmup=3)
    log(f"  fused_resstack: checking and packing a stage's operands (ChainTable), which a "
        f"served model does once: {pack_ms:.4f} ms a stage")
    T = T_main
    bms, by = bound_ms(*chain_work(1, T, stacks))
    return {
        "name": "fused_resstack", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/fused_resstack.cu",
        "replaces": "fastvocoder_tpu/ops/fused_resstack.py:153",
        "shape": f"x (1, {T}, {C}), 3 stacks K=3 d=1,3,9 (stage 2 of 2)",
        "max_abs_err": worst, "ms": times[T][0], "plain_ms": times[T][1],
        "bound_ms": bms, "bound_3xtf32_ms": times[T][3], "bound_by": by, "library_ms": None,
        "stage1_ms": times[T // 4][0], "stage1_plain_ms": times[T // 4][1],
        "stage1_bound_ms": times[T // 4][2], "stage1_bound_3xtf32_ms": times[T // 4][3],
        "pack_ms": pack_ms,
    }


def check_melgan_chain(torch, gen, frames: int) -> dict:
    """Kernel 2 with MelGAN original's release weights at its four stages
    of one utterance (C = 256, 128, 64, 32 over frames * 10 to frames * 240
    rows), against its plain version, and its time at each with the chain's
    packed operands kept, beside the float32 and 3xTF32 bounds.  -> the
    per-stage record for the kernels line."""
    from fastvocoder_tpu_torch.ops.fused_resstack import (
        ChainTable,
        fused_residual_stacks_cuda,
        fused_residual_stacks_plain,
    )

    dev = next(gen.parameters()).device
    g = torch.Generator().manual_seed(9)
    out, T = [], frames
    for stage, scale in enumerate(gen.cfg.upsample_scales):
        T *= scale
        stacks = [m.chain_operands() for m in gen.stacks[stage]]
        C = stacks[0][0].shape[1]
        x = (0.3 * torch.randn(1, T, C, generator=g)).to(dev)
        err, tol, rows_ok, ok = rows_close(fused_residual_stacks_cuda(x, stacks),
                                           fused_residual_stacks_plain(x, stacks),
                                           CHAIN_TOL, CHAIN_ROW_TOL)
        if not ok:
            raise AssertionError(f"fused_resstack disagrees with its plain version at MelGAN's "
                                 f"stage {stage} (1, {T}, {C})")
        table = ChainTable(stacks, dev)
        ms = cuda_ms(lambda: fused_residual_stacks_cuda(x, stacks, table), iters=20, warmup=3)
        plain = cuda_ms(lambda: fused_residual_stacks_plain(x, stacks), iters=20, warmup=3)
        nbytes, flops = chain_work(1, T, stacks)
        bms, _ = bound_ms(nbytes, flops)
        b3, by = bound_3xtf32_ms(nbytes, flops)
        log(f"  fused_resstack MelGAN stage {stage} (1, {T}, {C}): max abs {err:.3e} (tol "
            f"{tol:.3e}), rows within {CHAIN_ROW_TOL:.0e}: {rows_ok:.4f}; kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, float32 bound {bms:.4f} ms, 3xTF32 bound {b3:.4f} ms ({by}, "
            f"{flops / 1e9:.2f} GFLOP): {share(b3, ms)} of it")
        out.append({"shape": [1, T, C], "max_abs_err": err, "ms": ms, "plain_ms": plain,
                    "bound_ms": bms, "bound_3xtf32_ms": b3})
    return out


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


# Rows a block of the MRF kernels owns, by width: in a forward pair launch
# (64 rows a warpgroup less the 2 x 5 rows of u the k = 11 branch recomputes)
# and in an adjoint conv of the backward (`csrc/mma_common.cuh`, `Tile`).
MRF_PAIR_ROWS = {16: 118, 32: 118, 64: 118, 128: 118, 256: 54}
MRF_CONV_ROWS = {16: 128, 32: 128, 64: 128, 128: 128, 256: 64}


def mrf_edge_shapes(C: int):
    """(B, T) on the edges of the MRF kernels' tiles at width C: T = 1, T
    below the 30-row halo with B = 3, one below, at and one above a forward
    block's rows, one above an adjoint block's."""
    R = MRF_PAIR_ROWS[C]
    return [(1, 1), (3, 7), (1, R - 1), (3, R), (1, R + 1), (2, MRF_CONV_ROWS[C] + 1)]


def to_f64(torch, operands):
    """The same nested operands with every tensor in float64."""
    if isinstance(operands, torch.Tensor):
        return operands.double()
    if isinstance(operands, (list, tuple)):
        return type(operands)(to_f64(torch, o) for o in operands)
    return operands


def mrf_errors_against_f64(torch, dev) -> None:
    """What 3xTF32 costs: per width, the MRF kernels' error against a
    float64 run of the plain version, beside the float32 plain version's own
    error against it (forward: of the output's peak; backward: dx of its
    peak, and the worst dW or db of its own peak)."""
    from fastvocoder_tpu_torch.ops import fused_mrf as m

    g = torch.Generator().manual_seed(64)
    for C in m.KERNEL_WIDTHS:
        blocks = seeded_resblocks(torch, C, dev, 60 + C)
        x = (0.3 * torch.randn(2, 600, C, generator=g)).to(dev)
        cot = torch.randn(2, 600, C, generator=g).to(dev)
        x64, blocks64, cot64 = to_f64(torch, (x, blocks, cot))
        y64 = m.fused_mrf_stage_plain(x64, blocks64)
        dx64, grads64 = m.fused_mrf_stage_vjp_plain(x64, blocks64, cot64)
        flat = lambda grads: [t for br in grads for p in br for t in p]

        def fwd_err(y):
            e = (y.double() - y64).abs() / y64.abs().max()
            return e.max().item(), e.mean().item()

        def bwd_err(dx, grads):
            e = (dx.double() - dx64).abs() / dx64.abs().max()
            w = max(((a.double() - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(flat(grads), flat(grads64)))
            return e.max().item(), e.mean().item(), w

        k, p = fwd_err(m.fused_mrf_stage_cuda(x, blocks)), fwd_err(m.fused_mrf_stage_plain(x, blocks))
        log(f"  C = {C} forward against float64: kernel max {k[0]:.3e} mean {k[1]:.3e}; "
            f"float32 plain max {p[0]:.3e} mean {p[1]:.3e}")
        if not k[1] <= 4 * p[1] + 1e-8:
            raise AssertionError(f"the MRF kernel's error against float64 at C = {C} is not "
                                 "float32's")
        k = bwd_err(*m.fused_mrf_stage_vjp_cuda(x, blocks, cot))
        p = bwd_err(*m.fused_mrf_stage_vjp_plain(x, blocks, cot))
        log(f"  C = {C} backward against float64: kernel dx max {k[0]:.3e} mean {k[1]:.3e}, "
            f"worst dW/db {k[2]:.3e}; float32 plain dx max {p[0]:.3e} mean {p[1]:.3e}, worst "
            f"dW/db {p[2]:.3e}")
        # no bound here: one leaky-relu flip in either moves a run of rows
        # of dx by 1e-2 (BWD_DX_TOL and its neighbours hold the kernel)


def chain_errors_against_f64(torch, dev) -> None:
    """What 3xTF32 costs in the chain kernels: per width, the error against a
    float64 run of the plain version beside the float32 plain version's
    own (forward: of the output's peak; backward: dx of its peak, and the
    worst dW or db of its own peak)."""
    from fastvocoder_tpu_torch.ops import fused_resstack as r

    g = torch.Generator().manual_seed(65)
    for C in r.KERNEL_WIDTHS:
        stacks = seeded_stacks(torch, C, dev, 70 + C)
        x = (0.3 * torch.randn(2, 600, C, generator=g)).to(dev)
        cot = torch.randn(2, 600, C, generator=g).to(dev)
        x64, stacks64, cot64 = to_f64(torch, (x, stacks, cot))
        y64 = r.fused_residual_stacks_plain(x64, stacks64)
        dx64, grads64 = r.fused_residual_stacks_vjp_plain(x64, stacks64, cot64)

        def fwd_err(y):
            e = (y.double() - y64).abs() / y64.abs().max()
            return e.max().item(), e.mean().item()

        def bwd_err(dx, grads):
            e = (dx.double() - dx64).abs() / dx64.abs().max()
            w = max(((a.double() - b).abs().max() / b.abs().max()).item()
                    for a, b in zip([t for s_ in grads for t in s_], [t for s_ in grads64 for t in s_]))
            off = int((e.amax(dim=2) > BWD_DX_ROW_TOL).sum().item())
            return e.max().item(), e.mean().item(), w, off

        k = fwd_err(r.fused_residual_stacks_cuda(x, stacks))
        p = fwd_err(r.fused_residual_stacks_plain(x, stacks))
        log(f"  C = {C} chain forward against float64: kernel max {k[0]:.3e} mean {k[1]:.3e}; "
            f"float32 plain max {p[0]:.3e} mean {p[1]:.3e}")
        if not k[1] <= 4 * p[1] + 1e-8:
            raise AssertionError(f"the chain kernel's error against float64 at C = {C} is not "
                                 "float32's")
        k = bwd_err(*r.fused_residual_stacks_vjp_cuda(x, stacks, cot))
        p = bwd_err(*r.fused_residual_stacks_vjp_plain(x, stacks, cot))
        log(f"  C = {C} chain backward against float64: kernel dx max {k[0]:.3e} mean "
            f"{k[1]:.3e}, worst dW/db {k[2]:.3e}, rows off by more than {BWD_DX_ROW_TOL:.0e} of "
            f"the peak {k[3]} of {2 * 600}; float32 plain dx max {p[0]:.3e} mean {p[1]:.3e}, "
            f"worst dW/db {p[2]:.3e}, rows off {p[3]}")
        # no bound here either: a leaky-relu flip moves a run of rows of dx
        # (BWD_DX_TOL and its neighbours hold the kernel)


def check_fused_mrf(torch, gen, frames: int):
    """Kernel 4 against its plain version: the release weights of HiFiGAN
    light's three MRF stages at one utterance's shapes, at batch 4 and at
    lengths whose tiles touch both sequence edges, C = 256 (HiFiGAN large's
    widest stage) and every width on the edges of its tiles with seeded
    weights; times at the utterance's shapes.  -> entry for the kernels
    line."""
    from fastvocoder_tpu_torch.ops.fused_mrf import (
        KERNEL_WIDTHS,
        fused_mrf_stage_cuda,
        fused_mrf_stage_plain,
        swap_channels,
    )

    dev = next(gen.parameters()).device
    g = torch.Generator().manual_seed(4)
    stages = [[b.mrf_operands() for b in blocks] for blocks in gen.mrfs[:-1]]
    rates = gen.cfg.upsample_rates
    lengths = [frames * int(np.prod(rates[: i + 1])) for i in range(len(stages))]
    cases = [(blocks, B, T) for blocks, T0 in zip(stages, lengths)
             for B, T in ((1, T0), (4, T0), (1, 1), (2, 7), (1, 50))]
    cases.append((seeded_resblocks(torch, 256, dev, 5), 1, frames * rates[0]))
    for C in KERNEL_WIDTHS:
        blocks = seeded_resblocks(torch, C, dev, 40 + C)
        cases += [(blocks, B, T) for B, T in mrf_edge_shapes(C)]
    worst = 0.0
    for blocks, B, T in cases:
        C = blocks[0][0][0].shape[1]
        x = (0.3 * torch.randn(B, T, C, generator=g)).to(dev)
        got = fused_mrf_stage_cuda(x, blocks)
        want = fused_mrf_stage_plain(x, blocks)
        torch.cuda.synchronize()
        err, tol, rows_ok, ok = rows_close(got, want, MRF_TOL, MRF_ROW_TOL)
        if T > 1000:
            log(f"  fused_mrf ({B}, {T}, {C}): max abs {err:.3e} (tol {tol:.3e}), "
                f"rows within {MRF_ROW_TOL:.0e} of the peak: {rows_ok:.4f}")
        if not ok:
            raise AssertionError(f"fused_mrf disagrees with its plain version at ({B}, {T}, {C})")
        worst = max(worst, err)
    log(f"  fused_mrf: {len(cases)} shapes agree, among them every width at "
        f"(B, T) = {mrf_edge_shapes(128)} (C = 128; the edges of each width's own tiles)")

    per_stage, total = [], {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    for blocks, T in zip(stages + [seeded_resblocks(torch, 256, dev, 5)],
                         lengths + [frames * rates[0]]):
        C = blocks[0][0][0].shape[1]
        x = (0.3 * torch.randn(1, T, C, generator=g)).to(dev)
        swapped = swap_channels(blocks)  # kept by the caller, as a served model keeps them
        ms = cuda_ms(lambda: fused_mrf_stage_cuda(x, blocks, swapped), iters=20, warmup=3)
        plain = cuda_ms(lambda: fused_mrf_stage_plain(x, blocks), iters=20, warmup=3)
        nbytes, flops = mrf_work(1, T, blocks)
        bms, _ = bound_ms(nbytes, flops)
        b3, by = bound_3xtf32_ms(nbytes, flops)
        log(f"  fused_mrf (1, {T}, {C}): kernel {ms:.4f} ms, plain {plain:.4f} ms, float32 "
            f"bound {bms:.4f} ms, 3xTF32 bound {b3:.4f} ms ({by}, {flops / 1e9:.2f} GFLOP): "
            f"{share(b3, ms)} of it")
        per_stage.append({"shape": [1, T, C], "ms": ms, "plain_ms": plain, "bound_ms": bms,
                          "bound_3xtf32_ms": b3})
        if C != 256:  # the main path's stages
            for k, v in (("ms", ms), ("plain_ms", plain), ("bytes", nbytes), ("flops", flops)):
                total[k] += v
    bms, _ = bound_ms(total["bytes"], total["flops"])
    b3, by = bound_3xtf32_ms(total["bytes"], total["flops"])
    return {
        "name": "fused_mrf", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/fused_mrf.cu",
        "replaces": "fastvocoder_tpu/ops/fused_mrf.py:112",
        "shape": "HiFiGAN light's 3 MRF stages of a 585-frame utterance, summed: "
                 + ", ".join(str(tuple(s["shape"])) for s in per_stage[:-1]),
        "max_abs_err": worst, "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": bms, "bound_3xtf32_ms": b3, "bound_by": by, "library_ms": None,
        "stages": per_stage,
    }


def tail_edge_lengths(C: int):
    """T_in on both sides of the tail's tiles at width C: the pair launches
    own 118 output rows a block (128 less the k = 11 pairs' margins), the
    upsample 8192 / C rows, the head 4096 / C; T = 2 T_in."""
    return (1, 59, 60, 118, 119, 4096 // C // 2, 4096 // C // 2 + 1, 4096 // C, 4096 // C + 1)


def device_ms_by_name(torch, fn, n: int = 10, tries: int = 3) -> dict:
    """Device time of one call of fn by kernel name, from torch.profiler's
    CUDA events over n calls; empty where the profiler sees no device.  A
    profile now and then comes back without device events (seen once on the
    card's machine, where the same profile had given them in earlier runs),
    so an empty one is taken again, up to `tries` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                d = (e.time_range.end - e.time_range.start) / 1e3 / n
                out[e.name] = out.get(e.name, 0.0) + d
        if out:
            break
    return out


def host_us(torch, fn, n: int = 60) -> float:
    """Median host time of one call of fn, the device idle when it starts."""
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


def check_fused_tail(torch, gen, frames: int):
    """Kernel 6 against its plain version: HiFiGAN light's release tail at
    one utterance's shape, at batch 2 with a short input, at T_in = 1 and at
    lengths on both sides of its tiles (C_out = 16), and HiFiGAN large's
    64 -> 32 tail with seeded weights at the utterance's shape and the same
    edges; times at the utterance's shape with a kept `TailTable` (as a
    served model keeps it) and built on the call, its pair launches by
    kernel name beside kernel 4 on the same MRF and shape (the yardstick),
    and the host time of one wrapper call.  -> entry for the kernels line."""
    from fastvocoder_tpu_torch.ops.fused_mrf import fused_mrf_stage_cuda, swap_channels
    from fastvocoder_tpu_torch.ops.fused_tail import (
        TailTable,
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
    cases = [(light, 1, T_main), (light, 2, 35), (light, 1, 1), (light, 3, 4), (large, 1, T_main)]
    cases += [(light, 1, t) for t in tail_edge_lengths(16)]
    cases += [(large, 2, t) for t in tail_edge_lengths(32)]
    worst = 0.0
    for ops, B, T_in in cases:
        cin = ops[0].shape[1]
        x = (0.3 * torch.randn(B, T_in, cin, generator=g)).to(dev)
        got = fused_hifigan_tail_cuda(x, *ops)
        want = fused_hifigan_tail_plain(x, *ops)
        torch.cuda.synchronize()
        err, tol, rows_ok, ok = rows_close(got, want, TAIL_TOL, TAIL_ROW_TOL)
        if T_in > 1000 or not ok:
            log(f"  fused_tail ({B}, {T_in}, {cin}) -> {tuple(got.shape)}: max abs {err:.3e} "
                f"(tol {tol:.3e}), rows within {TAIL_ROW_TOL:.0e}: {rows_ok:.4f}")
        if got.shape != (B, 2 * T_in, 1) or not ok:
            raise AssertionError(
                f"fused_tail disagrees with its plain version at ({B}, {T_in}, {cin})")
        worst = max(worst, err)
    log(f"  fused_tail: {len(cases)} shapes agree, among them T_in = {tail_edge_lengths(16)} "
        f"at C_out = 16 and {tail_edge_lengths(32)} at C_out = 32")

    table = TailTable(*light, dev)
    x = (0.3 * torch.randn(1, T_main, 32, generator=g)).to(dev)
    ms = cuda_ms(lambda: fused_hifigan_tail_cuda(x, *light, table=table), iters=20, warmup=3)
    built = cuda_ms(lambda: fused_hifigan_tail_cuda(x, *light), iters=20, warmup=3)
    plain = cuda_ms(lambda: fused_hifigan_tail_plain(x, *light), iters=20, warmup=3)
    parts = device_ms_by_name(torch, lambda: fused_hifigan_tail_cuda(x, *light, table=table))
    pair_ms = sum(v for k, v in parts.items() if "tail_pair_kernel" in k)
    k_up, b_up, stride, _, blocks, k_post, b_post = light
    T = stride * T_main
    C = k_up.shape[2]
    h = (0.3 * torch.randn(1, T, C, generator=g)).to(dev)
    swapped = swap_channels(blocks)
    yardstick = cuda_ms(lambda: fused_mrf_stage_cuda(h, blocks, swapped), iters=20, warmup=3)
    xs = (0.3 * torch.randn(1, 64, 32, generator=g)).to(dev)
    host = {"built_each_call": host_us(torch, lambda: fused_hifigan_tail_cuda(xs, *light)),
            "kept_table": host_us(
                torch, lambda: fused_hifigan_tail_cuda(xs, *light, table=table))}

    mrf_bytes, mrf_flops = mrf_work(1, T, blocks)
    # read x and every weight once, write the waveform once
    nbytes = mrf_bytes - 4 * 2 * T * C + 4 * (x.numel() + k_up.numel() + b_up.numel()
                                             + k_post.numel() + b_post.numel() + T)
    core_flops = (2 * T * (k_up.shape[0] // stride) * k_up.shape[1] * C
                  + 2 * T * k_post.shape[0] * C * k_post.shape[2])
    bms, by = bound_ms(nbytes, mrf_flops + core_flops)
    # the MRF on the tensor cores in 3xTF32, the upsample and head on the CUDA cores
    b3 = max(nbytes / PEAK_BYTES_PER_S,
             3 * mrf_flops / PEAK_TF32_FLOP_PER_S + core_flops / PEAK_F32_FLOP_PER_S) * 1e3
    mrf_b3, _ = bound_3xtf32_ms(mrf_bytes, mrf_flops)
    log(f"  fused_tail (1, {T_main}, 32) -> (1, {T}, 1): kernel {ms:.4f} ms with a kept table, "
        f"{built:.4f} ms with the table built on the call, plain {plain:.4f} ms; float32 bound "
        f"{bms:.4f} ms ({by}, {(mrf_flops + core_flops) / 1e9:.2f} GFLOP): {share(bms, ms)} of "
        f"it; 3xTF32 bound {b3:.4f} ms: {share(b3, ms)} of it")
    log("  fused_tail by kernel: " + ", ".join(
        f"{re.findall(r'(\w+(?:<[^()]*>)?)\(', k)[0]} {v:.4f} ms"
        for k, v in sorted(parts.items(), key=lambda kv: -kv[1])))
    log(f"  fused_tail pair launches {pair_ms:.4f} ms against kernel 4 on the same MRF at "
        f"(1, {T}, {C}) {yardstick:.4f} ms (the MRF's 3xTF32 bound {mrf_b3:.4f} ms)")
    log(f"  fused_tail host us a wrapper call at (1, 64, 32), device idle, median of 60: "
        f"table built each call {host['built_each_call']:.1f}, kept {host['kept_table']:.1f}")
    return {
        "name": "fused_tail", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/fused_tail.cu",
        "replaces": "fastvocoder_tpu/ops/fused_tail.py:80",
        "shape": f"x (1, {T_main}, 32) -> (1, {T}, 1), HiFiGAN light's last stage and head",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bms,
        "bound_3xtf32_ms": b3, "bound_by": by, "library_ms": None, "ms_table_built": built,
        "pair_ms": pair_ms, "yardstick_kernel4_ms": yardstick, "host_us": host,
    }


def grads_close(dx, dx_ref, grads, grads_ref):
    """(worst abs error of dx, worst error of dx relative to its peak, share
    of dx's B T rows within BWD_DX_ROW_TOL, worst dW or db error relative to
    its own peak, ok)."""
    peak = dx_ref.abs().max().item()
    err = (dx - dx_ref).abs()
    rows_ok = (err.amax(dim=2) <= BWD_DX_ROW_TOL * peak).float().mean().item()
    w_rel = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(grads, grads_ref))
    dx_rel = err.max().item() / peak
    ok = dx_rel <= BWD_DX_TOL and rows_ok >= 0.9 and w_rel <= BWD_W_TOL
    return err.max().item(), dx_rel, rows_ok, w_rel, ok


def check_backward(torch, name, vjp_cuda, vjp_plain, forward_cuda, forward_plain, stages,
                   fwd_work, replaces, what, edges=(), tensor_cores=False):
    """A backward kernel against its plain VJP at the training path's
    shapes (`stages`: (operands, C, T) per stage; batch TRAIN_BATCH and 1)
    and at `edges` ((operands, C, B, T), untimed, against the plain VJP in
    float64: over so few rows one leaky-relu flip of the float32 plain VJP
    would be a large share of a dW), its time, the plain VJP's
    and the bound, summed over the stages at the training batch; also the
    forward kernel's time at that batch.  With `tensor_cores` the 3xTF32
    bound stands beside the float32 one.  -> (entry for the kernels line,
    the forward's per-stage times)."""
    g = torch.Generator().manual_seed(len(name))
    dev = torch.device("cuda")
    flat = lambda grads: [t for group in grads for t in (
        group if isinstance(group[0], torch.Tensor) else [u for p in group for u in p])]
    worst, per_stage, fwd_stages = 0.0, [], []
    total = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    failed = []
    for ops, C, B, T in edges:
        # inputs seeded per shape, so that no pre-activation of the kernel's
        # lies on the other side of the leaky-relu kink than float64's: a
        # flip, one element in 1e6, is no fault, but over so few rows it is
        # 5e-2 of a dW
        ge = torch.Generator().manual_seed(1000 * C + 10 * T + B)
        x = (0.3 * torch.randn(B, T, C, generator=ge)).to(dev)
        cot = torch.randn(B, T, C, generator=ge).to(dev)
        dx, grads = vjp_cuda(x, ops, cot)
        dx_ref, grads_ref = vjp_plain(*to_f64(torch, (x, ops, cot)))
        torch.cuda.synchronize()
        err, dx_rel, rows_ok, w_rel, ok = grads_close(dx, dx_ref, flat(grads), flat(grads_ref))
        if not ok:
            failed.append(f"({B}, {T}, {C}): dx {dx_rel:.3e} of its peak, rows within "
                          f"{BWD_DX_ROW_TOL:.0e}: {rows_ok:.4f}, dW/db {w_rel:.3e}")
        worst = max(worst, err)
    if failed:
        raise AssertionError(f"{name} disagrees with its plain VJP at " + "; ".join(failed))
    if edges:
        log(f"  {name}: {len(edges)} shapes on the edges of its tiles agree")
    for ops, C, T in stages:
        for B in (TRAIN_BATCH, 1):
            x = (0.3 * torch.randn(B, T, C, generator=g)).to(dev)
            cot = torch.randn(B, T, C, generator=g).to(dev)
            dx, grads = vjp_cuda(x, ops, cot)
            dx_ref, grads_ref = vjp_plain(x, ops, cot)
            torch.cuda.synchronize()
            err, dx_rel, rows_ok, w_rel, ok = grads_close(dx, dx_ref, flat(grads), flat(grads_ref))
            log(f"  {name} ({B}, {T}, {C}): dx max abs {err:.3e} ({dx_rel:.3e} of its peak, tol "
                f"{BWD_DX_TOL:.0e}), rows within {BWD_DX_ROW_TOL:.0e}: {rows_ok:.4f}, worst dW/db "
                f"{w_rel:.3e} of its peak (tol {BWD_W_TOL:.0e})")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain VJP at ({B}, {T}, {C})")
            worst = max(worst, err)
            if B != TRAIN_BATCH:
                continue
            ms = cuda_ms(lambda: vjp_cuda(x, ops, cot), iters=5, warmup=2)
            plain = cuda_ms(lambda: vjp_plain(x, ops, cot), iters=5, warmup=2)
            fbytes, fflops = fwd_work(B, T, ops)
            weights = fbytes - 4 * 2 * B * T * C
            # x and g read, dx written, every weight read and its gradient
            # written; the forward again plus twice its operations
            nbytes, flops = 4 * 3 * B * T * C + 2 * weights, 3 * fflops
            bms, by = bound_ms(nbytes, flops)
            stage = {"shape": [B, T, C], "ms": ms, "plain_ms": plain, "bound_ms": bms}
            against = f"bound {bms:.3f} ms ({by}, {flops / 1e9:.1f} GFLOP)"
            if tensor_cores:
                stage["bound_3xtf32_ms"], by3 = bound_3xtf32_ms(nbytes, flops)
                against = (f"float32 {against}, 3xTF32 bound {stage['bound_3xtf32_ms']:.3f} ms "
                           f"({by3}): {share(stage['bound_3xtf32_ms'], ms)} of it")
            log(f"  {name} ({B}, {T}, {C}): kernel {ms:.3f} ms, plain VJP {plain:.3f} ms, "
                + against)
            per_stage.append(stage)
            for k, v in (("ms", ms), ("plain_ms", plain), ("bytes", nbytes), ("flops", flops)):
                total[k] += v
            with torch.inference_mode():
                fms = cuda_ms(lambda: forward_cuda(x, ops), iters=5, warmup=2)
                fplain = cuda_ms(lambda: forward_plain(x, ops), iters=5, warmup=2)
            fb, _ = bound_ms(fbytes, fflops)
            fstage = {"shape": [B, T, C], "ms": fms, "plain_ms": fplain, "bound_ms": fb}
            against = f"bound {fb:.3f} ms"
            if tensor_cores:
                fstage["bound_3xtf32_ms"], _ = bound_3xtf32_ms(fbytes, fflops)
                against = (f"float32 {against}, 3xTF32 bound {fstage['bound_3xtf32_ms']:.3f} ms: "
                           f"{share(fstage['bound_3xtf32_ms'], fms)} of it")
            log(f"  forward at ({B}, {T}, {C}): kernel {fms:.3f} ms, plain {fplain:.3f} ms, "
                + against)
            fwd_stages.append(fstage)
            del x, cot, dx, grads, dx_ref, grads_ref
            torch.cuda.empty_cache()
    bms, by = bound_ms(total["bytes"], total["flops"])
    entry = {
        "name": name, "route": "cuda",
        "source": f"fastvocoder_tpu_torch/csrc/{name}.cu", "replaces": replaces,
        "shape": what + ", summed: " + ", ".join(str(tuple(s["shape"])) for s in per_stage),
        "max_abs_err": worst, "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": bms, "bound_by": by, "library_ms": None, "stages": per_stage,
    }
    if tensor_cores:
        entry["bound_3xtf32_ms"], entry["bound_by"] = bound_3xtf32_ms(total["bytes"],
                                                                     total["flops"])
    return entry, fwd_stages


def chain_work(B: int, T: int, stacks) -> tuple:
    """(bytes, FLOP) of one residual-stack chain's forward."""
    C = stacks[0][0].shape[1]
    weights = sum(w.numel() for s in stacks for w in s if not isinstance(w, int))
    taps = sum(s[0].shape[0] + 2 for s in stacks)
    return 4 * (2 * B * T * C + weights), 2 * B * T * taps * C * C


def check_fused_mrf_bwd(torch, gen):
    """Kernel 5 with the release weights of HiFiGAN light's four MRF stages
    at the training crop's lengths."""
    from fastvocoder_tpu_torch.ops import fused_mrf as m

    rates = gen.cfg.upsample_rates
    stages = []
    for i, blocks in enumerate(gen.mrfs):
        ops = [b.mrf_operands() for b in blocks]
        stages.append((ops, ops[0][0][0].shape[1], TRAIN_FRAMES * int(np.prod(rates[: i + 1]))))
    edges = []
    for C in m.KERNEL_WIDTHS:
        ops = seeded_resblocks(torch, C, torch.device("cuda"), 50 + C)
        edges += [(ops, C, B, T) for B, T in mrf_edge_shapes(C)]
    edges.append((seeded_resblocks(torch, 256, torch.device("cuda"), 5), 256, 1, MEL_FRAMES * rates[0]))
    return check_backward(
        torch, "fused_mrf_bwd", m.fused_mrf_stage_vjp_cuda, m.fused_mrf_stage_vjp_plain,
        m.fused_mrf_stage_cuda, m.fused_mrf_stage_plain, stages, mrf_work,
        "fastvocoder_tpu/ops/fused_mrf.py:227",
        f"HiFiGAN light's 4 MRF stages of {TRAIN_BATCH} crops of {TRAIN_FRAMES} frames",
        edges=edges, tensor_cores=True)


def check_fused_resstack_bwd(torch, gen):
    """Kernel 3 with the release weights of Basis-MelGAN light's two stages
    at the training crop's lengths, and with seeded weights at every width
    on the edges of its tiles."""
    from fastvocoder_tpu_torch.ops import fused_resstack as r

    stages = []
    for i, group in enumerate(gen.stacks):
        ops = [s.chain_operands() for s in group]
        stages.append((ops, ops[0][0].shape[1],
                       TRAIN_FRAMES * int(np.prod(gen.cfg.upsample_scales[: i + 1]))))
    edges = []
    for C in r.KERNEL_WIDTHS:
        ops = seeded_stacks(torch, C, torch.device("cuda"), 80 + C)
        edges += [(ops, C, B, T) for B, T in chain_edge_shapes(C, 10)]
    return check_backward(
        torch, "fused_resstack_bwd", r.fused_residual_stacks_vjp_cuda,
        r.fused_residual_stacks_vjp_plain, r.fused_residual_stacks_cuda,
        r.fused_residual_stacks_plain, stages, chain_work,
        "fastvocoder_tpu/ops/fused_resstack.py:241",
        f"Basis-MelGAN light's 2 stages of {TRAIN_BATCH} crops of {TRAIN_FRAMES} frames",
        edges=edges, tensor_cores=True)


def check_melgan_chain_bwd(torch, gen):
    """Kernel 3 with MelGAN original's release weights at its four training
    stages (32 crops of 140 frames: 1400 to 33,600 rows, C = 256 to 32)."""
    from fastvocoder_tpu_torch.ops import fused_resstack as r

    stages, T = [], TRAIN_FRAMES
    for i, scale in enumerate(gen.cfg.upsample_scales):
        T *= scale
        ops = [s_.chain_operands() for s_ in gen.stacks[i]]
        stages.append((ops, ops[0][0].shape[1], T))
    entry, fwd = check_backward(
        torch, "fused_resstack_bwd", r.fused_residual_stacks_vjp_cuda,
        r.fused_residual_stacks_vjp_plain, r.fused_residual_stacks_cuda,
        r.fused_residual_stacks_plain, stages, chain_work, "",
        f"MelGAN original's 4 stages of {TRAIN_BATCH} crops of {TRAIN_FRAMES} frames",
        tensor_cores=True)
    keep = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_3xtf32_ms", "bound_by",
            "stages")
    return {k: v for k, v in entry.items() if k in keep}, fwd


def bound_bf16_ms(nbytes: float, flops: float):
    """The bound of a bf16 form: bytes at bf16 widths (as the caller counts
    them) or every product at the dense bf16 rate of the tensor cores."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(torch, v):
    """One bf16 ulp at each element of v: 2^(e - 7), e its binade."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


def bf16_close(torch, got, want, tol: float = BF16_TOL):
    """(max abs error, the peak, share of elements more than one bf16 ulp
    apart, ok) of a bf16 form's output against its plain version's."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    peak = want.abs().max().item()
    far = (err > bf16_ulp(torch, want)).float().mean().item()
    ok = bool(torch.isfinite(got).all()) and err.max().item() <= tol * peak
    return err.max().item(), peak, far, ok


def bf16_cases(torch, name, cases, run, plain, log_if):
    """Runs a bf16 form (`run`) and its plain version on every case (the
    arguments after x, B, T, C, the input's width); fails on a case out of
    BF16_TOL.  -> the worst max abs error."""
    g = torch.Generator().manual_seed(80)
    worst = 0.0
    for args, B, T, C in cases:
        dev = next(a for a in _flat_tensors(args)).device
        x = (0.3 * torch.randn(B, T, C, generator=g)).to(dev).to(torch.bfloat16)
        got = run(x, *args)
        want = plain(x, *args)
        torch.cuda.synchronize()
        err, peak, far, ok = bf16_close(torch, got, want)
        if log_if(B, T) or not ok:
            log(f"  {name} ({B}, {T}, {C}): max abs {err:.3e} of peak {peak:.3e} (tol "
                f"{BF16_TOL * peak:.3e}), {far:.4f} of elements more than one bf16 ulp apart")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain bf16 version at ({B}, {T}, {C})")
        worst = max(worst, err)
    return worst


def _flat_tensors(obj):
    if isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _flat_tensors(o)
    elif hasattr(obj, "device"):
        yield obj


def against_f64(torch, name, x, args, bf16_form, f32_kernel, plain) -> None:
    """The error against float64 (the plain version in float64 on the bf16
    input) of the bf16 form, of its plain bf16 version and of the float32
    kernel on the same input, each of the float64 output's peak."""
    xb = x.to(torch.bfloat16)
    y64 = plain(xb.double(), *to_f64(torch, args)).double()
    peak = y64.abs().max().item()

    def rel(y):
        return ((y.double() - y64).abs().max() / peak).item()

    log(f"  {name} against float64 at {tuple(x.shape)}: bf16 form {rel(bf16_form(xb, *args)):.3e}, "
        f"its plain bf16 version {rel(plain(xb, *args)):.3e}, float32 kernel "
        f"{rel(f32_kernel(xb.float(), *args)):.3e} of the peak {peak:.3e}")


def bf16_grads_close(torch, dx, dx_ref, grads, grads_ref):
    """A bf16 backward form against its plain version, both the float32 VJP
    rounded to bf16 once: (share of dx's rows whose every element lies
    within one bf16 ulp of its own value of the plain version's plus the
    float32 forms' row tolerance, BWD_DX_ROW_TOL of the peak, dx's worst
    error of its peak, the worst dW or db error of its own peak, the largest
    share of a dW's or db's elements beyond one ulp and BWD_DX_ROW_TOL of
    its peak, ok)."""
    def beyond(got, want, peak):
        got, want = got.double(), want.double()
        return (got - want).abs() > (bf16_ulp(torch, torch.maximum(got.abs(), want.abs()))
                                     + BWD_DX_ROW_TOL * peak)

    peak = dx_ref.abs().max().item()
    rows_ok = 1 - beyond(dx, dx_ref, peak).any(dim=2).float().mean().item()
    dx_rel = (dx.double() - dx_ref.double()).abs().max().item() / peak
    w_rel, w_far = 0.0, 0.0
    for g_, w in zip(grads, grads_ref):
        w_peak = w.abs().max().item()
        w_rel = max(w_rel, (g_.double() - w.double()).abs().max().item() / w_peak)
        w_far = max(w_far, beyond(g_, w, w_peak).float().mean().item())
    ok = (dx.dtype == torch.bfloat16 and all(g_.dtype == torch.bfloat16 for g_ in grads)
          and dx_rel <= BWD_DX_TOL and rows_ok >= BF16_BWD_ROWS and w_rel <= BWD_W_TOL)
    return rows_ok, dx_rel, w_rel, w_far, ok


def vjp_switching_at(torch, vjp_plain, args, shift: int, near) -> list:
    """vjp_plain(*args), flattened, with every leaky-relu's derivative
    switching to 1 at `shift` KINK_BAND of its input's peak instead of at 0
    (the forward unchanged); `near`, if a list, gets per leaky-relu the
    number of its inputs within the band."""
    from fastvocoder_tpu_torch.ops import fused_mrf as fm
    from fastvocoder_tpu_torch.ops import fused_resstack as fr

    plain_leaky = fr.leaky_relu

    def leaky(v, slope=fr.SLOPE):
        y = plain_leaky(v, slope)
        if not v.requires_grad:
            return y
        d = v.detach()
        band = KINK_BAND * d.abs().max()
        if near is not None:
            near.append(int((d.abs() <= band).sum()))
        slopes = torch.full_like(d, slope).masked_fill_(d >= shift * band, 1.0)
        return y.detach() + (v - d) * slopes  # the value y, the derivative `slopes`

    saved = fr.leaky_relu, fm.leaky_relu
    fr.leaky_relu = fm.leaky_relu = leaky
    try:
        dx, grads = vjp_plain(*args)
    finally:
        fr.leaky_relu, fm.leaky_relu = saved
    return [dx] + list(_flat_tensors(grads))


def bf16_grads_against_f64(torch, got, vjp_plain, args64):
    """A bf16 backward form's flat (dx, dW and db ...) against its plain
    version run in float64 (`args64`): (worst error beyond one bf16 ulp and
    the tight tolerance, of dx's peak, and of a dW's or db's peak, the
    pre-activations within KINK_BAND of the kink, whether taking their other
    slope explains every element, ok).  Tight: one ulp plus BWD_DX_ROW_TOL
    of the peak (dx) or twice it (dW, db).  An element farther must be one
    that the other slope at those pre-activations moves, by no more than it
    moves it or than the float32 forms' bounds (BWD_DX_TOL, BWD_W_TOL);
    90 % of dx's rows tight, every element of dx within BWD_DX_TOL."""
    want = vjp_switching_at(torch, vjp_plain, args64, 0, None)
    tols = [BWD_DX_ROW_TOL] + [2 * BWD_DX_ROW_TOL] * (len(got) - 1)
    caps = [BWD_DX_TOL] + [BWD_W_TOL] * (len(got) - 1)
    peaks = [max(w.abs().max().item(), 1e-30) for w in want]
    ok = len(got) == len(want) and all(a.dtype == torch.bfloat16 and a.shape == w.shape
                                       for a, w in zip(got, want))
    errs = [(a.double() - w).abs() - bf16_ulp(torch, torch.maximum(a.double().abs(), w.abs()))
            - tol * peak for a, w, tol, peak in zip(got, want, tols, peaks)]
    beyond = [e.max().item() / p for e, p in zip(errs, peaks)]
    rows_ok = (errs[0] <= 0).all(dim=2).float().mean().item()
    ok = ok and rows_ok >= BF16_BWD_ROWS and (
        (got[0].double() - want[0]).abs().max().item() <= BWD_DX_TOL * peaks[0])
    near, explained = [], True
    if max(beyond) > 0:
        hi = vjp_switching_at(torch, vjp_plain, args64, -1, near)
        lo = vjp_switching_at(torch, vjp_plain, args64, 1, None)
        reach = [(h - w).abs() + (lo_ - w).abs() for h, lo_, w in zip(hi, lo, want)]
        moved = [r > 1e-6 * peak for r, peak in zip(reach, peaks)]
        explained = all(bool((e <= r).all()) for e, r in zip(errs, reach))
        ok = ok and all(bool((e <= torch.where(m, r.clamp_min(cap * peak), 0.0)).all())
                        for e, r, m, cap, peak in zip(errs, reach, moved, caps, peaks))
        log(f"    beyond one bf16 ulp: dx {beyond[0]:.3e}, dW/db {max(beyond[1:]):.3e} of the "
            f"peak, {rows_ok:.4f} of dx's rows within; {sum(near)} pre-activations within "
            f"{KINK_BAND} of their peak of the kink, whose other slope moves "
            f"{moved[0].any(dim=2).float().mean().item():.4f} of dx's rows and explains every "
            f"element: {explained}")
    return beyond[0], max(beyond[1:]), sum(near), explained, ok


def check_bf16_backward(torch, name, vjp_cuda, vjp_f32, vjp_plain, stages, fwd_work, replaces,
                        what, edges):
    """A bf16 backward form (kernel 3b or 5b) against its plain version:
    at `edges` ((operands, C, B, T), seeded per shape, untimed) against the
    plain version run in float64 on the same bf16 inputs (so that only the
    kernel's float32 rounding can flip a leaky-relu slope;
    `bf16_grads_against_f64`), with each one's error against it beside the
    plain bf16 version's, and bit for bit
    against the float32 form (`vjp_f32`) on the widened inputs, rounded;
    at the training path's `stages` ((operands, C, T), batch TRAIN_BATCH)
    against the plain bf16 version, timed against it and the bounds.
    Operands are float32 and cast to bf16 here, as training casts them.
    -> the kernels line's entry."""
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    cast = lambda ops: [cast(o) for o in ops] if isinstance(ops, (list, tuple)) else (
        ops.to(bf16) if hasattr(ops, "dtype") else ops)
    cast32 = lambda ops: [cast32(o) for o in ops] if isinstance(ops, (list, tuple)) else (
        ops.float() if hasattr(ops, "dtype") else ops)
    flat = lambda grads: [t for group in grads for t in (
        group if isinstance(group[0], torch.Tensor) else [u for p in group for u in p])]
    worst_f64 = (0.0, 0.0)
    for ops, C, B, T in edges:
        ge = torch.Generator().manual_seed(1000 * C + 10 * T + B)
        x = (0.3 * torch.randn(B, T, C, generator=ge)).to(dev).to(bf16)
        cot = torch.randn(B, T, C, generator=ge).to(dev).to(bf16)
        ops_b = cast(ops)
        dx, grads = vjp_cuda(x, ops_b, cot)
        dx_ref, grads_ref = vjp_plain(x, ops_b, cot)
        args64 = to_f64(torch, (x, ops_b, cot))
        dx64, _ = vjp_plain(*args64)
        dx32, grads32 = vjp_f32(x.float(), cast32(ops_b), cot.float())
        torch.cuda.synchronize()
        if not (torch.equal(dx, dx32.to(bf16)) and all(
                torch.equal(a, b.to(bf16)) for a, b in zip(flat(grads), flat(grads32)))):
            raise AssertionError(f"{name} at ({B}, {T}, {C}) is not the float32 form on the "
                                 f"widened inputs, rounded once")
        dx_far, w_far, near, explained, ok = bf16_grads_against_f64(
            torch, [dx] + flat(grads), vjp_plain, args64)
        peak = dx64.abs().max().item()
        k_err = (dx.double() - dx64).abs().max().item() / peak
        p_err = (dx_ref.double() - dx64).abs().max().item() / peak
        worst_f64 = max(worst_f64, (k_err, p_err))
        # (where a flip was shown, it moves dx off the plain version's error)
        if not ok or (near == 0 and k_err > 2 * p_err + 1e-7):
            raise AssertionError(
                f"{name} disagrees with its plain version at ({B}, {T}, {C}): beyond one bf16 "
                f"ulp and what a flip explains, dx {dx_far:.3e}, dW/db {w_far:.3e} of the peak "
                f"({near} pre-activations near the kink); against float64 {k_err:.3e}, its "
                f"plain version {p_err:.3e}")
    log(f"  {name}: {len(edges)} shapes on the edges of its tiles agree (each the float32 form "
        f"on the widened inputs rounded once, bit for bit); dx against float64: "
        f"worst {worst_f64[0]:.3e} of the peak, the plain bf16 version's {worst_f64[1]:.3e} "
        f"there (one rounding to bf16 each)")
    g = torch.Generator().manual_seed(len(name))
    worst, per_stage = 0.0, []
    total = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    for ops, C, T in stages:
        B = TRAIN_BATCH
        x = (0.3 * torch.randn(B, T, C, generator=g)).to(dev).to(bf16)
        cot = torch.randn(B, T, C, generator=g).to(dev).to(bf16)
        ops_b = cast(ops)
        dx, grads = vjp_cuda(x, ops_b, cot)
        dx_ref, grads_ref = vjp_plain(x, ops_b, cot)
        torch.cuda.synchronize()
        rows_ok, dx_rel, w_rel, w_far, ok = bf16_grads_close(torch, dx, dx_ref, flat(grads),
                                                             flat(grads_ref))
        log(f"  {name} ({B}, {T}, {C}): rows within one bf16 ulp {rows_ok:.4f} (at least "
            f"{BF16_BWD_ROWS}), dx {dx_rel:.3e} of its peak, worst dW/db {w_rel:.3e} of its peak, "
            f"{w_far:.4f} of a dW's elements beyond one ulp")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at ({B}, {T}, {C})")
        worst = max(worst, (dx.float() - dx_ref.float()).abs().max().item())
        ms = cuda_ms(lambda: vjp_cuda(x, ops_b, cot), iters=5, warmup=2)
        plain = cuda_ms(lambda: vjp_plain(x, ops_b, cot), iters=5, warmup=2)
        fbytes, fflops = fwd_work(B, T, ops)
        weights = fbytes / 4 - 2 * B * T * C
        # bf16 x and g read, dx written, every weight read and its gradient
        # written; the forward again plus twice its operations, in float32
        nbytes, flops = 2 * 3 * B * T * C + 2 * 2 * weights, 3 * fflops
        bms, by = bound_ms(nbytes, flops)
        b3, by3 = bound_3xtf32_ms(nbytes, flops)
        log(f"  {name} ({B}, {T}, {C}): kernel {ms:.3f} ms, plain {plain:.3f} ms, float32 bound "
            f"{bms:.3f} ms ({by}), 3xTF32 bound {b3:.3f} ms ({by3}): {share(b3, ms)} of it")
        per_stage.append({"shape": [B, T, C], "ms": ms, "plain_ms": plain, "bound_ms": bms,
                          "bound_3xtf32_ms": b3})
        for k, v in (("ms", ms), ("plain_ms", plain), ("bytes", nbytes), ("flops", flops)):
            total[k] += v
        del x, cot, dx, grads, dx_ref, grads_ref
        torch.cuda.empty_cache()
    bms, by = bound_ms(total["bytes"], total["flops"])
    entry = {
        "name": name, "route": "cuda", "form": "bf16",
        "source": f"fastvocoder_tpu_torch/csrc/{name[:-len('_bf16')]}.cu", "replaces": replaces,
        "shape": what + ", summed: " + ", ".join(str(tuple(s_["shape"])) for s_ in per_stage),
        "max_abs_err": worst, "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": bms, "bound_by": by, "library_ms": None, "stages": per_stage,
    }
    entry["bound_3xtf32_ms"], _ = bound_3xtf32_ms(total["bytes"], total["flops"])
    return entry


def check_bf16_chain_bwd(torch, basis_gen, melgan_gen):
    """Kernel 3b with the release weights of Basis-MelGAN light's two
    training stages and MelGAN original's four, and with seeded weights at
    every width on the edges of its tiles."""
    from fastvocoder_tpu_torch.ops import fused_resstack as r

    stages = []
    for gen in (basis_gen, melgan_gen):
        T = TRAIN_FRAMES
        for i, scale in enumerate(gen.cfg.upsample_scales):
            T *= scale
            ops = [s_.chain_operands() for s_ in gen.stacks[i]]
            stages.append((ops, ops[0][0].shape[1], T))
    edges = []
    for C in r.KERNEL_WIDTHS:
        ops = seeded_stacks(torch, C, torch.device("cuda"), 80 + C)
        edges += [(ops, C, B, T) for B, T in chain_edge_shapes(C, 10)]
    return check_bf16_backward(
        torch, "fused_resstack_bwd_bf16", r.fused_residual_stacks_vjp_bf16_cuda,
        r.fused_residual_stacks_vjp_cuda, r.fused_residual_stacks_vjp_plain, stages, chain_work,
        "fastvocoder_tpu/ops/fused_resstack.py:241 (bf16)",
        f"Basis-MelGAN light's 2 and MelGAN original's 4 stages of {TRAIN_BATCH} crops of "
        f"{TRAIN_FRAMES} frames, bf16", edges)


def check_bf16_mrf_bwd(torch, gen):
    """Kernel 5b with the release weights of HiFiGAN light's four MRF stages
    at the training crop's lengths, and seeded weights at every width on the
    edges of its tiles."""
    from fastvocoder_tpu_torch.ops import fused_mrf as m

    rates = gen.cfg.upsample_rates
    stages = []
    for i, blocks in enumerate(gen.mrfs):
        ops = [b.mrf_operands() for b in blocks]
        stages.append((ops, ops[0][0][0].shape[1], TRAIN_FRAMES * int(np.prod(rates[: i + 1]))))
    edges = []
    for C in m.KERNEL_WIDTHS:
        ops = seeded_resblocks(torch, C, torch.device("cuda"), 50 + C)
        edges += [(ops, C, B, T) for B, T in mrf_edge_shapes(C)]
    return check_bf16_backward(
        torch, "fused_mrf_bwd_bf16", m.fused_mrf_stage_vjp_bf16_cuda, m.fused_mrf_stage_vjp_cuda,
        m.fused_mrf_stage_vjp_plain, stages, mrf_work,
        "fastvocoder_tpu/ops/fused_mrf.py:227 (bf16)",
        f"HiFiGAN light's 4 MRF stages of {TRAIN_BATCH} crops of {TRAIN_FRAMES} frames, bf16",
        edges)


def check_bf16_decode(torch, F, basis):
    """Kernel 1's bf16 form against its plain version at the main path's
    shape, the training batch's and lengths on both sides of its tiles;
    device times at (1, F, C) and (32, 2240, C) beside `conv_transpose1d` in
    bf16.  -> entry for the kernels line."""
    from fastvocoder_tpu_torch.ops.basis_decode import (
        basis_decode_bf16_cuda,
        basis_decode_cuda,
        basis_decode_plain,
    )

    dev = basis.device
    bb = basis.to(torch.bfloat16)
    eps = float(np.finfo(np.float32).eps)
    g = torch.Generator().manual_seed(11)
    worst = 0.0
    C, L = basis.shape[1], basis.shape[0]
    for B, Fr in ((1, F), (32, 2240), (3, 77), (1, 1), (1, 15), (1, 16), (5, 63)):
        w = torch.relu(torch.randn(B, Fr, C, generator=g)).to(dev).to(torch.bfloat16)
        got = basis_decode_bf16_cuda(w, bb)
        want = basis_decode_plain(w, bb)
        torch.cuda.synchronize()
        # the same bf16 products summed in float32: the float32 form's bound
        err = (got - want).abs()
        ok = bool(torch.all(err <= 4 * C * eps * basis_decode_plain(w.abs(), bb.abs())))
        if not ok or B * Fr > 1000:
            log(f"  basis_decode_bf16 B={B} F={Fr}: max abs {err.max().item():.3e} of peak "
                f"{want.abs().max().item():.3e}, within the float32 form's bound {ok}")
        if not ok:
            raise AssertionError(f"basis_decode_bf16 disagrees with its plain version at B={B}")
        worst = max(worst, err.max().item())
    w = torch.relu(torch.randn(1, F, C, generator=g)).to(dev)
    against_f64(torch, "basis_decode", w, (basis,),
                lambda xb, b: basis_decode_bf16_cuda(xb, b.to(torch.bfloat16)),
                lambda xf, b: basis_decode_cuda(xf, b), basis_decode_plain)
    hop = L // 2
    kernel = bb.t()[:, None, :].contiguous()
    times = {}
    for B, Fr in ((1, F), (TRAIN_BATCH, TRAIN_FRAMES * 16)):
        w = torch.relu(torch.randn(B, Fr, C, generator=g)).to(dev).to(torch.bfloat16)
        wt = w.transpose(1, 2)
        fns = {"ms": lambda: basis_decode_bf16_cuda(w, bb),
               "plain_ms": lambda: basis_decode_plain(w, bb),
               "library_ms": lambda: torch.nn.functional.conv_transpose1d(wt, kernel, stride=hop)}
        got = {k: sum(device_ms_by_name(torch, fn, 20).values()) for k, fn in fns.items()}
        if min(got.values()) <= 0:
            raise AssertionError("torch.profiler saw no device time of the bf16 decode")
        nbytes = 2 * (B * Fr * C + L * C) + 4 * B * (Fr + 1) * hop
        bms, by = bound_bf16_ms(nbytes, 2 * 2 * B * (Fr + 1) * hop * C)
        log(f"  basis_decode_bf16 ({B}, {Fr}, {C}), device ms: kernel {got['ms']:.4f}, plain "
            f"{got['plain_ms']:.4f}, conv_transpose1d in bf16 {got['library_ms']:.4f}; bound "
            f"{bms:.4f} ms ({by}): {share(bms, got['ms'])} of it")
        times[B] = {"shape": [B, Fr, C], **got, "bound_ms": bms, "bound_by": by}
    return {
        "name": "basis_decode_bf16", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/basis_decode.cu",
        "replaces": "fastvocoder_tpu/ops/basis_decode.py:121", "form": "bf16",
        "shape": f"W (1, {F}, {C}) bf16, basis ({L}, {C}) bf16",
        "max_abs_err": worst, **{k: v for k, v in times[1].items() if k != "shape"},
        "batch32": times[TRAIN_BATCH],
    }


def check_bf16_chain(torch, basis_gen, melgan_gen, T_main):
    """Kernel 2's bf16 form against its plain version with the release
    weights of Basis-MelGAN light's two stages (batch 1 and 32) and MelGAN
    original's four, and with seeded weights at every width on the edges of
    its tiles; times with a kept bf16 `ChainTable`.  -> entry for the
    kernels line."""
    from fastvocoder_tpu_torch.ops.fused_resstack import (
        KERNEL_WIDTHS,
        ChainTable,
        fused_residual_stacks_bf16_cuda,
        fused_residual_stacks_cuda,
        fused_residual_stacks_plain,
    )

    dev = next(basis_gen.parameters()).device
    basis_stages = [[m.chain_operands() for m in st] for st in basis_gen.stacks]
    melgan_stages = [[m.chain_operands() for m in st] for st in melgan_gen.stacks]
    main = [((basis_stages[0],), 1, T_main // 4), ((basis_stages[1],), 1, T_main)]
    T, melgan = MEL_FRAMES, []
    for stage, scale in zip(melgan_stages, melgan_gen.cfg.upsample_scales):
        T *= scale
        melgan.append(((stage,), 1, T))
    batch32 = [((basis_stages[0],), TRAIN_BATCH, TRAIN_FRAMES * 4),
               ((basis_stages[1],), TRAIN_BATCH, TRAIN_FRAMES * 16)]
    cases = [(a, B, T, a[0][0][0].shape[1]) for a, B, T in main + melgan + batch32]
    for C in KERNEL_WIDTHS:
        stacks = seeded_stacks(torch, C, dev, 90 + C)
        cases += [((stacks,), B, T, C) for B, T in chain_edge_shapes(C, 1)]
    worst = bf16_cases(torch, "fused_resstack_bf16", cases, fused_residual_stacks_bf16_cuda,
                       fused_residual_stacks_plain, lambda B, T: T > 1000)
    log(f"  fused_resstack_bf16: {len(cases)} shapes agree, every width on the edges of its tiles")
    g = torch.Generator().manual_seed(81)
    x = (0.3 * torch.randn(1, T_main // 4, 256, generator=g)).to(dev)
    against_f64(torch, "fused_resstack", x, (basis_stages[0],), fused_residual_stacks_bf16_cuda,
                fused_residual_stacks_cuda, fused_residual_stacks_plain)

    timed = []
    for (stacks,), B, T in main + melgan + batch32:
        C = stacks[0][0].shape[1]
        x = (0.3 * torch.randn(B, T, C, generator=g)).to(dev).to(torch.bfloat16)
        table = ChainTable(stacks, dev, torch.bfloat16)  # kept, as a served model keeps it
        it = 5 if B > 1 else 20
        ms = cuda_ms(lambda: fused_residual_stacks_bf16_cuda(x, stacks, table), iters=it, warmup=2)
        plain = cuda_ms(lambda: fused_residual_stacks_plain(x, stacks), iters=it, warmup=2)
        nbytes, flops = chain_work(B, T, stacks)
        weights = nbytes / 4 - 2 * B * T * C
        bms, by = bound_bf16_ms(2 * 2 * B * T * C + 2 * weights, flops)
        log(f"  fused_resstack_bf16 ({B}, {T}, {C}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bf16 bound {bms:.4f} ms ({by}, {flops / 1e9:.2f} GFLOP): {share(bms, ms)} of it")
        timed.append({"shape": [B, T, C], "ms": ms, "plain_ms": plain, "bound_ms": bms,
                      "bound_by": by})
    main_entry = timed[1]
    return {
        "name": "fused_resstack_bf16", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/fused_resstack.cu",
        "replaces": "fastvocoder_tpu/ops/fused_resstack.py:153", "form": "bf16",
        "shape": f"x (1, {T_main}, 256) bf16, 3 stacks K=3 d=1,3,9 (stage 2 of 2)",
        "max_abs_err": worst, "ms": main_entry["ms"], "plain_ms": main_entry["plain_ms"],
        "bound_ms": main_entry["bound_ms"], "bound_by": main_entry["bound_by"],
        "library_ms": None, "stage1": timed[0], "melgan_stages": timed[2:6],
        "batch32": timed[6:],
    }


def check_bf16_mrf(torch, gen, frames: int):
    """Kernel 4's bf16 form against its plain version: the release weights of
    HiFiGAN light's three MRF stages at one utterance's shapes, and seeded
    weights at every width on the edges of its tiles; times at the
    utterance's shapes with a kept bf16 `StageTable`.  -> entry for the
    kernels line."""
    from fastvocoder_tpu_torch.ops.fused_mrf import (
        KERNEL_WIDTHS,
        StageTable,
        fused_mrf_stage_bf16_cuda,
        fused_mrf_stage_cuda,
        fused_mrf_stage_plain,
    )

    dev = next(gen.parameters()).device
    stages = [[b.mrf_operands() for b in blocks] for blocks in gen.mrfs[:-1]]
    rates = gen.cfg.upsample_rates
    lengths = [frames * int(np.prod(rates[: i + 1])) for i in range(len(stages))]
    cases = [((blocks,), 1, T, blocks[0][0][0].shape[1]) for blocks, T in zip(stages, lengths)]
    for C in KERNEL_WIDTHS:
        blocks = seeded_resblocks(torch, C, dev, 90 + C)
        cases += [((blocks,), B, T, C) for B, T in mrf_edge_shapes(C)]
    worst = bf16_cases(torch, "fused_mrf_bf16", cases, fused_mrf_stage_bf16_cuda,
                       fused_mrf_stage_plain, lambda B, T: T > 1000)
    log(f"  fused_mrf_bf16: {len(cases)} shapes agree, every width on the edges of its tiles")
    g = torch.Generator().manual_seed(82)
    x = (0.3 * torch.randn(1, lengths[0], stages[0][0][0][0].shape[1], generator=g)).to(dev)
    against_f64(torch, "fused_mrf", x, (stages[0],), fused_mrf_stage_bf16_cuda,
                fused_mrf_stage_cuda, fused_mrf_stage_plain)
    per_stage, total = [], {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "flops": 0.0}
    for blocks, T in zip(stages, lengths):
        C = blocks[0][0][0].shape[1]
        x = (0.3 * torch.randn(1, T, C, generator=g)).to(dev).to(torch.bfloat16)
        table = StageTable(blocks, None, x.device, torch.bfloat16)
        ms = cuda_ms(lambda: fused_mrf_stage_bf16_cuda(x, blocks, None, table), iters=20, warmup=3)
        plain = cuda_ms(lambda: fused_mrf_stage_plain(x, blocks), iters=20, warmup=3)
        nbytes, flops = mrf_work(1, T, blocks)
        nbytes /= 2  # bf16 activations and weights
        bms, by = bound_bf16_ms(nbytes, flops)
        log(f"  fused_mrf_bf16 (1, {T}, {C}): kernel {ms:.4f} ms, plain {plain:.4f} ms, bf16 "
            f"bound {bms:.4f} ms ({by}, {flops / 1e9:.2f} GFLOP): {share(bms, ms)} of it")
        per_stage.append({"shape": [1, T, C], "ms": ms, "plain_ms": plain, "bound_ms": bms})
        for k, v in (("ms", ms), ("plain_ms", plain), ("bytes", nbytes), ("flops", flops)):
            total[k] += v
    bms, by = bound_bf16_ms(total["bytes"], total["flops"])
    return {
        "name": "fused_mrf_bf16", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/fused_mrf.cu",
        "replaces": "fastvocoder_tpu/ops/fused_mrf.py:112", "form": "bf16",
        "shape": "HiFiGAN light's 3 MRF stages of a 585-frame utterance in bf16, summed: "
                 + ", ".join(str(tuple(s["shape"])) for s in per_stage),
        "max_abs_err": worst, "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": bms, "bound_by": by, "library_ms": None, "stages": per_stage,
    }


def check_bf16_tail(torch, gen, frames: int):
    """Kernel 6's bf16 form against its plain version: HiFiGAN light's release
    tail at one utterance's shape, batch 2, T_in = 1 and lengths on both
    sides of its tiles; its time with a kept bf16 `TailTable`.  -> entry for
    the kernels line."""
    from fastvocoder_tpu_torch.ops.fused_tail import (
        TailTable,
        fused_hifigan_tail_bf16_cuda,
        fused_hifigan_tail_cuda,
        fused_hifigan_tail_plain,
    )

    dev = next(gen.parameters()).device
    light = gen.tail_operands()
    T_main = frames * int(np.prod(gen.cfg.upsample_rates[:-1]))
    cases = [(light, 1, T_main, 32), (light, 2, 35, 32), (light, 1, 1, 32)]
    cases += [(light, 1, t, 32) for t in tail_edge_lengths(16)]
    worst = bf16_cases(torch, "fused_tail_bf16", cases, fused_hifigan_tail_bf16_cuda,
                       fused_hifigan_tail_plain, lambda B, T: T > 1000)
    log(f"  fused_tail_bf16: {len(cases)} shapes agree, among them T_in = "
        f"{tail_edge_lengths(16)}")
    g = torch.Generator().manual_seed(83)
    x = (0.3 * torch.randn(1, T_main, 32, generator=g)).to(dev)
    against_f64(torch, "fused_tail", x, light, fused_hifigan_tail_bf16_cuda,
                fused_hifigan_tail_cuda, fused_hifigan_tail_plain)
    table = TailTable(*light, dev, torch.bfloat16)
    xb = x.to(torch.bfloat16)
    ms = cuda_ms(lambda: fused_hifigan_tail_bf16_cuda(xb, *light, table=table), iters=20, warmup=3)
    plain = cuda_ms(lambda: fused_hifigan_tail_plain(xb, *light), iters=20, warmup=3)
    parts = device_ms_by_name(torch, lambda: fused_hifigan_tail_bf16_cuda(xb, *light, table=table))
    k_up, b_up, stride, _, blocks, k_post, b_post = light
    T, C = stride * T_main, k_up.shape[2]
    mrf_bytes, mrf_flops = mrf_work(1, T, blocks)
    nbytes = (mrf_bytes - 4 * 2 * T * C) / 2 + 2 * (xb.numel() + T) + 4 * (
        k_up.numel() + b_up.numel() + k_post.numel() + b_post.numel())
    core_flops = (2 * T * (k_up.shape[0] // stride) * k_up.shape[1] * C
                  + 2 * T * k_post.shape[0] * C * k_post.shape[2])
    # the MRF on the tensor cores in bf16, the upsample and head on the CUDA cores
    bms = max(nbytes / PEAK_BYTES_PER_S,
              mrf_flops / PEAK_BF16_FLOP_PER_S + core_flops / PEAK_F32_FLOP_PER_S) * 1e3
    by = "bytes" if nbytes / PEAK_BYTES_PER_S * 1e3 >= bms else "operations"
    log(f"  fused_tail_bf16 (1, {T_main}, 32) -> (1, {T}, 1): kernel {ms:.4f} ms with a kept "
        f"table, plain {plain:.4f} ms; bound {bms:.4f} ms ({by}): {share(bms, ms)} of it")
    log("  fused_tail_bf16 by kernel: " + ", ".join(
        f"{re.findall(r'(\w+(?:<[^()]*>)?)\(', k)[0]} {v:.4f} ms"
        for k, v in sorted(parts.items(), key=lambda kv: -kv[1])))
    return {
        "name": "fused_tail_bf16", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/fused_tail.cu",
        "replaces": "fastvocoder_tpu/ops/fused_tail.py:80", "form": "bf16",
        "shape": f"x (1, {T_main}, 32) bf16 -> (1, {T}, 1), HiFiGAN light's last stage and head",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None,
    }


def bf16_gate(want) -> float:
    return max(2e-3, 0.01 * float(np.abs(want).max()))


def rms(d) -> float:
    return float(np.sqrt(np.mean(np.square(d, dtype=np.float64))))


def bf16_release_phase(torch, count_path, Synthesizer, model: str, ckpt: str, conf: str,
                       kernels, absent) -> None:
    """`Synthesizer(compute_dtype=bf16)` on the release weights and the
    seeded 585-frame mel on the card (NHV: its generator with the CPU's
    sources), beside the float32 Synthesizer on the card and both on the
    CPU: the bf16 path launches the bf16 forms and no float32 form, its
    waveform is finite, and its deviation from float32 is the bf16
    arithmetic's.  On these trained weights that deviation exceeds the JAX
    package's gate on every implementation (the JAX package's own,
    tests/test_torch_bf16_models.py), and its maximum moves by tens of
    percent between two faithful ones, so the card is held by the root mean
    square: its deviation from float32 at most twice the CPU's (6 dB of
    SNR; a fault of layout or rounding point shows at the signal's scale).
    The gate's maxima and the card's distance from the CPU's bf16 waveform
    (two faithful runs differ as independent roundings do) are printed."""
    log(f"[{model}: Synthesizer in bf16]")
    mel = conditioning(model, mel_like_bench(MEL_FRAMES, 0))
    outs = {}
    for where in ("cuda", "cpu"):
        for dtype in (torch.bfloat16, None):
            synth = Synthesizer(ckpt, conf, model, device=where, compute_dtype=dtype)
            if model == "nhv":
                with torch.inference_mode():
                    cond = torch.from_numpy(mel[None])
                    src = Synthesizer(ckpt, conf, model, device="cpu").generator.sources(
                        cond[..., 80])
                    fn = lambda: synth.generator(  # noqa: E731
                        cond.to(where), sources=tuple(s.to(where) for s in src))[0].cpu().numpy()
            else:
                fn = lambda: synth._run(mel)  # noqa: E731
            if where == "cuda" and dtype is not None:
                outs[(where, dtype)] = count_path(f"{model} Synthesizer in bf16", fn, kernels,
                                                  absent=absent)
                if not all(p.dtype == torch.float32 for p in synth.generator.parameters()):
                    raise AssertionError(f"{model}: a bf16 model's parameters left float32")
            else:
                outs[(where, dtype)] = fn()
    card, f32 = outs[("cuda", torch.bfloat16)], outs[("cuda", None)]
    cpu, cpu_f32 = outs[("cpu", torch.bfloat16)], outs[("cpu", None)]
    gate = bf16_gate(f32)
    dev_card, dev_cpu, card_cpu = (float(np.abs(d).max())
                                   for d in (card - f32, cpu - cpu_f32, card - cpu))
    r_card, r_cpu, r_cc = rms(card - f32), rms(cpu - cpu_f32), rms(card - cpu)
    log(f"  wav {f32.shape}, peak {np.abs(f32).max():.3f}, gate {gate:.3e}; max abs: card bf16 - "
        f"card float32 {dev_card:.3e}, CPU bf16 - CPU float32 {dev_cpu:.3e}, card bf16 - CPU "
        f"bf16 {card_cpu:.3e}; rms: {r_card:.3e}, {r_cpu:.3e}, {r_cc:.3e} (signal rms "
        f"{rms(f32):.3e}, SNR of the card's bf16 {20 * np.log10(rms(f32) / r_card):.1f} dB)")
    if not np.isfinite(card).all() or card.shape != f32.shape or r_card > 2 * r_cpu:
        raise AssertionError(f"{model} in bf16 on the card is not the bf16 arithmetic's: rms "
                             f"{r_card:.3e} from float32, against the CPU's {r_cpu:.3e}")


def bf16_random_init_phase(torch) -> None:
    """The JAX package's bf16 gate as its own test applies it
    (tests/test_quality_gate.py): every family at full width from a seeded
    init (Basis-MelGAN with a 0.02-scaled basis), 128 frames of the seeded
    mel; the card's bf16 waveform within max(2e-3, 1 % of the peak) of the
    card's float32 one and of the CPU's bf16 one."""
    from fastvocoder_tpu_torch.hparams import load_model_config
    from fastvocoder_tpu_torch.models.factory import build_generator

    log("[bf16 on random init: the JAX package's gate]")
    mel = mel_like_bench(128, 3)
    for model, conf in (("basis-melgan", CONF), ("hifigan", HIFI_CONF),
                        ("multiband-hifigan", MB_CONF), ("melgan", MELGAN_CONF), ("nhv", NHV_CONF)):
        cfg = load_model_config(model, conf)
        kw = {}
        if model == "basis-melgan":
            rng = np.random.default_rng(4)
            kw["basis_signal_weight"] = (0.02 * rng.standard_normal(
                (cfg.arch.L, cfg.arch.out_channels))).astype(np.float32)
        torch.manual_seed(0)
        state = build_generator(cfg, **kw).state_dict()
        x = torch.from_numpy(conditioning(model, mel)[None])
        outs = {}
        for where in ("cuda", "cpu"):
            for dtype in (torch.bfloat16, None):
                gen = build_generator(cfg, compute_dtype=dtype, **kw)
                gen.load_state_dict(state)
                gen.to(where).eval().requires_grad_(False)
                with torch.inference_mode():
                    if model == "nhv":
                        torch.manual_seed(1)
                        src = (torch.zeros(1, 128 * HOP), 0.3 * torch.randn(1, 128 * HOP))
                        y = gen(x.to(where), sources=tuple(s.to(where) for s in src))
                    else:
                        y = gen.inference(x.to(where))
                outs[(where, dtype)] = y.float().cpu().numpy()
        f32 = outs[("cuda", None)]
        gate = bf16_gate(f32)
        dev = float(np.abs(outs[("cuda", torch.bfloat16)] - f32).max())
        card_cpu = float(np.abs(outs[("cuda", torch.bfloat16)]
                                - outs[("cpu", torch.bfloat16)]).max())
        log(f"  {model}: peak {np.abs(f32).max():.3f}, gate {gate:.3e}: card bf16 - card float32 "
            f"{dev:.3e}, card bf16 - CPU bf16 {card_cpu:.3e}")
        if not np.isfinite(outs[("cuda", torch.bfloat16)]).all() or dev > gate or card_cpu > gate:
            raise AssertionError(f"{model} in bf16 on random init misses the gate")


def bf16_rtf(torch, model: str, ckpt: str, conf: str) -> float:
    """The RTF protocol of bin/test.py (`measure_rtf`) over its 4 utterances
    with the model in bf16 (the entry point has no bf16 flag, as the JAX
    package's has none)."""
    from fastvocoder_tpu_torch.bin.test import Synthesizer as RtfSynthesizer
    from fastvocoder_tpu_torch.bin.test import measure_rtf

    synth = RtfSynthesizer(ckpt, conf, model, bucket_frames=64, compute_dtype=torch.bfloat16)
    mels = [mel_like_bench(frames, 10 + i) for i, frames in enumerate((585, 585, 320, 700))]
    duration = sum(m.shape[0] for m in mels) * HOP / 24000
    return measure_rtf(synth, mels, duration)


def kernel_class(name: str) -> str:
    for key, label in (("resstack_bwd_bf16_", "fused_resstack_bwd_bf16 kernel: bf16 conversions"),
                       ("mrf_bwd_bf16_", "fused_mrf_bwd_bf16 kernel: bf16 conversions"),
                       ("resstack_bf16_kernel", "fused_resstack_bf16 kernel"),
                       ("basis_decode_bf16_kernel", "basis_decode_bf16 kernel"),
                       ("mrf_pair_bf16_kernel", "fused_mrf_bf16 kernel"),
                       ("mrf_mean_bf16_kernel", "fused_mrf_bf16 kernel"),
                       ("tail_upsample_bf16_kernel", "fused_tail_bf16 kernel: upsample"),
                       ("tail_pair_bf16_kernel", "fused_tail_bf16 kernel: MRF pairs (bf16 wgmma)"),
                       ("tail_head_bf16_kernel", "fused_tail_bf16 kernel: mean and head"),
                       ("resstack_bwd_", "fused_resstack_bwd kernel"),
                       ("resstack_kernel", "fused_resstack kernel"),
                       ("basis_decode_kernel", "basis_decode kernel (persistent, cp.async ring)"),
                       ("mrf_bwd_", "fused_mrf_bwd kernel"),
                       ("mrf_pair_kernel", "fused_mrf kernel"),
                       ("mrf_mean_kernel", "fused_mrf kernel"),
                       ("tail_upsample_kernel", "fused_tail kernel: upsample (CUDA cores)"),
                       ("tail_pair_kernel", "fused_tail kernel: MRF pairs (wgmma, 3xTF32)"),
                       ("tail_head_kernel", "fused_tail kernel: mean and head"),
                       ("pack_kernel", "weight packing of the tensor-core kernels (2-6)"),
                       ("fvt_bwd", "sums of the backward kernels (dW reduction, MRF branches)")):
        if key in name:
            return label
    low = name.lower()
    if "wgrad" in low:
        return "cuDNN wgrad"
    if "dgrad" in low:
        return "cuDNN dgrad (also the forward of a transposed conv)"
    if "fft" in low:
        return "FFT"
    if "adam" in low or "multi_tensor_apply" in low:
        return "optimiser"
    if any(k in low for k in ("conv", "cudnn", "xmma", "gemm", "implicit", "winograd", "cutlass")):
        return "cuDNN forward and other library products"
    return "elementwise, pads, copies"


def profile_device(torch, fn, n: int, unit: str) -> None:
    """Device time by kernel class over n calls of fn, and the device's idle
    share of the window, from torch.profiler's CUDA (CUPTI) events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    log(f"  {n} x {unit}: host wall {wall_ms / n:.4f} ms each")
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
    summed = sum(by_class.values())
    log(f"  device busy {busy / 1e3 / n:.4f} ms per {unit}, {len(kernels) / n:.1f} device "
        f"ops per {unit}; idle share of the device window {1 - busy / window:.4f}; device ops' "
        f"durations sum to {summed / 1e3 / n:.4f} ms (more than busy where ops overlap)")
    for k, v in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"  {k}: {v / 1e3 / n:.4f} ms per {unit} ({v / summed:.3f} of the summed durations)")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {v / 1e3 / n:.4f} ms  {k[:110]}")


def profile_inference(torch, synth, mel: np.ndarray, n: int = 10) -> None:
    for _ in range(3):
        synth.test_rtf(mel)
    torch.cuda.synchronize()
    profile_device(torch, lambda: synth.test_rtf(mel), n, f"inference of {mel.shape[0]} frames")


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


def conditioning(model: str, mel: np.ndarray) -> np.ndarray:
    """A model's input for `mel` (T, 80): NHV's adds f0 (NHV_F0_HZ) as
    channel 80."""
    from fastvocoder_tpu_torch.dsp.f0 import f0_to_condition

    if model != "nhv":
        return mel
    return f0_to_condition(mel, np.full(mel.shape[0], NHV_F0_HZ, np.float32))


def rtf_phase(count_path, run_test, model: str, ckpt: str, conf: str, kernels) -> float:
    """The RTF protocol of bin/test.py over 4 utterances; it writes
    pattern-subtracted wavs for Basis-MelGAN only.  NHV's utterances are
    `<name>.mel.npy` files with their `<name>.f0.npy`."""
    log(f"[{model}: RTF protocol (bin/test.py)]")
    with tempfile.TemporaryDirectory() as d:
        for i, frames in enumerate((585, 585, 320, 700)):
            mel = mel_like_bench(frames, 10 + i)
            if model == "nhv":
                np.save(os.path.join(d, f"utt{i}.mel.npy"), mel.T)
                np.save(os.path.join(d, f"utt{i}.f0.npy"), conditioning(model, mel)[:, 80])
            else:
                np.save(os.path.join(d, f"utt{i}.npy"), mel.T)
        rtf = count_path(f"{model} RTF", lambda: run_test([
            "--checkpoint_path", ckpt, "--file_path", d, "--config", conf, "--model_name", model,
        ]), kernels)
        wavs = sorted(f for f in os.listdir(d) if f.endswith(".wav"))
    log(f"  rtf {rtf!r} over 4 utterances ({len(wavs)} wavs written)")
    if not (np.isfinite(rtf) and rtf > 0 and len(wavs) == (4 if model == "basis-melgan" else 0)):
        raise AssertionError(f"{model} RTF protocol failed")
    return rtf


def serving_phase(count_path, run_serve, ServingModel, model: str, ckpt: str, conf: str,
                  kernels, bf16: bool = False, absent=()) -> None:
    """4 concurrent HTTP requests, twice, against a direct ServingModel call
    (with `bf16`, `--bf16 1` against a ServingModel in bf16, within the bf16
    gate: a bucket's batch may take other library algorithms)."""
    import torch

    log(f"[{model}: HTTP serving (bin/serve.py{' --bf16 1' if bf16 else ''})]")
    lengths = (60, 130, 300, 585)
    req_mels = [conditioning(model, mel_like_bench(n, 20 + i)) for i, n in enumerate(lengths)]
    results = [None] * len(req_mels)

    def serve_all():
        httpd, batcher = run_serve(
            ["--checkpoint_path", ckpt, "--config", conf, "--model_name", model, "--port", "0"]
            + (["--bf16", "1"] if bf16 else []),
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

    health = count_path(f"{model} HTTP serving", serve_all, kernels, absent=absent)
    log(f"  healthz {health}")
    direct = ServingModel(ckpt, conf, model,
                          compute_dtype=torch.bfloat16 if bf16 else None)(req_mels)
    for i, n in enumerate(lengths):
        if results[i] is None:
            raise AssertionError(f"request {i} got no answer")
        status, wav = results[i]
        err = float(np.abs(wav - direct[i]).max())
        tol = bf16_gate(direct[i]) if bf16 else MODEL_TOL * max(1.0, float(np.abs(direct[i]).max()))
        log(f"  request T={n}: status {status}, wav {wav.shape}, vs ServingModel max abs {err:.3e} (tol {tol:.3e})")
        if status != 200 or wav.shape != (n * HOP,) or not np.isfinite(wav).all() or err > tol:
            raise AssertionError(f"served request {i} is wrong")


def nhv_phase(torch, count_path, Synthesizer):
    """NHV on its release weights and the seeded 585-frame mel with a
    NHV_F0_HZ f0 channel: the generator on the card against the CPU with
    the same sources (the CPU's impulse train and noise), the card's own
    impulse train against the CPU's (the same samples, or the phase sums
    disagree), then `Synthesizer` with `f0=` on the card.  -> (the card's
    Synthesizer, the conditioning (T, 81))."""
    log("[nhv: the card against the CPU with the same sources]")
    synth = Synthesizer(NHV_CKPT, NHV_CONF, "nhv")
    cpu = Synthesizer(NHV_CKPT, NHV_CONF, "nhv", device="cpu")
    mel = mel_like_bench(MEL_FRAMES, 0)
    cond = torch.from_numpy(conditioning("nhv", mel)[None])
    with torch.inference_mode():
        harmonic, noise = cpu.generator.sources(cond[..., 80])
        want = cpu.generator(cond, sources=(harmonic, noise))
        got = count_path("nhv generator", lambda: synth.generator(
            cond.cuda(), sources=(harmonic.cuda(), noise.cuda())), ()).cpu()
        card_train = synth.generator.sources(cond[..., 80].cuda())[0].cpu()
    err = (got - want).abs().max().item()
    tol = MODEL_TOL * max(1.0, want.abs().max().item())
    moved = int((card_train != harmonic).sum().item())
    log(f"  waveform {tuple(got.shape)}, peak {want.abs().max().item():.3f}, card vs CPU max abs "
        f"{err:.3e} (tol {tol:.3e}); impulse trains: {int(harmonic.sum().item())} impulses on the "
        f"CPU, {int(card_train.sum().item())} on the card, {moved} samples differ")
    if got.shape != (1, MEL_FRAMES * HOP) or not torch.isfinite(got).all() or err > tol:
        raise AssertionError("nhv on the card disagrees with the CPU")
    if moved:
        raise AssertionError("nhv's impulse train on the card is not the CPU's")

    log("[nhv: Synthesizer with f0]")
    f0 = np.full(MEL_FRAMES, NHV_F0_HZ, np.float32)
    t0 = time.perf_counter()
    est, est_remove, bias = count_path("nhv Synthesizer", lambda: synth.synthesize(mel, f0=f0), ())
    log(f"  synthesize (585 frames, bias + utterance): {time.perf_counter() - t0:.3f} s "
        f"(first call), wav {est.shape}, peak {np.abs(est).max():.3f}, bias peak "
        f"{np.abs(bias).max():.3f}")
    if (est.shape != (MEL_FRAMES * HOP,) or not np.isfinite(est).all()
            or not np.array_equal(est - bias, est_remove)):
        raise AssertionError("nhv Synthesizer failed")
    return synth, cond[0].numpy()


def profile_melgan(torch, synth, mel: np.ndarray, stages) -> None:
    """A profile of MelGAN's batch-1 inference, then kernel 2's device time
    in one inference at each width (its three launches a stage) beside the
    stage's bounds (`check_melgan_chain`'s `stages`, which it fills in)."""
    profile_inference(torch, synth, mel)
    by_name = device_ms_by_name(torch, lambda: synth.test_rtf(mel), 10)
    per_width = {}
    for name, ms in by_name.items():
        m = re.search(r"resstack_kernel<(\d+)", name)
        if m:
            per_width[int(m.group(1))] = per_width.get(int(m.group(1)), 0.0) + ms
    if not per_width:
        log("  torch.profiler shows no device time of kernel 2: not measured")
    for st in stages:
        C = st["shape"][2]
        if C in per_width:
            st["in_inference_ms"] = per_width[C]
            log(f"  kernel 2 at C = {C} in one inference ({tuple(st['shape'])}, 3 launches): "
                f"{per_width[C]:.4f} ms device, float32 bound {st['bound_ms']:.4f} ms, 3xTF32 "
                f"bound {st['bound_3xtf32_ms']:.4f} ms: {share(st['bound_3xtf32_ms'], per_width[C])}"
                " of it")


def write_corpus(root: str, n: int = 64, seed: int = 0, weight_channels: int = 0):
    """A seeded corpus in the format `data/dataset.py` reads: per utterance
    `<i>.wav.npy` (sines plus noise, 160-220 frames of 240 samples),
    `<i>.mel.npy` (80, T) and `<i>.f0.npy` (the port's `extract_f0` of the
    wav), two index files, and with `weight_channels` a `weight/<i>.wav.npy`
    (C, 16 T) target each.  -> (audio index, mel index)."""
    from fastvocoder_tpu_torch.dsp.f0 import extract_f0

    rng = np.random.default_rng(seed)
    audio, mel = [], []
    if weight_channels:
        os.makedirs(os.path.join(root, "weight"), exist_ok=True)
    for i in range(n):
        frames = int(rng.integers(160, 221))
        t = np.arange(frames * HOP, dtype=np.float32) / 24000.0
        wav = sum(a * np.sin(2 * np.pi * f * t + p) for a, f, p in zip(
            rng.uniform(0.05, 0.2, 3), rng.uniform(100, 3000, 3), rng.uniform(0, 6.28, 3)))
        wav = (wav + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)
        audio.append(os.path.join(root, f"{i}.wav.npy"))
        mel.append(os.path.join(root, f"{i}.mel.npy"))
        np.save(audio[-1], wav)
        np.save(mel[-1], rng.random((80, frames), dtype=np.float32))
        np.save(os.path.join(root, f"{i}.f0.npy"), extract_f0(wav))
        if weight_channels:
            np.save(os.path.join(root, "weight", f"{i}.wav.npy"),
                    rng.random((weight_channels, frames * 16), dtype=np.float32))
    paths = []
    for name, lines in (("audio_index.txt", audio), ("mel_index.txt", mel)):
        paths.append(os.path.join(root, name))
        with open(paths[-1], "w") as f:
            f.write("\n".join(lines) + "\n")
    return tuple(paths)


def train_phase(torch, count_path, model: str, conf: str, corpus: str, index, steps: int,
                start_steps: int, kernels, basis_dir: str = "", use_mpd: bool = False,
                mixprecision: bool = False, absent=()):
    """`run_train` as a user calls it, at full width on the card (with
    `use_mpd`, `--use_mpd 1`; with `mixprecision`, `--mixprecision 1`,
    launching none of `absent`); checks the losses, that the weights moved,
    and that the checkpoint loads back (a bf16 run's also in `Synthesizer`
    in bf16)."""
    import dataclasses

    from fastvocoder_tpu_torch.bin.train import run_train
    from fastvocoder_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
    from fastvocoder_tpu_torch.train.trainer import make_trainer
    from fastvocoder_tpu_torch.hparams import load_model_config

    kind = "bf16 mixed-precision training (bin/train.py --mixprecision 1)" if mixprecision \
        else "training (bin/train.py)"
    log(f"[{model}: {kind}, {steps} steps of {TRAIN_BATCH} x {TRAIN_FRAMES} frames]")
    run_dir = os.path.join(corpus, f"run_{model}" + ("_bf16" if mixprecision else ""))
    argv = ["--audio_index_path", index[0], "--mel_index_path", index[1],
            "--audio_index_valid_path", index[0], "--mel_index_valid_path", index[1],
            "--model_name", model, "--config", conf, "--run_dir", run_dir, "--seed", "0",
            "--batch_size", str(TRAIN_BATCH), "--batch_expand_size", "1",
            "--fixed_length", str(TRAIN_FRAMES), "--max_steps", str(steps),
            "--save_step", str(steps), "--valid_step", str(steps), "--valid_num", "3",
            "--discriminator_train_start_steps", str(start_steps)]
    if basis_dir:
        argv += ["--basis_dataset_path", basis_dir]
    if use_mpd:
        argv += ["--use_mpd", "1"]
    if mixprecision:
        argv += ["--mixprecision", "1"]
    t0 = time.perf_counter()
    state = count_path(f"{model} {kind}", lambda: run_train(argv), kernels, absent)
    log(f"  {steps} steps, a validation pass and a checkpoint in {time.perf_counter() - t0:.2f} s")
    for step, metrics in state.history:
        log(f"  step {step}: " + " ".join(f"{k}={v:.5f}" for k, v in sorted(metrics.items())))
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{model} training: a loss of step {step} is not finite")
    if [s_ for s_, _ in state.history] != list(range(1, steps + 1)):
        raise AssertionError(f"{model} training logged steps {[s_ for s_, _ in state.history]}")
    gan = [m for s_, m in state.history if s_ > start_steps]
    if any("discriminator_loss" not in m for m in gan) or any(
            "discriminator_loss" in m for s_, m in state.history if s_ <= start_steps):
        raise AssertionError(f"{model} training: the steps' kinds do not follow the boundary")

    if (state.discriminator.mpd is not None) != use_mpd:
        raise AssertionError(f"{model} training: the discriminator's MPD is not as asked")
    cfg = dataclasses.replace(load_model_config(model, conf), use_mpd=use_mpd)
    basis = state.generator.basis_signal.basis.detach().cpu().numpy() if basis_dir else None
    trainer = make_trainer(cfg, basis_signal_weight=basis)
    fresh = trainer.init_state(0)  # the run's own initial weights (seed 0)

    def moved(a, b):
        return max((v - w).abs().max().item()
                   for (k, v), w in zip(a.state_dict().items(), b.state_dict().values())
                   if not k.startswith("basis_signal."))

    g_moved = moved(state.generator, fresh.generator)
    d_moved = moved(state.discriminator, fresh.discriminator)
    log(f"  weights moved: generator by up to {g_moved:.3e}, discriminator by up to {d_moved:.3e}")
    if not g_moved > 0 or (bool(gan) and not d_moved > 0):
        raise AssertionError(f"{model} training did not move the weights")
    ckpt = latest_checkpoint(run_dir)
    if ckpt is None or not ckpt.endswith(f"checkpoint_{steps}.pth.tar"):
        raise AssertionError(f"{model} training left no checkpoint of step {steps}: {ckpt}")
    load_checkpoint(ckpt, fresh, model)
    back = max(moved(state.generator, fresh.generator),
               moved(state.discriminator, fresh.discriminator))
    log(f"  {os.path.basename(ckpt)} loads back: step {fresh.step}, max difference {back:.1e}")
    if fresh.step != steps or back != 0.0:
        raise AssertionError(f"{model}: the checkpoint does not hold the trained state")
    if mixprecision:
        from fastvocoder_tpu_torch.bin.synthesize import Synthesizer

        wav = Synthesizer(ckpt, conf, model, compute_dtype=torch.bfloat16)._run(
            mel_like_bench(100, 3))
        log(f"  the checkpoint synthesizes in bf16: {wav.shape[0]} samples, peak "
            f"{np.abs(wav).max():.3e}")
        if wav.dtype != np.float32 or not np.all(np.isfinite(wav)):
            raise AssertionError(f"{model}: the bf16 run's checkpoint does not synthesize")
    return cfg, basis


def fixed_batch(cfg, index, basis_dir: str = ""):
    """One seeded training batch of the corpus, as numpy."""
    from fastvocoder_tpu_torch.data import dataset as d
    from fastvocoder_tpu_torch.hparams import HP

    hp = HP.replace(batch_size=TRAIN_BATCH, batch_expand_size=1, fixed_length=TRAIN_FRAMES)
    if basis_dir:
        ds = d.WeightDataset.from_index_files(index[0], index[1], cfg.arch.L,
                                              os.path.join(basis_dir, "weight"), hp=hp)
        return next(d.batch_iterator(ds, hp, seed=1, L=cfg.arch.L))
    ds = d.BufferDataset(d.load_data_to_buffer(index[0], index[1], log=lambda m: None,
                                               with_f0=cfg.model_name == "nhv"), hp)
    return next(d.batch_iterator(ds, hp, seed=1))


def step_against_cpu(torch, cfg, basis, step: str, batch) -> None:
    """One step from the same initial weights on the same batch, on the card
    (through the kernels) and on the CPU (through the plain versions)."""
    from fastvocoder_tpu_torch.train.trainer import make_trainer

    log(f"[{cfg.model_name}: one {step} on the card against the CPU plain path]")
    out = {}
    for dev in ("cuda", "cpu"):
        trainer = make_trainer(cfg, basis_signal_weight=basis, device=dev, keep_grads=True)
        state = trainer.init_state(0)
        args = [torch.from_numpy(batch[k]).to(dev) if k in batch else None
                for k in ("mel", "wav", "weight")]
        t0 = time.perf_counter()
        _, metrics = getattr(trainer, step)(state, *args)
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {who: {n: g_.cpu() for n, g_ in grads.items()}
                     for who, grads in trainer.last_grads.items()})
        log(f"  on {dev}: {time.perf_counter() - t0:.2f} s")
    (m_gpu, g_gpu), (m_cpu, g_cpu) = out["cuda"], out["cpu"]
    for k, want in m_cpu.items():
        # relative to the CPU's value, or to 1e-2 where that is smaller
        # (`weight_average_value` is a mean that cancels to about 1e-6)
        rel = abs(m_gpu[k] - want) / max(abs(want), 1e-2)
        log(f"  {k}: card {m_gpu[k]:.6f}, CPU {want:.6f} (relative {rel:.2e}, tol {STEP_LOSS_RTOL:.0e})")
        if not (np.isfinite(m_gpu[k]) and rel <= STEP_LOSS_RTOL):
            raise AssertionError(f"{cfg.model_name} {step}: {k} disagrees with the CPU")
    for who, want in g_cpu.items():
        worst, worst_name = 0.0, ""
        for name, w in want.items():
            peak = w.abs().max().item()
            sibling = name.rsplit(".", 1)[0] + ".weight"
            if sibling in want:
                peak = max(peak, want[sibling].abs().max().item())
            rel = (g_gpu[who][name] - w).abs().max().item() / max(peak, 1e-30)
            if rel > worst:
                worst, worst_name = rel, name
        log(f"  {who} gradients ({len(want)} tensors): worst {worst:.2e} of its peak "
            f"({worst_name}), tol {STEP_GRAD_TOL:.0e}")
        if not worst <= STEP_GRAD_TOL:
            raise AssertionError(f"{cfg.model_name} {step}: {who} gradients disagree with the CPU")


def rel_rms(got: dict, want: dict) -> float:
    """|got - want| / |want| over every tensor of both (by name)."""
    num = sum(float((got[k].double() - want[k].double()).pow(2).sum()) for k in want)
    return float(np.sqrt(num / sum(float(want[k].double().pow(2).sum()) for k in want)))


def release_generator_state(path: str) -> dict:
    """A release checkpoint's generator in its weight-norm form, the state
    dict of a trainer's generator."""
    from fastvocoder_tpu_torch.checkpoint import state_dict_from_jax

    with np.load(path, allow_pickle=False) as z:
        flat = {k[len("param:"):]: z[k] for k in z.files if k.startswith("param:")}
    return state_dict_from_jax(flat, fuse=False)


def bf16_step_against_float32(torch, cfg, basis, step: str, batch, release: str = "") -> None:
    """One bf16 step against the float32 step from the same initial weights
    on the same BF16_CPU_BATCH crops, on the card and on the CPU: the
    card's gradients may deviate from its float32 step's by at most
    BF16_STEP_RATIO times the CPU's (the CPU runs the module paths in bf16,
    the card the kernels' bf16 forms: another arithmetic, so the two bf16
    steps are not held to each other).  The generator starts from seed 0's
    init or, given `release`, from that release checkpoint's weights (where
    a random init's bf16 gradient is rounding noise on every
    implementation, as Basis-MelGAN's is: tests/test_torch_bf16_train.py)."""
    from fastvocoder_tpu_torch.train.trainer import make_trainer

    start = release_generator_state(release) if release else None
    log(f"[{cfg.model_name}: one {step} in bf16 against float32, on the card and on the CPU, "
        f"{BF16_CPU_BATCH} crops, from {os.path.basename(release) if release else 'seed 0'}]")
    out = {}
    for dev in ("cuda", "cpu"):
        for dt in (None, torch.bfloat16):
            trainer = make_trainer(cfg, basis_signal_weight=basis, device=dev, keep_grads=True,
                                   compute_dtype=dt)
            state = trainer.init_state(0)
            if start is not None:
                state.generator.load_state_dict(start)
            args = [torch.from_numpy(batch[k][:BF16_CPU_BATCH]).to(dev) if k in batch else None
                    for k in ("mel", "wav", "weight")]
            t0 = time.perf_counter()
            _, metrics = getattr(trainer, step)(state, *args)
            out[(dev, dt)] = ({k: float(v) for k, v in metrics.items()},
                              {who: {n: g_.cpu() for n, g_ in grads.items()}
                               for who, grads in trainer.last_grads.items()})
            log(f"  {dev} {'bf16' if dt else 'float32'}: {time.perf_counter() - t0:.2f} s, "
                + " ".join(f"{k}={v:.5f}" for k, v in sorted(out[(dev, dt)][0].items())))
            if not all(np.isfinite(v) for v in out[(dev, dt)][0].values()):
                raise AssertionError(f"{cfg.model_name} {step}: a loss is not finite")
    bf = torch.bfloat16
    for who in out[("cuda", bf)][1]:
        card = rel_rms(out[("cuda", bf)][1][who], out[("cuda", None)][1][who])
        cpu = rel_rms(out[("cpu", bf)][1][who], out[("cpu", None)][1][who])
        log(f"  {who} gradients, relative RMS deviation of bf16 from float32: card {card:.3e}, "
            f"CPU {cpu:.3e} (card at most {BF16_STEP_RATIO} x the CPU's)")
        if not card <= BF16_STEP_RATIO * cpu:
            raise AssertionError(f"{cfg.model_name} {step}: the card's bf16 {who} gradients "
                                 f"deviate more than the rule allows")


def time_steps(torch, cfg, basis, step: str, batch, n: int = 5, profile: bool = False,
               compute_dtype=None) -> float:
    """Median ms of steps 2..n of `step` on the card on one batch, each
    window closed by torch.cuda.synchronize(), in `compute_dtype` (bf16:
    mixed precision); with `profile`, one more step under torch.profiler."""
    from fastvocoder_tpu_torch.train.trainer import make_trainer

    trainer = make_trainer(cfg, basis_signal_weight=basis, compute_dtype=compute_dtype)
    state = trainer.init_state(0)
    args = [torch.from_numpy(batch[k]).cuda() if k in batch else None
            for k in ("mel", "wav", "weight")]
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        getattr(trainer, step)(state, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times[1:]))
    kind = " in bf16" if compute_dtype else ""
    log(f"  {cfg.model_name} {step}{kind}: {ms:.2f} ms a step (median of steps 2..{n}: "
        f"{', '.join(f'{t:.1f}' for t in times[1:])}; first {times[0]:.1f}), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        log(f"[profile: one {cfg.model_name} {step}{kind} on the device]")
        profile_device(torch, lambda: getattr(trainer, step)(state, *args), 1, step)
    return ms


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
    melgan_gen = Synthesizer(MELGAN_CKPT, MELGAN_CONF, "melgan").generator
    F_main = MEL_FRAMES * 16
    with torch.inference_mode():
        entries = [check_basis_decode(torch, F_main, basis_gen.basis_signal.basis),
                   check_fused_resstack(torch, basis_gen, F_main),
                   check_fused_mrf(torch, hifi_gen, MEL_FRAMES),
                   check_fused_tail(torch, hifi_gen, MEL_FRAMES)]
        log("[kernel 2 at MelGAN original's stages]")
        entries[1]["melgan_stages"] = check_melgan_chain(torch, melgan_gen, MEL_FRAMES)
    log("[backward kernels against their plain VJPs]")
    chain_bwd, entries[1]["batch32"] = check_fused_resstack_bwd(torch, basis_gen)
    mrf_bwd, entries[2]["batch32"] = check_fused_mrf_bwd(torch, hifi_gen)
    log("[kernel 3 at MelGAN original's training stages]")
    chain_bwd["melgan"], entries[1]["melgan_batch32"] = check_melgan_chain_bwd(torch, melgan_gen)
    entries[2:2] = [chain_bwd]   # kernels 1, 2, 3, 4, 5, 6
    entries[4:4] = [mrf_bwd]
    log("[bf16 forms against their plain versions]")
    with torch.inference_mode():
        entries += [check_bf16_decode(torch, F_main, basis_gen.basis_signal.basis),
                    check_bf16_chain(torch, basis_gen, melgan_gen, F_main),
                    check_bf16_mrf(torch, hifi_gen, MEL_FRAMES),
                    check_bf16_tail(torch, hifi_gen, MEL_FRAMES)]
    log("[bf16 forms of the backward kernels against their plain versions]")
    entries += [check_bf16_chain_bwd(torch, basis_gen, melgan_gen),
                check_bf16_mrf_bwd(torch, hifi_gen)]
    log("[the MRF kernels' 3xTF32 against float64]")
    mrf_errors_against_f64(torch, torch.device("cuda"))
    log("[the chain kernels' 3xTF32 against float64]")
    chain_errors_against_f64(torch, torch.device("cuda"))
    del melgan_gen
    torch.cuda.empty_cache()
    launches = {e["name"]: 0 for e in entries}

    def count_path(name, fn, kernels, absent=()):
        """Run one path with every count zeroed; fail if it launched none
        of `kernels`, or any of `absent`."""
        _build.launch_counts.clear()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: _build.launch_counts[k] for k in launches}
        log(f"  launches on the {name} path: {counts}")
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"{name} path never launched {missing}")
        stray = [k for k in absent if counts[k] != 0]
        if stray:
            raise AssertionError(f"{name} path launched {stray}")
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

    chain = ("fused_resstack",)
    melgan_synth, _ = synthesizer_phase(torch, count_path, Synthesizer, "melgan", MELGAN_CKPT,
                                        MELGAN_CONF, chain, wav_len)
    rtfs["melgan"] = rtf_phase(count_path, run_test, "melgan", MELGAN_CKPT, MELGAN_CONF, chain)
    serving_phase(count_path, run_serve, ServingModel, "melgan", MELGAN_CKPT, MELGAN_CONF, chain)
    log("[profile: melgan batch-1 inference on the device]")
    profile_melgan(torch, melgan_synth, mel, entries[1]["melgan_stages"])
    del melgan_synth

    nhv_synth, nhv_cond = nhv_phase(torch, count_path, Synthesizer)
    log("[profile: nhv batch-1 inference on the device]")
    profile_inference(torch, nhv_synth, nhv_cond)
    del nhv_synth
    rtfs["nhv"] = rtf_phase(count_path, run_test, "nhv", NHV_CKPT, NHV_CONF, ())
    serving_phase(count_path, run_serve, ServingModel, "nhv", NHV_CKPT, NHV_CONF, ())
    log(f"  rtf by model: {rtfs}")

    # bf16 serving: every family through Synthesizer, the RTF protocol and
    # --bf16 serving for three, the JAX package's gate on random init
    f32_forms = ("basis_decode", "fused_resstack", "fused_mrf", "fused_tail")
    bf16_paths = (("basis-melgan", CKPT, CONF, ("basis_decode_bf16", "fused_resstack_bf16")),
                  ("hifigan", HIFI_CKPT, HIFI_CONF, ("fused_mrf_bf16", "fused_tail_bf16")),
                  ("multiband-hifigan", MB_CKPT, MB_CONF, ("fused_mrf_bf16",)),
                  ("melgan", MELGAN_CKPT, MELGAN_CONF, ("fused_resstack_bf16",)),
                  ("nhv", NHV_CKPT, NHV_CONF, ()))
    for model, ckpt, conf, kernels in bf16_paths:
        bf16_release_phase(torch, count_path, Synthesizer, model, ckpt, conf, kernels, f32_forms)
    for model, ckpt, conf, kernels in bf16_paths:
        if model in ("basis-melgan", "hifigan", "melgan"):
            log(f"[{model}: RTF protocol in bf16]")
            rtfs[model + " bf16"] = count_path(f"{model} RTF in bf16",
                                               lambda: bf16_rtf(torch, model, ckpt, conf),
                                               kernels, absent=f32_forms)
            log(f"  rtf {rtfs[model + ' bf16']!r} in bf16, {rtfs[model]!r} in float32 (this call)")
    serving_phase(count_path, run_serve, ServingModel, "basis-melgan", CKPT, CONF,
                  bf16_paths[0][3], bf16=True, absent=f32_forms)
    bf16_random_init_phase(torch)
    for model, ckpt, conf, _ in bf16_paths[:2]:
        log(f"[profile: {model} batch-1 inference in bf16 on the device]")
        profile_inference(torch, Synthesizer(ckpt, conf, model, compute_dtype=torch.bfloat16),
                          mel)
    log(f"  rtf by model: {rtfs}")

    torch.cuda.empty_cache()
    step_ms = {}
    with tempfile.TemporaryDirectory() as corpus:
        t0 = time.perf_counter()
        index = write_corpus(corpus, weight_channels=256)
        np.save(os.path.join(corpus, "basis_signal_weight.npy"),
                np.load(os.path.join(ROOT, "dataset", "clean_basis", "basis_signal_weight.npy")))
        log(f"[corpus: 64 seeded utterances of 160-220 frames written in "
            f"{time.perf_counter() - t0:.2f} s]")
        hifi_cfg, _ = train_phase(torch, count_path, "hifigan", HIFI_CONF, corpus, index, steps=6,
                                  start_steps=2, kernels=("fused_mrf", "fused_mrf_bwd"))
        # 2 + 2 * 4 generator passes of 4 MRF stages (the validation's come
        # on top), one backward of each stage a step
        if launches["fused_mrf_bwd"] != 4 * 6:
            raise AssertionError(f"6 HiFiGAN steps launched fused_mrf_bwd "
                                 f"{launches['fused_mrf_bwd']} times, want 24")
        batch = fixed_batch(hifi_cfg, index)
        step_against_cpu(torch, hifi_cfg, None, "gan_step", batch)
        log("[ms a step on the card]")
        step_ms["hifigan gan_step"] = time_steps(torch, hifi_cfg, None, "gan_step", batch,
                                                 profile=True)
        step_ms["hifigan pre_adv_step"] = time_steps(torch, hifi_cfg, None, "pre_adv_step", batch)
        torch.cuda.empty_cache()

        seen = dict(launches)
        basis_cfg, basis = train_phase(
            torch, count_path, "basis-melgan", CONF, corpus, index, steps=4, start_steps=4,
            kernels=("fused_resstack", "fused_resstack_bwd", "basis_decode"), basis_dir=corpus)
        # the trunk runs twice a step (the mel and the zero mel), 2 stages each
        if launches["fused_resstack_bwd"] - seen["fused_resstack_bwd"] != 4 * 4:
            raise AssertionError("4 Basis-MelGAN steps did not launch fused_resstack_bwd 16 times")
        batch = fixed_batch(basis_cfg, index, basis_dir=corpus)
        step_against_cpu(torch, basis_cfg, basis, "pre_adv_step", batch)
        log("[ms a step on the card]")
        step_ms["basis-melgan pre_adv_step"] = time_steps(torch, basis_cfg, basis, "pre_adv_step",
                                                          batch, profile=True)
        torch.cuda.empty_cache()

        seen = dict(launches)
        melgan_cfg, _ = train_phase(
            torch, count_path, "melgan", MELGAN_CONF, corpus, index, steps=4, start_steps=2,
            kernels=("fused_resstack", "fused_resstack_bwd"), use_mpd=True)
        # one generator backward a step, 4 stages each
        if launches["fused_resstack_bwd"] - seen["fused_resstack_bwd"] != 4 * 4:
            raise AssertionError("4 MelGAN steps did not launch fused_resstack_bwd 16 times")
        batch = fixed_batch(melgan_cfg, index)
        step_against_cpu(torch, melgan_cfg, None, "gan_step",
                         {k: v[:MELGAN_CPU_BATCH] for k, v in batch.items()})
        log("[ms a step on the card]")
        step_ms["melgan pre_adv_step"] = time_steps(torch, melgan_cfg, None, "pre_adv_step", batch)
        step_ms["melgan gan_step (MSD + MFD + MPD)"] = time_steps(torch, melgan_cfg, None,
                                                                  "gan_step", batch, profile=True)
        torch.cuda.empty_cache()

        nhv_cfg, _ = train_phase(torch, count_path, "nhv", NHV_CONF, corpus, index, steps=2,
                                 start_steps=2, kernels=())
        log("[ms a step on the card]")
        step_ms["nhv pre_adv_step"] = time_steps(torch, nhv_cfg, None, "pre_adv_step",
                                                 fixed_batch(nhv_cfg, index))
        torch.cuda.empty_cache()

        # bf16 mixed-precision training (--mixprecision 1): the bf16 forms,
        # forward and backward, and no float32 form of any kernel
        bf16 = torch.bfloat16
        f32_kernels = ("basis_decode", "fused_resstack", "fused_resstack_bwd", "fused_mrf",
                       "fused_mrf_bwd")
        seen = dict(launches)
        train_phase(torch, count_path, "hifigan", HIFI_CONF, corpus, index, steps=6,
                    start_steps=2, kernels=("fused_mrf_bf16", "fused_mrf_bwd_bf16"),
                    mixprecision=True, absent=f32_kernels)
        if launches["fused_mrf_bwd_bf16"] - seen["fused_mrf_bwd_bf16"] != 4 * 6:
            raise AssertionError("6 bf16 HiFiGAN steps did not launch fused_mrf_bwd_bf16 24 times")
        batch = fixed_batch(hifi_cfg, index)
        bf16_step_against_float32(torch, hifi_cfg, None, "gan_step", batch)
        log("[ms a step on the card, bf16 beside float32 in this call]")
        step_ms["hifigan gan_step bf16"] = time_steps(torch, hifi_cfg, None, "gan_step", batch,
                                                      profile=True, compute_dtype=bf16)
        step_ms["hifigan pre_adv_step bf16"] = time_steps(torch, hifi_cfg, None, "pre_adv_step",
                                                          batch, profile=True, compute_dtype=bf16)
        torch.cuda.empty_cache()

        seen = dict(launches)
        train_phase(torch, count_path, "basis-melgan", CONF, corpus, index, steps=4, start_steps=4,
                    kernels=("fused_resstack_bf16", "fused_resstack_bwd_bf16",
                             "basis_decode_bf16"),
                    basis_dir=corpus, mixprecision=True, absent=f32_kernels)
        if launches["fused_resstack_bwd_bf16"] - seen["fused_resstack_bwd_bf16"] != 4 * 4:
            raise AssertionError("4 bf16 Basis-MelGAN steps did not launch fused_resstack_bwd_bf16 "
                                 "16 times")
        batch = fixed_batch(basis_cfg, index, basis_dir=corpus)
        bf16_step_against_float32(torch, basis_cfg, basis, "pre_adv_step", batch, release=CKPT)
        log("[ms a step on the card, bf16 beside float32 in this call]")
        step_ms["basis-melgan pre_adv_step bf16"] = time_steps(
            torch, basis_cfg, basis, "pre_adv_step", batch, compute_dtype=bf16)
        torch.cuda.empty_cache()

        seen = dict(launches)
        train_phase(torch, count_path, "melgan", MELGAN_CONF, corpus, index, steps=3,
                    start_steps=1, kernels=("fused_resstack_bf16", "fused_resstack_bwd_bf16"),
                    use_mpd=True, mixprecision=True, absent=f32_kernels)
        if launches["fused_resstack_bwd_bf16"] - seen["fused_resstack_bwd_bf16"] != 4 * 3:
            raise AssertionError("3 bf16 MelGAN steps did not launch fused_resstack_bwd_bf16 "
                                 "12 times")
        batch = fixed_batch(melgan_cfg, index)
        bf16_step_against_float32(torch, melgan_cfg, None, "gan_step", batch)
        log("[ms a step on the card, bf16 beside float32 in this call]")
        step_ms["melgan gan_step (MSD + MFD + MPD) bf16"] = time_steps(
            torch, melgan_cfg, None, "gan_step", batch, compute_dtype=bf16)
    log(f"  ms a step: {step_ms}")

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
