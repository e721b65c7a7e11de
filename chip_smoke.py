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
    fused_mrf).

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
  * ms a step of the three step kinds, and a profile of one HiFiGAN GAN
    step and of one Basis-MelGAN pre-adversarial step.

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
MEL_FRAMES = 585  # the RTF protocol's utterance (bench.py's eval set)
HOP = 240

# H100 SXM published peaks at the full 700 W (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12  # float32 on the CUDA cores, no tensor cores
PEAK_TF32_FLOP_PER_S = 495e12  # dense TF32 on the tensor cores

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


def kernel_class(name: str) -> str:
    for key, label in (("resstack_bwd_", "fused_resstack_bwd kernel"),
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


def write_corpus(root: str, n: int = 64, seed: int = 0, weight_channels: int = 0):
    """A seeded corpus in the format `data/dataset.py` reads: per utterance
    `<i>.wav.npy` (sines plus noise, 160-220 frames of 240 samples) and
    `<i>.mel.npy` (80, T), two index files, and with `weight_channels` a
    `weight/<i>.wav.npy` (C, 16 T) target each.  -> (audio index, mel index)."""
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
                start_steps: int, kernels, basis_dir: str = ""):
    """`run_train` as a user calls it, at full width on the card; checks the
    losses, that the weights moved, and that the checkpoint loads back."""
    from fastvocoder_tpu_torch.bin.train import run_train
    from fastvocoder_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
    from fastvocoder_tpu_torch.train.trainer import make_trainer
    from fastvocoder_tpu_torch.hparams import load_model_config

    log(f"[{model}: training (bin/train.py), {steps} steps of {TRAIN_BATCH} x {TRAIN_FRAMES} frames]")
    run_dir = os.path.join(corpus, f"run_{model}")
    argv = ["--audio_index_path", index[0], "--mel_index_path", index[1],
            "--audio_index_valid_path", index[0], "--mel_index_valid_path", index[1],
            "--model_name", model, "--config", conf, "--run_dir", run_dir, "--seed", "0",
            "--batch_size", str(TRAIN_BATCH), "--batch_expand_size", "1",
            "--fixed_length", str(TRAIN_FRAMES), "--max_steps", str(steps),
            "--save_step", str(steps), "--valid_step", str(steps), "--valid_num", "3",
            "--discriminator_train_start_steps", str(start_steps)]
    if basis_dir:
        argv += ["--basis_dataset_path", basis_dir]
    t0 = time.perf_counter()
    state = count_path(f"{model} training", lambda: run_train(argv), kernels)
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

    cfg = load_model_config(model, conf)
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
    ds = d.BufferDataset(d.load_data_to_buffer(index[0], index[1], log=lambda m: None), hp)
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


def time_steps(torch, cfg, basis, step: str, batch, n: int = 5, profile: bool = False) -> float:
    """Median ms of steps 2..n of `step` on the card on one batch, each
    window closed by torch.cuda.synchronize(); with `profile`, one more step
    under torch.profiler."""
    from fastvocoder_tpu_torch.train.trainer import make_trainer

    trainer = make_trainer(cfg, basis_signal_weight=basis)
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
    log(f"  {cfg.model_name} {step}: {ms:.2f} ms a step (median of steps 2..{n}: "
        f"{', '.join(f'{t:.1f}' for t in times[1:])}; first {times[0]:.1f}), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        log(f"[profile: one {cfg.model_name} {step} on the device]")
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
    F_main = MEL_FRAMES * 16
    with torch.inference_mode():
        entries = [check_basis_decode(torch, F_main, basis_gen.basis_signal.basis),
                   check_fused_resstack(torch, basis_gen, F_main),
                   check_fused_mrf(torch, hifi_gen, MEL_FRAMES),
                   check_fused_tail(torch, hifi_gen, MEL_FRAMES)]
    log("[backward kernels against their plain VJPs]")
    chain_bwd, entries[1]["batch32"] = check_fused_resstack_bwd(torch, basis_gen)
    mrf_bwd, entries[2]["batch32"] = check_fused_mrf_bwd(torch, hifi_gen)
    entries[2:2] = [chain_bwd]   # kernels 1, 2, 3, 4, 5, 6
    entries[4:4] = [mrf_bwd]
    log("[the MRF kernels' 3xTF32 against float64]")
    mrf_errors_against_f64(torch, torch.device("cuda"))
    log("[the chain kernels' 3xTF32 against float64]")
    chain_errors_against_f64(torch, torch.device("cuda"))
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
