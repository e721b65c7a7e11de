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
timed at the training batch's shape.  Kernel 7, the discriminators' grouped
strided conv, is held against its plain version in float64 at the 18
grouped layers of the default discriminators at the GAN cell's batch, each
pass timed beside its plain version, cuDNN and its float32 bound.  Then
the script drives each ported
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
    a checkpoint (kernels: fused_mrf, fused_mrf_bwd, and kernel 7's three,
    grouped_conv_fwd, _dgrad and _wgrad, 72, 54 and 36 times a GAN step);
    then one GAN step on
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
    step;
  * `--fused_train 0` (`fused_train_phase`: the generator's stages as the
    modules' cuDNN convs): one step from the same weights under 0 and under
    1 for HiFiGAN light (GAN and pre-adversarial, float32 and bf16),
    Basis-MelGAN light and MelGAN original (pre-adversarial, float32), held
    to the one-step bounds in float32, in bf16 each against its own float32
    step (the RMS rule above) and the two within 5e-3; ms a step and peak
    memory of both and their ratio; `run_train --fused_train 0` for HiFiGAN
    light and Basis-MelGAN light, 2 pre-adversarial and 1 GAN step with a
    validation pass, launching none of kernels 2-5 or their bf16 forms, the
    decode as often as Basis-MelGAN's same run under -1.

Then the training runtime (`bin/train.py`'s runtime flags), at the same
geometry on the same corpus:

  * Basis-MelGAN light: `run_train --device_cache 1` for 4 pre-adversarial
    steps (kernels 1, 2, 3), its first batch bit for bit a `DeviceCorpus`
    built on the CPU from the same seed; ms a step of the three input paths
    on one trainer (the corpus on the card; host crops through
    `prefetch_to_device`, float16 target; host crops copied in the loop's
    own thread, float32 target, as the loop did before the runtime), and the
    host-to-device bytes of one profiled step of each;
  * HiFiGAN light: one GAN step with remat against one without (same
    weights and batch; kernel 4 launched one generator pass more), peak
    memory and ms a step of both;
  * HiFiGAN light through `run_train --remat 1 --fused_train 1` with a
    wall-clock deadline: 2 steps, their checkpoint (reference layout,
    written by the asynchronous writer) resumed with `--restore_step 2` for
    2 more, held against an unbroken 4-step run, the checkpoint in
    `Synthesizer` on the card against the CPU; the loop's stall per
    checkpoint save (the asynchronous writer's snapshot against a
    synchronous save); 2 steps with `--mixprecision 1 --remat 1
    --device_cache 0`.

Then the pipeline from a wav to a published model, Basis-MelGAN light,
through the port's launcher and CLI (`pipeline_phase`):

  * the mel golden's wav through `dsp.audio.melspectrogram` on the card
    against its mel (1e-5), and ms of extraction a second of audio;
  * 12 seeded wavs of 2-4 s (one at 48 kHz, one at 22.05 kHz) and
    `docs/samples/ground_truth_eval0.wav` through `MODE=preprocess python -m
    fastvocoder_tpu_torch.bin.launcher` in a fresh process, its pool of host
    workers on;
  * `MODE=train`, 2 pre-adversarial steps on those mels with seeded weight
    targets (kernels 1, 2, 3); `python -m fastvocoder_tpu_torch.bin.cli
    synthesize` on the checkpoint (4 wavs, `.gl.wav` included), and
    Griffin-Lim on the card in float64 against a plain numpy loop from the
    same phase (1e-9 of the peak), timed on both;
  * `MODE=publish`: the 30,000-frame pattern (kernel 2 at 120,000 and
    480,000 rows, kernel 1 over 480,000 weight steps), each held against
    its plain version at those shapes; the release weights' zero-mel
    response against the pattern `basis_melgan_clean2.npz` stores;
  * `MODE=test` on the published file over the eval mels, `MODE=evaluation`
    on the eval split, and `StreamingSynthesizer.for_model` on the release
    weights against the full pass (the interior within 1e-5), ms a chunk.

These run in this process through `runpy` (preprocess excepted), so that
the launch counts see them.

Data parallelism and mesh serving run on the one card of the machine
(NCCL between two cards is not measured here).  After bf16 serving:

  * `bin/serve.py --mesh all` for Basis-MelGAN light (a mesh of every card:
    one here), 4 concurrent requests, against the server without a mesh;
    `BatchedSynthesizer` over a mesh of two replicas on cuda:0 (3
    utterances in one bucket, rows padded to 4) against one replica, within
    1e-6 of the peak, ms a call of both (kernels 1, 2);
  * `LastLinear` at C = 256 on the card against the CPU, eval and train
    mode.

After the training runtime, on the same corpus:

  * `run_train` for Basis-MelGAN light, 4 steps, in a child process in a
    one-rank NCCL group (RANK=0 WORLD_SIZE=1 LOCAL_RANK=0 MASTER_ADDR
    MASTER_PORT): the launches of kernels 1, 2 and 3 and the losses of the
    run without the group;
  * two child processes, two gloo ranks on the card (NCCL refuses two ranks
    on one GPU), 16 rows each of one batch of 32: a Basis-MelGAN light
    pre-adversarial step with the weight target and a HiFiGAN light GAN step
    against the full-size discriminator, the reduced gradients, losses and
    clip norms against one process's step at batch 32, ms a step of both.
    Each child prints its launch counts, which the parent adds to the
    kernels' line; a child that fails fails the run.

Launch counts are zeroed before each path and
read right after it; the run fails if a kernel of the path was not
launched.  A profile of one batch-1
inference of each of the first two models closes the run (MelGAN's and
NHV's come with their phases).

Output: the card's name and power limit, a log per phase, then one JSON line
with the kernels (launches, error, times, bound) and, last, one JSON line
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when CUDA
is unavailable, when the port is not beside this script, or when any phase
fails.  Needs one GPU; uses no network (the server binds 127.0.0.1).
"""

from __future__ import annotations

import copy
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
# --fused_train 0 against 1 in bf16: the two paths' logged values within
# FUSED_BF16_LOSS_RTOL (the JAX package's comparison of its two bf16 paths,
# tests/test_fused_mrf.py:259-297)
FUSED_BF16_LOSS_RTOL = 5e-3
# the training runtime on the card: a remat GAN step against the standard
# one from the same weights on the same batch (the same kernels on the same
# inputs; cuDNN's algorithm choice is the only source of difference): losses
# within REMAT_LOSS_RTOL, gradients within REMAT_GRAD_TOL of their peaks; a
# run resumed from its checkpoint against the unbroken run: losses within
# RESUME_RTOL
REMAT_LOSS_RTOL, REMAT_GRAD_TOL, RESUME_RTOL = 1e-5, 1e-4, 1e-5


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
    """The bound of a kernel that computes on the float32 CUDA cores (kernel
    1); beside a tensor-core kernel's own bound as `bound_f32_ms`."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_3xtf32_ms(nbytes: float, flops: float):
    """The bound of a kernel that computes every float32 product as three
    TF32 products on the tensor cores."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 3 * flops / PEAK_TF32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_w16_ms(nbytes: float, flops: float):
    """The bound of a bf16 backward form (3b, 5b): a third of its operations
    (the weight gradients) three TF32 products each, the recompute's and the
    adjoints' two (against a bf16 weight the third adds zeros): 7/9 of the
    3xTF32 bound."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 7 / 3 * flops / PEAK_TF32_FLOP_PER_S * 1e3
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
    _, by = bound_3xtf32_ms(*chain_work(1, T, stacks))
    return {
        "name": "fused_resstack", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/fused_resstack.cu",
        "replaces": "fastvocoder_tpu/ops/fused_resstack.py:153",
        "shape": f"x (1, {T}, {C}), 3 stacks K=3 d=1,3,9 (stage 2 of 2)",
        "max_abs_err": worst, "ms": times[T][0], "plain_ms": times[T][1],
        "bound_ms": times[T][3], "bound_f32_ms": times[T][2], "bound_by": by, "library_ms": None,
        "stage1_ms": times[T // 4][0], "stage1_plain_ms": times[T // 4][1],
        "stage1_bound_ms": times[T // 4][3], "stage1_bound_f32_ms": times[T // 4][2],
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
                    "bound_ms": b3, "bound_f32_ms": bms})
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
        per_stage.append({"shape": [1, T, C], "ms": ms, "plain_ms": plain, "bound_ms": b3,
                          "bound_f32_ms": bms})
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
        "bound_ms": b3, "bound_f32_ms": bms, "bound_by": by, "library_ms": None,
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


def one_fused_tail(torch, fn, what: str) -> dict:
    """One call of fn launches the one-launch bf16 tail once and none of
    the five launches' kernels, by the library's own launch counts (the
    profiler sees no device events in a profile of one call at that point
    of this run); -> the launches by kernel."""
    from fastvocoder_tpu_torch.ops.fused_tail import kernel_launches

    torch.cuda.synchronize()
    before = kernel_launches()
    fn()
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in kernel_launches().items() if n != before[k]}
    if ran != {"tail_fused_bf16_kernel": 1}:
        raise AssertionError(f"{what} ran the tail as {ran}, not one launch of "
                             "tail_fused_bf16_kernel")
    return ran


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
    t_ops = 3 * mrf_flops / PEAK_TF32_FLOP_PER_S + core_flops / PEAK_F32_FLOP_PER_S
    b3 = max(nbytes / PEAK_BYTES_PER_S, t_ops) * 1e3
    by3 = "operations" if t_ops * 1e3 >= b3 else "bytes"
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
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": b3,
        "bound_f32_ms": bms, "bound_by": by3, "library_ms": None, "ms_table_built": built,
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
                   fwd_work, replaces, what, edges=()):
    """A backward kernel against its plain VJP at the training path's
    shapes (`stages`: (operands, C, T) per stage; batch TRAIN_BATCH and 1)
    and at `edges` ((operands, C, B, T), untimed, against the plain VJP in
    float64: over so few rows one leaky-relu flip of the float32 plain VJP
    would be a large share of a dW), its time, the plain VJP's
    and the bound (3xTF32 on the tensor cores; the float32 CUDA cores' beside
    it), summed over the stages at the training batch; also the forward
    kernel's time at that batch.  -> (entry for the kernels line, the
    forward's per-stage times)."""
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
            b3, by3 = bound_3xtf32_ms(nbytes, flops)
            stage = {"shape": [B, T, C], "ms": ms, "plain_ms": plain, "bound_ms": b3,
                     "bound_f32_ms": bms}
            log(f"  {name} ({B}, {T}, {C}): kernel {ms:.3f} ms, plain VJP {plain:.3f} ms, "
                f"float32 bound {bms:.3f} ms ({by}, {flops / 1e9:.1f} GFLOP), 3xTF32 bound "
                f"{b3:.3f} ms ({by3}): {share(b3, ms)} of it")
            per_stage.append(stage)
            for k, v in (("ms", ms), ("plain_ms", plain), ("bytes", nbytes), ("flops", flops)):
                total[k] += v
            with torch.inference_mode():
                fms = cuda_ms(lambda: forward_cuda(x, ops), iters=5, warmup=2)
                fplain = cuda_ms(lambda: forward_plain(x, ops), iters=5, warmup=2)
            fb, _ = bound_ms(fbytes, fflops)
            fb3, _ = bound_3xtf32_ms(fbytes, fflops)
            fstage = {"shape": [B, T, C], "ms": fms, "plain_ms": fplain, "bound_ms": fb3,
                      "bound_f32_ms": fb}
            log(f"  forward at ({B}, {T}, {C}): kernel {fms:.3f} ms, plain {fplain:.3f} ms, "
                f"float32 bound {fb:.3f} ms, 3xTF32 bound {fb3:.3f} ms: {share(fb3, fms)} of it")
            fwd_stages.append(fstage)
            del x, cot, dx, grads, dx_ref, grads_ref
            torch.cuda.empty_cache()
    bms, _ = bound_ms(total["bytes"], total["flops"])
    b3, by = bound_3xtf32_ms(total["bytes"], total["flops"])
    entry = {
        "name": name, "route": "cuda",
        "source": f"fastvocoder_tpu_torch/csrc/{name}.cu", "replaces": replaces,
        "shape": what + ", summed: " + ", ".join(str(tuple(s["shape"])) for s in per_stage),
        "max_abs_err": worst, "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": b3, "bound_f32_ms": bms, "bound_by": by, "library_ms": None,
        "stages": per_stage,
    }
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
        edges=edges)


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
        edges=edges)


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
        f"MelGAN original's 4 stages of {TRAIN_BATCH} crops of {TRAIN_FRAMES} frames")
    keep = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_f32_ms", "bound_by",
            "stages")
    return {k: v for k, v in entry.items() if k in keep}, fwd


GROUPED_TOLS = {"forward": 1e-5, "dgrad": 1e-5, "wgrad": 1e-4}  # of the float64 result's peak
GROUPED_NAMES = {"forward": "grouped_conv_fwd", "dgrad": "grouped_conv_dgrad",
                 "wgrad": "grouped_conv_wgrad"}


def check_grouped_conv(torch):
    """Kernel 7 against its plain version run in float64 at the 18 grouped
    downsample layers of the default discriminators, at the GAN cell's batch
    (32 crops of 33,600 samples): the forward and the input gradient (sums
    of 4 K products an element) within 1e-5 of their peak, the weight and
    bias gradients (sums over up to 268,800 rows) within 1e-4; each pass
    timed as the kernel, the plain version in float32 and cuDNN as the port
    ran these convs before the kernels (`F.conv1d` on transposed views),
    beside its float32 bound.  -> three entries for the kernels line, one a
    pass, with the sums over a `gan_step`'s passes (4 forward, 3 input and 2
    weight gradients of each layer)."""
    from fastvocoder_tpu_torch.bin.kernel_times import (
        DISC_CROPS,
        DISC_PASSES,
        DISC_SAMPLES,
        disc_bounds,
        disc_layers,
        disc_passes,
    )

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(21)
    per_pass = {p: {"max_rel_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                    "bound_ms": 0.0, "bound_3xtf32_ms": 0.0, "layers": []}
                for p, _ in DISC_PASSES}
    for name, x_shape, w_shape, stride, padding in disc_layers(torch):
        B, T, _ = x_shape
        K = w_shape[2]
        T_out = (T + 2 * padding - K) // stride + 1
        x = torch.randn(x_shape, generator=g).to(dev)
        w = (torch.randn(w_shape, generator=g) / np.sqrt(4 * K)).to(dev)
        b = (0.1 * torch.randn(w_shape[0], generator=g)).to(dev)
        dy = torch.randn(B, T_out, w_shape[0], generator=g).to(dev)
        kernel = disc_passes(torch, "kernel", x, w, b, dy, stride, padding)
        want = disc_passes(torch, "plain", *(t.double() for t in (x, w, b, dy)), stride, padding)
        plain = disc_passes(torch, "plain", x, w, b, dy, stride, padding)
        cudnn = disc_passes(torch, "cudnn", x, w, b, dy, stride, padding)
        bounds = disc_bounds(x_shape, w_shape, stride, padding)
        for p, _ in DISC_PASSES:
            got, ref = kernel[p](), want[p]()
            got, ref = (got if isinstance(got, tuple) else (got,)), (
                ref if isinstance(ref, tuple) else (ref,))
            err = max(((a.double() - r).abs().max() / r.abs().max()).item()
                      for a, r in zip(got, ref))
            if not err <= GROUPED_TOLS[p]:
                raise AssertionError(f"grouped conv {p} at {name} {x_shape}: {err:.3e} of the "
                                     f"peak, want at most {GROUPED_TOLS[p]:.0e}")
            del got, ref
            ms = cuda_ms(kernel[p], iters=5, warmup=2)
            plain_ms = cuda_ms(plain[p], iters=5, warmup=2)
            library_ms = cuda_ms(cudnn[p], iters=5, warmup=2)
            entry = per_pass[p]
            entry["max_rel_err"] = max(entry["max_rel_err"], err)
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                           ("bound_ms", bounds[p][0]), ("bound_3xtf32_ms", bounds[p][1])):
                entry[key] += v
            entry["layers"].append({"layer": name, "x": list(x_shape), "weight": list(w_shape),
                                    "max_rel_err": err, "ms": ms, "plain_ms": plain_ms,
                                    "library_ms": library_ms, "bound_ms": bounds[p][0]})
        log(f"  grouped conv {name} {x_shape} -> {(B, T_out, w_shape[0])}: " + ", ".join(
            f"{p} {per_pass[p]['layers'][-1]['ms']:.4f} ms (plain "
            f"{per_pass[p]['layers'][-1]['plain_ms']:.4f}, cuDNN "
            f"{per_pass[p]['layers'][-1]['library_ms']:.4f}, bound {bounds[p][0]:.4f}; "
            f"{per_pass[p]['layers'][-1]['max_rel_err']:.1e} of the peak)" for p, _ in DISC_PASSES))
        torch.cuda.empty_cache()
    entries = []
    for p, n in DISC_PASSES:
        e = per_pass[p]
        log(f"  {GROUPED_NAMES[p]}: the 18 layers once {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f}, cuDNN {e['library_ms']:.4f}, float32 bound "
            f"{e['bound_ms']:.4f} ({share(e['bound_ms'], e['ms'])} of it); a gan_step's {n} "
            f"passes {n * e['ms']:.4f} ms against cuDNN's {n * e['library_ms']:.4f}")
        entries.append({
            "name": GROUPED_NAMES[p], "route": "cuda",
            "source": "fastvocoder_tpu_torch/csrc/grouped_conv.cu", "replaces": None,
            "new": "the JAX package runs these convs through XLA "
                   "(fastvocoder_tpu/ops/conv.py::conv1d)",
            "shape": f"the default discriminators' 18 grouped downsample convs, {p}, at "
                     f"{DISC_CROPS} crops of {DISC_SAMPLES} samples, summed over the layers",
            "max_rel_err": e["max_rel_err"], "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"], "bound_f32_ms": e["bound_ms"],
            "bound_3xtf32_ms": e["bound_3xtf32_ms"], "bound_by": "each layer's operations or bytes",
            "library_ms": e["library_ms"], "passes_a_gan_step": n, "layers": e["layers"]})
    return entries


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


def against_f64(torch, name, x, args, bf16_form, f32_kernel, plain) -> dict:
    """The error against float64 (the plain version in float64 on the bf16
    input) of the bf16 form, of its plain bf16 version and of the float32
    kernel on the same input, each of the float64 output's peak.  -> the
    first two, for the kernels line."""
    xb = x.to(torch.bfloat16)
    y64 = plain(xb.double(), *to_f64(torch, args)).double()
    peak = y64.abs().max().item()

    def rel(y):
        return ((y.double() - y64).abs().max() / peak).item()

    got, want = rel(bf16_form(xb, *args)), rel(plain(xb, *args))
    log(f"  {name} against float64 at {tuple(x.shape)}: bf16 form {got:.3e}, its plain bf16 "
        f"version {want:.3e}, float32 kernel {rel(f32_kernel(xb.float(), *args)):.3e} of the "
        f"peak {peak:.3e}")
    return {"err_f64": got, "plain_err_f64": want}


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
                        what, edges, groups):
    """A bf16 backward form (kernel 3b or 5b) against its plain version:
    at `edges` ((operands, C, B, T), seeded per shape, untimed) against the
    plain version run in float64 on the same bf16 inputs (so that only the
    kernel's float32 rounding can flip a leaky-relu slope;
    `bf16_grads_against_f64`), with each one's error against it beside the
    plain bf16 version's, and bit for bit
    against the float32 form (`vjp_f32`) on the widened inputs, rounded;
    at the training path's `stages` ((operands, C, T), batch TRAIN_BATCH)
    against the plain bf16 version, timed against it, the bounds (its own,
    `bound_w16_ms`, and the 3xTF32 and float32 ones beside it), and its
    device time broken down by pass; `groups` ((label, number of stages) in order) get
    the sums of their stages logged.  Operands are float32 and cast to bf16
    here, as training casts them.  -> the kernels line's entry."""
    from fastvocoder_tpu_torch.bin.chain_times import by_pass

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
        bw, byw = bound_w16_ms(nbytes, flops)
        log(f"  {name} ({B}, {T}, {C}): kernel {ms:.3f} ms, plain {plain:.3f} ms, float32 bound "
            f"{bms:.3f} ms ({by}), 3xTF32 bound {b3:.3f} ms ({by3}): {share(b3, ms)} of it, "
            f"two-product bound {bw:.3f} ms ({byw}): {share(bw, ms)} of it")
        passes = by_pass(torch, lambda: vjp_cuda(x, ops_b, cot),
                         "resstack_bwd" if "resstack" in name else "mrf_bwd")
        log(f"    by pass (device ms): " + ", ".join(f"{k} {v:.3f}" for k, v in passes.items()))
        per_stage.append({"shape": [B, T, C], "ms": ms, "plain_ms": plain, "bound_ms": bw,
                          "bound_3xtf32_ms": b3, "bound_f32_ms": bms, "passes": passes})
        for k, v in (("ms", ms), ("plain_ms", plain), ("bytes", nbytes), ("flops", flops)):
            total[k] += v
        del x, cot, dx, grads, dx_ref, grads_ref
        torch.cuda.empty_cache()
    first = 0
    for label, n in groups:
        part = per_stage[first:first + n]
        first += n
        ms = sum(s_["ms"] for s_ in part)
        bw = sum(s_["bound_ms"] for s_ in part)
        log(f"  {name} over {label}'s {n} stages: {ms:.3f} ms, two-product bound {bw:.3f} ms: "
            f"{share(bw, ms)} of it")
    bw, by = bound_w16_ms(total["bytes"], total["flops"])
    entry = {
        "name": name, "route": "cuda", "form": "bf16",
        "source": f"fastvocoder_tpu_torch/csrc/{name[:-len('_bf16')]}.cu", "replaces": replaces,
        "shape": what + ", summed: " + ", ".join(str(tuple(s_["shape"])) for s_ in per_stage),
        "max_abs_err": worst, "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": bw, "bound_by": by, "library_ms": None, "stages": per_stage,
    }
    entry["bound_3xtf32_ms"], _ = bound_3xtf32_ms(total["bytes"], total["flops"])
    entry["bound_f32_ms"], _ = bound_ms(total["bytes"], total["flops"])
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
        f"{TRAIN_FRAMES} frames, bf16", edges,
        (("Basis-MelGAN light", len(basis_gen.cfg.upsample_scales)),
         ("MelGAN original", len(melgan_gen.cfg.upsample_scales))))


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
        edges, (("HiFiGAN light", len(gen.mrfs)),))


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
    f64 = against_f64(torch, "fused_resstack", x, (basis_stages[0],),
                      fused_residual_stacks_bf16_cuda, fused_residual_stacks_cuda,
                      fused_residual_stacks_plain)

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
                      "bound_by": by, "share_of_bound": bms / ms})
    main_entry = timed[1]
    return {
        "name": "fused_resstack_bf16", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/fused_resstack.cu",
        "replaces": "fastvocoder_tpu/ops/fused_resstack.py:153", "form": "bf16",
        "shape": f"x (1, {T_main}, 256) bf16, 3 stacks K=3 d=1,3,9 (stage 2 of 2)",
        "max_abs_err": worst, "ms": main_entry["ms"], "plain_ms": main_entry["plain_ms"],
        "bound_ms": main_entry["bound_ms"], "bound_by": main_entry["bound_by"],
        "library_ms": None, "share_of_bound": main_entry["share_of_bound"], **f64,
        "stage1": timed[0], "melgan_stages": timed[2:6], "batch32": timed[6:],
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
    f64 = against_f64(torch, "fused_mrf", x, (stages[0],), fused_mrf_stage_bf16_cuda,
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
        per_stage.append({"shape": [1, T, C], "ms": ms, "plain_ms": plain, "bound_ms": bms,
                          "share_of_bound": bms / ms})
        for k, v in (("ms", ms), ("plain_ms", plain), ("bytes", nbytes), ("flops", flops)):
            total[k] += v
    bms, by = bound_bf16_ms(total["bytes"], total["flops"])
    log(f"  fused_mrf_bf16 over the {len(per_stage)} stages: {total['ms']:.4f} ms, bf16 bound "
        f"{bms:.4f} ms: {share(bms, total['ms'])} of it")
    return {
        "name": "fused_mrf_bf16", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/fused_mrf.cu",
        "replaces": "fastvocoder_tpu/ops/fused_mrf.py:112", "form": "bf16",
        "shape": "HiFiGAN light's 3 MRF stages of a 585-frame utterance in bf16, summed: "
                 + ", ".join(str(tuple(s["shape"])) for s in per_stage),
        "max_abs_err": worst, "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": bms, "bound_by": by, "library_ms": None, "share_of_bound": bms / total["ms"],
        **f64, "stages": per_stage,
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
    # batch 3 of 8000 rows: 126 planned tiles of 192 rows, the last ragged
    cases = [(light, 1, T_main, 32), (light, 2, 35, 32), (light, 1, 1, 32), (light, 3, 4000, 32)]
    cases += [(light, 1, t, 32) for t in tail_edge_lengths(16)]
    worst = bf16_cases(torch, "fused_tail_bf16", cases, fused_hifigan_tail_bf16_cuda,
                       fused_hifigan_tail_plain, lambda B, T: T > 1000)
    log(f"  fused_tail_bf16: {len(cases)} shapes agree, among them T_in = "
        f"{tail_edge_lengths(16)}")
    g = torch.Generator().manual_seed(83)
    x = (0.3 * torch.randn(1, T_main, 32, generator=g)).to(dev)
    f64 = against_f64(torch, "fused_tail", x, light, fused_hifigan_tail_bf16_cuda,
                      fused_hifigan_tail_cuda, fused_hifigan_tail_plain)
    table = TailTable(*light, dev, torch.bfloat16)
    xb = x.to(torch.bfloat16)
    ms = cuda_ms(lambda: fused_hifigan_tail_bf16_cuda(xb, *light, table=table), iters=20, warmup=3)
    plain = cuda_ms(lambda: fused_hifigan_tail_plain(xb, *light), iters=20, warmup=3)
    parts = device_ms_by_name(torch, lambda: fused_hifigan_tail_bf16_cuda(xb, *light, table=table))
    # at C_out 16 the whole tail is one launch, none of the five launches' kernels
    ran = one_fused_tail(torch, lambda: fused_hifigan_tail_bf16_cuda(xb, *light, table=table),
                         "fused_tail_bf16")
    k_up, b_up, stride, _, blocks, k_post, b_post = light
    T, C = stride * T_main, k_up.shape[2]
    mrf_bytes, mrf_flops = mrf_work(1, T, blocks)
    nbytes = (mrf_bytes - 4 * 2 * T * C) / 2 + 2 * (xb.numel() + T) + 4 * (
        k_up.numel() + b_up.numel() + k_post.numel() + b_post.numel())
    up_flops = 2 * T * (k_up.shape[0] // stride) * k_up.shape[1] * C
    head_flops = 2 * T * k_post.shape[0] * C * k_post.shape[2]
    # the MRF and the upsample on the tensor cores in bf16 (the operands'
    # type), the head on the CUDA cores at the float32 rate
    bms = max(nbytes / PEAK_BYTES_PER_S, (mrf_flops + up_flops) / PEAK_BF16_FLOP_PER_S
              + head_flops / PEAK_F32_FLOP_PER_S) * 1e3
    by = "bytes" if nbytes / PEAK_BYTES_PER_S * 1e3 >= bms else "operations"
    plan = table.plan(1, T)
    log(f"  fused_tail_bf16 (1, {T_main}, 32) -> (1, {T}, 1): kernel {ms:.4f} ms with a kept "
        f"table ({plan.tiles} tiles of {plan.rows} rows, halo {plan.halo}), plain {plain:.4f} "
        f"ms; bound {bms:.4f} ms ({by}): {share(bms, ms)} of it")
    log(f"  fused_tail_bf16 launches of one call {ran}; device by kernel: " + (", ".join(
        f"{re.findall(r'(\w+(?:<[^()]*>)?)\(', k)[0]} {v:.4f} ms"
        for k, v in sorted(parts.items(), key=lambda kv: -kv[1])) or "not measured (no device "
        "events)"))
    return {
        "name": "fused_tail_bf16", "route": "cuda",
        "source": "fastvocoder_tpu_torch/csrc/fused_tail.cu",
        "replaces": "fastvocoder_tpu/ops/fused_tail.py:80", "form": "bf16",
        "shape": f"x (1, {T_main}, 32) bf16 -> (1, {T}, 1), HiFiGAN light's last stage and head",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "share_of_bound": bms / ms, **f64,
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
    for key, label in (("resstack_bwd_bf16_", "fused_resstack_bwd_bf16 kernel"),
                       ("mrf_bwd_bf16_", "fused_mrf_bwd_bf16 kernel"),
                       ("resstack_bf16_kernel", "fused_resstack_bf16 kernel"),
                       ("basis_decode_wgmma_bf16_kernel",
                        "basis_decode_bf16 kernel (bf16 wgmma, persistent)"),
                       ("mrf_pair_bf16_kernel", "fused_mrf_bf16 kernel"),
                       ("mrf_mean_bf16_kernel", "fused_mrf_bf16 kernel"),
                       ("tail_fused_bf16_kernel",
                        "fused_tail_bf16 kernel: one launch (upsample, MRF, head)"),
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
                       ("grouped_conv_", "grouped_conv kernel (the discriminators' grouped convs)"),
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
    converting = sorted({e.name for e in kernels
                         if "bf16_widen" in e.name or "bf16_narrow" in e.name})
    if converting:  # 3b and 5b read bf16 in their own passes
        raise AssertionError(f"a bf16 backward form widened or rounded apart: {converting}")
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


def kernel_name(name: str) -> str:
    """A kernel's name from a profiler's, without its namespaces and types."""
    return re.sub(r"\(anonymous namespace\)::|\w+::", "", name).split("(")[0].split("<")[0]


def tail_in_one_launch(torch, synth, mel: np.ndarray) -> None:
    """A bf16 HiFiGAN light inference runs its tail as one launch of
    `tail_fused_bf16_kernel` and none of the five launches' kernels."""
    ran = one_fused_tail(torch, lambda: synth.test_rtf(mel), "a bf16 HiFiGAN inference")
    names = device_ms_by_name(torch, lambda: synth.test_rtf(mel), 3)
    log(f"  tail kernels of one bf16 inference: launches {ran}; device " + (", ".join(
        f"{kernel_name(k).replace('void ', '')} {v:.4f} ms" for k, v in names.items()
        if "tail_" in k) or "not measured (no device events)"))


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
                  kernels, bf16: bool = False, absent=(), mesh: bool = False) -> None:
    """4 concurrent HTTP requests, twice, against a direct ServingModel call
    without a mesh (with `bf16`, `--bf16 1` against a ServingModel in bf16,
    within the bf16 gate: a bucket's batch may take other library
    algorithms; with `mesh`, `--mesh all`, /healthz reporting every card)."""
    import torch

    flags = (["--bf16", "1"] if bf16 else []) + (["--mesh", "all"] if mesh else [])
    log(f"[{model}: HTTP serving (bin/serve.py{''.join(' ' + f for f in flags)})]")
    lengths = (60, 130, 300, 585)
    req_mels = [conditioning(model, mel_like_bench(n, 20 + i)) for i, n in enumerate(lengths)]
    results = [None] * len(req_mels)

    def serve_all():
        httpd, batcher = run_serve(
            ["--checkpoint_path", ckpt, "--config", conf, "--model_name", model, "--port", "0"]
            + flags,
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

    health = count_path(f"{model} HTTP serving" + (" on a mesh" if mesh else ""), serve_all,
                        kernels, absent=absent)
    log(f"  healthz {health}")
    if health.get("mesh_size") != (torch.cuda.device_count() if mesh else 1):
        raise AssertionError(f"/healthz reports a mesh of {health.get('mesh_size')}")
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
                f"{per_width[C]:.4f} ms device, float32 bound {st['bound_f32_ms']:.4f} ms, 3xTF32 "
                f"bound {st['bound_ms']:.4f} ms: {share(st['bound_ms'], per_width[C])} of it")


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


def train_argv(model: str, conf: str, index, run_dir: str, steps: int, start_steps: int,
               basis_dir: str = "") -> list:
    """`run_train`'s arguments for a training phase: a validation pass and a
    checkpoint at `steps`."""
    argv = ["--audio_index_path", index[0], "--mel_index_path", index[1],
            "--audio_index_valid_path", index[0], "--mel_index_valid_path", index[1],
            "--model_name", model, "--config", conf, "--run_dir", run_dir, "--seed", "0",
            "--batch_size", str(TRAIN_BATCH), "--batch_expand_size", "1",
            "--fixed_length", str(TRAIN_FRAMES), "--max_steps", str(steps),
            "--save_step", str(steps), "--valid_step", str(steps), "--valid_num", "3",
            "--discriminator_train_start_steps", str(start_steps)]
    if basis_dir:
        argv += ["--basis_dataset_path", basis_dir]
    return argv


def train_phase(torch, count_path, model: str, conf: str, corpus: str, index, steps: int,
                start_steps: int, kernels, basis_dir: str = "", use_mpd: bool = False,
                mixprecision: bool = False, absent=(), extra=()):
    """`run_train` as a user calls it, at full width on the card (with
    `use_mpd`, `--use_mpd 1`; with `mixprecision`, `--mixprecision 1`;
    `extra`: more arguments; launching none of `absent`); checks the
    losses, that the weights moved, and that the checkpoint loads back (a
    bf16 run's also in `Synthesizer` in bf16).  -> (configuration, basis or
    None, the run's logged history)."""
    import dataclasses

    from fastvocoder_tpu_torch.bin.train import run_train
    from fastvocoder_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
    from fastvocoder_tpu_torch.train.trainer import make_trainer
    from fastvocoder_tpu_torch.hparams import load_model_config

    kind = "bf16 mixed-precision training (bin/train.py --mixprecision 1)" if mixprecision \
        else "training (bin/train.py)"
    if extra:
        kind = kind[:-1] + " " + " ".join(map(str, extra)) + ")"
    log(f"[{model}: {kind}, {steps} steps of {TRAIN_BATCH} x {TRAIN_FRAMES} frames]")
    run_dir = os.path.join(corpus, f"run_{model}" + ("_bf16" if mixprecision else "")
                           + "".join(f"_{a}".replace("--", "") for a in extra))
    argv = train_argv(model, conf, index, run_dir, steps, start_steps, basis_dir)
    argv += [str(a) for a in extra]
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
    return cfg, basis, state.history


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


def one_step(torch, cfg, basis, step: str, batch, dev, compute_dtype=None,
             fused_train: bool = True, rows=None, start=None):
    """One `step` from seed 0's weights (the generator's from the state
    dict `start`, if given) on `batch` (its first `rows` crops) on `dev`:
    -> (logged values, {who: {name: gradient on the CPU}})."""
    from fastvocoder_tpu_torch.train.trainer import make_trainer

    trainer = make_trainer(cfg, basis_signal_weight=basis, device=dev, keep_grads=True,
                           compute_dtype=compute_dtype, fused_train=fused_train)
    state = trainer.init_state(0)
    if start is not None:
        state.generator.load_state_dict(start)
    args = [torch.from_numpy(batch[k][:rows]).to(dev) if k in batch else None
            for k in ("mel", "wav", "weight")]
    _, metrics = getattr(trainer, step)(state, *args)
    out = ({k: float(v) for k, v in metrics.items()},
           {who: {n: g_.cpu() for n, g_ in grads.items()}
            for who, grads in trainer.last_grads.items()})
    if not all(np.isfinite(v) for v in out[0].values()):
        raise AssertionError(f"{cfg.model_name} {step} on {dev}: a loss is not finite")
    return out


def hold_step(what: str, got, want) -> None:
    """One step's (logged values, gradients) against another's: every value
    within STEP_LOSS_RTOL, every gradient within STEP_GRAD_TOL of its peak (a
    gain's or bias's of its conv's weight gradient's peak, if larger)."""
    (m_got, g_got), (m_want, g_want) = got, want
    for k, w in m_want.items():
        # relative to the wanted value, or to 1e-2 where that is smaller
        # (`weight_average_value` is a mean that cancels to about 1e-6)
        rel = abs(m_got[k] - w) / max(abs(w), 1e-2)
        log(f"  {k}: {m_got[k]:.6f} against {w:.6f} (relative {rel:.2e}, tol {STEP_LOSS_RTOL:.0e})")
        if not (np.isfinite(m_got[k]) and rel <= STEP_LOSS_RTOL):
            raise AssertionError(f"{what}: {k} disagrees")
    for who, want_g in g_want.items():
        worst, worst_name = 0.0, ""
        for name, w in want_g.items():
            peak = w.abs().max().item()
            sibling = name.rsplit(".", 1)[0] + ".weight"
            if sibling in want_g:
                peak = max(peak, want_g[sibling].abs().max().item())
            rel = (g_got[who][name] - w).abs().max().item() / max(peak, 1e-30)
            if rel > worst:
                worst, worst_name = rel, name
        log(f"  {who} gradients ({len(want_g)} tensors): worst {worst:.2e} of its peak "
            f"({worst_name}), tol {STEP_GRAD_TOL:.0e}")
        if not worst <= STEP_GRAD_TOL:
            raise AssertionError(f"{what}: {who} gradients disagree")


def step_against_cpu(torch, cfg, basis, step: str, batch) -> None:
    """One step from the same initial weights on the same batch, on the card
    (through the kernels) and on the CPU (through the plain versions)."""
    log(f"[{cfg.model_name}: one {step} on the card against the CPU plain path]")
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[dev] = one_step(torch, cfg, basis, step, batch, dev)
        log(f"  on {dev}: {time.perf_counter() - t0:.2f} s")
    hold_step(f"{cfg.model_name} {step} against the CPU", out["cuda"], out["cpu"])


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
    start = release_generator_state(release) if release else None
    log(f"[{cfg.model_name}: one {step} in bf16 against float32, on the card and on the CPU, "
        f"{BF16_CPU_BATCH} crops, from {os.path.basename(release) if release else 'seed 0'}]")
    out = {}
    for dev in ("cuda", "cpu"):
        for dt in (None, torch.bfloat16):
            t0 = time.perf_counter()
            out[(dev, dt)] = one_step(torch, cfg, basis, step, batch, dev, dt,
                                      rows=BF16_CPU_BATCH, start=start)
            log(f"  {dev} {'bf16' if dt else 'float32'}: {time.perf_counter() - t0:.2f} s, "
                + " ".join(f"{k}={v:.5f}" for k, v in sorted(out[(dev, dt)][0].items())))
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
               compute_dtype=None, fused_train: bool = True) -> float:
    """Median ms of steps 2..n of `step` on the card on one batch, each
    window closed by torch.cuda.synchronize(), in `compute_dtype` (bf16:
    mixed precision), through the kernels or, with `fused_train` False, the
    modules; with `profile`, one more step under torch.profiler."""
    from fastvocoder_tpu_torch.train.trainer import make_trainer

    trainer = make_trainer(cfg, basis_signal_weight=basis, compute_dtype=compute_dtype,
                           fused_train=fused_train)
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
    kind = (" in bf16" if compute_dtype else "") + ("" if fused_train else ", --fused_train 0")
    log(f"  {cfg.model_name} {step}{kind}: {ms:.2f} ms a step (median of steps 2..{n}: "
        f"{', '.join(f'{t:.1f}' for t in times[1:])}; first {times[0]:.1f}), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        log(f"[profile: one {cfg.model_name} {step}{kind} on the device]")
        profile_device(torch, lambda: getattr(trainer, step)(state, *args), 1, step)
    return ms


def fused_train_pair(torch, cfg, basis, step: str, batch, compute_dtype=None) -> None:
    """One `step` under `--fused_train 0` (the generator's stages as the
    modules' cuDNN convs) against the same step under 1 (the kernels), from
    the same weights on the same batch.  Float32, all TRAIN_BATCH crops: the
    one-step bounds (`hold_step`).  bf16, BF16_CPU_BATCH crops: each path's
    gradients against its own float32 step's, at most BF16_STEP_RATIO times
    the CPU's bf16 deviation (the module path rounds to bf16 between every
    conv, kernels 3b and 5b compute in float32 inside: the two bf16 steps are
    not held to each other at the float32 bounds), the two paths' logged
    values within FUSED_BF16_LOSS_RTOL of each other."""
    what = f"{cfg.model_name} {step}" + (" in bf16" if compute_dtype else "")
    if compute_dtype is None:
        log(f"[{what}: --fused_train 0 against 1, {TRAIN_BATCH} crops]")
        hold_step(f"{what}, --fused_train 0 against 1",
                  one_step(torch, cfg, basis, step, batch, "cuda", fused_train=False),
                  one_step(torch, cfg, basis, step, batch, "cuda", fused_train=True))
        return
    log(f"[{what}: --fused_train 0 and 1, each against its float32 step, {BF16_CPU_BATCH} crops]")
    rows = BF16_CPU_BATCH
    cpu = {dt: one_step(torch, cfg, basis, step, batch, "cpu", dt, rows=rows)
           for dt in (None, compute_dtype)}
    got = {}
    for fused_train in (False, True):
        f32 = one_step(torch, cfg, basis, step, batch, "cuda", None, fused_train, rows)
        got[fused_train] = one_step(torch, cfg, basis, step, batch, "cuda", compute_dtype,
                                    fused_train, rows)
        for who, grads in got[fused_train][1].items():
            card = rel_rms(grads, f32[1][who])
            ref = rel_rms(cpu[compute_dtype][1][who], cpu[None][1][who])
            log(f"  --fused_train {int(fused_train)}: {who} gradients' relative RMS deviation "
                f"from float32 {card:.3e}, the CPU's {ref:.3e} (at most {BF16_STEP_RATIO} x)")
            if not card <= BF16_STEP_RATIO * ref:
                raise AssertionError(f"{what}, --fused_train {int(fused_train)}: the {who} "
                                     f"gradients deviate more than the rule allows")
    for k, want in got[True][0].items():
        rel = abs(got[False][0][k] - want) / max(abs(want), 1e-2)
        log(f"  {k}: --fused_train 0 {got[False][0][k]:.6f}, 1 {want:.6f} (relative {rel:.2e}, "
            f"tol {FUSED_BF16_LOSS_RTOL:.0e})")
        if not rel <= FUSED_BF16_LOSS_RTOL:
            raise AssertionError(f"{what}: {k} of --fused_train 0 and 1 disagree")


def fused_train_phase(torch, count_path, path_counts, corpus: str, index, hifi_cfg, basis_cfg,
                      basis, melgan_cfg) -> dict:
    """`--fused_train 0` on the card: each step kind of HiFiGAN light
    (float32 and bf16), Basis-MelGAN light and MelGAN original held against
    the kernels' step (`fused_train_pair`) and timed both ways (ms a step,
    peak device memory, the ratio); then `run_train --fused_train 0` for
    HiFiGAN light and Basis-MelGAN light across the discriminator boundary
    with a validation pass, launching none of kernels 2-5 or their bf16
    forms, Basis-MelGAN's decode (not gated, as in the JAX package) as often
    as in the same run under -1.  -> {step: ms and GiB both ways}."""
    bf16 = torch.bfloat16
    stages = ("fused_resstack", "fused_resstack_bwd", "fused_mrf", "fused_mrf_bwd")
    absent = stages + tuple(k + "_bf16" for k in stages)
    hifi_batch = fixed_batch(hifi_cfg, index)
    cases = ((hifi_cfg, None, "gan_step", hifi_batch, None),
             (hifi_cfg, None, "pre_adv_step", hifi_batch, None),
             (hifi_cfg, None, "gan_step", hifi_batch, bf16),
             (hifi_cfg, None, "pre_adv_step", hifi_batch, bf16),
             (basis_cfg, basis, "pre_adv_step", fixed_batch(basis_cfg, index, basis_dir=corpus),
              None),
             (melgan_cfg, None, "pre_adv_step", fixed_batch(melgan_cfg, index), None))
    out = {}
    for cfg, b, step, batch, dt in cases:
        fused_train_pair(torch, cfg, b, step, batch, dt)
        log("[ms a step on the card, --fused_train 0 and 1]")
        ms, gib = {}, {}
        for fused_train in (False, True):
            ms[fused_train] = time_steps(torch, cfg, b, step, batch, compute_dtype=dt,
                                         fused_train=fused_train)
            gib[fused_train] = torch.cuda.max_memory_allocated() / 2**30
        name = f"{cfg.model_name} {step}" + (" bf16" if dt else "")
        out[name] = {"modules_ms": ms[False], "kernels_ms": ms[True],
                     "modules_over_kernels": ms[False] / ms[True],
                     "modules_peak_gib": gib[False], "kernels_peak_gib": gib[True]}
        log(f"  {name}: --fused_train 0 {ms[False]:.2f} ms, 1 {ms[True]:.2f} ms a step (0 / 1 "
            f"{ms[False] / ms[True]:.3f}); peak {gib[False]:.2f} / {gib[True]:.2f} GiB")
        torch.cuda.empty_cache()

    flag = ("--fused_train", 0)
    train_phase(torch, count_path, "hifigan", HIFI_CONF, corpus, index, steps=3, start_steps=2,
                kernels=(), absent=absent, extra=flag)
    histories = {}
    for extra in (flag, ("--fused_train", -1)):
        histories[extra] = train_phase(
            torch, count_path, "basis-melgan", CONF, corpus, index, steps=3, start_steps=2,
            kernels=("basis_decode",), basis_dir=corpus, extra=extra,
            absent=absent if extra == flag else ())[2]
    decode = [path_counts[f"basis-melgan training (bin/train.py --fused_train {v})"]
              ["basis_decode"] for v in (0, -1)]
    log(f"  basis_decode launches: --fused_train 0 {decode[0]}, -1 {decode[1]}")
    if decode[0] != decode[1]:
        raise AssertionError("--fused_train 0 changed the decode's launches")
    first = [dict(histories[e])[1] for e in (flag, ("--fused_train", -1))]
    for k, want in first[1].items():
        rel = abs(first[0][k] - want) / max(abs(want), 1e-2)
        log(f"  step 1 {k}: --fused_train 0 {first[0][k]:.6f}, -1 {want:.6f} (relative "
            f"{rel:.2e}, tol {STEP_LOSS_RTOL:.0e})")
        if not rel <= STEP_LOSS_RTOL:
            raise AssertionError(f"run_train --fused_train 0: step 1's {k} disagrees with -1's")
    return out


def h2d_bytes(torch, fn) -> int:
    """Host-to-device bytes of one call of fn: the `Memcpy HtoD` events of a
    torch.profiler trace (CUPTI), summed."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return int(sum(e.get("args", {}).get("bytes", 0) for e in events
                   if "HtoD" in str(e.get("name", ""))))


def runtime_argv(model: str, conf: str, index, run_dir: str, steps: int, start_steps: int,
                 basis_dir: str = "", *flags) -> list:
    """`run_train`'s arguments for the runtime phase: no validation pass
    (valid_step past the run), a checkpoint at `steps`."""
    argv = ["--audio_index_path", index[0], "--mel_index_path", index[1],
            "--audio_index_valid_path", index[0], "--mel_index_valid_path", index[1],
            "--model_name", model, "--config", conf, "--run_dir", run_dir, "--seed", "0",
            "--batch_size", str(TRAIN_BATCH), "--batch_expand_size", "1",
            "--fixed_length", str(TRAIN_FRAMES), "--max_steps", str(steps),
            "--save_step", str(steps), "--valid_step", "100000",
            "--discriminator_train_start_steps", str(start_steps), "--stall_exit_s", "600"]
    if basis_dir:
        argv += ["--basis_dataset_path", basis_dir]
    return argv + [str(f) for f in flags]


def input_paths_phase(torch, count_path, corpus: str, index, basis_cfg, basis) -> dict:
    """Basis-MelGAN light's training input on the card: `run_train
    --device_cache 1` for 4 pre-adversarial steps (kernels 1, 2, 3), its
    first batch held bit for bit against a `DeviceCorpus` built on the CPU
    from the same seed; then ms a step of the three input paths on one
    trainer (the device corpus, the host path through `prefetch_to_device`
    with the float16 target, and host crops copied in the loop's own thread
    with the float32 target, as the loop did before the runtime), and the
    host-to-device bytes of one profiled step of each."""
    from fastvocoder_tpu_torch.bin.train import run_train
    from fastvocoder_tpu_torch.data.device_cache import DeviceCorpus
    from fastvocoder_tpu_torch.train import trainer as tr

    log(f"[basis-melgan: run_train --device_cache 1, 4 steps of {TRAIN_BATCH} x {TRAIN_FRAMES} "
        f"frames, the corpus on the card]")
    first = []
    pre_adv = tr.Trainer.pre_adv_step

    def spy(self, state, mel, wav, weight=None):
        if not first:
            first.append({"mel": mel.clone(), "wav": wav.clone(), "weight": weight.clone()})
        return pre_adv(self, state, mel, wav, weight)

    tr.Trainer.pre_adv_step = spy
    try:
        t0 = time.perf_counter()
        state = count_path("basis-melgan run_train --device_cache 1", lambda: run_train(
            runtime_argv("basis-melgan", CONF, index, os.path.join(corpus, "run_cache"), 4, 4,
                         corpus, "--device_cache", 1)),
            ("basis_decode", "fused_resstack", "fused_resstack_bwd"))
    finally:
        tr.Trainer.pre_adv_step = pre_adv
    log(f"  4 steps and a checkpoint in {time.perf_counter() - t0:.2f} s: "
        + "; ".join(f"step {s_} " + " ".join(f"{k}={v:.5f}" for k, v in sorted(m.items()))
                    for s_, m in state.history))
    if [s_ for s_, _ in state.history] != [1, 2, 3, 4] or not all(
            np.isfinite(v) for _, m in state.history for v in m.values()):
        raise AssertionError("the device-cache run did not take 4 finite steps")
    hp, ds = basis_input_setup(corpus, index, basis_cfg)
    cpu_first = next(DeviceCorpus(ds, hp=hp, L=basis_cfg.arch.L, device="cpu",
                                  log=lambda m: None).batches(seed=0, weight_until=4))
    for k, want in cpu_first.items():
        got = first[0][k].cpu()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"the run's first batch's {k} is not the CPU DeviceCorpus's")
    log(f"  the run's first batch equals a CPU DeviceCorpus's bit for bit: "
        + ", ".join(f"{k} {tuple(v.shape)} {str(v.dtype).split('.')[-1]}"
                    for k, v in cpu_first.items()))

    log("[basis-melgan: ms a step by input path, one trainer, pre-adversarial steps]")
    out = {}
    step_on, paths = input_paths(torch, corpus, index, basis_cfg, basis)
    for name, (what, batches) in paths.items():
        step = lambda: step_on(next(batches))
        n = 6
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n - 1):
            step()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / (n - 1)
        batches.close()
        log(f"  {what}: {out[name]:.2f} ms a step (steps 2..{n}, one window)")
    t0 = time.perf_counter()
    n = 8
    for _, b in zip(range(n), host_batches(corpus, index, basis_cfg, f16=True)):
        pass
    log(f"  host ms a batch (crop, collate, float16): {(time.perf_counter() - t0) * 1e3 / n:.2f}")

    # Earlier profiles in this process can leave CUPTI's copy records out of
    # a later trace, so the bytes are read in a process of their own.
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--h2d", corpus, *index],
                           capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        raise AssertionError(f"the host-to-device profile failed:\n{child.stderr[-4000:]}")
    nbytes = json.loads(child.stdout.strip().splitlines()[-1])
    for name, b in nbytes.items():
        log(f"  {name}: host-to-device "
            + (f"{b} bytes in one profiled step" if b else "not measured (no copy in the trace)"))
    return {name: (ms, nbytes[name]) for name, ms in out.items()}


def basis_input_setup(corpus: str, index, basis_cfg):
    """(hp, dataset) of the Basis-MelGAN runtime phase: the reference's batch
    of TRAIN_BATCH x TRAIN_FRAMES over the seeded corpus's weight targets."""
    from fastvocoder_tpu_torch.data import dataset as d
    from fastvocoder_tpu_torch.hparams import HP

    hp = HP.replace(batch_size=TRAIN_BATCH, batch_expand_size=1, fixed_length=TRAIN_FRAMES)
    ds = d.WeightDataset.from_index_files(index[0], index[1], basis_cfg.arch.L,
                                          os.path.join(corpus, "weight"), hp=hp)
    return hp, ds


def host_batches(corpus: str, index, basis_cfg, f16: bool):
    """The host path's batches (crop and collate in numpy), the weight target
    float16 as `run_train` sends it, or float32 as the loop did before."""
    from fastvocoder_tpu_torch.data import dataset as d

    hp, ds = basis_input_setup(corpus, index, basis_cfg)
    for epoch in range(hp.epochs):
        for b in d.batch_iterator(ds, hp, seed=0, epoch=epoch, L=basis_cfg.arch.L):
            yield dict(b, weight=b["weight"].astype(np.float16)) if f16 else b


def input_paths(torch, corpus: str, index, basis_cfg, basis):
    """(step, {name: (what, batches)}): Basis-MelGAN light's pre-adversarial
    step on one trainer (seed 0), `step(batch)`, and the batches of each
    input path: the corpus on the card (`DeviceCorpus`), the host path
    through `prefetch_to_device`, and host crops copied in the loop's own
    thread with the float32 target, as the loop did before the runtime."""
    from fastvocoder_tpu_torch.data import dataset as d
    from fastvocoder_tpu_torch.data.device_cache import DeviceCorpus
    from fastvocoder_tpu_torch.runtime import prefetch_to_device
    from fastvocoder_tpu_torch.train import trainer as tr

    hp, ds = basis_input_setup(corpus, index, basis_cfg)
    trainer = tr.make_trainer(basis_cfg, hp=hp, basis_signal_weight=basis)
    state = trainer.init_state(0)
    t0 = time.perf_counter()
    corpus_dev = DeviceCorpus(ds, hp=hp, L=basis_cfg.arch.L, log=log)
    log(f"  staged in {time.perf_counter() - t0:.2f} s")
    cuda = torch.device("cuda")
    return (lambda batch: trainer.pre_adv_step(state, **batch)), {
        "device corpus": ("device corpus (--device_cache 1)",
                          corpus_dev.batches(seed=0, weight_until=10 ** 9)),
        "host prefetch": ("host crops, prefetch_to_device, float16 target (--device_cache 0)",
                          prefetch_to_device(host_batches(corpus, index, basis_cfg, True), cuda)),
        "host in the loop": ("host crops copied in the loop's thread, float32 target",
                             (d.to_device(b, cuda)
                              for b in host_batches(corpus, index, basis_cfg, False))),
    }


def h2d_child(corpus: str, audio_index: str, mel_index: str) -> int:
    """`chip_smoke.py --h2d <corpus> <audio index> <mel index>`: the
    host-to-device bytes of one profiled step of each input path (after one
    unprofiled step), printed as one JSON object on the last line."""
    import torch

    sys.path.insert(0, ROOT)
    from fastvocoder_tpu_torch.hparams import load_model_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    basis_cfg = load_model_config("basis-melgan", CONF)
    basis = np.load(os.path.join(corpus, "basis_signal_weight.npy")).astype(np.float32)
    out = {}
    step_on, paths = input_paths(torch, corpus, (audio_index, mel_index), basis_cfg, basis)
    for name, (_, batches) in paths.items():
        step = lambda: step_on(next(batches))
        step()
        torch.cuda.synchronize()
        out[name] = h2d_bytes(torch, step)
        batches.close()
    print(json.dumps(out), flush=True)
    return 0


def remat_phase(torch, count_path, hifi_cfg, batch) -> dict:
    """HiFiGAN light, one GAN step with remat against one without, from the
    same weights on the same batch, with cuDNN held to deterministic
    algorithms (its nondeterministic ones move a step's gradients between
    two runs of the same step, printed beside): losses within
    REMAT_LOSS_RTOL, every gradient within REMAT_GRAD_TOL of its peak,
    kernel 4 launched one generator pass (4 stages) more.  Then, with
    cuDNN's default choice, peak memory (first step) and ms a step (median
    of steps 2..4) of both."""
    from fastvocoder_tpu_torch.ops import _build
    from fastvocoder_tpu_torch.train.trainer import make_trainer

    log("[hifigan: one gan_step with remat against one without, same weights and batch]")
    args = [torch.from_numpy(batch[k]).cuda() for k in ("mel", "wav")]

    def one_step(remat: bool, name: str):
        trainer = make_trainer(hifi_cfg, keep_grads=True, remat=remat)
        state = trainer.init_state(0)
        _, metrics = count_path(name, lambda: trainer.gan_step(state, *args),
                                ("fused_mrf", "fused_mrf_bwd"))
        return ({k: float(v) for k, v in metrics.items()},
                {who: {n: g_.cpu() for n, g_ in grads.items()}
                 for who, grads in trainer.last_grads.items()},
                _build.launch_counts["fused_mrf"])

    def worst(got, want):
        out = {}
        for who, w in want.items():
            out[who] = 0.0, ""
            for name, t in w.items():
                peak = t.abs().max().item()
                sibling = name.rsplit(".", 1)[0] + ".weight"
                if sibling in w:
                    peak = max(peak, w[sibling].abs().max().item())
                rel = (got[who][name] - t).abs().max().item() / max(peak, 1e-30)
                out[who] = max(out[who], (rel, name))
        return out

    torch.backends.cudnn.deterministic = True
    try:
        m0, g0, n0 = one_step(False, "hifigan gan_step, cuDNN deterministic")
        m1, g1, n1 = one_step(True, "hifigan gan_step remat, cuDNN deterministic")
    finally:
        torch.backends.cudnn.deterministic = False
    _, g_again, _ = one_step(False, "hifigan gan_step, cuDNN's default")
    _, g_twice, _ = one_step(False, "hifigan gan_step again, cuDNN's default")
    log(f"  kernel 4 launches: {n0} without, {n1} with remat (+{n1 - n0}, one generator pass "
        f"of 4 stages)")
    if n1 - n0 != 4:
        raise AssertionError(f"remat launched kernel 4 {n1 - n0} more times, want 4")
    for k, want in m0.items():
        rel = abs(m1[k] - want) / max(abs(want), 1e-30)
        log(f"  {k}: {m1[k]:.7f} with, {want:.7f} without (relative {rel:.1e}, tol "
            f"{REMAT_LOSS_RTOL:.0e})")
        if not rel <= REMAT_LOSS_RTOL:
            raise AssertionError(f"remat moved {k}")
    noise = worst(g_twice, g_again)
    for who, (rel, name) in worst(g1, g0).items():
        log(f"  {who} gradients with remat against without (cuDNN deterministic): worst "
            f"{rel:.2e} of its peak ({name}), tol {REMAT_GRAD_TOL:.0e}; two runs of the step "
            f"without remat, cuDNN's default: {noise[who][0]:.2e} ({noise[who][1]})")
        if not rel <= REMAT_GRAD_TOL:
            raise AssertionError(f"remat moved the {who} gradients")

    out = {}
    for remat in (False, True):
        trainer = make_trainer(hifi_cfg, remat=remat)
        state = trainer.init_state(0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer.gan_step(state, *args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            trainer.gan_step(state, *args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[remat] = peak / 2**30, float(np.median(times[1:]))
        log(f"  remat={remat}: peak device memory {out[remat][0]:.3f} GiB (first step), "
            f"{out[remat][1]:.2f} ms a step (median of steps 3..5: "
            f"{', '.join(f'{t:.1f}' for t in times[1:])})")
        del trainer, state
    return {"peak GiB": (out[False][0], out[True][0]), "ms": (out[False][1], out[True][1])}


def resume_phase(torch, count_path, Synthesizer, corpus: str, index) -> dict:
    """HiFiGAN light through `run_train` with the runtime's flags (`--remat
    1 --fused_train 1 --stall_exit_s 600`, a wall-clock deadline an hour
    on): 2 steps written by the asynchronous writer in the reference layout,
    a second run from the run directory with `--restore_step 2` for 2 more
    (GAN steps), its losses those of an unbroken 4-step run within
    RESUME_RTOL; the checkpoint in `Synthesizer` on the card against the
    CPU; the loop's stall per checkpoint save (`save_stall`, returned); then
    2 steps in bf16 (`--mixprecision 1 --remat 1 --device_cache 0`)."""
    from fastvocoder_tpu_torch.bin.train import run_train
    from fastvocoder_tpu_torch.checkpoint import checkpoint_format
    from fastvocoder_tpu_torch.train.checkpoint import latest_checkpoint

    log("[hifigan: run_train --remat 1 --fused_train 1, 2 + 2 steps resumed against 4 unbroken]")
    os.environ["TRAIN_DEADLINE_EPOCH"] = str(time.time() + 3600)
    flags = ("--remat", 1, "--fused_train", 1)
    kernels = ("fused_mrf", "fused_mrf_bwd")
    try:
        whole = count_path("hifigan run_train 4 steps", lambda: run_train(runtime_argv(
            "hifigan", HIFI_CONF, index, os.path.join(corpus, "whole"), 4, 2, "", *flags)),
            kernels)
        cut = os.path.join(corpus, "cut")
        count_path("hifigan run_train 2 steps", lambda: run_train(runtime_argv(
            "hifigan", HIFI_CONF, index, cut, 2, 2, "", *flags)), kernels)
        ckpt = latest_checkpoint(cut)
        log(f"  {os.path.basename(ckpt)}: format {checkpoint_format(ckpt)!r}")
        if checkpoint_format(ckpt) != "reference":
            raise AssertionError("the run's checkpoint is not in the reference layout")
        resumed = count_path("hifigan run_train resumed", lambda: run_train(runtime_argv(
            "hifigan", HIFI_CONF, index, cut, 4, 2, "", *flags, "--checkpoint_path", cut,
            "--restore_step", 2)), kernels)
    finally:
        del os.environ["TRAIN_DEADLINE_EPOCH"]
    want = dict(whole.history)
    if [s_ for s_, _ in resumed.history] != [3, 4]:
        raise AssertionError(f"the resumed run logged {[s_ for s_, _ in resumed.history]}")
    for step, m in resumed.history:
        for k, v in m.items():
            rel = abs(v - want[step][k]) / max(abs(want[step][k]), 1e-30)
            log(f"  step {step} {k}: resumed {v:.7f}, unbroken {want[step][k]:.7f} "
                f"(relative {rel:.1e}, tol {RESUME_RTOL:.0e})")
            if not rel <= RESUME_RTOL:
                raise AssertionError(f"the resumed run's step {step} {k} is not the unbroken run's")
    final = latest_checkpoint(cut)  # the resumed run's tail
    mel = mel_like_bench(100, 4)
    card = Synthesizer(final, HIFI_CONF, "hifigan")._run(mel)
    cpu = Synthesizer(final, HIFI_CONF, "hifigan", device="cpu")._run(mel)
    err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    log(f"  Synthesizer on the card from the resumed run's {os.path.basename(final)}: "
        f"{card.shape[0]} samples, "
        f"{err:.2e} of the CPU's peak off (tol {MODEL_TOL:.0e})")
    if not (card.shape == cpu.shape and np.all(np.isfinite(card)) and err <= MODEL_TOL):
        raise AssertionError("the trained checkpoint does not synthesize on the card as on the CPU")
    saves = save_stall(torch, resumed, corpus)

    log("[hifigan: run_train --mixprecision 1 --remat 1 --device_cache 0, 2 steps]")
    bf16 = count_path("hifigan run_train bf16 remat host path", lambda: run_train(runtime_argv(
        "hifigan", HIFI_CONF, index, os.path.join(corpus, "bf16_remat"), 2, 1, "",
        "--mixprecision", 1, "--remat", 1, "--device_cache", 0)),
        ("fused_mrf_bf16", "fused_mrf_bwd_bf16"))
    log("  " + "; ".join(f"step {s_} " + " ".join(f"{k}={v:.5f}" for k, v in sorted(m.items()))
                         for s_, m in bf16.history))
    if not all(np.isfinite(v) for _, m in bf16.history for v in m.values()):
        raise AssertionError("the bf16 remat run's losses are not finite")
    return saves


def save_stall(torch, state, corpus: str, n: int = 3) -> dict:
    """The loop's stall per checkpoint save on a trained HiFiGAN light state
    (its Adam states included): `AsyncCheckpointWriter.submit` until its
    on-device snapshot is done, the write that follows on the worker, and a
    synchronous `save_checkpoint`; medians of n saves, in ms."""
    from fastvocoder_tpu_torch.train.checkpoint import AsyncCheckpointWriter, save_checkpoint

    log("[hifigan light: the loop's stall per checkpoint save]")
    times = {"submit": [], "write on the worker": [], "synchronous save": []}
    writer = AsyncCheckpointWriter()
    try:
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            writer.submit(os.path.join(corpus, f"async_{i}.pth.tar"), state, "hifigan")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            writer.wait()
            t2 = time.perf_counter()
            save_checkpoint(os.path.join(corpus, f"sync_{i}.pth.tar"), state, "hifigan")
            t3 = time.perf_counter()
            for k, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
                times[k].append(dt * 1e3)
    finally:
        writer.close()
    out = {k: float(np.median(v)) for k, v in times.items()}
    log(f"  {os.path.getsize(os.path.join(corpus, 'sync_0.pth.tar'))} bytes a file; ms, median "
        f"of {n}: " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


# ---------------------------------------------------------------------------
# The pipeline: wav -> mel -> train -> synthesize -> publish -> test ->
# evaluation, through the port's launcher and CLI, and streaming
# ---------------------------------------------------------------------------

GROUND_TRUTH = os.path.join(ROOT, "docs", "samples", "ground_truth_eval0.wav")
MEL_GOLDEN = os.path.join(ROOT, "tests", "goldens", "mel_golden.npz")
# a release file's pattern was computed from its weights before they were
# rounded to float16: the zero-mel response of the committed weights lies
# within 5e-4 of the pattern's peak from it, in the JAX package and in the
# port alike (tests/test_torch_publish.py, on the CPU); the card's response
# is held within that plus the card's bound against the CPU
RELEASE_PATTERN_TOL = 5e-4 + MODEL_TOL


def run_module(module: str, argv, mode: str = "") -> str:
    """`[MODE=<mode>] python -m <module> <argv>` inside this process, so
    that the launch counts see its kernels; -> what it printed (echoed)."""
    import contextlib
    import runpy

    saved_argv, saved_mode = sys.argv, os.environ.get("MODE")
    sys.argv = [module] + list(argv)
    sys.modules.pop(module, None)  # as in a fresh process
    if mode:
        os.environ["MODE"] = mode
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_module(module, run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            raise AssertionError(f"{mode or module} exited with {e.code}") from e
    finally:
        sys.argv = saved_argv
        if saved_mode is None:
            os.environ.pop("MODE", None)
        else:
            os.environ["MODE"] = saved_mode
        for line in out.getvalue().splitlines():
            log(f"    | {line}")
    return out.getvalue()


def write_wavs(root: str) -> str:
    """12 seeded wavs of 2-4 s (a voiced tone with harmonics, vibrato and
    noise; one at 48 kHz, one at 22.05 kHz, the rest at 24 kHz) and the
    ground-truth sample, as an index file; -> its path."""
    import scipy.io.wavfile

    rng = np.random.default_rng(21)
    paths = []
    for i in range(12):
        sr = {0: 48000, 1: 22050}.get(i, 24000)
        t = np.arange(int(rng.uniform(2.0, 4.0) * sr)) / sr
        f0 = rng.uniform(100, 250) * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        y = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6))
        y = y * (0.6 + 0.4 * np.sin(2 * np.pi * 0.5 * t)) + 0.02 * rng.standard_normal(t.size)
        paths.append(os.path.join(root, f"utt_{i}.wav"))
        scipy.io.wavfile.write(paths[-1], sr, (y / np.abs(y).max() * 20000).astype(np.int16))
    paths.append(GROUND_TRUTH)
    index = os.path.join(root, "wavs.txt")
    with open(index, "w") as f:
        f.write("\n".join(paths) + "\n")
    return index


def numpy_griffin_lim(S: np.ndarray, phase: np.ndarray, n_iters: int, n_fft: int, hop: int,
                      win: int) -> np.ndarray:
    """The plain host loop (reference data/audio.py:74-84,108-110): numpy
    float64, S (bins, frames) from the initial phase `phase`."""
    n = np.arange(win)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * n / win)
    left = (n_fft - win) // 2
    w = np.pad(w, (left, n_fft - win - left))

    def stft(y):
        y = np.pad(y, (n_fft // 2, n_fft // 2), mode="reflect")
        nf = 1 + (len(y) - n_fft) // hop
        frames = np.stack([y[i * hop: i * hop + n_fft] for i in range(nf)])
        return np.fft.rfft(frames * w, n=n_fft, axis=-1).T

    def istft(z):
        frames = np.fft.irfft(z.T, n=n_fft, axis=-1) * w
        total = n_fft + hop * (frames.shape[0] - 1)
        out, wsq = np.zeros(total), np.zeros(total)
        for i, fr in enumerate(frames):
            out[i * hop: i * hop + n_fft] += fr
            wsq[i * hop: i * hop + n_fft] += w * w
        return (out / np.maximum(wsq, 1e-10))[n_fft // 2: total - n_fft // 2]

    y = istft(S * np.exp(1j * phase))
    for _ in range(n_iters):
        y = istft(S * np.exp(1j * np.angle(stft(y))))
    return y


def mel_phase(torch) -> dict:
    """The mel golden's wav on the card against its mel; ms of extraction a
    second of audio on the card and through the CPU path."""
    from fastvocoder_tpu_torch.dsp import audio

    g = np.load(MEL_GOLDEN)
    got = audio.melspectrogram(g["wav"])
    err = float(np.abs(got - g["mel"]).max())
    log(f"  melspectrogram of the golden wav on the card: {got.shape}, max abs {err:.3e} from "
        f"the golden (tol 1e-5)")
    if got.shape != g["mel"].shape or not err <= 1e-5:
        raise AssertionError("melspectrogram on the card disagrees with the mel golden")
    rng = np.random.default_rng(4)
    wav = (0.3 * np.sin(np.arange(240000) / 9.0) + 0.05 * rng.standard_normal(240000)
           ).astype(np.float32)  # 10 s
    card = host_us(torch, lambda: audio.melspectrogram(wav), 5) / 1e4
    cpu = host_us(torch, lambda: audio.melspectrogram(wav, device="cpu"), 3) / 1e4
    log(f"  mel extraction (float64): {card:.3f} ms a second of audio on the card, {cpu:.3f} on "
        f"the CPU path")
    return {"mel_ms_per_audio_s": card, "mel_ms_per_audio_s_cpu": cpu, "golden_err": err}


def griffin_lim_phase(torch, mel: np.ndarray) -> dict:
    """Griffin-Lim of `mel` (80, T) on the card in float64 against the
    plain numpy loop from the same phase (1e-9 of the peak), and the times
    of both, of float32 on the card and of `inv_mel_spectrogram` (the
    synthesize path's)."""
    from fastvocoder_tpu_torch.dsp import audio, griffin_lim
    from fastvocoder_tpu_torch.hparams import HP as hp

    amp = np.power(10.0, (np.clip(mel.astype(np.float64), 0, 1) * -hp.min_level_db
                          + hp.min_level_db + hp.ref_level_db) * 0.05)
    basis = griffin_lim._inv_mel_basis(hp.sample_rate, hp.n_fft, hp.num_mels, hp.fmin)
    S = np.maximum(1e-10, basis @ amp) ** hp.power
    phase = 2 * np.pi * np.random.default_rng(8).random(S.shape)
    args = dict(n_iters=hp.griffin_lim_iters, n_fft=hp.n_fft, hop=hp.hop_length, win=hp.win_length)
    t0 = time.perf_counter()
    want = numpy_griffin_lim(S, phase, **args)
    host = (time.perf_counter() - t0) * 1e3
    mag = torch.from_numpy(S.T.copy()).cuda()
    run = lambda m, p: griffin_lim.griffin_lim(m, phase0=p, length=want.shape[0], **args)
    got = run(mag, phase.T.copy()).cpu().numpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    card = host_us(torch, lambda: run(mag, phase.T.copy()), 3) / 1e3
    card32 = host_us(torch, lambda: run(mag.float(), phase.T.copy()), 3) / 1e3
    inv = host_us(torch, lambda: audio.inv_mel_spectrogram(mel), 3) / 1e3
    log(f"  Griffin-Lim, {hp.griffin_lim_iters} iterations over {mel.shape[1]} frames: card "
        f"float64 {card:.2f} ms (float32 {card32:.2f}), host numpy loop {host:.2f} ms; card "
        f"against the host from the same phase {err:.3e} of the peak (tol 1e-9); "
        f"inv_mel_spectrogram on the card {inv:.2f} ms")
    if not err <= 1e-9:
        raise AssertionError("Griffin-Lim on the card disagrees with the numpy loop")
    return {"frames": int(mel.shape[1]), "card_f64_ms": card, "card_f32_ms": card32,
            "host_numpy_ms": host, "inv_mel_spectrogram_ms": inv, "rel_err": err}


def long_launches(torch, gen, frames: int) -> dict:
    """Kernels 2 and 1 at publish's shapes against their plain versions on
    the card: the chain at (1, 4 frames, 256) and (1, 16 frames, 256) with
    the trained stages' weights, the decode over 16 frames weight steps;
    with their times."""
    from fastvocoder_tpu_torch.ops.basis_decode import basis_decode_cuda, basis_decode_plain
    from fastvocoder_tpu_torch.ops.fused_resstack import (
        fused_residual_stacks_cuda,
        fused_residual_stacks_plain,
    )

    dev = next(gen.parameters()).device
    g = torch.Generator().manual_seed(12)
    out = {}
    for stage, T in ((0, frames * 4), (1, frames * 16)):
        stacks = [m.chain_operands() for m in gen.stacks[stage]]
        x = (0.3 * torch.randn(1, T, stacks[0][0].shape[1], generator=g)).to(dev)
        got = fused_residual_stacks_cuda(x, stacks)
        want = fused_residual_stacks_plain(x, stacks)
        err, tol, rows_ok, ok = rows_close(got, want, CHAIN_TOL, CHAIN_ROW_TOL)
        del got, want
        ms = cuda_ms(lambda: fused_residual_stacks_cuda(x, stacks), iters=3, warmup=1)
        plain = cuda_ms(lambda: fused_residual_stacks_plain(x, stacks), iters=3, warmup=1)
        b3, _ = bound_3xtf32_ms(*chain_work(1, T, stacks))
        log(f"  fused_resstack (1, {T}, 256): max abs {err:.3e} (tol {tol:.3e}), rows within "
            f"{CHAIN_ROW_TOL:.0e}: {rows_ok:.4f}; kernel {ms:.3f} ms, plain {plain:.3f}, 3xTF32 "
            f"bound {b3:.3f}")
        if not ok:
            raise AssertionError(f"fused_resstack disagrees with its plain version at (1, {T})")
        out[f"fused_resstack_{T}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                                      "bound_ms": b3}
        del x
    basis = gen.basis_signal.basis
    eps = float(np.finfo(np.float32).eps)
    w = torch.relu(torch.randn(1, frames * 16, basis.shape[1], generator=g)).to(dev)
    got, want = basis_decode_cuda(w, basis), basis_decode_plain(w, basis)
    err = (got - want).abs()
    ok = bool(torch.all(err <= 4 * basis.shape[1] * eps * basis_decode_plain(w.abs(),
                                                                              basis.abs())))
    ms = cuda_ms(lambda: basis_decode_cuda(w, basis), iters=5, warmup=1)
    plain = cuda_ms(lambda: basis_decode_plain(w, basis), iters=5, warmup=1)
    C, L = basis.shape[1], basis.shape[0]
    bms, by = bound_ms(4 * (frames * 16 * C + L * C + (frames * 16 + 1) * L // 2),
                       2 * 2 * (frames * 16 + 1) * L // 2 * C)
    log(f"  basis_decode (1, {frames * 16}, {C}): max abs {err.max().item():.3e}, within bound "
        f"{ok}; kernel {ms:.3f} ms, plain {plain:.3f}, bound {bms:.3f} ({by})")
    if not ok:
        raise AssertionError("basis_decode disagrees with its plain version at publish's shape")
    out[f"basis_decode_{frames * 16}"] = {"max_abs_err": err.max().item(), "ms": ms,
                                          "plain_ms": plain, "bound_ms": bms}
    return out


def pipeline_phase(torch, count_path, root: str) -> dict:
    """wav -> mel -> train -> synthesize -> publish -> test -> evaluation
    for Basis-MelGAN light through the port's launcher and CLI, then
    streaming on the release weights; -> the phase's numbers."""
    import scipy.io.wavfile

    from fastvocoder_tpu_torch.bin.evaluation import evaluate, load_data
    from fastvocoder_tpu_torch.bin.publish import PATTERN_FRAMES, zero_mel_response
    from fastvocoder_tpu_torch.bin.synthesize import Synthesizer
    from fastvocoder_tpu_torch.checkpoint import load_release_npz
    from fastvocoder_tpu_torch.dsp import audio
    from fastvocoder_tpu_torch.hparams import load_model_config
    from fastvocoder_tpu_torch.models.factory import load_generator
    from fastvocoder_tpu_torch.models.streaming import DEFAULT_HALO, StreamingSynthesizer
    from fastvocoder_tpu_torch.train.checkpoint import latest_checkpoint

    basis = ("basis_decode", "fused_resstack")
    out = {}
    log("[pipeline: feature extraction on the card]")
    out["mel"] = mel_phase(torch)

    log("[pipeline: MODE=preprocess python -m fastvocoder_tpu_torch.bin.launcher, pool on]")
    index = write_wavs(root)
    processed, audio_idx, mel_idx = (os.path.join(root, d) for d in ("processed", "audio", "mel"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fastvocoder_tpu_torch.bin.launcher", "--data_path", index,
         "--save_path", processed, "--audio_index_path", audio_idx, "--mel_index_path", mel_idx,
         "--train_size", "9", "--valid_size", "2", "--eval_size", "2"],
        cwd=ROOT, env=dict(os.environ, MODE="preprocess", PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=600)
    out["preprocess_s"] = time.perf_counter() - t0
    for line in (proc.stdout + proc.stderr).strip().splitlines()[-6:]:
        log(f"    | {line}")
    mels = sorted(f for f in os.listdir(processed) if f.endswith(".mel.npy"))
    log(f"  13 wavs (2-4 s; 48 kHz, 22.05 kHz, 24 kHz) -> {len(mels)} mels in "
        f"{out['preprocess_s']:.2f} s (a fresh process, its pool of host workers included)")
    if proc.returncode != 0 or len(mels) != 13 or "failed" in proc.stdout:
        raise AssertionError(f"preprocess failed (exit {proc.returncode})")
    gt_mel = np.load(os.path.join(processed, "ground_truth_eval0.wav.mel.npy"))
    _, gt = scipy.io.wavfile.read(GROUND_TRUTH)
    again = audio.melspectrogram(gt.astype(np.float32) / 32768.0)
    if gt_mel.shape != again.shape or not np.abs(gt_mel - again).max() <= 1e-9:
        raise AssertionError("the preprocessed ground-truth mel is not the card's mel of its wav")

    log("[pipeline: MODE=train, Basis-MelGAN light, 2 pre-adversarial steps]")
    os.makedirs(os.path.join(root, "weight"))
    rng = np.random.default_rng(5)
    for path in open(os.path.join(audio_idx, "train")).read().split() + \
            open(os.path.join(audio_idx, "valid")).read().split():
        frames = np.load(path.replace(".wav.npy", ".wav.mel.npy"), mmap_mode="r").shape[1]
        np.save(os.path.join(root, "weight", os.path.basename(path)),
                rng.random((256, frames * 16), dtype=np.float32))  # as write_corpus's targets
    np.save(os.path.join(root, "basis_signal_weight.npy"),
            np.load(os.path.join(ROOT, "dataset", "clean_basis", "basis_signal_weight.npy")))
    run_dir = os.path.join(root, "run")
    t0 = time.perf_counter()
    count_path("pipeline MODE=train", lambda: run_module(
        "fastvocoder_tpu_torch.bin.launcher",
        ["--audio_index_path", os.path.join(audio_idx, "train"),
         "--mel_index_path", os.path.join(mel_idx, "train"),
         "--audio_index_valid_path", os.path.join(audio_idx, "valid"),
         "--mel_index_valid_path", os.path.join(mel_idx, "valid"),
         "--model_name", "basis-melgan", "--config", CONF, "--run_dir", run_dir,
         "--basis_dataset_path", root, "--batch_size", "4", "--batch_expand_size", "1",
         "--fixed_length", str(TRAIN_FRAMES), "--max_steps", "2", "--save_step", "2",
         "--valid_step", "2", "--valid_num", "1"], mode="train"),
        basis + ("fused_resstack_bwd",))
    ckpt = latest_checkpoint(run_dir)
    losses = [float(v) for d, _, files in os.walk(run_dir) if "total_loss.txt" in files
              for v in open(os.path.join(d, "total_loss.txt")).read().split()]
    log(f"  {ckpt} in {time.perf_counter() - t0:.2f} s; total losses {losses}")
    if ckpt is None or not ckpt.endswith("checkpoint_2.pth.tar") or len(losses) != 2 \
            or not np.isfinite(losses).all():
        raise AssertionError("pipeline training left no step-2 checkpoint or no finite losses")

    log("[pipeline: python -m fastvocoder_tpu_torch.bin.cli synthesize]")
    gt_mel_path = os.path.join(processed, "ground_truth_eval0.wav.mel.npy")
    wav_path = os.path.join(root, "gt.wav")
    count_path("pipeline cli synthesize", lambda: run_module(
        "fastvocoder_tpu_torch.bin.cli",
        ["synthesize", "--checkpoint_path", ckpt, "--mel_path", gt_mel_path, "--wav_path",
         wav_path, "--model_name", "basis-melgan", "--config", CONF]), basis)
    T = gt_mel.shape[1]
    for suffix, n in (("", (T * 16 - 1) * 15 + 30), (".remove", (T * 16 - 1) * 15 + 30),
                      (".bias", (T * 16 - 1) * 15 + 30), (".gl", (T - 1) * HOP)):
        rate, y = scipy.io.wavfile.read(wav_path[:-4] + suffix + ".wav")
        if rate != 24000 or y.shape != (n,):
            raise AssertionError(f"synthesize wrote {suffix or 'the waveform'} as {y.shape}")
    log(f"  4 wavs written (est, remove, bias: {(T * 16 - 1) * 15 + 30} samples; gl: "
        f"{(T - 1) * HOP})")
    out["griffin_lim"] = griffin_lim_phase(torch, gt_mel)

    log(f"[pipeline: MODE=publish, the {PATTERN_FRAMES}-frame zero-mel pattern]")
    published = os.path.join(root, "published.pth.tar")
    t0 = time.perf_counter()
    count_path("pipeline MODE=publish", lambda: run_module(
        "fastvocoder_tpu_torch.bin.launcher",
        ["--checkpoint_path", ckpt, "--model_name", "basis-melgan", "--config", CONF,
         "--save_path", published], mode="publish"), basis)
    out["publish_ms"] = (time.perf_counter() - t0) * 1e3
    gen, pattern = load_generator(published, load_model_config("basis-melgan", CONF),
                                  torch.device("cuda"))
    n = (PATTERN_FRAMES * 16 - 1) * 15 + 30
    if pattern is None or pattern.shape != (n,) or not np.isfinite(pattern).all():
        raise AssertionError(f"the published pattern is {None if pattern is None else pattern.shape}")
    out["pattern_ms"] = host_us(torch, lambda: zero_mel_response(
        gen, PATTERN_FRAMES, 80, torch.device("cuda")), 3) / 1e3
    log(f"  published in {out['publish_ms']:.1f} ms (a zero-mel inference of {PATTERN_FRAMES} "
        f"frames alone {out['pattern_ms']:.1f} ms), pattern of {n} samples, peak "
        f"{np.abs(pattern).max():.3e}")
    out["long_launches"] = long_launches(torch, gen, PATTERN_FRAMES)
    del gen
    torch.cuda.empty_cache()
    release = Synthesizer(CKPT, CONF, "basis-melgan")
    stored = load_release_npz(CKPT)["pattern"]
    frames = (stored.shape[0] - 30) // (16 * 15) + 1
    got = count_path("release zero-mel response", lambda: zero_mel_response(
        release.generator, frames, 80, torch.device("cuda")), basis)
    err, peak = float(np.abs(got - stored).max()), float(np.abs(stored).max())
    log(f"  basis_melgan_clean2.npz zero-mel response over {frames} frames against the stored "
        f"pattern: max abs {err:.3e}, {err / peak:.3e} of the peak (tol {RELEASE_PATTERN_TOL})")
    if got.shape != stored.shape or not err <= RELEASE_PATTERN_TOL * peak:
        raise AssertionError("the release zero-mel response disagrees with the stored pattern")
    out["release_pattern_err"] = err

    log("[pipeline: MODE=test on the published file over the eval mels]")
    eval_dir = os.path.join(root, "eval_mels")
    os.makedirs(eval_dir)
    for path in open(os.path.join(mel_idx, "eval")).read().split():
        np.save(os.path.join(eval_dir, os.path.basename(path)), np.load(path))
    said = count_path("pipeline MODE=test", lambda: run_module(
        "fastvocoder_tpu_torch.bin.launcher",
        ["--checkpoint_path", published, "--file_path", eval_dir, "--model_name",
         "basis-melgan", "--config", CONF], mode="test"), basis)
    out["test_rtf"] = float(re.search(r"rtf is ([0-9.eE+-]+)\.", said).group(1))
    wavs = [f for f in os.listdir(eval_dir) if f.endswith(".wav")]
    if len(wavs) != 2 or not out["test_rtf"] > 0:
        raise AssertionError("MODE=test wrote no wavs or no RTF")

    log("[pipeline: MODE=evaluation on the eval split]")
    result = os.path.join(root, "eval.json")
    eval_args = ["--checkpoint_path", ckpt, "--model_name", "basis-melgan", "--config", CONF,
                 "--audio_index_path", os.path.join(audio_idx, "eval"),
                 "--mel_index_path", os.path.join(mel_idx, "eval"), "--num_items", "2",
                 "--output", result]
    count_path("pipeline MODE=evaluation", lambda: run_module(
        "fastvocoder_tpu_torch.bin.launcher", eval_args, mode="evaluation"), basis)
    with open(result) as f:
        summary = json.load(f)
    if len(summary["items"]) != 2 or not np.isfinite(list(summary["mean"].values())).all():
        raise AssertionError("MODE=evaluation gave no finite metrics")
    synth = Synthesizer(ckpt, CONF, "basis-melgan", bucket_frames=64)
    items = load_data(os.path.join(audio_idx, "eval"), os.path.join(mel_idx, "eval"), [0, 1])
    out["evaluation_ms_per_item"] = host_us(torch, lambda: evaluate(synth, *items), 3) / 2e3
    log(f"  mean {summary['mean']}; {out['evaluation_ms_per_item']:.1f} ms an item "
        f"(a warm Synthesizer)")
    del synth

    log("[pipeline: streaming on the release weights against the full pass]")
    mel = np.tile(gt_mel.T.astype(np.float32), (4, 1))  # 4 x 193 frames
    gen, pattern = release.generator, release.pattern
    s = StreamingSynthesizer.for_model(gen, "basis-melgan", pattern=pattern)
    streamed = count_path("streaming", lambda: s(mel), basis)
    T = mel.shape[0]
    with torch.inference_mode():
        full_pass = lambda: gen.inference(torch.from_numpy(mel[None]).cuda())[0].cpu().numpy()
        full = full_pass()[: T * HOP] - pattern[: T * HOP]
    edge = DEFAULT_HALO * HOP
    peak = max(1.0, float(np.abs(full).max()))
    interior = float(np.abs(streamed[edge:-edge] - full[edge:-edge]).max())
    chunks = -(-T // s.chunk)
    stream_ms = host_us(torch, lambda: s(mel), 5) / 1e3
    with torch.inference_mode():
        full_ms = host_us(torch, full_pass, 5) / 1e3
    seconds = T * HOP / 24000
    log(f"  {T} frames in {chunks} chunks of {s.chunk} + 2 x {s.halo} frames: interior max abs "
        f"{interior:.3e} (tol {1e-5 * peak:.1e}), edges {np.abs(streamed - full).max():.3e}; "
        f"{stream_ms / chunks:.3f} ms a chunk, RTF {stream_ms / 1e3 / seconds:.3e} streamed "
        f"against {full_ms / 1e3 / seconds:.3e} in one pass")
    if streamed.shape != full.shape or not interior <= 1e-5 * peak:
        raise AssertionError("streaming disagrees with the full pass in the interior")
    out["streaming"] = {"frames": T, "chunks": chunks, "ms_per_chunk": stream_ms / chunks,
                        "rtf": stream_ms / 1e3 / seconds, "full_pass_rtf": full_ms / 1e3 / seconds,
                        "interior_err": interior}
    return out


# data parallelism on the one card: the one-rank NCCL run against the run
# without a group (the same arithmetic and a one-rank all-reduce: losses
# within DP_LOSS_RTOL); two gloo ranks against one process at batch 32 (the
# reduced gradients within DP_GRAD_TOL of their peaks, a gain's or a
# bias's against its conv weight's, if larger; the frozen basis's, which
# only enters the clip norm, within DP_BASIS_GRAD_TOL: a float32 sum over
# the batch's 71,680 weight frames with cancellation, 1.1e-4 of its peak
# apart in two summation orders; the losses within DP_LOSS_RTOL, the clip
# norms within DP_NORM_RTOL); two serving replicas on the card against one
# (within MESH_TOL of the peak); LastLinear on the card against the CPU
# (LASTLINEAR_TOL of the peak)
DP_LOSS_RTOL, DP_GRAD_TOL, DP_NORM_RTOL, MESH_TOL, LASTLINEAR_TOL = 1e-5, 1e-4, 1e-5, 1e-6, 1e-5
DP_BASIS_GRAD_TOL = 1e-3
DP_STEPS = (("basis-melgan", "pre_adv_step"), ("hifigan", "gan_step"))
CHILD_TIMEOUT_S = 300


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_children(name: str, argv, envs) -> list:
    """Start one process of `chip_smoke.py argv` an environment of `envs`
    (each beside this one's), all at once; -> each one's output.  A child
    that fails or outlives CHILD_TIMEOUT_S fails the phase; every child is
    ended before this returns."""
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv],
                              env=dict(os.environ, **env), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for env in envs]
    outputs = []
    try:
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        for p in procs:
            outputs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        for line in out.splitlines():
            if "data parallel:" in line or "CHILD " in line:
                log(f"  rank {rank}: {line.strip()}")
        if p.returncode != 0:
            raise AssertionError(f"{name}: rank {rank} exited {p.returncode}:\n{out[-6000:]}")
    return outputs


def child_launches(output: str) -> dict:
    """The launch counts a child printed on its `CHILD launches` line."""
    for line in output.splitlines():
        if line.startswith("CHILD launches "):
            return json.loads(line[len("CHILD launches "):])
    raise AssertionError("a child printed no launch counts")


def dp_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def dp_nccl_phase(corpus: str, index, want_history, want_counts, launches) -> None:
    """`run_train` for Basis-MelGAN light, 4 pre-adversarial steps of 32 x
    140 frames, in a child process that the environment puts in a one-rank
    NCCL group (RANK=0 WORLD_SIZE=1 LOCAL_RANK=0 MASTER_ADDR MASTER_PORT):
    its log names the backend and the world size, it launches kernels 1, 2
    and 3 as the run without the group did, and its losses are that run's."""
    kernels = ("basis_decode", "fused_resstack", "fused_resstack_bwd")
    log("[basis-melgan: bin/train.py in a one-rank NCCL group, 4 steps]")
    argv_path, out_path = os.path.join(corpus, "dp_argv.json"), os.path.join(corpus, "dp_out.json")
    with open(argv_path, "w") as f:
        json.dump(train_argv("basis-melgan", CONF, index, os.path.join(corpus, "run_dp"), 4, 4,
                             corpus), f)
    t0 = time.perf_counter()
    (out,) = run_children("one-rank NCCL run_train", ["--dp-train", argv_path, out_path],
                          [dp_env(0, 1, free_port())])
    log(f"  the child ran in {time.perf_counter() - t0:.2f} s (its start and imports included)")
    if "rank 0 of 1 over nccl" not in out:
        raise AssertionError("the one-rank run did not log an NCCL group of one rank")
    counts = child_launches(out)
    log(f"  launches on the one-rank NCCL path: {counts}; without the group: {want_counts}")
    if any(counts.get(k, 0) != want_counts[k] for k in kernels):
        raise AssertionError("the one-rank NCCL run launched other kernels than the run without "
                             "the group")
    for k, v in counts.items():
        launches[k] += v
    with open(out_path) as f:
        history = [(s_, m) for s_, m in json.load(f)["history"]]
    # relative to each value, or to 1e-2 where that is smaller
    # (`weight_average_value` is a mean that cancels to about 1e-5)
    worst, where = max((abs(m[k] - w[k]) / max(abs(w[k]), 1e-2), f"step {s_} {k}")
                       for (s_, m), (_, w) in zip(history, want_history) for k in w)
    log(f"  losses of 4 steps against the run without the group: worst relative {worst:.3e} "
        f"({where}; tol {DP_LOSS_RTOL:.0e})")
    if [s_ for s_, _ in history] != [s_ for s_, _ in want_history] or not worst <= DP_LOSS_RTOL:
        raise AssertionError("the one-rank NCCL run's losses differ from the run without a group")


def dp_train_child(argv_path: str, out_path: str) -> int:
    """`chip_smoke.py --dp-train <argv.json> <out.json>`: `run_train` with
    those arguments in the group the environment names; its history to
    `out.json`, its launch counts on a `CHILD launches` line."""
    import logging

    import torch

    logging.basicConfig(level=logging.INFO)
    sys.path.insert(0, ROOT)
    from fastvocoder_tpu_torch.bin.train import run_train
    from fastvocoder_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(argv_path) as f:
        state = run_train(json.load(f))
    with open(out_path, "w") as f:
        json.dump({"history": state.history}, f)
    print("CHILD launches " + json.dumps(dict(_build.launch_counts)), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def dp_models(corpus: str):
    """(name, configuration, basis or None, step kind) of DP_STEPS."""
    from fastvocoder_tpu_torch.hparams import load_model_config

    basis = np.load(os.path.join(corpus, "basis_signal_weight.npy")).astype(np.float32)
    confs = {"basis-melgan": CONF, "hifigan": HIFI_CONF}
    return [(m, load_model_config(m, confs[m]), basis if m == "basis-melgan" else None, step)
            for m, step in DP_STEPS]


def dp_step_result(trainer, metrics) -> dict:
    out = {f"m/{k}": float(v) for k, v in metrics.items()}
    out.update({f"n/{k}": float(v) for k, v in trainer.last_norms.items()})
    out.update({f"g/{who}/{n}": g.cpu().numpy() for who, grads in trainer.last_grads.items()
                for n, g in grads.items()})
    return out


def dp_steps_child(work: str) -> int:
    """`chip_smoke.py --dp-steps <work dir>`: a rank of a gloo group on the
    card the environment names (every rank on cuda:0); for each of
    DP_STEPS, from seed 0's weights broadcast by rank 0, one step on this
    rank's rows of the batch in `batches.npz`, its global metrics, clip
    norms and reduced gradients to `<model>.npz` (rank 0), then 3 more steps
    timed; launch counts on a `CHILD launches` line."""
    import torch

    sys.path.insert(0, ROOT)
    from fastvocoder_tpu_torch.ops import _build
    from fastvocoder_tpu_torch.parallel import (
        DataParallel,
        maybe_initialize_distributed,
        reduce_metrics,
        replicate_state,
    )
    from fastvocoder_tpu_torch.train.trainer import make_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = maybe_initialize_distributed("cuda", backend="gloo")
    dp = DataParallel.current()
    dev = torch.device("cuda", 0)
    for model, cfg, basis, step in dp_models(work):
        with np.load(os.path.join(work, f"{model}.batch.npz")) as z:
            batch = dict(z)
        trainer = make_trainer(cfg, basis_signal_weight=basis, keep_grads=True, dp=dp, device=dev)
        state = replicate_state(trainer.init_state(0), dp)
        rows = dp.rows(batch["wav"].shape[0] // world)
        args = [torch.from_numpy(batch[k][rows]).to(dev) if k in batch else None
                for k in ("mel", "wav", "weight")]
        _, metrics = getattr(trainer, step)(state, *args)
        (metrics,) = reduce_metrics([metrics], dp)
        if rank == 0:
            np.savez(os.path.join(work, f"{model}.dp.npz"), **dp_step_result(trainer, metrics))
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            getattr(trainer, step)(state, *args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"CHILD {model} {step} on {rank + 1} of {world} gloo ranks sharing the card, "
              f"{len(batch['wav']) // world} rows a rank: {float(np.median(times)):.2f} ms a step "
              f"(median of 3: {', '.join(f'{t:.1f}' for t in times)})", flush=True)
        del trainer, state
        torch.cuda.empty_cache()
    print("CHILD launches " + json.dumps(dict(_build.launch_counts)), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def dp_gloo_phase(torch, corpus: str, index, launches) -> dict:
    """Two gloo ranks on the one card (NCCL refuses two ranks on one GPU),
    each on 16 rows of one fixed batch of 32: a Basis-MelGAN light
    pre-adversarial step with the weight target (kernels 1, 2, 3) and a
    HiFiGAN light GAN step against the full-size discriminator (4, 5),
    their reduced gradients, losses and clip norms against one process's
    step on the whole batch; -> ms a step, one process beside two ranks."""
    from fastvocoder_tpu_torch.train.trainer import make_trainer

    log("[data parallelism: two gloo ranks on the card against one process, batch 32]")
    kernels = ("basis_decode", "fused_resstack", "fused_resstack_bwd", "fused_mrf",
               "fused_mrf_bwd")
    models = dp_models(corpus)
    for model, cfg, _, _ in models:
        batch = fixed_batch(cfg, index, basis_dir=corpus if model == "basis-melgan" else "")
        np.savez(os.path.join(corpus, f"{model}.batch.npz"), **batch)
    port = free_port()
    t0 = time.perf_counter()
    outs = run_children("two gloo ranks", ["--dp-steps", corpus],
                        [dp_env(r, 2, port) for r in range(2)])
    log(f"  both ranks ran in {time.perf_counter() - t0:.2f} s (start and imports included)")
    for rank, out in enumerate(outs):
        counts = child_launches(out)
        log(f"  launches of rank {rank}: {counts}")
        missing = [k for k in kernels if counts.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"rank {rank} never launched {missing}")
        for k, v in counts.items():
            launches[k] += v
    timing = {}
    for model, cfg, basis, step in models:
        with np.load(os.path.join(corpus, f"{model}.batch.npz")) as z:
            batch = dict(z)
        trainer = make_trainer(cfg, basis_signal_weight=basis, keep_grads=True)
        state = trainer.init_state(0)
        args = [torch.from_numpy(batch[k]).cuda() if k in batch else None
                for k in ("mel", "wav", "weight")]
        _, metrics = getattr(trainer, step)(state, *args)
        want = dp_step_result(trainer, metrics)
        with np.load(os.path.join(corpus, f"{model}.dp.npz")) as z:
            got = dict(z)
        loss = max(abs(got[k] - v) / max(abs(v), 1e-2) for k, v in want.items()
                   if k.startswith("m/"))
        norm = max(abs(got[k] - v) / abs(v) for k, v in want.items() if k.startswith("n/"))
        grad, where, basis_grad = 0.0, "", 0.0
        for k, w in want.items():
            if k.startswith("g/"):
                sibling = k.rsplit(".", 1)[0] + ".weight"
                peak = max(np.abs(w).max(), np.abs(want[sibling]).max() if sibling in want else 0)
                err = float(np.abs(got[k] - w).max() / max(peak, 1e-30))
                if k.endswith("basis_signal.basis"):
                    basis_grad = err
                elif err > grad:
                    grad, where = err, k[2:]
        log(f"  {model} {step}: two ranks against one process: losses {loss:.3e} relative (tol "
            f"{DP_LOSS_RTOL:.0e}), clip norms {norm:.3e} (tol {DP_NORM_RTOL:.0e}), gradients "
            f"{grad:.3e} of the peak at worst ({where}; tol {DP_GRAD_TOL:.0e})"
            + (f", the frozen basis's {basis_grad:.3e} (tol {DP_BASIS_GRAD_TOL:.0e})"
               if basis is not None else ""))
        if not (loss <= DP_LOSS_RTOL and norm <= DP_NORM_RTOL and grad <= DP_GRAD_TOL
                and basis_grad <= DP_BASIS_GRAD_TOL):
            raise AssertionError(f"{model} {step}: two gloo ranks disagree with one process")
        timing[f"{model} {step}, one process, 32 rows"] = time_steps(torch, cfg, basis, step,
                                                                     batch, n=4)
        del trainer, state
        torch.cuda.empty_cache()
    return timing


def mesh_serving_phase(torch, count_path, run_serve, ServingModel) -> dict:
    """`bin/serve.py --mesh all` for Basis-MelGAN light (every card of this
    machine) against the server without a mesh; then `BatchedSynthesizer`
    over a mesh of two replicas on cuda:0, 3 utterances in one bucket (rows
    padded to 4), against one replica; -> ms of each."""
    from fastvocoder_tpu_torch.hparams import load_model_config
    from fastvocoder_tpu_torch.models.batched import BatchedSynthesizer
    from fastvocoder_tpu_torch.models.factory import load_generator
    from fastvocoder_tpu_torch.parallel import make_mesh

    kernels = ("basis_decode", "fused_resstack")
    serving_phase(count_path, run_serve, ServingModel, "basis-melgan", CKPT, CONF, kernels,
                  mesh=True)
    log("[basis-melgan: BatchedSynthesizer over two replicas on cuda:0]")
    cfg = load_model_config("basis-melgan", CONF)
    replicas = [load_generator(CKPT, cfg, "cuda:0")[0] for _ in range(2)]
    mels = [mel_like_bench(n, 40 + i) for i, n in enumerate((300, 310, 320))]
    two = BatchedSynthesizer([g.inference for g in replicas], HOP, bucket_frames=64,
                             mesh=make_mesh(["cuda:0", "cuda:0"]))
    one = BatchedSynthesizer(replicas[0].inference, HOP, torch.device("cuda:0"), bucket_frames=64)
    got = count_path("two-replica mesh", lambda: two(mels), kernels)
    want = one(mels)
    ms = {}
    for name, synth in (("one replica", one), ("two replicas", two)):
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            synth(mels)  # ends in the copy to the host
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = float(np.median(times[1:]))
    worst = max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))
    log(f"  3 utterances of 300-320 frames (one 320-frame bucket, 4 rows over two replicas): "
        f"{worst:.3e} of the peak from one replica (tol {MESH_TOL:.0e}); ms a call, median of 5: "
        f"{ms}")
    if not worst <= MESH_TOL or any(g.shape != w.shape for g, w in zip(got, want)):
        raise AssertionError("the two-replica mesh disagrees with one replica")
    return ms


def lastlinear_phase(torch) -> None:
    """`LastLinear` at C = 256 on the card against the CPU, on (4, 585, 256)
    inputs: eval mode from seeded running statistics, then two calls in
    train mode (outputs and running statistics)."""
    from fastvocoder_tpu_torch.models.layers import LastLinear

    log("[LastLinear at C = 256: the card against the CPU]")
    torch.manual_seed(0)
    layer = LastLinear(256, 256, 256)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for bn in (layer.bn_1, layer.bn_2):
            bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(256).astype(np.float32)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 256).astype(np.float32)))
    xs = [torch.from_numpy(2 * rng.standard_normal((4, MEL_FRAMES, 256)).astype(np.float32))
          for _ in range(3)]
    cpu, card = layer, copy.deepcopy(layer).cuda()
    worst = {}
    with torch.no_grad():
        for mode, x in (("eval", xs[0]), ("train 1", xs[1]), ("train 2", xs[2])):
            for m in (cpu, card):
                m.train(mode != "eval")
            want, got = cpu(x), card(x.cuda()).cpu()
            worst[mode] = float((got - want).abs().max() / want.abs().max())
    for name, buf in cpu.named_buffers():
        other = dict(card.named_buffers())[name].cpu()
        worst[name] = float((other - buf).abs().max() / buf.abs().max())
    log(f"  the card against the CPU, of each peak: {json.dumps(worst)} (tol {LASTLINEAR_TOL:.0e})")
    if not all(v <= LASTLINEAR_TOL for v in worst.values()):
        raise AssertionError("LastLinear on the card disagrees with the CPU")


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
    log("[kernel 7, the discriminators' grouped convs, against float64]")
    entries += check_grouped_conv(torch)
    log("[the MRF kernels' 3xTF32 against float64]")
    mrf_errors_against_f64(torch, torch.device("cuda"))
    log("[the chain kernels' 3xTF32 against float64]")
    chain_errors_against_f64(torch, torch.device("cuda"))
    del melgan_gen
    torch.cuda.empty_cache()
    launches = {e["name"]: 0 for e in entries}
    path_counts = {}

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
        path_counts[name] = counts
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
        synth = Synthesizer(ckpt, conf, model, compute_dtype=torch.bfloat16)
        profile_inference(torch, synth, mel)
        if model == "hifigan":
            tail_in_one_launch(torch, synth, mel)
    log(f"  rtf by model: {rtfs}")
    mesh_ms = mesh_serving_phase(torch, count_path, run_serve, ServingModel)
    lastlinear_phase(torch)

    torch.cuda.empty_cache()
    step_ms = {}
    with tempfile.TemporaryDirectory() as corpus:
        t0 = time.perf_counter()
        index = write_corpus(corpus, weight_channels=256)
        np.save(os.path.join(corpus, "basis_signal_weight.npy"),
                np.load(os.path.join(ROOT, "dataset", "clean_basis", "basis_signal_weight.npy")))
        log(f"[corpus: 64 seeded utterances of 160-220 frames written in "
            f"{time.perf_counter() - t0:.2f} s]")
        grouped = tuple(GROUPED_NAMES.values())
        hifi_cfg, _, _ = train_phase(torch, count_path, "hifigan", HIFI_CONF, corpus, index, steps=6,
                                  start_steps=2, kernels=("fused_mrf", "fused_mrf_bwd") + grouped)
        # 2 + 2 * 4 generator passes of 4 MRF stages (the validation's come
        # on top), one backward of each stage a step
        if launches["fused_mrf_bwd"] != 4 * 6:
            raise AssertionError(f"6 HiFiGAN steps launched fused_mrf_bwd "
                                 f"{launches['fused_mrf_bwd']} times, want 24")
        # the 18 grouped layers in each of the 4 GAN steps: 4 passes forward,
        # 3 to the input, 2 to the weights (none in the generator's update)
        if [launches[k] for k in grouped] != [4 * 4 * 18, 4 * 3 * 18, 4 * 2 * 18]:
            raise AssertionError(f"4 HiFiGAN GAN steps launched {grouped} "
                                 f"{[launches[k] for k in grouped]} times, want 288, 216, 144")
        batch = fixed_batch(hifi_cfg, index)
        step_against_cpu(torch, hifi_cfg, None, "gan_step", batch)
        log("[ms a step on the card]")
        step_ms["hifigan gan_step"] = time_steps(torch, hifi_cfg, None, "gan_step", batch,
                                                 profile=True)
        # profiled beside its bf16 form below: device busy and idle of both
        step_ms["hifigan pre_adv_step"] = time_steps(torch, hifi_cfg, None, "pre_adv_step", batch,
                                                     profile=True)
        torch.cuda.empty_cache()

        seen = dict(launches)
        basis_cfg, basis, basis_history = train_phase(
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
        melgan_cfg, _, _ = train_phase(
            torch, count_path, "melgan", MELGAN_CONF, corpus, index, steps=4, start_steps=2,
            kernels=("fused_resstack", "fused_resstack_bwd") + grouped, use_mpd=True)
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

        nhv_cfg, _, _ = train_phase(torch, count_path, "nhv", NHV_CONF, corpus, index, steps=2,
                                 start_steps=2, kernels=())
        log("[ms a step on the card]")
        step_ms["nhv pre_adv_step"] = time_steps(torch, nhv_cfg, None, "pre_adv_step",
                                                 fixed_batch(nhv_cfg, index))
        torch.cuda.empty_cache()

        # bf16 mixed-precision training (--mixprecision 1): the bf16 forms,
        # forward and backward, and no float32 form of any kernel
        bf16 = torch.bfloat16
        f32_kernels = ("basis_decode", "fused_resstack", "fused_resstack_bwd", "fused_mrf",
                       "fused_mrf_bwd") + grouped
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
        torch.cuda.empty_cache()

        # --fused_train 0: the generator's stages through the modules' cuDNN convs
        step_ms["--fused_train 0 against 1"] = fused_train_phase(
            torch, count_path, path_counts, corpus, index, hifi_cfg, basis_cfg, basis, melgan_cfg)

        # the training runtime: input paths, remat, resume (reference layout)
        step_ms["basis-melgan pre_adv_step by input path (ms, H2D bytes)"] = input_paths_phase(
            torch, count_path, corpus, index, basis_cfg, basis)
        torch.cuda.empty_cache()
        step_ms["hifigan gan_step without / with remat"] = remat_phase(
            torch, count_path, hifi_cfg, fixed_batch(hifi_cfg, index))
        step_ms["hifigan checkpoint save (ms)"] = resume_phase(torch, count_path, Synthesizer,
                                                               corpus, index)
        torch.cuda.empty_cache()
        # data parallelism on the one card: a one-rank NCCL group, two gloo ranks
        dp_nccl_phase(corpus, index, basis_history,
                      path_counts["basis-melgan training (bin/train.py)"], launches)
        step_ms["data parallel (ms a step)"] = dp_gloo_phase(torch, corpus, index, launches)
    log(f"  ms a step: {step_ms}")
    log(f"  ms a call of the two-replica mesh against one replica: {mesh_ms}")

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        pipeline = pipeline_phase(torch, count_path, work)
    log(f"  pipeline: {json.dumps(pipeline)}")
    for e in entries:
        if e["name"] in ("basis_decode", "fused_resstack"):
            e["publish"] = {k: v for k, v in pipeline["long_launches"].items()
                            if k.startswith(e["name"])}

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
    if sys.argv[1:2] == ["--h2d"]:
        sys.exit(h2d_child(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--dp-train"]:
        sys.exit(dp_train_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--dp-steps"]:
        sys.exit(dp_steps_child(sys.argv[2]))
    sys.exit(main())
