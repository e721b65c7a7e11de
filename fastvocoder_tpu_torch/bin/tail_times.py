"""Times of the HiFiGAN tail (kernel 6) and the Basis-MelGAN decode
(kernel 1) of the package in any checkout, on one NVIDIA GPU.

    python3 fastvocoder_tpu_torch/bin/tail_times.py --root <checkout> --label <name>
        [--parts tail,decode] [--rtf N]

Run as a file, once per checkout: it puts `--root` first on the module path
and imports that checkout's `fastvocoder_tpu_torch`, so two commits (for
example the parent unpacked with `git archive` under `build/`) are compared
in one call by running it on each in turns.  On HiFiGAN light's release
weights (that checkout's `docs/checkpoints/`) it prints:

  * the tail at (1, 70200, 32), a 585-frame utterance, with a kept
    `TailTable` where the checkout has one, and the device time of one call
    by kernel name (torch.profiler);
  * kernel 4 (`fused_mrf_stage_cuda`, its swapped weights kept) at
    (1, 140400, 16) on the tail's own MRF blocks: the same contraction as
    the tail's pair launches;
  * the host time of one tail wrapper call at (1, 64, 32), the device idle
    when it starts (median of 60), with the operands checked (and packed)
    on every call and with a kept table, in float32 (kernel 6) and bf16
    (6b), and the bf16 form's device time at (1, 70200, 32) by kernel;
  * a bf16 HiFiGAN light inference (`Synthesizer.test_rtf` of a seeded
    585-frame mel): the host time to issue one call, the device idle when
    it starts (median of 30), and the wall time a call of 10 under
    torch.profiler, synchronized at the end, as `chip_smoke.py`'s profile
    takes it;
  * the decode at (1, 9360, 256) and (32, 2240, 256), float32 (kernel 1)
    and bf16 (1b), with `conv_transpose1d` in the same type on the same
    inputs beside it: CUDA events over a loop of calls, which at batch 1
    time the host's work to issue a call, and the device time of a call
    (torch.profiler); a digest of the float32 form's output, the bf16
    form's error against the plain version run in float64 on the same bf16
    input (of its peak) beside the plain bf16 version's; and the host time
    of one decode wrapper call at (1, 9360, 256);
  * with `--rtf N`, N runs each of the RTF protocol (`bin/test.py`) for
    Basis-MelGAN light and HiFiGAN light on their release checkpoints, over
    the four seeded utterances `chip_smoke.py` uses (585, 585, 320 and 700
    frames): the end-to-end metric the two kernels' host and device time
    feed.

`--parts` keeps the tail's lines (`tail`) or the decode's (`decode`).
CUDA events, L2 not flushed.
"""

import argparse
import hashlib
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def tail_lines(torch, ft, fm, ops, kept, label, ms, host_us, by_name) -> None:
    """Kernel 6 and kernel 4 on the tail's MRF (module docstring)."""
    x = 0.3 * torch.randn(1, 70200, 32, device="cuda")
    kw = {"table": ft.TailTable(*ops, x.device)} if kept else {}
    t = ms(lambda: ft.fused_hifigan_tail_cuda(x, *ops, **kw), 20, 3)
    print(f"{label} tail (1, 70200, 32): {t:.4f} ms", flush=True)
    for name, v in sorted(by_name(lambda: ft.fused_hifigan_tail_cuda(x, *ops, **kw)).items(),
                          key=lambda kv: -kv[1]):
        print(f"{label}   {v:.4f} ms  {name[:100]}", flush=True)

    blocks = ops[4]
    swapped = fm.swap_channels(blocks)
    h = 0.3 * torch.randn(1, 140400, 16, device="cuda")
    t = ms(lambda: fm.fused_mrf_stage_cuda(h, blocks, swapped), 20, 3)
    print(f"{label} kernel 4 at (1, 140400, 16), the tail's MRF: {t:.4f} ms", flush=True)

    xs = 0.3 * torch.randn(1, 64, 32, device="cuda")
    line = (f"{label} tail host us a call at (1, 64, 32): operands each call "
            f"{host_us(lambda: ft.fused_hifigan_tail_cuda(xs, *ops)):.1f}")
    if kept:
        table = ft.TailTable(*ops, xs.device)
        line += (", kept table "
                 f"{host_us(lambda: ft.fused_hifigan_tail_cuda(xs, *ops, table=table)):.1f}")
    print(line, flush=True)

    bf = torch.bfloat16
    xb = x.to(bf)
    table = ft.TailTable(*ops, x.device, bf)
    parts = by_name(lambda: ft.fused_hifigan_tail_bf16_cuda(xb, *ops, table=table))
    print(f"{label} bf16 tail (1, 70200, 32): device {sum(parts.values()):.4f} ms" + "".join(
        f"; {v:.4f} ms {name[:60]}" for name, v in sorted(parts.items(), key=lambda kv: -kv[1])),
        flush=True)
    xs = xs.to(bf)
    table = ft.TailTable(*ops, xs.device, bf)
    print(f"{label} bf16 tail host us a call at (1, 64, 32): operands each call "
          f"{host_us(lambda: ft.fused_hifigan_tail_bf16_cuda(xs, *ops)):.1f}, kept table "
          f"{host_us(lambda: ft.fused_hifigan_tail_bf16_cuda(xs, *ops, table=table)):.1f}",
          flush=True)


def inference_lines(torch, root, label, host_us) -> None:
    """A bf16 HiFiGAN light inference's host times (module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from fastvocoder_tpu_torch.bin.synthesize import Synthesizer

    synth = Synthesizer(os.path.join(root, "docs", "checkpoints", "hifigan_light_clean2.npz"),
                        os.path.join(root, "conf", "hifigan", "light.yaml"), "hifigan",
                        compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)  # as chip_smoke.py's mel_like_bench(585, 0)
    mel = np.clip(0.5 + 0.25 * rng.standard_normal((585, 80)), 0.0, 1.0).astype(np.float32)
    median = host_us(lambda: synth.test_rtf(mel), 30) / 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        for _ in range(10):
            synth.test_rtf(mel)
        torch.cuda.synchronize()
        profiled = (time.perf_counter() - t0) * 1e2
    print(f"{label} bf16 HiFiGAN light inference of 585 frames: host {median:.4f} ms to issue "
          f"a call (median of 30), wall {profiled:.4f} ms a call under torch.profiler (10)",
          flush=True)


def decode_lines(torch, bd, label, ms, host_us, by_name) -> None:
    """Kernels 1 and 1b beside `conv_transpose1d` (module docstring)."""
    g = torch.Generator().manual_seed(1)
    basis = (0.1 * torch.randn(30, 256, generator=g)).cuda()
    forms = [("float32", torch.float32, bd.basis_decode_cuda)]
    if hasattr(bd, "basis_decode_bf16_cuda"):
        forms.append(("bf16", torch.bfloat16, bd.basis_decode_bf16_cuda))
    for B, F in ((1, 9360), (32, 2240)):
        w32 = torch.relu(torch.randn(B, F, 256, generator=g)).cuda()
        for form, dtype, fn in forms:
            w, b = w32.to(dtype), basis.to(dtype)
            wt = w.transpose(1, 2)
            kernel = b.t()[:, None, :].contiguous()  # (C, 1, L) for conv_transpose1d
            t = ms(lambda: fn(w, b), 100, 10)
            lib = ms(lambda: torch.nn.functional.conv_transpose1d(wt, kernel, stride=15), 100, 10)
            dev_k = sum(by_name(lambda: fn(w, b), 20).values())
            dev_l = sum(by_name(lambda: torch.nn.functional.conv_transpose1d(
                wt, kernel, stride=15), 20).values())
            out = fn(w, b)
            if form == "float32":
                digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
                what = f"output digest {digest}"
            else:
                y64 = bd.basis_decode_plain(w.double(), b.double())
                peak = y64.abs().max().item()
                err = (out.double() - y64).abs().max().item() / peak
                err_plain = (bd.basis_decode_plain(w, b).double() - y64).abs().max().item() / peak
                what = (f"against float64 {err:.3e} of the peak (plain bf16 "
                        f"{err_plain:.3e})")
            print(f"{label} decode {form} ({B}, {F}, 256): {t:.4f} ms a call, device "
                  f"{dev_k:.4f} ms; conv_transpose1d {lib:.4f} ms a call, device "
                  f"{dev_l:.4f} ms; {what}", flush=True)
    w = torch.relu(torch.randn(1, 9360, 256, generator=g)).cuda()
    print(f"{label} decode host us a call at (1, 9360, 256): "
          f"{host_us(lambda: bd.basis_decode_cuda(w, basis)):.1f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--rtf", type=int, default=0, help="runs of the RTF protocol per model")
    ap.add_argument("--parts", default="tail,decode")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    sys.path.insert(0, args.root)
    import torch

    from fastvocoder_tpu_torch.bin.test import run_test
    from fastvocoder_tpu_torch.hparams import load_model_config
    from fastvocoder_tpu_torch.models.factory import load_generator
    from fastvocoder_tpu_torch.ops import _build
    from fastvocoder_tpu_torch.ops import basis_decode as bd
    from fastvocoder_tpu_torch.ops import fused_mrf as fm
    from fastvocoder_tpu_torch.ops import fused_tail as ft

    if not torch.cuda.is_available():
        print("tail_times: CUDA is not available", file=sys.stderr)
        return 2
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{args.label} card: {smi}", flush=True)

    def ms(fn, iters, warmup):
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

    def by_name(fn, n=10):
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
                out[e.name] = out.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
        return {k: v / 1e3 / n for k, v in out.items()}

    root = os.path.abspath(args.root)
    cfg = load_model_config("hifigan", os.path.join(root, "conf", "hifigan", "light.yaml"))
    gen, _ = load_generator(os.path.join(root, "docs", "checkpoints", "hifigan_light_clean2.npz"),
                            cfg, torch.device("cuda"))
    ops = gen.tail_operands()
    kept = hasattr(ft, "TailTable")
    with torch.inference_mode():
        if "tail" in parts:
            tail_lines(torch, ft, fm, ops, kept, args.label, ms, host_us, by_name)
        if "decode" in parts:
            decode_lines(torch, bd, args.label, ms, host_us, by_name)
    if "tail" in parts:  # a served model's parameters are no inference tensors
        inference_lines(torch, root, args.label, host_us)

    with tempfile.TemporaryDirectory() as d:
        for i, frames in enumerate((585, 585, 320, 700)):
            rng = np.random.default_rng(10 + i)  # as chip_smoke.py's mel_like_bench
            mel = np.clip(0.5 + 0.25 * rng.standard_normal((frames, 80)), 0.0, 1.0)
            np.save(os.path.join(d, f"utt{i}.npy"), mel.astype(np.float32).T)
        for model, ckpt, conf in (
                ("basis-melgan", "basis_melgan_clean2.npz", "basis-melgan/light.yaml"),
                ("hifigan", "hifigan_light_clean2.npz", "hifigan/light.yaml")):
            rtfs = [run_test(["--checkpoint_path", os.path.join(root, "docs", "checkpoints", ckpt),
                              "--file_path", d, "--config", os.path.join(root, "conf", conf),
                              "--model_name", model]) for _ in range(args.rtf)]
            if rtfs:
                print(f"{args.label} {model} rtf: " + ", ".join(f"{r:.4e}" for r in rtfs),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
