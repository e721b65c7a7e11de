"""Tile variants of the tail (kernel 6) and decode (kernel 1) kernels, timed
in turns on one NVIDIA GPU.

    python3 -m fastvocoder_tpu_torch.bin.tile_variants

For each variant it copies the kernel's source and headers to
`build/tile_variants/<name>/` with one tile constant changed, compiles them
all at once with the flags of `ops/_build.py`, and loads each library in
place of the built one.  Then, in the order listed and back again, it checks
each variant against the plain version and prints its device time
(torch.profiler, a call's kernels summed) at the main paths' shapes:

  * the tail's pair launches over the warpgroups a block stacks over the
    rows (`WM`) and the slabs of its weight ring (`ST`) at C_out <= 32, on
    HiFiGAN light's release tail at (1, 70200, 32) and a seeded HiFiGAN
    large tail at (1, 70200, 64);
  * the decode's frames a tile (`kRows`), frames a thread (`kFT`), slices
    of the channels (`kSlices`) and ring depth (`kStages`) at
    (1, 9360, 256) and (32, 2240, 256).

The first variant of each list is the shipped one.  This is the loop that
chose the tiles in the sources; `bin/tail_times.py` compares two checkouts.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

TAIL_LAUNCH = ("fvt_mrf::run_pairs<C>(tail_pair_kernel<C, fvt_mma::Tile<C>::kWM, "
               "fvt_mma::Tile<C>::kST>,")
TAIL_VARIANTS = {"tail WM 2 ST 2": (2, 2), "tail WM 4 ST 2": (4, 2), "tail WM 4 ST 3": (4, 3),
                 "tail WM 1 ST 2": (1, 2)}
DECODE_CONSTANTS = ("kRows", "kFT", "kSlices", "kStages")
DECODE_VARIANTS = {"decode R 16 FT 4 S 16 ST 3": (16, 4, 16, 3),
                   "decode R 32 FT 8 S 16 ST 3": (32, 8, 16, 3),
                   "decode R 32 FT 8 S 32 ST 3": (32, 8, 32, 3),
                   "decode R 16 FT 4 S 16 ST 4": (16, 4, 16, 4)}


def tail_source(src: str, wm: int, st: int) -> str:
    if TAIL_LAUNCH not in src:
        raise RuntimeError("fused_tail.cu no longer launches its pairs as this script expects")
    shape = (f"(C <= 32 ? {wm} : fvt_mma::Tile<C>::kWM), "
             f"(C <= 32 ? {st} : fvt_mma::Tile<C>::kST)")
    return src.replace(TAIL_LAUNCH, f"fvt_mrf::run_pairs<C, {shape}>(tail_pair_kernel<C, {shape}>,")


def decode_source(src: str, values) -> str:
    for name, v in zip(DECODE_CONSTANTS, values):
        head = f"constexpr int {name} = "
        at = src.index(head) + len(head)
        src = src[:at] + str(v) + src[src.index(";", at):]
    return src


def main(argv=None) -> int:
    import torch

    from fastvocoder_tpu_torch.hparams import load_model_config
    from fastvocoder_tpu_torch.models.factory import load_generator
    from fastvocoder_tpu_torch.ops import _build
    from fastvocoder_tpu_torch.ops import basis_decode as bd
    from fastvocoder_tpu_torch.ops import fused_tail as ft

    if not torch.cuda.is_available():
        print("tile_variants: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    out_dir = _build.BUILD_DIR.parent / "tile_variants"
    libs, procs = {}, []
    for lib_name, variants, make in (
            ("fused_tail", TAIL_VARIANTS, lambda s, v: tail_source(s, *v)),
            ("basis_decode", DECODE_VARIANTS, decode_source)):
        src = (_build.CSRC / f"{lib_name}.cu").read_text()
        for name, values in variants.items():
            d = out_dir / name.replace(" ", "_")
            d.mkdir(parents=True, exist_ok=True)
            for header in _build.local_includes(_build.CSRC / f"{lib_name}.cu"):
                shutil.copy(header, d)
            (d / f"{lib_name}.cu").write_text(make(src, values))
            libs[name] = (lib_name, d / "lib.so")
            procs.append((name, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                 str(d / f"{lib_name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}:\n{log}")

    def device_ms(fn, n=20):
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return sum(e.time_range.end - e.time_range.start for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n

    root = os.path.dirname(str(_build.PACKAGE_DIR))
    cfg = load_model_config("hifigan", os.path.join(root, "conf", "hifigan", "light.yaml"))
    gen, _ = load_generator(os.path.join(root, "docs", "checkpoints", "hifigan_light_clean2.npz"),
                            cfg, torch.device("cuda"))
    g = torch.Generator().manual_seed(7)

    def u(*shape, fan_in):
        return ((torch.rand(shape, generator=g) * 2 - 1) / np.sqrt(fan_in)).cuda()

    large = (u(4, 64, 32, fan_in=128), u(32, fan_in=128), 2, 1,
             [[(u(K, 32, 32, fan_in=32 * K), u(32, fan_in=32 * K), d,
                u(K, 32, 32, fan_in=32 * K), u(32, fan_in=32 * K)) for d in (1, 3, 5)]
              for K in (3, 7, 11)], u(7, 32, 1, fan_in=224), u(1, fan_in=224))
    tails = [(gen.tail_operands(), 0.3 * torch.randn(1, 70200, 32, device="cuda")),
             (large, 0.3 * torch.randn(1, 70200, 64, device="cuda"))]
    basis = (0.1 * torch.randn(30, 256, generator=g)).cuda()
    weights = [torch.relu(torch.randn(B, F, 256, generator=g)).cuda()
               for B, F in ((1, 9360), (32, 2240))]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    with torch.inference_mode():
        for variants in (TAIL_VARIANTS, DECODE_VARIANTS):
            for name in list(variants) + list(reversed(list(variants))):
                lib_name, path = libs[name]
                _build._libs[lib_name] = ctypes.CDLL(str(path))
                if lib_name == "fused_tail":
                    cols = []
                    for ops, x in tails:
                        table = ft.TailTable(*ops, x.device)
                        err = (ft.fused_hifigan_tail_cuda(x, *ops, table=table)
                               - ft.fused_hifigan_tail_plain(x, *ops)).abs().max().item()
                        t = device_ms(lambda: ft.fused_hifigan_tail_cuda(x, *ops, table=table))
                        cols.append(f"{tuple(x.shape)} {t:.4f} ms (max abs {err:.1e})")
                else:
                    cols = []
                    for w in weights:
                        err = (bd.basis_decode_cuda(w, basis)
                               - bd.basis_decode_plain(w, basis)).abs().max().item()
                        t = device_ms(lambda: bd.basis_decode_cuda(w, basis))
                        cols.append(f"{tuple(w.shape)} {t:.4f} ms (max abs {err:.1e})")
                print(f"{name}: " + ", ".join(cols), flush=True)
    _build._libs.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
