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

    python3 -m fastvocoder_tpu_torch.bin.tile_variants --bf16-forward [--once]
        [--variants <name>,...]

times the blocks of the bf16 forward forms 2b, 4b and 6b instead
(`BF16_VARIANTS`: warpgroups over the rows, ring stages and slab bytes of
`TileBf16Pair<C>` and `TileBf16Stack<C>` in `csrc/mma_common.cuh`, by
width).  Each variant is a copy of the package under
`build/tile_variants/<name>/` with its three forward sources and those
lines changed (`conf/` and `docs/` linked),
built in parallel; then `bin/chain_times.py --parts bf16_forward` runs on
each in turns (in the order listed and back again, or once with `--once`)
and prints, per shape, device ms, share of the bf16 bound and error against
float64.  `--probes` adds `BF16_PROBES`: builds that skip the weights'
copies or the products on purpose (their results are wrong), to show what
a call's time is made of.

    python3 -m fastvocoder_tpu_torch.bin.tile_variants --one-launch [--once]
        [--variants <name>,...]

does the same for the bf16 tail's one launch (`tail_fused_bf16_kernel`,
`csrc/fused_tail.cu`) and the bf16 decode on the tensor cores
(`basis_decode_wgmma_bf16_kernel`, `csrc/basis_decode.cu`):
`ONE_LAUNCH_VARIANTS`, edits of those two sources, and with `--probes`
`ONE_LAUNCH_PROBES`, each timed by `bin/chain_times.py --parts bf16_forward
--forms 6b` (the tail's) or `bin/tail_times.py --parts decode` (the
decode's), the shipped build by both.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

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


# Edits (old, new) of mma_common.cuh that variants and probes make
_WIDE = ("kSlabBytes = 32768, kCost = 5;", "kSlabBytes = 32768, kCost = 100;")
_COPIES = ("    load_slab<C, THREADS, bf16, false, kU>(ring + (s + ST - 2) % ST * kSlabElems, "
           "W, K,\n                                           s + ST - 2);",
           "    cp_async_commit();")
_PRODUCTS = ("WgmmaBf16<G::kNW>::run(acc,", "if (K < 0) WgmmaBf16<G::kNW>::run(acc,")
_BARRIER = ("    __syncthreads();  // slab s has landed; every warpgroup is done with slab "
            "s - 2", "")
_STAGING = [(f"  stage<C, THREADS>(tile, rs, src, T, {rows}",
             f"  if (is_bf16<E>() && T < 0) stage<C, THREADS>(tile, rs, src, T, {rows}")
            for rows in ("q0 - m, no + 2 * m,", "u_lo - m1, nu + 2 * m1,")]
_EMPTY = ("  E* tile = smem_base<C>(smem);\n  E* ring = tile + tile_rows * G::kSA;\n"
          "  const int rs = tile_stride<C>(tile_rows);  // the bf16 tile's (`tile_at`)\n"
          "  float acc[G::kNT][4];\n",
          "  if (is_bf16<E>() && T > 0) return;\n  E* tile = smem_base<C>(smem);\n"
          "  E* ring = tile + tile_rows * G::kSA;\n"
          "  const int rs = tile_stride<C>(tile_rows);  // the bf16 tile's (`tile_at`)\n"
          "  float acc[G::kNT][4];\n")
_WIDE_C = (("Stack", 128), ("Stack", 256), ("Pair", 128), ("Pair", 256))
_NARROW_C = (("Stack", 32), ("Stack", 64), ("Pair", 16), ("Pair", 32), ("Pair", 64))

# name -> {(kind, C): (WM, ST, slab bytes)} over the shipped TileBf16Pair
# (kind "Pair": 4b, 6b) and TileBf16Stack ("Stack": 2b) of mma_common.cuh,
# or a list of edits of it; the first, {}, is the shipped one
BF16_VARIANTS = {
    "shipped": {},
    "C>=128 ST 5": {k: (None, 5, None) for k in _WIDE_C},
    "C>=128 ST 3": {k: (None, 3, None) for k in _WIDE_C},
    "C<=64 ST 3": {k: (None, 3, None) for k in _NARROW_C},
    "C<=64 slab 32K": {k: (None, None, 32768) for k in _NARROW_C if k[1] > 16},
    "Stack C256 64-row blocks only": [_WIDE],
    "Pair C128 WM 1": {("Pair", 128): (1, None, None)},
    "Pair C64 WM 2": {("Pair", 64): (2, None, None)},
    "Pair C32 WM 2": {("Pair", 32): (2, None, None)},
}
# Probes that break the kernels' results on purpose, to see what their time
# is made of: edits of mma_common.cuh, on the shipped tiles
BF16_PROBES = {
    "probe: no weight copies": [_COPIES],
    "probe: no products": [_PRODUCTS],
    "probe: loop alone": [_COPIES, _PRODUCTS],
    "probe: loop alone, no slab barrier": [_COPIES, _PRODUCTS, _BARRIER],
    "probe: loop alone, no staging": [_COPIES, _PRODUCTS] + _STAGING,
    "probe: empty stack body": [_EMPTY],
}
BF16_SOURCES = ("fused_resstack.cu", "fused_mrf.cu", "fused_tail.cu")


# The `--one-launch` mode: name -> {source: [(old, new), ...]}; the first,
# {}, is the shipped build.  The variants are choices the redesign of these
# two kernels measured; the probes break the results on purpose.
_TAIL_WM = ("constexpr int kWM = 6;             // warpgroups over the rows\n"
            "constexpr int kThreads = 128 * kWM;\n"
            "constexpr int kMaxB = 2;  ", "constexpr int kWM = 4;\n"
            "constexpr int kThreads = 128 * kWM;\nconstexpr int kMaxB = 3;  ")
_DECODE_GROUPS = "constexpr int kGroups = 4; "
_TAIL_PACK = [
    ("  return fvt_mma::unpack_bf16x2(fvt_mma::pack_bf16x2(v0, v1));\n",
     "  return make_float2(__uint_as_float(rn_bits(v0)), __uint_as_float(rn_bits(v1)));\n"),
    ("__device__ __forceinline__ float2 rounded(",
     "__device__ __forceinline__ uint32_t rn_bits(float v) {\n"
     "  const uint32_t b = __float_as_uint(v);\n"
     "  return (b + 0x7FFFu + ((b >> 16) & 1u)) & 0xFFFF0000u;\n}\n"
     "__device__ __forceinline__ uint32_t pack2(float v0, float v1) {\n"
     "  return (rn_bits(v0) >> 16) | rn_bits(v1);\n}\n"
     "__device__ __forceinline__ float2 rounded("),
    ("  return fvt_mma::pack_bf16x2(fmaxf(v.x, v.x * slope), fmaxf(v.y, v.y * slope));",
     "  return pack2(fmaxf(v.x, v.x * slope), fmaxf(v.y, v.y * slope));"),
    ("  return fvt_mma::pack_bf16x2(f.x + b.x, f.y + b.y);", "  return pack2(f.x + b.x, f.y + b.y);"),
    ("ok ? fvt_mma::pack_bf16x2(acc[i][j][2 * half], acc[i][j][2 * half + 1]) : 0u;",
     "ok ? pack2(acc[i][j][2 * half], acc[i][j][2 * half + 1]) : 0u;"),
]
ONE_LAUNCH_VARIANTS = {
    "shipped": {},
    "tail: 4 warpgroups": {"fused_tail.cu": [_TAIL_WM]},
    # the epilogues' bf16 rounding in integer operations, the same bits
    "tail: integer rounding": {"fused_tail.cu": _TAIL_PACK},
    "decode: 2 copy groups": {"basis_decode.cu": [
        (_DECODE_GROUPS, "constexpr int kGroups = 2; ")]},
    "decode: 1 copy group": {"basis_decode.cu": [
        (_DECODE_GROUPS, "constexpr int kGroups = 1; ")]},
}
ONE_LAUNCH_PROBES = {
    "probe: tail without the MRF products": {"fused_tail.cu": [
        ("      WgmmaBf16<kC>::run(acc[i], a0[i] + static_cast<uint64_t>(k * step),\n"
         "                         b0 + static_cast<uint64_t>(k * (kUnit / 8)));\n", "")]},
    "probe: tail without the per-row passes": {"fused_tail.cu": [
        ("      for (int j = 0; j < 2; ++j) fn(i, half, j, r, 8 * j + 2 * ln.t);",
         "      (void)fn;")]},
    "probe: decode without products": {"basis_decode.cu": [
        ("      issue_products<N>(part[g], a0, b0, lay.rsa, lay.rsb, c_lo / 2,\n"
         "                        min(c_lo + lay.per_group, lay.cols) / 2);\n", "")]},
    "probe: decode without weight rows": {"basis_decode.cu": [
        ("      stage_cols(ring + q * lay.cols * lay.rsa, lay.rsa, w + static_cast<size_t>(b) * F"
         " * C, F,\n                 f0 - 1, kRowsA, C, c_lo, c_hi);\n",
         "      (void)b;\n      (void)f0;\n")]},
    "probe: decode without the basis": {"basis_decode.cu": [
        ("        stage_cols(bs, lay.rsb, basis, L, 0, N, C, c_lo, c_hi, blockIdx.x % (c_hi - "
         "c_lo));\n", "")]},
}


def _package_copy(out_dir: Path, name: str, sources, edit) -> Path:
    """A copy of the package under out_dir with only `sources` of its
    kernels (and their headers), edit(pkg) applied, `conf/` and `docs/`
    linked; -> its root."""
    from fastvocoder_tpu_torch.ops import _build

    d = out_dir / name.replace(" ", "_").replace(":", "").replace("<=", "le").replace(">=", "ge")
    if d.exists():
        shutil.rmtree(d)
    pkg = d / "fastvocoder_tpu_torch"
    shutil.copytree(_build.PACKAGE_DIR, pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "*.cu", "*.cuh"))
    for src in sources:
        for f in [_build.CSRC / src] + _build.local_includes(_build.CSRC / src):
            shutil.copy(f, pkg / "csrc" / f.name)
    edit(pkg)
    root = Path(_build.PACKAGE_DIR).parent
    for link in ("conf", "docs"):
        (d / link).symlink_to(root / link)
    return d


def _build_copies(roots) -> None:
    """Builds every copy's kernels, all at once."""
    procs = [(name, subprocess.Popen(
        [sys.executable, "-c", "from fastvocoder_tpu_torch.ops import _build; _build.build_all()"],
        cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, d in roots.items()]
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: build failed:\n{log}")


def _replacing(edits):
    """edit(pkg) that applies {source: [(old, new), ...]} to a copy's csrc/."""
    def edit(pkg):
        for src, pairs in edits.items():
            path = pkg / "csrc" / src
            text = path.read_text()
            for old, new in pairs:
                if old not in text:
                    raise RuntimeError(f"{src} no longer holds {old!r}")
                text = text.replace(old, new)
            path.write_text(text)
    return edit


def one_launch_variants(args) -> int:
    """The `--one-launch` mode (module docstring)."""
    from fastvocoder_tpu_torch.ops import _build

    table = {**ONE_LAUNCH_VARIANTS, **(ONE_LAUNCH_PROBES if args.probes else {})}
    names = args.variants.split(",") if args.variants else list(table)
    out_dir = _build.BUILD_DIR.parent / "tile_variants"
    roots = {name: _package_copy(out_dir, name, ("fused_tail.cu", "basis_decode.cu"),
                                 _replacing(table[name])) for name in names}
    _build_copies(roots)
    here = Path(__file__).resolve().parent
    failed = 0
    for i, name in enumerate(names if args.once else names + names[::-1]):
        touched = set(table[name]) or {"fused_tail.cu", "basis_decode.cu"}
        runs = []
        if "fused_tail.cu" in touched:
            runs.append(([str(here / "chain_times.py"), "--parts", "bf16_forward", "--forms",
                          "6b"], lambda line: " 6b " in line))
        if "basis_decode.cu" in touched:
            runs.append(([str(here / "tail_times.py"), "--parts", "decode"],
                         lambda line: "decode bf16" in line))
        for cmd, keep in runs:
            run = subprocess.run([sys.executable, *cmd, "--root", str(roots[name]), "--label",
                                  f"{name} #{i}"], capture_output=True, text=True)
            print("\n".join(line for line in run.stdout.splitlines() if keep(line)), flush=True)
            if run.returncode != 0:
                print(f"{name}: exit {run.returncode}\n{run.stderr[-3000:]}", flush=True)
                failed += 1
    return 1 if failed else 0


def tile_bf16_source(src: str, over) -> str:
    """mma_common.cuh with the TileBf16Pair / TileBf16Stack lines of `over`
    changed."""
    for (kind, C), values in over.items():
        head = f"struct TileBf16{kind}<{C}> {{ static constexpr int "
        if head not in src:
            raise RuntimeError(f"mma_common.cuh no longer holds {head!r}")
        at = src.index(head) + len(head)
        end = src.index(";", at)
        fields = dict(f.strip().split(" = ") for f in src[at:end].split(","))
        for key, v in zip(("kWM", "kST", "kSlabBytes"), values):
            if v is not None:
                fields[key] = str(v)
        src = src[:at] + ", ".join(f"{k} = {v}" for k, v in fields.items()) + src[end:]
    return src


def bf16_forward_variants(args) -> int:
    """The `--bf16-forward` mode (module docstring)."""
    from fastvocoder_tpu_torch.ops import _build

    names = args.variants.split(",") if args.variants else list(BF16_VARIANTS)
    names += list(BF16_PROBES) if args.probes else []
    out_dir = _build.BUILD_DIR.parent / "tile_variants"
    header = (_build.CSRC / "mma_common.cuh").read_text()

    def edit_of(name):
        edits = BF16_PROBES.get(name, BF16_VARIANTS.get(name))
        if isinstance(edits, list):
            return _replacing({"mma_common.cuh": edits})
        return lambda pkg: (pkg / "csrc" / "mma_common.cuh").write_text(
            tile_bf16_source(header, edits))

    roots = {name: _package_copy(out_dir, name, BF16_SOURCES, edit_of(name)) for name in names}
    _build_copies(roots)
    order = names if args.once else names + names[::-1]
    tool = Path(__file__).resolve().parent / "chain_times.py"
    failed = 0
    for i, name in enumerate(order):
        run = subprocess.run([sys.executable, str(tool), "--root", str(roots[name]), "--label",
                              f"{name} #{i}", "--parts", "bf16_forward"],
                             capture_output=True, text=True)
        print("\n".join(line for line in run.stdout.splitlines() if "device" in line or
                        "W" in line[-10:]), flush=True)
        if run.returncode != 0:
            print(f"{name}: chain_times exit {run.returncode}\n{run.stderr[-3000:]}", flush=True)
            failed += 1
    return 1 if failed else 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16-forward", action="store_true")
    ap.add_argument("--one-launch", action="store_true")
    ap.add_argument("--once", action="store_true")
    ap.add_argument("--probes", action="store_true",
                    help="also time BF16_PROBES (ONE_LAUNCH_PROBES)")
    ap.add_argument("--variants", default="",
                    help="names of the mode's variants or probes, comma separated")
    args = ap.parse_args(argv)
    if args.one_launch:
        return one_launch_variants(args)
    if args.bf16_forward:
        return bf16_forward_variants(args)
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
