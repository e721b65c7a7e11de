"""Times of the residual-stack chain kernels (2 and 3) and of the MRF
backward (kernel 5) of the package in any checkout, on one NVIDIA GPU.

    python3 fastvocoder_tpu_torch/bin/chain_times.py --root <checkout> --label <name>

Run as a file, once per checkout: it puts `--root` first on the module path
and imports that checkout's `fastvocoder_tpu_torch`, so two commits (for
example the parent unpacked with `git archive` under `build/`) are compared
in one call by running it on each in turns.  With seeded weights at
Basis-MelGAN light's shapes it prints the chain forward at batch 1 and 32
(with a kept `ChainTable` where the checkout has one) and its backward at
batch 32; the host time of one forward wrapper call at (1, 64, 256), the
device idle when it starts (median of 60), with the operands checked and
packed on every call and with a kept table; and the MRF backward at
(32, 1120, 128) and (32, 33600, 16).  CUDA events, L2 not flushed.
"""

import argparse
import sys
import time

import numpy as np


def _seeded(torch, g, *shape, fan_in):
    return ((torch.rand(shape, generator=g) * 2 - 1) / np.sqrt(fan_in)).cuda()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
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

    g = torch.Generator().manual_seed(0)
    C = 256
    stacks = [(_seeded(torch, g, 3, C, C, fan_in=3 * C), _seeded(torch, g, C, fan_in=3 * C), d,
               _seeded(torch, g, 1, C, C, fan_in=C), _seeded(torch, g, C, fan_in=C),
               _seeded(torch, g, 1, C, C, fan_in=C), _seeded(torch, g, C, fan_in=C))
              for d in (1, 3, 9)]
    for B, T in ((1, 2340), (1, 9360), (32, 560), (32, 2240)):
        x = 0.3 * torch.randn(B, T, C, device="cuda")
        kw = {"table": r.ChainTable(stacks, x.device)} if hasattr(r, "ChainTable") else {}
        line = (f"{args.label} ({B}, {T}, {C}): forward "
                f"{ms(lambda: r.fused_residual_stacks_cuda(x, stacks, **kw), 20, 3):.4f} ms")
        if B > 1:
            cot = torch.randn(B, T, C, device="cuda")
            line += (f", backward "
                     f"{ms(lambda: r.fused_residual_stacks_vjp_cuda(x, stacks, cot), 5, 2):.3f} ms")
        print(line, flush=True)

    x = 0.3 * torch.randn(1, 64, C, device="cuda")
    line = (f"{args.label} host us a call at (1, 64, 256): operands each call "
            f"{host_us(lambda: r.fused_residual_stacks_cuda(x, stacks)):.1f}")
    if hasattr(r, "ChainTable"):
        t = r.ChainTable(stacks, x.device)
        line += f", kept table {host_us(lambda: r.fused_residual_stacks_cuda(x, stacks, t)):.1f}"
    print(line, flush=True)

    for B, T, Cm in ((32, 1120, 128), (32, 33600, 16)):
        gm = torch.Generator().manual_seed(Cm)
        blocks = [[(_seeded(torch, gm, K, Cm, Cm, fan_in=Cm * K), _seeded(torch, gm, Cm, fan_in=Cm * K),
                    d, _seeded(torch, gm, K, Cm, Cm, fan_in=Cm * K),
                    _seeded(torch, gm, Cm, fan_in=Cm * K)) for d in (1, 3, 5)] for K in (3, 7, 11)]
        x = 0.3 * torch.randn(B, T, Cm, device="cuda")
        cot = torch.randn(B, T, Cm, device="cuda")
        t = ms(lambda: fm.fused_mrf_stage_vjp_cuda(x, blocks, cot), 3, 1)
        print(f"{args.label} mrf backward ({B}, {T}, {Cm}): {t:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
