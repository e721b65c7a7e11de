"""Times of the tensor-core kernels alone, on one NVIDIA GPU.

    python3 -m fastvocoder_tpu_torch.bin.kernel_times [--only mrf|chain] [--profile]

Builds the kernels, then times, with seeded weights at the shapes of the
main paths: `fused_mrf_stage_cuda` (kernel 4) and `fused_mrf_stage_vjp_cuda`
(kernel 5) at HiFiGAN light's three batch-1 stages of a 585-frame
utterance, its tail's MRF at (1, 140400, 16) (kernel 4 at the shape of the
tail kernel's pair launches), HiFiGAN large's (1, 4680, 256), and the four
stages of a training batch of 32 crops of 140 frames;
`fused_residual_stacks_cuda` (kernel 2, its
packed operands kept as a served model keeps them) and
`fused_residual_stacks_vjp_cuda` (kernel 3) at Basis-MelGAN light's two
batch-1 stages of a 585-frame utterance and its two training stages.  It
prints ms and the float32-equivalent rate (2 FLOP a multiply-add of every
conv; a backward is three forwards).  With `--profile` it adds the device
time by kernel name of one backward at C = 128 and C = 16 (MRF) and of one
chain backward at batch 32.  `chip_smoke.py` holds the kernels against their plain
versions and measures the paths; this is the short loop for tuning a kernel:
a change of tile or ring is timed here in under a minute.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

CHAIN_SHAPES = ((1, 2340, 256), (1, 9360, 256), (32, 560, 256), (32, 2240, 256))
CHAIN_DILATIONS = (1, 3, 9)
SHAPES = ((1, 4680, 128), (1, 23400, 64), (1, 70200, 32), (1, 140400, 16), (1, 4680, 256),
          (32, 1120, 128), (32, 5600, 64), (32, 16800, 32), (32, 33600, 16))
KERNELS, DILATIONS = (3, 7, 11), (1, 3, 5)


def seeded_resblocks(torch, C: int, seed: int):
    """ResBlock1 branches with torch's default conv init, from a seed."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan_in):
        return ((torch.rand(shape, generator=g) * 2 - 1) / np.sqrt(fan_in)).cuda()

    return [[(u(K, C, C, fan_in=C * K), u(C, fan_in=C * K), d, u(K, C, C, fan_in=C * K),
              u(C, fan_in=C * K)) for d in DILATIONS] for K in KERNELS]


def seeded_stacks(torch, C: int, seed: int, K: int = 3):
    """Residual stacks with torch's default conv init, from a seed."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan_in):
        return ((torch.rand(shape, generator=g) * 2 - 1) / np.sqrt(fan_in)).cuda()

    return [(u(K, C, C, fan_in=C * K), u(C, fan_in=C * K), d, u(1, C, C, fan_in=C),
             u(C, fan_in=C), u(1, C, C, fan_in=C), u(C, fan_in=C)) for d in CHAIN_DILATIONS]


def cuda_ms(torch, fn, iters: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    import torch

    from fastvocoder_tpu_torch.ops import _build
    from fastvocoder_tpu_torch.ops.fused_mrf import (
        fused_mrf_stage_cuda,
        fused_mrf_stage_vjp_cuda,
        swap_channels,
    )
    from fastvocoder_tpu_torch.ops.fused_resstack import (
        ChainTable,
        fused_residual_stacks_cuda,
        fused_residual_stacks_vjp_cuda,
    )

    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--only", choices=("mrf", "chain"))
    args.add_argument("--profile", action="store_true")
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 2
    _build.build_all()
    print(torch.cuda.get_device_name(0), flush=True)
    taps = 2 * len(DILATIONS) * sum(KERNELS)
    for B, T, C in SHAPES if args.only != "chain" else ():
        blocks = seeded_resblocks(torch, C, C)
        swapped = swap_channels(blocks)
        x = 0.3 * torch.randn(B, T, C, device="cuda")
        g = torch.randn(B, T, C, device="cuda")
        flops = 2 * B * T * taps * C * C
        ms = cuda_ms(torch, lambda: fused_mrf_stage_cuda(x, blocks, swapped), 10, 2)
        line = f"({B}, {T}, {C}): forward {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s"
        if B > 1:
            ms = cuda_ms(torch, lambda: fused_mrf_stage_vjp_cuda(x, blocks, g), 3, 1)
            line += f"; backward {ms:.3f} ms, {3 * flops / ms / 1e9:.1f} TFLOP/s"
        print(line, flush=True)
    for B, T, C in CHAIN_SHAPES if args.only != "mrf" else ():
        stacks = seeded_stacks(torch, C, C)
        table = ChainTable(stacks, torch.device("cuda"))
        x = 0.3 * torch.randn(B, T, C, device="cuda")
        g = torch.randn(B, T, C, device="cuda")
        flops = 2 * B * T * len(stacks) * (stacks[0][0].shape[0] + 2) * C * C
        ms = cuda_ms(torch, lambda: fused_residual_stacks_cuda(x, stacks, table), 10, 2)
        line = f"chain ({B}, {T}, {C}): forward {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s"
        if B > 1:
            ms = cuda_ms(torch, lambda: fused_residual_stacks_vjp_cuda(x, stacks, g), 3, 1)
            line += f"; backward {ms:.3f} ms, {3 * flops / ms / 1e9:.1f} TFLOP/s"
        print(line, flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        runs = []
        for B, T, C in ((32, 1120, 128), (32, 33600, 16)) if args.only != "chain" else ():
            blocks = seeded_resblocks(torch, C, C)
            x = 0.3 * torch.randn(B, T, C, device="cuda")
            g = torch.randn(B, T, C, device="cuda")
            runs.append(((B, T, C), lambda x=x, blocks=blocks, g=g:
                         fused_mrf_stage_vjp_cuda(x, blocks, g)))
        for B, T, C in ((32, 2240, 256),) if args.only != "mrf" else ():
            stacks = seeded_stacks(torch, C, C)
            x = 0.3 * torch.randn(B, T, C, device="cuda")
            g = torch.randn(B, T, C, device="cuda")
            runs.append(((B, T, C), lambda x=x, stacks=stacks, g=g:
                         fused_residual_stacks_vjp_cuda(x, stacks, g)))
        for shape, fn in runs:
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            print(f"one backward at {shape}:")
            print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=10,
                                            max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
