"""Times of the two MRF kernels alone, on one NVIDIA GPU.

    python3 -m fastvocoder_tpu_torch.bin.kernel_times [--profile]

Builds the kernels, then times `fused_mrf_stage_cuda` (kernel 4) and
`fused_mrf_stage_vjp_cuda` (kernel 5) with seeded weights at the shapes of
the main paths: HiFiGAN light's three batch-1 stages of a 585-frame
utterance, HiFiGAN large's (1, 4680, 256), and the four stages of a training
batch of 32 crops of 140 frames.  It prints ms and the float32-equivalent
rate (2 FLOP a multiply-add of every conv; a backward is three forwards).
With `--profile` it adds the device time by kernel name of one backward at
C = 128 and C = 16.  `chip_smoke.py` holds the kernels against their plain
versions and measures the paths; this is the short loop for tuning a kernel:
a change of tile or ring is timed here in under a minute.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

SHAPES = ((1, 4680, 128), (1, 23400, 64), (1, 70200, 32), (1, 4680, 256),
          (32, 1120, 128), (32, 5600, 64), (32, 16800, 32), (32, 33600, 16))
KERNELS, DILATIONS = (3, 7, 11), (1, 3, 5)


def seeded_resblocks(torch, C: int, seed: int):
    """ResBlock1 branches with torch's default conv init, from a seed."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan_in):
        return ((torch.rand(shape, generator=g) * 2 - 1) / np.sqrt(fan_in)).cuda()

    return [[(u(K, C, C, fan_in=C * K), u(C, fan_in=C * K), d, u(K, C, C, fan_in=C * K),
              u(C, fan_in=C * K)) for d in DILATIONS] for K in KERNELS]


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

    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--profile", action="store_true")
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 2
    _build.build_all()
    print(torch.cuda.get_device_name(0), flush=True)
    taps = 2 * len(DILATIONS) * sum(KERNELS)
    for B, T, C in SHAPES:
        blocks = seeded_resblocks(torch, C, C)
        swapped = swap_channels(blocks)
        x = 0.3 * torch.randn(B, T, C, device="cuda")
        g = torch.randn(B, T, C, device="cuda")
        flops = 2 * B * T * taps * C * C
        ms = cuda_ms(torch, lambda: fused_mrf_stage_cuda(x, blocks, swapped), 10, 2)
        line = f"({B}, {T}, {C}): forward {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s"
        if B > 1:
            ms = cuda_ms(torch, lambda: fused_mrf_stage_vjp_cuda(x, blocks, g, swapped), 3, 1)
            line += f"; backward {ms:.3f} ms, {3 * flops / ms / 1e9:.1f} TFLOP/s"
        print(line, flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        for B, T, C in ((32, 1120, 128), (32, 33600, 16)):
            blocks = seeded_resblocks(torch, C, C)
            x = 0.3 * torch.randn(B, T, C, device="cuda")
            g = torch.randn(B, T, C, device="cuda")
            fused_mrf_stage_vjp_cuda(x, blocks, g)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fused_mrf_stage_vjp_cuda(x, blocks, g)
                torch.cuda.synchronize()
            print(f"one backward at ({B}, {T}, {C}):")
            print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8,
                                            max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
