"""Times of the tensor-core kernels alone, on one NVIDIA GPU.

    python3 -m fastvocoder_tpu_torch.bin.kernel_times [--only mrf|chain|disc] [--profile]
        [--disc-parts kernel,plain,cudnn,cudnn_autotuned] [--json PATH]

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

`--only disc` times kernel 7 (`ops/grouped_conv.py`): the forward, input
gradient and weight gradient of each of the default discriminator's 18
grouped downsample convs at the GAN cell's shapes (32 crops of 33,600
samples), as the kernels, as the plain versions, through cuDNN as the port
ran these convs before the kernels (transposed views, `F.conv1d` and its
`convolution_backward`) and through cuDNN autotuned
(`torch.backends.cudnn.benchmark` on, here only, never in the port), with
TF32 off as the benchmark's cells; each beside its bounds, the sums over a
`gan_step` (each layer's forward 4 times, input gradient 3 times, weight
gradient twice: `DISC_PASSES`) and, with `--profile`, the cuDNN kernels each
pass launches.
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
DISC_CROPS, DISC_SAMPLES = 32, 33600  # the GAN cell's batch: 32 crops of 140 frames of hop 240
DISC_PASSES = (("forward", 4), ("dgrad", 3), ("wgrad", 2))  # a gan_step's passes of each layer
DISC_PARTS = ("kernel", "plain", "cudnn", "cudnn_autotuned")
PEAK_F32, PEAK_TF32, PEAK_BYTES = 67e12, 495e12, 3.35e12  # H100 SXM at 700 W


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


def disc_layers(torch, B: int = DISC_CROPS, samples: int = DISC_SAMPLES):
    """[(name, x shape, weight shape, stride, padding)] of the grouped convs
    of the default discriminator (MSD and MFD at `hparams.DISC`) on B crops
    of `samples`, read by hooks on one forward of one crop on the CPU."""
    from fastvocoder_tpu_torch.models.factory import build_discriminator
    from fastvocoder_tpu_torch.models.layers import Conv1d

    disc, layers, hooks = build_discriminator(), [], []
    for name, m in disc.named_modules():
        if isinstance(m, Conv1d) and m.groups > 1:
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: layers.append(
                    (name, (B,) + tuple(inp[0].shape[1:]), tuple(mod.weight.shape), mod.stride,
                     mod.padding))))
    with torch.no_grad():
        disc(torch.zeros(1, samples))
    for h in hooks:
        h.remove()
    return layers


def disc_bounds(x_shape, w_shape, stride: int, padding: int):
    """{pass: (bound ms on the CUDA cores, bound ms in 3xTF32)}: the
    operations (2 a multiply-add) or the bytes (each input read, each output
    written once), whichever takes longer."""
    from fastvocoder_tpu_torch.ops.grouped_conv import out_length

    B, T, cin = x_shape
    cout, _, K = w_shape
    T_out = out_length(T, K, stride, padding)
    flops = 2 * B * T_out * cout * 4 * K
    t_bytes = (B * T * cin + B * T_out * cout + cout * 4 * K + cout) * 4 / PEAK_BYTES
    bound = (max(flops / PEAK_F32, t_bytes) * 1e3, max(3 * flops / PEAK_TF32, t_bytes) * 1e3)
    return {name: bound for name, _ in DISC_PASSES}  # each pass reads and writes the same


def disc_passes(torch, part: str, x, w, b, dy, stride: int, padding: int):
    """{pass: a call computing it} for one layer as `part` computes it."""
    import torch.nn.functional as F

    from fastvocoder_tpu_torch.ops import grouped_conv as gc

    K, G = w.shape[2], x.shape[2] // 4
    if part == "kernel":
        return {"forward": lambda: gc.grouped_conv1d_cuda(x, w, b, stride, padding),
                "dgrad": lambda: gc.grouped_conv1d_dx_cuda(dy, w, x.shape, stride, padding),
                "wgrad": lambda: gc.grouped_conv1d_dw_cuda(x, dy, K, stride, padding)}
    if part == "plain":
        return {"forward": lambda: gc.grouped_conv1d_plain(x, w, b, stride, padding),
                "dgrad": lambda: gc.grouped_conv1d_dx_plain(dy, w, x.shape, stride, padding),
                "wgrad": lambda: gc.grouped_conv1d_dw_plain(x, dy, K, stride, padding)}
    xt, dyt = x.transpose(1, 2), dy.transpose(1, 2)

    def backward(mask):
        return torch.ops.aten.convolution_backward(
            dyt, xt, w, [w.shape[0]], [stride], [padding], [1], False, [0], G, mask)

    return {"forward": lambda: F.conv1d(xt, w, b, stride=stride, padding=padding,
                                        groups=G).transpose(1, 2).contiguous(),
            "dgrad": lambda: backward([True, False, False]),
            "wgrad": lambda: backward([False, True, True])}


def device_kernels(torch, fn):
    """The names of the kernels one call of fn launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages() if e.self_device_time_total > 0})


def disc_times(torch, parts, profile_kernels: bool):
    """{layer: {part: {pass: ms}}} and the bounds, printed as they come."""
    from fastvocoder_tpu_torch.ops.grouped_conv import out_length

    layers = disc_layers(torch)
    gen = torch.Generator().manual_seed(7)
    table = {}
    for name, x_shape, w_shape, stride, padding in layers:
        B, T, _ = x_shape
        T_out = out_length(T, w_shape[2], stride, padding)
        x = torch.randn(x_shape, generator=gen).cuda()
        w = (torch.randn(w_shape, generator=gen) / np.sqrt(4 * w_shape[2])).cuda()
        b = (0.1 * torch.randn(w_shape[0], generator=gen)).cuda()
        dy = torch.randn(B, T_out, w_shape[0], generator=gen).cuda()
        row = {"x": list(x_shape), "weight": list(w_shape), "stride": stride,
               "padding": padding, "bounds": disc_bounds(x_shape, w_shape, stride, padding)}
        for part in parts:
            tuned = part == "cudnn_autotuned"
            row[part] = {}
            for pname, fn in disc_passes(torch, part, x, w, b, dy, stride, padding).items():
                was = torch.backends.cudnn.benchmark
                torch.backends.cudnn.benchmark = tuned
                try:
                    row[part][pname] = cuda_ms(torch, fn, 5, 2)
                    if profile_kernels and part.startswith("cudnn"):
                        row[part][pname + "_kernels"] = device_kernels(torch, fn)
                finally:
                    torch.backends.cudnn.benchmark = was
        table[name] = row
        print(name, x_shape, "->", (B, T_out, w_shape[0]), " ".join(
            f"{part}: " + ", ".join(f"{p} {row[part][p]:.4f}" for p, _ in DISC_PASSES)
            for part in parts), "bound f32/3xtf32: " + ", ".join(
            f"{p} {row['bounds'][p][0]:.4f}/{row['bounds'][p][1]:.4f}" for p, _ in DISC_PASSES),
            flush=True)
        if profile_kernels:
            for part in parts:
                for p, _ in DISC_PASSES:
                    if p + "_kernels" in row[part]:
                        print(f"  {part} {p}: {row[part][p + '_kernels']}", flush=True)
    step = {part: sum(n * row[part][p] for row in table.values() for p, n in DISC_PASSES)
            for part in parts}
    step["bound_f32"] = sum(n * row["bounds"][p][0] for row in table.values()
                            for p, n in DISC_PASSES)
    step["bound_3xtf32"] = sum(n * row["bounds"][p][1] for row in table.values()
                               for p, n in DISC_PASSES)
    by_pass = {part: {p: sum(row[part][p] for row in table.values()) for p, _ in DISC_PASSES}
               for part in parts}
    print("one of each pass over the 18 layers (ms):", by_pass)
    print("a gan_step's passes (4 forward, 3 input, 2 weight gradients) summed (ms):", step,
          flush=True)
    return {"layers": table, "by_pass": by_pass, "step": step}


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
    args.add_argument("--only", choices=("mrf", "chain", "disc"))
    args.add_argument("--profile", action="store_true")
    args.add_argument("--disc-parts", default=",".join(DISC_PARTS))
    args.add_argument("--json", help="write the discriminator's table here")
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), flush=True)
    if args.only == "disc":
        parts = args.disc_parts.split(",")
        if "kernel" in parts:
            _build.build_all()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        result = disc_times(torch, parts, args.profile)
        result["device"] = torch.cuda.get_device_name(0)
        if args.json:
            import json

            with open(args.json, "w") as f:
                json.dump(result, f, indent=1)
        return 0
    _build.build_all()
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
