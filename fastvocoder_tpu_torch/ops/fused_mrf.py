"""Fused HiFiGAN MRF stage: the mean over a stage's ResBlock1 branches.

Counterpart of `fastvocoder_tpu/ops/fused_mrf.py`, forward only.  Each
branch is a chain of pairs

    h = h + conv_K2(leaky(conv_K1,d(leaky(h)) + b1)) + b2

with leaky slope 0.1 and zero "same" padding ((K - 1) d // 2) on every
conv's own input; the stage returns the mean of the branches' outputs.

`fused_mrf_stage` routes by device: CUDA tensors go to the hand-written
kernel (`csrc/fused_mrf.cu`), CPU tensors to `fused_mrf_stage_plain`, the
module semantics written out.  The TPU kernel's blocked (B, Q, 128) layout,
block-Toeplitz weights and `T % (128 // C)` gate have no counterpart here:
the kernel takes any T >= 1 and any B.

Branches are given as in the JAX package: per branch a list of pairs
(k1 (K1, C, C), b1 (C,), dilation, k2 (K2, C, C), b2 (C,)), kernels laid
out (tap, c_in, c_out).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from fastvocoder_tpu_torch.ops import _build
from fastvocoder_tpu_torch.ops.conv import conv1d
from fastvocoder_tpu_torch.ops.fused_resstack import leaky_relu

NAME = "fused_mrf"
KERNEL_WIDTHS = (16, 32, 64, 128, 256)
LRELU_SLOPE = 0.1  # HiFiGAN's resblocks (reference modules.py:9)

Pair = Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor, torch.Tensor]


def tap_major_to_torch(k: torch.Tensor) -> torch.Tensor:
    """(K, Cin, Cout) -> torch's conv weight (Cout, Cin, K)."""
    return k.permute(2, 1, 0)


def resblock1_plain(x: torch.Tensor, pairs: Sequence[Pair]) -> torch.Tensor:
    """One ResBlock1 branch: its pairs in turn, zero "same" padding."""
    h = x
    for k1, b1, d, k2, b2 in pairs:
        t = leaky_relu(h, LRELU_SLOPE)
        t = conv1d(t, tap_major_to_torch(k1), b1, padding=(k1.shape[0] - 1) * d // 2, dilation=d)
        t = leaky_relu(t, LRELU_SLOPE)
        t = conv1d(t, tap_major_to_torch(k2), b2, padding=(k2.shape[0] - 1) // 2)
        h = h + t
    return h


def fused_mrf_stage_plain(x: torch.Tensor, resblocks: Sequence[Sequence[Pair]]) -> torch.Tensor:
    """The stage with module semantics: sum of the branches in order,
    divided by their count."""
    acc = None
    for pairs in resblocks:
        h = resblock1_plain(x, pairs)
        acc = h if acc is None else acc + h
    return acc / len(resblocks)


def mrf_table(op: str, resblocks: Sequence[Sequence[Pair]], C: int, device: torch.device,
              max_branches: int, max_pairs: int):
    """The (branch, pair) table the C entry points take, branch-major:
    (nb, np, ints (K1, dilation, K2) per pair, device pointers (w1, b1, w2,
    b2) per pair), after checking every operand."""
    nb = len(resblocks)
    if not 1 <= nb <= max_branches:
        raise ValueError(f"{op}: want 1..{max_branches} branches, got {nb}")
    np_ = len(resblocks[0])
    if any(len(pairs) != np_ for pairs in resblocks) or not 1 <= np_ <= max_pairs:
        raise ValueError(
            f"{op}: every branch needs the same number of pairs, 1..{max_pairs}; "
            f"got {[len(p) for p in resblocks]}"
        )
    ints: List[int] = []
    ptrs: List[int] = []
    for i, pairs in enumerate(resblocks):
        for j, (k1, b1, d, k2, b2) in enumerate(pairs):
            K1, K2 = k1.shape[0], k2.shape[0]
            if K1 % 2 == 0 or K2 % 2 == 0 or int(d) < 1:
                raise ValueError(f"{op}: branch {i} pair {j}: want odd kernels and dilation >= 1")
            want = {"k1": (k1, (K1, C, C)), "b1": (b1, (C,)), "k2": (k2, (K2, C, C)),
                    "b2": (b2, (C,))}
            for name, (w, shape) in want.items():
                if tuple(w.shape) != shape:
                    raise ValueError(
                        f"{op}: branch {i} pair {j} {name} has shape {tuple(w.shape)}, want {shape}"
                    )
                _build.check_operand(op, f"branch {i} pair {j} {name}", w, device)
            ints += [K1, int(d), K2]
            ptrs += [k1.data_ptr(), b1.data_ptr(), k2.data_ptr(), b2.data_ptr()]
    return nb, np_, (ctypes.c_int * len(ints))(*ints), (ctypes.c_void_p * len(ptrs))(*ptrs)


def fused_mrf_stage_cuda(x: torch.Tensor, resblocks: Sequence[Sequence[Pair]]) -> torch.Tensor:
    """Launch the CUDA kernel on x (B, T, C) float32, contiguous, on a CUDA
    device, C in `KERNEL_WIDTHS`."""
    if not x.is_cuda:
        raise ValueError(f"{NAME}: x must be a CUDA tensor, got {x.device}")
    _build.refuse_autograd(NAME, [x] + [w for pairs in resblocks for p in pairs for w in p
                                 if isinstance(w, torch.Tensor)])
    if x.dim() != 3:
        raise ValueError(f"{NAME}: want x (B, T, C), got {tuple(x.shape)}")
    B, T, C = x.shape
    if C not in KERNEL_WIDTHS:
        raise ValueError(f"{NAME}: C={C} not in {KERNEL_WIDTHS}")
    _build.check_operand(NAME, "x", x, x.device)
    lib = _build.library(NAME)
    nb, np_, ints, ptrs = mrf_table(NAME, resblocks, C, x.device,
                                    lib.fvt_fused_mrf_max_branches(), lib.fvt_fused_mrf_max_pairs())
    y = torch.empty_like(x)
    if B == 0 or T == 0:
        return y
    scratch = torch.empty(2 * nb * B * T * C, dtype=torch.float32, device=x.device)
    fn = lib.fvt_fused_mrf
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), scratch.data_ptr(), B, T, C, nb, np_,
                 ctypes.addressof(ints), ctypes.addressof(ptrs), stream)
    _build.check_launch(NAME, err)
    return y


def fused_mrf_stage(x: torch.Tensor, resblocks: Sequence[Sequence[Pair]]) -> torch.Tensor:
    """Apply an MRF stage to x (B, T, C): the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if x.is_cuda:
        return fused_mrf_stage_cuda(x, resblocks)
    return fused_mrf_stage_plain(x, resblocks)
