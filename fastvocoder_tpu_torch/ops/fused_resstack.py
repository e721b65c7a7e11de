"""Fused MelGAN-family residual-stack chain: one launch per upsample stage.

Counterpart of `fastvocoder_tpu/ops/fused_resstack.py`.  A stage runs
sequential ResidualStacks, each

    leaky(0.2) -> reflect-pad -> dilated conv K -> leaky(0.2) -> 1x1 conv
    + a 1x1 skip conv of the stack's input.

`fused_residual_stacks` routes by device: CUDA tensors go to the
hand-written kernel (`csrc/fused_resstack.cu`), which runs the whole chain
from shared memory and mirrors each stack's input at the sequence edges
itself; CPU tensors go to `fused_residual_stacks_plain`, the module
semantics written out.  The kernel has no backward yet.

Stacks are given as in the JAX package: per stack the tuple
(k_dilated (K, C, C), b_d (C,), dilation, k_1x1 (1, C, C), b_1 (C,),
k_skip (1, C, C), b_s (C,)), kernels laid out (tap, c_in, c_out).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from fastvocoder_tpu_torch.ops import _build
from fastvocoder_tpu_torch.ops.conv import conv1d, reflect_pad1d

NAME = "fused_resstack"
KERNEL_WIDTHS = (32, 64, 128, 256)
SLOPE = 0.2  # leaky-relu slope of MelGAN's stacks (reference modules.py:320-382)

Stack = Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor, torch.Tensor,
              torch.Tensor, torch.Tensor]


def stack_margin(kernel_size: int, dilation: int) -> int:
    return (kernel_size - 1) // 2 * dilation


def leaky_relu(x: torch.Tensor, slope: float = SLOPE) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def _conv_weight(k: torch.Tensor) -> torch.Tensor:
    """(K, Cin, Cout) -> torch's (Cout, Cin, K)."""
    return k.permute(2, 1, 0)


def fused_residual_stacks_plain(x: torch.Tensor, stacks: Sequence[Stack]) -> torch.Tensor:
    """The chain with module semantics (reflect pads per stack)."""
    h = x
    for kd, bd, d, k1, b1, ks, bs in stacks:
        t = leaky_relu(h)
        t = reflect_pad1d(t, stack_margin(kd.shape[0], d))
        t = conv1d(t, _conv_weight(kd), bd, dilation=d)
        t = leaky_relu(t)
        t = conv1d(t, _conv_weight(k1), b1)
        h = t + conv1d(h, _conv_weight(ks), bs)
    return h


def _check_cuda_f32(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"{NAME}: {name} must be a contiguous float32 tensor on {device}, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"{NAME}: {name} must be 16-byte aligned")


def fused_residual_stacks_cuda(x: torch.Tensor, stacks: Sequence[Stack]) -> torch.Tensor:
    """Launch the CUDA kernel on x (B, T, C) float32, contiguous, on a CUDA
    device, C in `KERNEL_WIDTHS`."""
    if not x.is_cuda:
        raise ValueError(f"{NAME}: x must be a CUDA tensor, got {x.device}")
    if torch.is_grad_enabled() and (
        x.requires_grad
        or any(isinstance(w, torch.Tensor) and w.requires_grad for s in stacks for w in s)
    ):
        raise NotImplementedError(
            f"{NAME}: the CUDA kernel is forward only; its backward is still "
            "to be ported (ROADMAP queue B)"
        )
    if x.dim() != 3:
        raise ValueError(f"{NAME}: want x (B, T, C), got {tuple(x.shape)}")
    B, T, C = x.shape
    if C not in KERNEL_WIDTHS:
        raise ValueError(f"{NAME}: C={C} not in {KERNEL_WIDTHS}")
    _check_cuda_f32("x", x, x.device)
    lib = _build.library(NAME)
    max_stacks = lib.fvt_fused_resstacks_max_stacks()
    if not 1 <= len(stacks) <= max_stacks:
        raise ValueError(f"{NAME}: want 1..{max_stacks} stacks, got {len(stacks)}")
    K = stacks[0][0].shape[0]
    ptrs, dils = [], []
    for i, (kd, bd, d, k1, b1, ks, bs) in enumerate(stacks):
        want = {"k_dilated": (kd, (K, C, C)), "b_d": (bd, (C,)),
                "k_1x1": (k1, (1, C, C)), "b_1": (b1, (C,)),
                "k_skip": (ks, (1, C, C)), "b_s": (bs, (C,))}
        for name, (w, shape) in want.items():
            if tuple(w.shape) != shape:
                raise ValueError(
                    f"{NAME}: stack {i} {name} has shape {tuple(w.shape)}, want {shape}"
                )
            _check_cuda_f32(f"stack {i} {name}", w, x.device)
        ptrs += [kd.data_ptr(), bd.data_ptr(), k1.data_ptr(), b1.data_ptr(),
                 ks.data_ptr(), bs.data_ptr()]
        dils.append(int(d))
    y = torch.empty_like(x)
    if B == 0 or T == 0:
        return y
    fn = lib.fvt_fused_resstacks
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    dil_arr = (ctypes.c_int * len(dils))(*dils)
    ptr_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), B, T, C, len(stacks), K,
                 ctypes.addressof(dil_arr), ctypes.addressof(ptr_arr), stream)
    _build.check_launch(NAME, err)
    return y


def fused_residual_stacks(x: torch.Tensor, stacks: Sequence[Stack]) -> torch.Tensor:
    """Apply a ResidualStack chain to x (B, T, C): the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if x.is_cuda:
        return fused_residual_stacks_cuda(x, stacks)
    return fused_residual_stacks_plain(x, stacks)
