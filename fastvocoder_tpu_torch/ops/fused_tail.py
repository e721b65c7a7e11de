"""Fused HiFiGAN tail: the last upsample stage and the output head.

Counterpart of `fastvocoder_tpu/ops/fused_tail.py`, forward only:

    leaky(0.1) -> ConvTranspose1d(stride u) -> MRF -> leaky(0.01)
      -> conv_post -> tanh

(the 0.01 slope before conv_post is the reference's, model/generator/
hifigan.py:104).  x (B, T_in, C_in) -> (B, u * T_in, bands).  Every conv
zero-pads its own input; the transposed conv has torch's semantics with the
given padding, its output cut or extended to u * T_in rows, as the JAX
kernel computes them.

`fused_hifigan_tail` routes by device: CUDA tensors go to the hand-written
kernel (`csrc/fused_tail.cu`), CPU tensors to `fused_hifigan_tail_plain`.
Kernels are laid out as in the JAX package: up_kernel (K, C_in, C_out),
resblocks as `ops/fused_mrf.py` takes them at C_out, post_kernel
(Kp, C_out, bands).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from fastvocoder_tpu_torch.ops import _build
from fastvocoder_tpu_torch.ops.conv import conv1d, conv_transpose1d
from fastvocoder_tpu_torch.ops.fused_mrf import (
    KERNEL_WIDTHS,
    LRELU_SLOPE,
    Pair,
    fused_mrf_stage_plain,
    mrf_table,
    tap_major_to_torch,
)
from fastvocoder_tpu_torch.ops.fused_resstack import leaky_relu

NAME = "fused_tail"
HEAD_SLOPE = 0.01  # torch's default leaky slope before conv_post


def _or_zeros(bias: Optional[torch.Tensor], n: int, like: torch.Tensor) -> torch.Tensor:
    return bias if bias is not None else torch.zeros(n, dtype=like.dtype, device=like.device)


def fused_hifigan_tail_plain(
    x: torch.Tensor,
    up_kernel: torch.Tensor,
    up_bias: Optional[torch.Tensor],
    stride: int,
    padding: int,
    resblocks: Sequence[Sequence[Pair]],
    post_kernel: torch.Tensor,
    post_bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """The tail with module semantics."""
    T_in = x.shape[1]
    K = up_kernel.shape[0]
    natural = (T_in - 1) * stride - 2 * padding + K
    extra = T_in * stride - natural
    h = leaky_relu(x, LRELU_SLOPE)
    # (K, Cin, Cout) -> torch's transposed-conv weight (Cin, Cout, K)
    h = conv_transpose1d(h, up_kernel.permute(1, 2, 0), up_bias, stride=stride,
                         padding=padding, output_padding=max(extra, 0))
    h = h[:, : T_in * stride]
    h = fused_mrf_stage_plain(h, resblocks)
    h = leaky_relu(h, HEAD_SLOPE)
    h = conv1d(h, tap_major_to_torch(post_kernel), post_bias,
               padding=(post_kernel.shape[0] - 1) // 2)
    return torch.tanh(h)


def fused_hifigan_tail_cuda(
    x: torch.Tensor,
    up_kernel: torch.Tensor,
    up_bias: Optional[torch.Tensor],
    stride: int,
    padding: int,
    resblocks: Sequence[Sequence[Pair]],
    post_kernel: torch.Tensor,
    post_bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """Launch the CUDA kernel on x (B, T_in, C_in) float32, contiguous, on a
    CUDA device; C_out in `KERNEL_WIDTHS`, C_in a multiple of 4."""
    if not x.is_cuda:
        raise ValueError(f"{NAME}: x must be a CUDA tensor, got {x.device}")
    ops = [x, up_kernel, post_kernel] + [t for t in (up_bias, post_bias) if t is not None]
    _build.refuse_autograd(NAME, ops + [w for pairs in resblocks for p in pairs for w in p
                                 if isinstance(w, torch.Tensor)])
    if x.dim() != 3 or up_kernel.dim() != 3 or post_kernel.dim() != 3:
        raise ValueError(f"{NAME}: want x (B, T_in, C_in) and kernels (K, Cin, Cout)")
    B, T_in, cin = x.shape
    K, _, C = up_kernel.shape
    Kp, _, bands = post_kernel.shape
    if C not in KERNEL_WIDTHS or cin % 4:
        raise ValueError(
            f"{NAME}: C_out={C} not in {KERNEL_WIDTHS}, or C_in={cin} not a multiple of 4")
    if tuple(up_kernel.shape) != (K, cin, C) or tuple(post_kernel.shape) != (Kp, C, bands):
        raise ValueError(
            f"{NAME}: up_kernel {tuple(up_kernel.shape)} and post_kernel "
            f"{tuple(post_kernel.shape)} do not fit x {tuple(x.shape)}"
        )
    if stride < 1 or padding < 0 or Kp % 2 == 0:
        raise ValueError(f"{NAME}: want stride >= 1, padding >= 0 and an odd post kernel")
    up_bias = _or_zeros(up_bias, C, x)
    post_bias = _or_zeros(post_bias, bands, x)
    dev = x.device
    for name, t in (("x", x), ("up_kernel", up_kernel), ("up_bias", up_bias),
                    ("post_kernel", post_kernel), ("post_bias", post_bias)):
        _build.check_operand(NAME, name, t, dev)
    if tuple(up_bias.shape) != (C,) or tuple(post_bias.shape) != (bands,):
        raise ValueError(f"{NAME}: want up_bias ({C},) and post_bias ({bands},)")
    lib = _build.library(NAME)
    if bands > lib.fvt_fused_tail_max_bands():
        raise ValueError(f"{NAME}: at most {lib.fvt_fused_tail_max_bands()} bands, got {bands}")
    nb, np_, ints, ptrs = mrf_table(NAME, resblocks, C, dev, lib.fvt_fused_tail_max_branches(),
                                    lib.fvt_fused_tail_max_pairs())
    T = T_in * stride
    y = torch.empty(B, T, bands, dtype=torch.float32, device=dev)
    if B == 0 or T_in == 0:
        return y
    scratch = torch.empty((2 * nb + 1) * B * T * C, dtype=torch.float32, device=dev)
    fn = lib.fvt_fused_tail
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), scratch.data_ptr(), B, T_in, cin, C,
                 up_kernel.data_ptr(), up_bias.data_ptr(), K, stride, padding, nb, np_,
                 ctypes.addressof(ints), ctypes.addressof(ptrs), post_kernel.data_ptr(),
                 post_bias.data_ptr(), Kp, bands, stream)
    _build.check_launch(NAME, err)
    return y


def fused_hifigan_tail(x: torch.Tensor, *args) -> torch.Tensor:
    """The tail on x (B, T_in, C_in): the kernel on CUDA tensors, the plain
    version on CPU tensors.  Arguments as `fused_hifigan_tail_plain`."""
    if x.is_cuda:
        return fused_hifigan_tail_cuda(x, *args)
    return fused_hifigan_tail_plain(x, *args)
