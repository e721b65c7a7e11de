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
kernel (`csrc/fused_tail.cu`; its MRF contracts on the tensor cores in
3xTF32, as kernel 4 does), CPU tensors to `fused_hifigan_tail_plain`.
Kernels are laid out as in the JAX package: up_kernel (K, C_in, C_out),
resblocks as `ops/fused_mrf.py` takes them at C_out, post_kernel
(Kp, C_out, bands).  The kernel reads its operands from a `TailTable`:
checked once, the MRF's kernels packed for the tensor cores once, kept by a
served model (`models/hifigan.py`) until a weight is written.

The kernel has a bf16 form (`fused_hifigan_tail_bf16_cuda`, counted as
`NAME_BF16`), inference only as the float32 one: bf16 x and y, a
`TailTable` of that type (the MRF's kernels packed as bf16, the upsample's
and the head's weights and biases rounded to bf16), float32 sums rounded to
bf16 where the JAX package's Pallas body rounds (`fused_tail.py:121-174`:
the upsample's output, the MRF as `ops/fused_mrf.py`'s bf16 form, the
branches' mean, the head's leaky-relu, tanh of the float32 sum).  Its plain
version is `fused_hifigan_tail_plain` given bf16 x.
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
from fastvocoder_tpu_torch.ops.precision import fit, widen

NAME = "fused_tail"
NAME_BF16 = "fused_tail_bf16"
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
    """The tail with module semantics, in x's type (for bf16 x the bf16
    form's arithmetic: float32 sums of bf16 operands, rounded where the
    kernel rounds)."""
    dt = x.dtype
    T_in = x.shape[1]
    K = up_kernel.shape[0]
    natural = (T_in - 1) * stride - 2 * padding + K
    extra = T_in * stride - natural

    def cast(w):
        return None if w is None else fit(w, dt)

    h = fit(leaky_relu(widen(x), LRELU_SLOPE), dt)
    # (K, Cin, Cout) -> torch's transposed-conv weight (Cin, Cout, K)
    h = conv_transpose1d(h, cast(up_kernel).permute(1, 2, 0), cast(up_bias), stride=stride,
                         padding=padding, output_padding=max(extra, 0))
    h = fit(h[:, : T_in * stride], dt)
    h = widen(fused_mrf_stage_plain(h.to(dt), resblocks))
    h = fit(leaky_relu(h, HEAD_SLOPE), dt)
    h = conv1d(h, tap_major_to_torch(cast(post_kernel)), cast(post_bias),
               padding=(post_kernel.shape[0] - 1) // 2)
    return torch.tanh(h).to(dt)


class TailTable:
    """What the kernel's C entry point takes of a tail's operands, checked
    once: the MRF's (K1, dilation, K2) table and pointers, its kernels
    packed for the tensor cores (split into TF32 halves, or with `dtype`
    bf16 rounded to bf16, in the order the pair launches read them, by one
    launch), and the upsample's and head's weights (for bf16 rounded copies).
    It keeps the operands alive.  A caller whose operands stay (a served
    model) builds it once and hands it to the form of its `dtype`; built on
    every call it costs the checks of 41 tensors and one launch."""

    def __init__(self, up_kernel: torch.Tensor, up_bias: Optional[torch.Tensor], stride: int,
                 padding: int, resblocks: Sequence[Sequence[Pair]], post_kernel: torch.Tensor,
                 post_bias: Optional[torch.Tensor], device: torch.device,
                 dtype: torch.dtype = torch.float32):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{NAME}: no kernel form for {dtype}")
        if up_kernel.dim() != 3 or post_kernel.dim() != 3:
            raise ValueError(f"{NAME}: want kernels (K, Cin, Cout)")
        K, cin, C = up_kernel.shape
        Kp, _, bands = post_kernel.shape
        if C not in KERNEL_WIDTHS or cin % 4:
            raise ValueError(
                f"{NAME}: C_out={C} not in {KERNEL_WIDTHS}, or C_in={cin} not a multiple of 4")
        if tuple(post_kernel.shape) != (Kp, C, bands):
            raise ValueError(f"{NAME}: post_kernel {tuple(post_kernel.shape)} does not fit "
                             f"up_kernel {tuple(up_kernel.shape)}")
        if stride < 1 or padding < 0 or Kp % 2 == 0:
            raise ValueError(f"{NAME}: want stride >= 1, padding >= 0 and an odd post kernel")
        up_bias = _or_zeros(up_bias, C, up_kernel)
        post_bias = _or_zeros(post_bias, bands, post_kernel)
        for name, t in (("up_kernel", up_kernel), ("up_bias", up_bias),
                        ("post_kernel", post_kernel), ("post_bias", post_bias)):
            _build.check_operand(NAME, name, t, device)
        if tuple(up_bias.shape) != (C,) or tuple(post_bias.shape) != (bands,):
            raise ValueError(f"{NAME}: want up_bias ({C},) and post_bias ({bands},)")
        lib = _build.library(NAME)
        if bands > lib.fvt_fused_tail_max_bands():
            raise ValueError(f"{NAME}: at most {lib.fvt_fused_tail_max_bands()} bands, got {bands}")
        if not resblocks or not resblocks[0]:
            raise ValueError(f"{NAME}: want at least one branch of at least one pair")
        self.nb, self.np_, self.ints, self.ptrs = mrf_table(
            NAME, resblocks, C, device, lib.fvt_fused_tail_max_branches(),
            lib.fvt_fused_tail_max_pairs())
        self.C, self.cin, self.K, self.Kp, self.bands = C, cin, K, Kp, bands
        self.stride, self.padding, self.device = int(stride), int(padding), device
        self.dtype = dtype
        self.keep = (up_kernel, up_bias, stride, padding, resblocks, post_kernel, post_bias)
        # the CUDA-core convs read float32; the bf16 form's hold bf16 values
        self.up = tuple(fit(t, dtype).contiguous() for t in (up_kernel, up_bias))
        self.post = tuple(fit(t, dtype).contiguous() for t in (post_kernel, post_bias))
        bf16 = dtype == torch.bfloat16
        size_fn = lib.fvt_fused_tail_bf16_packed_elems if bf16 else lib.fvt_fused_tail_packed_floats
        size_fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        size_fn.restype = ctypes.c_longlong
        n_packed = size_fn(C, self.nb, self.np_, ctypes.addressof(self.ints))
        if n_packed < 0:
            raise ValueError(f"{NAME}: the kernel refuses this tail's MRF")
        self.packed = torch.empty(n_packed, dtype=dtype, device=device)
        fn = lib.fvt_fused_tail_bf16_pack if bf16 else lib.fvt_fused_tail_pack
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(self.packed.data_ptr(), C, self.nb, self.np_, ctypes.addressof(self.ints),
                     ctypes.addressof(self.ptrs), stream)
        if err != 0:
            raise RuntimeError(f"{NAME} kernel packing failed: CUDA error {err}")


def _run_tail(op: str, dtype: torch.dtype, x: torch.Tensor, args,
              table: Optional[TailTable]) -> torch.Tensor:
    """The kernel's form of `dtype` (named `op`) on x; `args` as
    `fused_hifigan_tail_plain` takes them after x."""
    if table is not None:
        _build.check_table(op, table, x)
    _build.check_form(op, x, dtype)
    if not x.is_cuda:
        raise ValueError(f"{op}: x must be a CUDA tensor, got {x.device}")
    if table is None:
        up_kernel, up_bias, _, _, resblocks, post_kernel, post_bias = args
        _build.refuse_autograd(op, [x, up_kernel, post_kernel] + [
            t for t in (up_bias, post_bias) if t is not None] + [
            w for pairs in resblocks for p in pairs for w in p if isinstance(w, torch.Tensor)])
        table = TailTable(*args, x.device, dtype)
    else:
        _build.refuse_autograd(op, [x])
    if x.dim() != 3 or x.shape[2] != table.cin or x.device != table.device:
        raise ValueError(f"{op}: the tail's operands take (B, T_in, {table.cin}) on "
                         f"{table.device}, got x {tuple(x.shape)} on {x.device}")
    _build.check_operand(op, "x", x, x.device, dtype)
    B, T_in, cin = x.shape
    C, dev = table.C, x.device
    T = T_in * table.stride
    y = torch.empty(B, T, table.bands, dtype=dtype, device=dev)
    if B == 0 or T_in == 0:
        return y
    # the caching allocator hands the same block back on every call
    scratch = torch.empty((2 * table.nb + 1) * B * T * C, dtype=dtype, device=dev)
    lib = _build.library(NAME)
    fn = lib.fvt_fused_tail_bf16 if dtype == torch.bfloat16 else lib.fvt_fused_tail
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    (k_up, b_up), (k_post, b_post) = table.up, table.post
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), scratch.data_ptr(), table.packed.data_ptr(), B,
                 T_in, cin, C, k_up.data_ptr(), b_up.data_ptr(), table.K, table.stride,
                 table.padding, table.nb, table.np_, ctypes.addressof(table.ints),
                 ctypes.addressof(table.ptrs), k_post.data_ptr(), b_post.data_ptr(), table.Kp,
                 table.bands, stream)
    _build.check_launch(op, err)
    return y


def fused_hifigan_tail_cuda(
    x: torch.Tensor,
    up_kernel: torch.Tensor,
    up_bias: Optional[torch.Tensor],
    stride: int,
    padding: int,
    resblocks: Sequence[Sequence[Pair]],
    post_kernel: torch.Tensor,
    post_bias: Optional[torch.Tensor],
    table: Optional[TailTable] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on x (B, T_in, C_in) float32, contiguous, on a
    CUDA device; C_out in `KERNEL_WIDTHS`, C_in a multiple of 4.  `table`:
    `TailTable(<the other operands>, x.device)` where the caller keeps it
    (the operands are then read from it)."""
    return _run_tail(NAME, torch.float32, x, (up_kernel, up_bias, stride, padding, resblocks,
                                              post_kernel, post_bias), table)


def fused_hifigan_tail_bf16_cuda(
    x: torch.Tensor,
    up_kernel: torch.Tensor,
    up_bias: Optional[torch.Tensor],
    stride: int,
    padding: int,
    resblocks: Sequence[Sequence[Pair]],
    post_kernel: torch.Tensor,
    post_bias: Optional[torch.Tensor],
    table: Optional[TailTable] = None,
) -> torch.Tensor:
    """The kernel's bf16 form on x (B, T_in, C_in) bf16: y (B, u T_in,
    bands) bf16.  The operands are float32, as a model's parameters;
    `table`: `TailTable(<the other operands>, x.device, torch.bfloat16)`
    where the caller keeps it."""
    return _run_tail(NAME_BF16, torch.bfloat16, x, (up_kernel, up_bias, stride, padding,
                                                    resblocks, post_kernel, post_bias), table)


def fused_hifigan_tail(x: torch.Tensor, *args, table: Optional[TailTable] = None
                       ) -> torch.Tensor:
    """The tail on x (B, T_in, C_in): the kernel's form of x's type on CUDA
    tensors (`table`: a kept `TailTable` of that type), the plain version on
    CPU tensors.  Arguments as `fused_hifigan_tail_plain`."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return fused_hifigan_tail_bf16_cuda(x, *args, table=table)
    if x.is_cuda:
        return fused_hifigan_tail_cuda(x, *args, table=table)
    return fused_hifigan_tail_plain(x, *args)
