"""The discriminators' grouped strided 1-D conv, channels last (B, T, C).

The downsample layers of `ConvStackDiscriminator` (MSD and MFD) are convs
of 4 input channels a group, 16 or 4 output channels a group, stride S
and K taps (41 in the MSD, 25 in the MFD, both at S = 4), with symmetric
zero padding P:

    y[b, t, g N + n] = bias[g N + n]
                       + sum_{c < 4, k < K} x[b, t S + k - P, 4 g + c] w[g N + n, c, k]

for t in [0, T_out), T_out = (T + 2 P - K) // S + 1, rows outside [0, T)
read as zero; `weight` is PyTorch's (Cout, 4, K), the effective weight
(weight norm stays in the module, under autograd).

It replaces no TPU kernel: the JAX package runs these convs through XLA
(`fastvocoder_tpu/ops/conv.py::conv1d`, `lax.conv_general_dilated` with
`feature_group_count`).  It was added because cuDNN has no fast float32
algorithm for 4-channel groups at stride 4: its grouped gradient kernels
held most of the GAN step's device time (`PERF.md`, kernel 7).

`grouped_conv1d` is differentiable.  On CUDA float32 tensors its forward,
input gradient and weight and bias gradients are the kernels of
`csrc/grouped_conv.cu` (launches counted under `NAME_FWD`, `NAME_DGRAD`,
`NAME_WGRAD`); on CPU tensors they are the plain versions below, the same
functions written in plain PyTorch, channels last.  Any other CUDA tensor
(bf16, float64) is refused.  The backward computes the gradients of the
inputs that require one (`ctx.needs_input_grad`): the trainer freezes the
discriminator's parameters for the generator's update, whose backward
through the discriminator then runs the input gradient alone.

`kernel_takes` is what `ops/conv.py::conv1d` asks before it sends a conv
here; every other conv keeps cuDNN.  A geometry it admits whose blocks do
not fit (a K far beyond the discriminators') makes the C entry points
return cudaErrorInvalidValue, and the launch raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from fastvocoder_tpu_torch.ops import _build

NAME_FWD = "grouped_conv_fwd"
NAME_DGRAD = "grouped_conv_dgrad"
NAME_WGRAD = "grouped_conv_wgrad"

GROUP_IN = 4  # input channels a group: one 16-byte float4 a row
GROUP_OUTS = (4, 16)  # output channels a group of the discriminators' layers


def out_length(T: int, K: int, stride: int, padding: int) -> int:
    return (T + 2 * padding - K) // stride + 1


def kernel_takes(device_type: str, dtype: torch.dtype, cin: int, cout: int, groups: int,
                 K: int, stride: int, dilation: int, left: int, right: int) -> bool:
    """Whether the kernels run this conv: CUDA, float32, groups > 1 of 4
    input and 16 or 4 output channels, dilation 1, symmetric padding."""
    if device_type != "cuda" or dtype != torch.float32 or groups <= 1:
        return False
    if cin != GROUP_IN * groups or cout % groups or cout // groups not in GROUP_OUTS:
        return False
    return dilation == 1 and left == right and left >= 0 and stride >= 1 and K >= 1


# --- the plain versions ---------------------------------------------------------------------


def _geometry(T: int, cin: int, weight_shape, stride: int, padding: int):
    """-> (G, N, K, T_out) after checking the shapes."""
    cout, per, K = weight_shape
    if per != GROUP_IN or cin % GROUP_IN or cout % (cin // GROUP_IN):
        raise ValueError(f"grouped conv: want x (B, T, 4 G) and weight (N G, 4, K), got "
                         f"{cin} channels and weight {tuple(weight_shape)}")
    T_out = out_length(T, K, stride, padding)
    if T_out < 1:
        raise ValueError(f"grouped conv: T={T} padded by {padding} is shorter than K={K}")
    G = cin // GROUP_IN
    return G, cout // G, K, T_out


def _frames(x: torch.Tensor, K: int, stride: int, padding: int, T_out: int) -> torch.Tensor:
    """(B, T_out, G, 4, K): the K padded rows each output reads, by group."""
    B, _, cin = x.shape
    fr = F.pad(x, (0, 0, padding, padding)).unfold(1, K, stride)[:, :T_out]  # (B, T_out, cin, K)
    return fr.reshape(B, T_out, cin // GROUP_IN, GROUP_IN, K)


def grouped_conv1d_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                         stride: int, padding: int) -> torch.Tensor:
    """x (B, T, 4 G), weight (N G, 4, K), bias (N G,) or None -> y (B, T_out, N G)."""
    B, T, cin = x.shape
    G, N, K, T_out = _geometry(T, cin, weight.shape, stride, padding)
    y = torch.einsum("btgck,gnck->btgn", _frames(x, K, stride, padding, T_out),
                     weight.reshape(G, N, GROUP_IN, K)).reshape(B, T_out, G * N)
    return y if bias is None else y + bias


def grouped_conv1d_dx_plain(dy: torch.Tensor, weight: torch.Tensor, x_shape, stride: int,
                            padding: int) -> torch.Tensor:
    """The input gradient: dy (B, T_out, N G) -> dx of `x_shape` (B, T, 4 G):
    each output row's K taps added back onto the rows it read."""
    B, T, cin = x_shape
    G, N, K, T_out = _geometry(T, cin, weight.shape, stride, padding)
    dfr = torch.einsum("btgn,gnck->btgck", dy.reshape(B, T_out, G, N),
                       weight.reshape(G, N, GROUP_IN, K)).reshape(B, T_out, cin, K)
    dxp = dy.new_zeros(B, max(T + 2 * padding, (T_out - 1) * stride + K), cin)
    for k in range(K):
        dxp[:, k:k + (T_out - 1) * stride + 1:stride] += dfr[..., k]
    return dxp[:, padding:padding + T]


def grouped_conv1d_dw_plain(x: torch.Tensor, dy: torch.Tensor, K: int, stride: int,
                            padding: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight and bias gradients: (dw (N G, 4, K), db (N G,)), sums over
    every (b, t) row."""
    B, T_out, cout = dy.shape
    G = x.shape[2] // GROUP_IN
    dw = torch.einsum("btgn,btgck->gnck", dy.reshape(B, T_out, G, cout // G),
                      _frames(x, K, stride, padding, T_out))
    return dw.reshape(cout, GROUP_IN, K), dy.sum((0, 1))


# --- the kernels ----------------------------------------------------------------------------


def _lib():
    lib = _build.library("grouped_conv")
    if not getattr(lib, "_fvt_typed", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        dims = [i] * 8  # B, T, Cin, Cout, K, S, P, T_out
        lib.fvt_grouped_conv_fwd.argtypes = [ptr] * 4 + dims + [ptr]
        lib.fvt_grouped_conv_dgrad.argtypes = [ptr] * 3 + dims + [ptr]
        lib.fvt_grouped_conv_wgrad.argtypes = [ptr] * 5 + dims + [ptr]
        lib.fvt_grouped_conv_wgrad_scratch.argtypes = dims
        for fn in (lib.fvt_grouped_conv_fwd, lib.fvt_grouped_conv_dgrad,
                   lib.fvt_grouped_conv_wgrad):
            fn.restype = i
        lib.fvt_grouped_conv_wgrad_scratch.restype = ctypes.c_longlong
        lib._fvt_typed = True
    return lib


class _Dims(NamedTuple):
    """The dims the C entry points take, in their order."""
    B: int
    T: int
    Cin: int
    Cout: int
    K: int
    S: int
    P: int
    T_out: int


def _dims(op: str, x_shape, weight_shape, stride: int, padding: int) -> _Dims:
    """The C entry points' dims, after checking that the kernels take the
    geometry."""
    B, T, cin = x_shape
    G, N, K, T_out = _geometry(T, cin, weight_shape, stride, padding)
    if not kernel_takes("cuda", torch.float32, cin, G * N, G, K, stride, 1, padding, padding):
        raise ValueError(f"{op}: the kernels do not take {G} groups of {N} outputs, "
                         f"K={K}, stride {stride}, padding {padding}")
    return _Dims(B, T, cin, G * N, K, stride, padding, T_out)


def _operands(op: str, **tensors: Optional[torch.Tensor]) -> torch.device:
    """Raise unless every given tensor is a contiguous, 16-byte aligned
    float32 CUDA tensor on the first one's device; -> that device."""
    device = next(iter(tensors.values())).device
    if device.type != "cuda":
        raise ValueError(f"{op}: want CUDA tensors, got {device}")
    for name, t in tensors.items():
        if t is not None:
            _build.check_form(op, t, torch.float32)
            _build.check_operand(op, name, t, device)
    return device


def _launch(op: str, fn, device: torch.device, pointers, dims) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[p.data_ptr() if p is not None else None for p in pointers], *dims, stream)
    _build.check_launch(op, err)


def grouped_conv1d_cuda(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                        stride: int, padding: int) -> torch.Tensor:
    """The forward kernel: x (B, T, 4 G), weight (N G, 4, K), bias (N G,) or
    None, float32, contiguous, on one CUDA device -> y (B, T_out, N G)."""
    device = _operands(NAME_FWD, x=x, weight=weight, bias=bias)
    if x.dim() != 3:
        raise ValueError(f"{NAME_FWD}: want x (B, T, C), got {tuple(x.shape)}")
    dims = _dims(NAME_FWD, x.shape, weight.shape, stride, padding)
    y = x.new_empty(dims.B, dims.T_out, dims.Cout)
    if dims.B:
        _launch(NAME_FWD, _lib().fvt_grouped_conv_fwd, device, (x, weight, bias, y), dims)
    return y


def grouped_conv1d_dx_cuda(dy: torch.Tensor, weight: torch.Tensor, x_shape, stride: int,
                           padding: int) -> torch.Tensor:
    """The input-gradient kernel: dy (B, T_out, N G), weight (N G, 4, K) ->
    dx of `x_shape` (B, T, 4 G)."""
    device = _operands(NAME_DGRAD, dy=dy, weight=weight)
    dims = _dims(NAME_DGRAD, x_shape, weight.shape, stride, padding)
    if tuple(dy.shape) != (dims.B, dims.T_out, dims.Cout):
        raise ValueError(f"{NAME_DGRAD}: want dy {(dims.B, dims.T_out, dims.Cout)}, got "
                         f"{tuple(dy.shape)}")
    dx = dy.new_empty(x_shape)
    if dims.B:
        _launch(NAME_DGRAD, _lib().fvt_grouped_conv_dgrad, device, (dy, weight, dx), dims)
    return dx


def grouped_conv1d_dw_cuda(x: torch.Tensor, dy: torch.Tensor, K: int, stride: int,
                           padding: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight-gradient kernel: x (B, T, 4 G), dy (B, T_out, N G) ->
    (dw (N G, 4, K), db (N G,)).  Blocks sum slices of the B T_out rows into
    a scratch of partial sums, which a second pass adds in a fixed order:
    two runs on the same inputs give the same bits."""
    device = _operands(NAME_WGRAD, x=x, dy=dy)
    if x.dim() != 3 or dy.dim() != 3:
        raise ValueError(f"{NAME_WGRAD}: want x (B, T, C) and dy (B, T_out, C), got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    dims = _dims(NAME_WGRAD, x.shape, (dy.shape[2], GROUP_IN, K), stride, padding)
    if tuple(dy.shape) != (dims.B, dims.T_out, dims.Cout):
        raise ValueError(f"{NAME_WGRAD}: want dy {(dims.B, dims.T_out, dims.Cout)}, got "
                         f"{tuple(dy.shape)}")
    dw = x.new_empty(dims.Cout, GROUP_IN, K)
    db = x.new_empty(dims.Cout)
    if not dims.B:
        return dw.zero_(), db.zero_()
    lib = _lib()
    floats = lib.fvt_grouped_conv_wgrad_scratch(*dims)
    if floats < 0:  # its blocks do not fit
        _build.check_launch(NAME_WGRAD, 1)  # cudaErrorInvalidValue
    scratch = x.new_empty(floats)
    _launch(NAME_WGRAD, lib.fvt_grouped_conv_wgrad, device, (x, dy, dw, db, scratch), dims)
    return dw, db


# --- the op ---------------------------------------------------------------------------------


class _GroupedConv1d(torch.autograd.Function):
    """The kernels on CUDA float32 tensors, the plain versions on CPU ones."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.geometry = (stride, padding)
        ctx.save_for_backward(x, weight)
        if x.is_cuda:
            return grouped_conv1d_cuda(x, weight, bias, stride, padding)
        return grouped_conv1d_plain(x, weight, bias, stride, padding)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        stride, padding = ctx.geometry
        dy = dy.contiguous()
        dx = dw = db = None
        need_x, need_w, need_b = ctx.needs_input_grad[:3]  # need_b: False without a bias
        if need_x:
            dx = (grouped_conv1d_dx_cuda if x.is_cuda else grouped_conv1d_dx_plain)(
                dy, weight, x.shape, stride, padding)
        if need_w or need_b:
            dw, db = (grouped_conv1d_dw_cuda if x.is_cuda else grouped_conv1d_dw_plain)(
                x, dy, weight.shape[2], stride, padding)
        return dx, dw if need_w else None, db if need_b else None, None, None


def grouped_conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   stride: int = 1, padding: int = 0) -> torch.Tensor:
    """x (B, T, 4 G), weight (N G, 4, K), bias (N G,) or None -> y (B, T_out,
    N G), differentiable: the kernels for CUDA float32 tensors (any other
    CUDA tensor raises), the plain versions for CPU tensors."""
    return _GroupedConv1d.apply(x, weight, bias, stride, padding)
