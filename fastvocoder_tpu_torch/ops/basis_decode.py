"""Fused Basis-MelGAN decode: weights @ basis + 50 %-overlap-add in one op.

Counterpart of `fastvocoder_tpu/ops/basis_decode.py`.  With hop = L / 2
every output sample is the sum of exactly two frame samples, so the decode
is a shift-matmul:

    out[f*hop : (f+1)*hop] = W[f] @ basis[:hop].T + W[f-1] @ basis[hop:].T

for f in [0, F], rows -1 and F being zero.  Output length (F + 1) * hop.

`basis_decode` routes by device: CUDA tensors go to the hand-written kernel
(`csrc/basis_decode.cu`), CPU tensors to `basis_decode_plain`.  The kernel
is forward only; its gradient is the plain version's VJP
(`basis_decode_vjp`), as the JAX package pairs its Pallas forward with the
XLA VJP.

The kernel has a bf16 form (`basis_decode_bf16_cuda`, counted as
`NAME_BF16`), the Pallas kernel's bf16 instantiation
(`fastvocoder_tpu/ops/basis_decode.py:113-143`), on the tensor cores: bf16
weights and a bf16 basis in, exact products summed in float32, a float32
waveform out, at every size
(the JAX package's `auto` route sends more than 65,536 rows to an einsum
that writes bf16; the port follows the kernel).  Its plain version is
`basis_decode_plain` given bf16 weights.  In training with compute_dtype
bf16 its gradient is `basis_decode_vjp` in the inputs' type, as the JAX
package pairs the Pallas forward with XLA's VJP of the bf16 decode
(`_basis_decode_pallas_ad`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fastvocoder_tpu_torch.ops import _build
from fastvocoder_tpu_torch.ops.precision import widen

NAME = "basis_decode"
NAME_BF16 = "basis_decode_bf16"


def _halves(basis: torch.Tensor, dtype: torch.dtype):
    L = basis.shape[0]
    if L % 2:
        raise ValueError(f"basis length L={L} must be even (hop = L / 2)")
    hop = L // 2
    return basis[:hop].t().to(dtype), basis[hop:].t().to(dtype), hop


def basis_decode_plain(weight: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """weight (B, F, C), basis (L, C) -> wav (B, (F + 1) * L/2), float32.
    For bf16 weights the basis is rounded to bf16 and both products and
    their sum are taken in float32, as the bf16 form does."""
    b1, b2, hop = _halves(basis, weight.dtype)
    w, b1, b2 = widen(weight), widen(b1), widen(b2)
    a = F.pad(w, (0, 0, 0, 1))  # a[f] = W[f], zero at f = F
    b = F.pad(w, (0, 0, 1, 0))  # b[f] = W[f-1], zero at f = 0
    out = a @ b1 + b @ b2  # (B, F+1, hop)
    return out.reshape(weight.shape[0], -1)


def basis_decode_vjp(weight: torch.Tensor, basis: torch.Tensor, g: torch.Tensor):
    """Cotangents (d weight, d basis) of `basis_decode_plain` for output
    cotangent g (B, (F + 1) * hop), in the weights' type: for bf16 weights
    g and the basis are rounded to bf16 and each product is a bf16 one
    (float32 sums, bf16 results), as XLA differentiates the bf16 decode."""
    b1, b2, hop = _halves(basis, weight.dtype)
    B, Fr, C = weight.shape
    g = g.reshape(B, Fr + 1, hop).to(weight.dtype)
    da = g @ b1.t()  # (B, F+1, C)
    db = g @ b2.t()
    dweight = da[:, :Fr] + db[:, 1:]
    a = F.pad(weight, (0, 0, 0, 1))
    b = F.pad(weight, (0, 0, 1, 0))
    dbasis = torch.cat(
        [torch.einsum("bfc,bfh->hc", a, g), torch.einsum("bfc,bfh->hc", b, g)]
    ).to(basis.dtype)
    return dweight, dbasis


def _launch(op: str, dtype: torch.dtype, weight: torch.Tensor,
            basis: torch.Tensor) -> torch.Tensor:
    """The kernel's form of `dtype` (named `op`): weight (B, F, C) and basis
    (L, C) of that type, contiguous, on one CUDA device -> float32 wav."""
    _build.check_form(op, weight, dtype)
    for name, t in (("weight", weight), ("basis", basis)):
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{op}: {name} must be a contiguous {dtype} CUDA tensor, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
    if weight.device != basis.device:
        raise ValueError(f"{op}: weight on {weight.device}, basis on {basis.device}")
    if weight.dim() != 3 or basis.dim() != 2 or weight.shape[2] != basis.shape[1]:
        raise ValueError(
            f"{op}: want weight (B, F, C) and basis (L, C), got "
            f"{tuple(weight.shape)} and {tuple(basis.shape)}"
        )
    B, Fr, C = weight.shape
    L = basis.shape[0]
    vec = 16 // weight.element_size()  # channels of a 16-byte copy
    if L % 2 or Fr < 1 or C % vec:
        raise ValueError(
            f"{op}: want even L, F >= 1 and C a multiple of {vec}, got L={L}, F={Fr}, C={C}"
        )
    if weight.data_ptr() % 16 or basis.data_ptr() % 16:
        raise ValueError(f"{op}: weight and basis must be 16-byte aligned")
    hop = L // 2
    lib = _build.library(NAME)
    if hop > lib.fvt_basis_decode_max_hop():
        raise ValueError(f"{op}: the kernel takes L up to {2 * lib.fvt_basis_decode_max_hop()}, "
                         f"got L={L}")
    out = torch.empty((B, (Fr + 1) * hop), dtype=torch.float32, device=weight.device)
    if B == 0:
        return out
    fn = lib.fvt_basis_decode_bf16 if dtype == torch.bfloat16 else lib.fvt_basis_decode
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(weight.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(weight.data_ptr(), basis.data_ptr(), out.data_ptr(), B, Fr, C, L, stream)
    _build.check_launch(op, err)
    return out


def basis_decode_cuda(weight: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; weight (B, F, C) and basis (L, C) float32,
    contiguous, on one CUDA device."""
    return _launch(NAME, torch.float32, weight, basis)


def basis_decode_bf16_cuda(weight: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """The kernel's bf16 form; weight (B, F, C) and basis (L, C) bf16,
    contiguous, on one CUDA device -> float32 wav.  Records no graph:
    gradients come through `basis_decode`."""
    _build.refuse_autograd(NAME_BF16, [weight, basis], _build.no_graph("basis_decode"))
    return _launch(NAME_BF16, torch.bfloat16, weight, basis)


class _BasisDecode(torch.autograd.Function):
    """Kernel forward (the form of the weights' type), plain-version VJP
    backward in the same type."""

    @staticmethod
    def forward(ctx, weight, basis):
        ctx.save_for_backward(weight, basis)
        if weight.dtype == torch.bfloat16:
            return basis_decode_bf16_cuda(weight, basis)
        return basis_decode_cuda(weight, basis)

    @staticmethod
    def backward(ctx, g):
        weight, basis = ctx.saved_tensors
        dweight, dbasis = basis_decode_vjp(weight, basis, g)
        return (
            dweight if ctx.needs_input_grad[0] else None,
            dbasis if ctx.needs_input_grad[1] else None,
        )


def basis_decode(weight: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """weight (B, F, C), basis (L, C) -> wav (B, (F + 1) * L/2), float32.
    The kernel on CUDA tensors (its bf16 form for bf16 weights, which takes
    the basis in bf16: `BasisSignalLayer` casts it), differentiable through
    the plain version's VJP; the plain version on CPU tensors."""
    if weight.is_cuda:
        return _BasisDecode.apply(weight, basis)
    return basis_decode_plain(weight, basis)
