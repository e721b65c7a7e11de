"""Fused MelGAN-family residual-stack chain: one launch per upsample stage.

Counterpart of `fastvocoder_tpu/ops/fused_resstack.py`.  A stage runs
sequential ResidualStacks, each

    leaky(0.2) -> reflect-pad -> dilated conv K -> leaky(0.2) -> 1x1 conv
    + a 1x1 skip conv of the stack's input.

`fused_residual_stacks` routes by device: CUDA tensors go to the
hand-written kernels, CPU tensors to `fused_residual_stacks_plain`, the
module semantics written out, which autograd differentiates.  On CUDA the
chain is a `torch.autograd.Function`: its forward is
`csrc/fused_resstack.cu`, which runs the whole chain from shared memory and
mirrors each stack's input at the sequence edges itself; its backward is
`csrc/fused_resstack_bwd.cu`, which recomputes the chain from x and returns
dx and every dW and db (`fused_residual_stacks_vjp_cuda`; the plain version
of the same function is `fused_residual_stacks_vjp_plain`).  The backward
needs every stack's margin to be at most T - 1, as torch's reflection pad
does.

Stacks are given as in the JAX package: per stack the tuple
(k_dilated (K, C, C), b_d (C,), dilation, k_1x1 (1, C, C), b_1 (C,),
k_skip (1, C, C), b_s (C,)), kernels laid out (tap, c_in, c_out).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from fastvocoder_tpu_torch.ops import _build
from fastvocoder_tpu_torch.ops.conv import conv1d, reflect_pad1d

NAME = "fused_resstack"
BWD_NAME = "fused_resstack_bwd"
KERNEL_WIDTHS = (32, 64, 128, 256)
SLOPE = 0.2  # leaky-relu slope of MelGAN's stacks (reference modules.py:320-382)

Stack = Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor, torch.Tensor,
              torch.Tensor, torch.Tensor]


def stack_margin(kernel_size: int, dilation: int) -> int:
    return (kernel_size - 1) // 2 * dilation


def leaky_relu(x: torch.Tensor, slope: float = SLOPE) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def leaf_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` that autograd can differentiate (a tensor made under
    inference_mode cannot be made to require a gradient)."""
    return t.detach().clone().requires_grad_(True)


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


def _check_chain(op: str, x: torch.Tensor, stacks: Sequence[Stack], max_stacks: int):
    """-> (B, T, C, K) after checking x and every operand of the chain."""
    if not x.is_cuda:
        raise ValueError(f"{op}: x must be a CUDA tensor, got {x.device}")
    if x.dim() != 3:
        raise ValueError(f"{op}: want x (B, T, C), got {tuple(x.shape)}")
    B, T, C = x.shape
    if C not in KERNEL_WIDTHS:
        raise ValueError(f"{op}: C={C} not in {KERNEL_WIDTHS}")
    _build.check_operand(op, "x", x, x.device)
    if not 1 <= len(stacks) <= max_stacks:
        raise ValueError(f"{op}: want 1..{max_stacks} stacks, got {len(stacks)}")
    K = stacks[0][0].shape[0]
    for i, (kd, bd, d, k1, b1, ks, bs) in enumerate(stacks):
        want = {"k_dilated": (kd, (K, C, C)), "b_d": (bd, (C,)),
                "k_1x1": (k1, (1, C, C)), "b_1": (b1, (C,)),
                "k_skip": (ks, (1, C, C)), "b_s": (bs, (C,))}
        for name, (w, shape) in want.items():
            if tuple(w.shape) != shape:
                raise ValueError(
                    f"{op}: stack {i} {name} has shape {tuple(w.shape)}, want {shape}"
                )
            _build.check_operand(op, f"stack {i} {name}", w, x.device)
    return B, T, C, K


def fused_residual_stacks_cuda(x: torch.Tensor, stacks: Sequence[Stack]) -> torch.Tensor:
    """Launch the forward kernel on x (B, T, C) float32, contiguous, on a
    CUDA device, C in `KERNEL_WIDTHS`.  Records no graph: gradients come
    through `fused_residual_stacks`."""
    if not x.is_cuda:
        raise ValueError(f"{NAME}: x must be a CUDA tensor, got {x.device}")
    lib = _build.library(NAME)
    B, T, C, K = _check_chain(NAME, x, stacks, lib.fvt_fused_resstacks_max_stacks())
    ptrs, dils = [], []
    for kd, bd, d, k1, b1, ks, bs in stacks:
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


Grads = List[Tuple[torch.Tensor, ...]]


def fused_residual_stacks_vjp_plain(x: torch.Tensor, stacks: Sequence[Stack],
                                    g: torch.Tensor) -> Tuple[torch.Tensor, Grads]:
    """The chain's vector-Jacobian product by autograd of the plain forward:
    (dx, per stack (dk_dilated, db_d, dk_1x1, db_1, dk_skip, db_s)), kernels
    (tap, c_in, c_out) as they were given."""
    with torch.enable_grad():
        xg = leaf_copy(x)
        leaves = [tuple(w if isinstance(w, int) else leaf_copy(w) for w in s)
                  for s in stacks]
        y = fused_residual_stacks_plain(xg, leaves)
        flat = [w for s in leaves for w in s if isinstance(w, torch.Tensor)]
        got = torch.autograd.grad(y, [xg] + flat, g)
    return got[0], [tuple(got[1 + 6 * i: 7 + 6 * i]) for i in range(len(stacks))]


def fused_residual_stacks_vjp_cuda(x: torch.Tensor, stacks: Sequence[Stack],
                                   g: torch.Tensor) -> Tuple[torch.Tensor, Grads]:
    """Launch the backward kernel: from x and the cotangent g of the chain's
    output, (dx, per stack (dk_dilated, db_d, dk_1x1, db_1, dk_skip, db_s)),
    float32.  The chain is recomputed from x on the card."""
    if not x.is_cuda:
        raise ValueError(f"{BWD_NAME}: x must be a CUDA tensor, got {x.device}")
    lib = _build.library(BWD_NAME)
    B, T, C, K = _check_chain(BWD_NAME, x, stacks, lib.fvt_fused_resstacks_bwd_max_stacks())
    if tuple(g.shape) != (B, T, C):
        raise ValueError(f"{BWD_NAME}: g has shape {tuple(g.shape)}, want {(B, T, C)}")
    _build.check_operand(BWD_NAME, "g", g, x.device)
    dx = torch.empty_like(x)
    grads = [tuple(torch.empty_like(w) for w in s if isinstance(w, torch.Tensor))
             for s in stacks]
    if B == 0 or T == 0:
        for group in grads:
            for t in group:
                t.zero_()
        return dx, grads
    margin = max(stack_margin(K, int(s[2])) for s in stacks)
    if margin > T - 1:
        raise ValueError(
            f"{BWD_NAME}: a stack mirrors {margin} rows at each edge and needs T > {margin}, "
            f"got T={T}"
        )
    # the adjoint convs read each kernel with its channel axes swapped
    swapped = [(kd.transpose(1, 2).contiguous(), k1.transpose(1, 2).contiguous(),
                ks.transpose(1, 2).contiguous()) for kd, _, _, k1, _, ks, _ in stacks]
    ptrs, outs, dils = [], [], []
    for (kd, bd, d, k1, b1, ks, bs), sw, group in zip(stacks, swapped, grads):
        ptrs += [kd.data_ptr(), bd.data_ptr(), k1.data_ptr(), b1.data_ptr(), ks.data_ptr(),
                 bs.data_ptr()] + [t.data_ptr() for t in sw]
        outs += [t.data_ptr() for t in group]
        dils.append(int(d))
    dil_arr = (ctypes.c_int * len(dils))(*dils)
    size_fn = lib.fvt_fused_resstacks_bwd_scratch_floats
    size_fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    size_fn.restype = ctypes.c_longlong
    n_scratch = size_fn(B, T, C, len(stacks), K, ctypes.addressof(dil_arr))
    if n_scratch < 0:
        raise ValueError(f"{BWD_NAME}: the kernel refuses this chain")
    # the caching allocator hands the same block back on every step
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    fn = lib.fvt_fused_resstacks_bwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    ptr_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    out_arr = (ctypes.c_void_p * len(outs))(*outs)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(), scratch.data_ptr(), B, T, C,
                 len(stacks), K, ctypes.addressof(dil_arr), ctypes.addressof(ptr_arr),
                 ctypes.addressof(out_arr), stream)
    _build.check_launch(BWD_NAME, err)
    return dx, grads


def _pack(dilations, tensors) -> List[Stack]:
    it = iter(tensors)
    return [(next(it), next(it), d, next(it), next(it), next(it), next(it)) for d in dilations]


class _FusedResidualStacks(torch.autograd.Function):
    """The chain on CUDA: forward kernel, backward kernel.  Saves x and the
    weights; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, dilations, *tensors):
        ctx.dilations = dilations
        ctx.save_for_backward(x, *tensors)
        return fused_residual_stacks_cuda(x, _pack(dilations, tensors))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, *tensors = ctx.saved_tensors
        dx, grads = fused_residual_stacks_vjp_cuda(x, _pack(ctx.dilations, tensors),
                                                   g.contiguous())
        return (dx, None, *[t for group in grads for t in group])


def fused_residual_stacks(x: torch.Tensor, stacks: Sequence[Stack]) -> torch.Tensor:
    """Apply a ResidualStack chain to x (B, T, C): the kernels on CUDA
    tensors (with their own backward), the plain version on CPU tensors."""
    if x.is_cuda:
        dilations = tuple(int(s[2]) for s in stacks)
        tensors = [w.contiguous() for s in stacks for w in s if isinstance(w, torch.Tensor)]
        return _FusedResidualStacks.apply(x, dilations, *tensors)
    return fused_residual_stacks_plain(x, stacks)
