"""Fused HiFiGAN MRF stage: the mean over a stage's ResBlock1 branches.

Counterpart of `fastvocoder_tpu/ops/fused_mrf.py`, forward and backward.
Each branch is a chain of pairs

    h = h + conv_K2(leaky(conv_K1,d(leaky(h)) + b1)) + b2

with leaky slope 0.1 and zero "same" padding ((K - 1) d // 2) on every
conv's own input; the stage returns the mean of the branches' outputs.

`fused_mrf_stage` routes by device: CUDA tensors go to the hand-written
kernels, CPU tensors to `fused_mrf_stage_plain`, the module semantics
written out, which autograd differentiates.  On CUDA the stage is a
`torch.autograd.Function`: its forward is `csrc/fused_mrf.cu`, its backward
`csrc/fused_mrf_bwd.cu`, which recomputes the stage from x and returns dx
and every dW and db (`fused_mrf_stage_vjp_cuda`; the plain version of the
same function is `fused_mrf_stage_vjp_plain`).  The TPU kernel's blocked
(B, Q, 128) layout, block-Toeplitz weights and `T % (128 // C)` gate have no
counterpart here: the kernels take any T >= 1 and any B.

Both kernels contract on the tensor cores in 3xTF32 (`csrc/mma_common.cuh`;
`ops/tf32.py` models the arithmetic): operands split into two TF32 halves,
three products, float32 sums, which keeps float32 accuracy.

Branches are given as in the JAX package: per branch a list of pairs
(k1 (K1, C, C), b1 (C,), dilation, k2 (K2, C, C), b2 (C,)), kernels laid
out (tap, c_in, c_out).  The kernels' B operand wants the contracted channel
contiguous: a forward conv reads its kernel as (tap, c_out, c_in)
(`swap_channels`), the adjoint conv of the backward as it is given.  The
CUDA wrappers take the swapped copies as `swapped`, so that a caller can
cache them (`models/layers.py`), and build them when given none.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from fastvocoder_tpu_torch.ops import _build
from fastvocoder_tpu_torch.ops.conv import conv1d
from fastvocoder_tpu_torch.ops.fused_resstack import leaf_copy, leaky_relu

NAME = "fused_mrf"
BWD_NAME = "fused_mrf_bwd"
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


Swapped = Sequence[Sequence[Tuple[torch.Tensor, torch.Tensor]]]


def swap_channels(resblocks: Sequence[Sequence[Pair]]) -> Swapped:
    """Per branch per pair (k1, k2) as (tap, c_out, c_in), contiguous: the
    layout a forward conv's kernel has as the tensor cores' B operand."""
    return [[(k1.transpose(1, 2).contiguous(), k2.transpose(1, 2).contiguous())
             for k1, _, _, k2, _ in pairs] for pairs in resblocks]


def _check_swapped(op: str, resblocks: Sequence[Sequence[Pair]], swapped: Swapped) -> None:
    if [len(sw) for sw in swapped] != [len(pairs) for pairs in resblocks]:
        raise ValueError(f"{op}: `swapped` does not match the branches' pairs")
    for i, (pairs, sw) in enumerate(zip(resblocks, swapped)):
        for j, ((k1, _, _, k2, _), (k1t, k2t)) in enumerate(zip(pairs, sw)):
            for name, k, kt in (("k1", k1, k1t), ("k2", k2, k2t)):
                if tuple(kt.shape) != (k.shape[0], k.shape[2], k.shape[1]):
                    raise ValueError(f"{op}: branch {i} pair {j} swapped {name} has shape "
                                     f"{tuple(kt.shape)}")
                _build.check_operand(op, f"branch {i} pair {j} swapped {name}", kt, k.device)


class StageTable:
    """What the forward's C entry point takes of a stage's operands, checked
    once: the (K1, dilation, K2) table and the pointers (k1 as
    (tap, c_out, c_in), b1, k2 as (tap, c_out, c_in), b2) per pair.  It keeps
    the tensors alive.  A caller whose operands stay (a served model: 0.2 ms
    of host time a stage to check 54 tensors) builds it once and hands it to
    `fused_mrf_stage_cuda` with them."""

    def __init__(self, resblocks: Sequence[Sequence[Pair]], swapped: Optional[Swapped],
                 device: torch.device):
        lib = _build.library(NAME)
        self.C, self.device = resblocks[0][0][0].shape[1], device
        self.nb, self.np_, self.ints, _ = mrf_table(
            NAME, resblocks, self.C, device, lib.fvt_fused_mrf_max_branches(),
            lib.fvt_fused_mrf_max_pairs())
        if swapped is None:
            swapped = swap_channels(resblocks)
        _check_swapped(NAME, resblocks, swapped)
        self.keep = (resblocks, swapped)
        ptrs = [p for pairs, sw in zip(resblocks, swapped)
                for (_, b1, _, _, b2), (k1t, k2t) in zip(pairs, sw)
                for p in (k1t.data_ptr(), b1.data_ptr(), k2t.data_ptr(), b2.data_ptr())]
        self.ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)


def fused_mrf_stage_cuda(x: torch.Tensor, resblocks: Sequence[Sequence[Pair]],
                         swapped: Optional[Swapped] = None,
                         table: Optional[StageTable] = None) -> torch.Tensor:
    """Launch the forward kernel on x (B, T, C) float32, contiguous, on a
    CUDA device, C in `KERNEL_WIDTHS`.  `swapped`: `swap_channels(resblocks)`
    where the caller keeps it; `table`: `StageTable(resblocks, swapped,
    x.device)` where the caller keeps that too.  Records no graph: gradients
    come through `fused_mrf_stage`."""
    B, T, C = _build.check_x(NAME, x, KERNEL_WIDTHS)
    lib = _build.library(NAME)
    if table is None:
        if not resblocks or not resblocks[0]:
            raise ValueError(f"{NAME}: want at least one branch of at least one pair")
        table = StageTable(resblocks, swapped, x.device)
    if table.C != C or table.device != x.device:
        raise ValueError(f"{NAME}: the stage's operands are for C={table.C} on {table.device}, "
                         f"x is (B, T, {C}) on {x.device}")
    nb, np_, ints, ptrs = table.nb, table.np_, table.ints, table.ptrs
    y = torch.empty_like(x)
    if B == 0 or T == 0:
        return y
    size_fn = lib.fvt_fused_mrf_scratch_floats
    size_fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    size_fn.restype = ctypes.c_longlong
    n_scratch = size_fn(B, T, C, nb, np_, ctypes.addressof(ints))
    if n_scratch < 0:
        raise ValueError(f"{NAME}: the kernel refuses this stage")
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    fn = lib.fvt_fused_mrf
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), scratch.data_ptr(), B, T, C, nb, np_,
                 ctypes.addressof(ints), ctypes.addressof(ptrs), stream)
    _build.check_launch(NAME, err)
    return y


Grads = List[List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]]


def fused_mrf_stage_vjp_plain(x: torch.Tensor, resblocks: Sequence[Sequence[Pair]],
                              g: torch.Tensor) -> Tuple[torch.Tensor, Grads]:
    """The stage's vector-Jacobian product by autograd of the plain
    forward: (dx, per branch per pair (dk1, db1, dk2, db2)), kernels
    (tap, c_in, c_out) as they were given."""
    with torch.enable_grad():
        xg = leaf_copy(x)
        leaves = [[(leaf_copy(k1), leaf_copy(b1), d, leaf_copy(k2), leaf_copy(b2))
                   for k1, b1, d, k2, b2 in pairs] for pairs in resblocks]
        y = fused_mrf_stage_plain(xg, leaves)
        flat = [w for pairs in leaves for p in pairs for w in p if isinstance(w, torch.Tensor)]
        got = torch.autograd.grad(y, [xg] + flat, g)
    it = iter(got[1:])
    return got[0], [[(next(it), next(it), next(it), next(it)) for _ in pairs]
                    for pairs in resblocks]


def fused_mrf_stage_vjp_cuda(x: torch.Tensor, resblocks: Sequence[Sequence[Pair]],
                             g: torch.Tensor,
                             swapped: Optional[Swapped] = None) -> Tuple[torch.Tensor, Grads]:
    """Launch the backward kernel: from x and the cotangent g of the stage's
    output, (dx, per branch per pair (dk1, db1, dk2, db2)), float32, kernels
    (tap, c_in, c_out).  The stage is recomputed from x on the card.
    `swapped`: `swap_channels(resblocks)` where the caller keeps it."""
    B, T, C = _build.check_x(BWD_NAME, x, KERNEL_WIDTHS)
    if tuple(g.shape) != (B, T, C):
        raise ValueError(f"{BWD_NAME}: g has shape {tuple(g.shape)}, want {(B, T, C)}")
    _build.check_operand(BWD_NAME, "g", g, x.device)
    lib = _build.library(BWD_NAME)
    nb, np_, ints, _ = mrf_table(BWD_NAME, resblocks, C, x.device,
                                 lib.fvt_fused_mrf_bwd_max_branches(),
                                 lib.fvt_fused_mrf_bwd_max_pairs())
    dx = torch.empty_like(x)
    grads = [[(torch.empty_like(k1), torch.empty_like(b1), torch.empty_like(k2),
               torch.empty_like(b2)) for k1, b1, _, k2, b2 in pairs] for pairs in resblocks]
    if B == 0 or T == 0:
        for pairs in grads:
            for group in pairs:
                for t in group:
                    t.zero_()
        return dx, grads
    # the recompute's forward convs read each kernel with its channel axes
    # swapped, the adjoint convs as it is
    if swapped is None:
        swapped = swap_channels(resblocks)
    _check_swapped(BWD_NAME, resblocks, swapped)
    ptrs: List[int] = []
    for pairs, sw in zip(resblocks, swapped):
        for (k1, b1, _, k2, b2), (k1t, k2t) in zip(pairs, sw):
            ptrs += [k1.data_ptr(), b1.data_ptr(), k2.data_ptr(), b2.data_ptr(),
                     k1t.data_ptr(), k2t.data_ptr()]
    outs = [t.data_ptr() for pairs in grads for group in pairs for t in group]
    size_fn = lib.fvt_fused_mrf_bwd_scratch_floats
    size_fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    size_fn.restype = ctypes.c_longlong
    n_scratch = size_fn(B, T, C, nb, np_, ctypes.addressof(ints))
    if n_scratch < 0:
        raise ValueError(f"{BWD_NAME}: the kernel refuses this stage")
    # the caching allocator hands the same block back on every step
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    fn = lib.fvt_fused_mrf_bwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    ptr_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    out_arr = (ctypes.c_void_p * len(outs))(*outs)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(), scratch.data_ptr(), B, T, C, nb, np_,
                 ctypes.addressof(ints), ctypes.addressof(ptr_arr), ctypes.addressof(out_arr),
                 stream)
    _build.check_launch(BWD_NAME, err)
    return dx, grads


def _pack(dilations, tensors) -> List[List[Pair]]:
    it = iter(tensors)
    return [[(next(it), next(it), d, next(it), next(it)) for d in branch] for branch in dilations]


class _FusedMRFStage(torch.autograd.Function):
    """The MRF stage on CUDA: forward kernel, backward kernel.  Saves x, the
    weights and their swapped copies; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, dilations, swapped, *tensors):
        ctx.dilations = dilations
        ctx.swapped = swapped
        ctx.save_for_backward(x, *tensors)
        return fused_mrf_stage_cuda(x, _pack(dilations, tensors), swapped)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, *tensors = ctx.saved_tensors
        dx, grads = fused_mrf_stage_vjp_cuda(x, _pack(ctx.dilations, tensors), g.contiguous(),
                                             ctx.swapped)
        flat = [t for pairs in grads for group in pairs for t in group]
        return (dx, None, None, *flat)


def fused_mrf_stage(x: torch.Tensor, resblocks: Sequence[Sequence[Pair]],
                    swapped: Optional[Swapped] = None,
                    table: Optional[StageTable] = None) -> torch.Tensor:
    """Apply an MRF stage to x (B, T, C): the kernels on CUDA tensors (with
    their own backward), the plain version on CPU tensors.  `swapped`:
    `swap_channels(resblocks)` where the caller keeps it (the values only: no
    gradient flows through it); `table`: the `StageTable` of both, used
    where nothing needs a gradient."""
    if x.is_cuda:
        tensors = [w for pairs in resblocks for p in pairs for w in p
                   if isinstance(w, torch.Tensor)]
        if not (torch.is_grad_enabled() and any(t.requires_grad for t in [x] + tensors)):
            return fused_mrf_stage_cuda(x, resblocks, swapped, table)  # nothing to differentiate
        dilations = tuple(tuple(int(p[2]) for p in pairs) for pairs in resblocks)
        tensors = [w.contiguous() for w in tensors]
        with torch.no_grad():
            if swapped is None:
                swapped = swap_channels(_pack(dilations, tensors))
            swapped = [[(k1t.detach(), k2t.detach()) for k1t, k2t in sw] for sw in swapped]
        return _FusedMRFStage.apply(x, dilations, swapped, *tensors)
    return fused_mrf_stage_plain(x, resblocks)
