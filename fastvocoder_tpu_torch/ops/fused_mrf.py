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

The forward has a bf16 form (`fused_mrf_stage_bf16_cuda`, counted as
`NAME_BF16`): bf16 x and y, the float32 kernels packed as bf16 once, in a
`StageTable` of that type, one bf16 product a depth step with float32 sums,
rounded to bf16 where the JAX package's Pallas body rounds in bf16
(`fused_mrf.py:162-172`: each conv's output after its bias, each
leaky-relu, each residual sum, the branches' sum and their mean).  Its
plain version is `fused_mrf_stage_plain` given bf16 x.  Each form refuses
the other's x and the other's table.

So has the backward (`fused_mrf_stage_vjp_bf16_cuda`, counted as
`BWD_NAME_BF16`): bf16 x, g and weights in, dx and every dW and db out in
bf16, computed as the Pallas backward body computes them
(`fused_mrf.py:259-264, 276-279, 452, 461`): the float32 VJP of the
float32 upcasts, rounded to bf16 once.  The JAX package sums the branches'
dx in bf16 (`:488-517`) and, below C = 128, the bf16 partials of its
blocked weights (`:66-90`); here both sums are float32 until the one
rounding.  Its plain version is `fused_mrf_stage_vjp_plain` given bf16 x.
Training with compute_dtype bf16 goes through `fused_mrf_stage`, which
casts the weights to bf16 for the backward form (autograd saves the casts)
and runs both bf16 forms; the wrappers themselves record no graph.

Branches are given as in the JAX package: per branch a list of pairs
(k1 (K1, C, C), b1 (C,), dilation, k2 (K2, C, C), b2 (C,)), kernels laid
out (tap, c_in, c_out).  The kernels' B operand wants the contracted channel
contiguous: a forward conv reads its kernel as (tap, c_out, c_in)
(`swap_channels`), the adjoint conv of the backward as it is given.  The
float32 forward takes the swapped copies as `swapped`, so that a caller can
cache them (`models/layers.py`), and builds them when given none; the bf16
forward's table and both backward forms take the kernels as given, and
their pack launch swaps the channel axes.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from fastvocoder_tpu_torch.ops import _build
from fastvocoder_tpu_torch.ops.conv import conv1d
from fastvocoder_tpu_torch.ops.fused_resstack import leaf_copy, leaky_relu
from fastvocoder_tpu_torch.ops.precision import fit, widen

NAME = "fused_mrf"
NAME_BF16 = "fused_mrf_bf16"
BWD_NAME = "fused_mrf_bwd"
BWD_NAME_BF16 = "fused_mrf_bwd_bf16"
BF16 = torch.bfloat16
KERNEL_WIDTHS = (16, 32, 64, 128, 256)
LRELU_SLOPE = 0.1  # HiFiGAN's resblocks (reference modules.py:9)

Pair = Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor, torch.Tensor]


def tap_major_to_torch(k: torch.Tensor) -> torch.Tensor:
    """(K, Cin, Cout) -> torch's conv weight (Cout, Cin, K)."""
    return k.permute(2, 1, 0)


def resblock1_plain(x: torch.Tensor, pairs: Sequence[Pair],
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One ResBlock1 branch: its pairs in turn, zero "same" padding.  With
    `dtype` bf16, x holds bf16 values in float32 and the arithmetic is the
    bf16 form's (`precision.fit` where the kernel rounds)."""
    h = x
    for k1, b1, d, k2, b2 in pairs:
        k1, b1, k2, b2 = (fit(w, dtype) for w in (k1, b1, k2, b2))
        t = fit(leaky_relu(h, LRELU_SLOPE), dtype)
        t = conv1d(t, tap_major_to_torch(k1), b1, padding=(k1.shape[0] - 1) * d // 2, dilation=d)
        t = fit(leaky_relu(fit(t, dtype), LRELU_SLOPE), dtype)
        t = fit(conv1d(t, tap_major_to_torch(k2), b2, padding=(k2.shape[0] - 1) // 2), dtype)
        h = fit(h + t, dtype)
    return h


def fused_mrf_stage_plain(x: torch.Tensor, resblocks: Sequence[Sequence[Pair]]) -> torch.Tensor:
    """The stage with module semantics, in x's type: sum of the branches
    in order, divided by their count (for bf16 x each sum and the quotient
    rounded, as the bf16 form rounds)."""
    dt = x.dtype
    acc = None
    for pairs in resblocks:
        h = resblock1_plain(widen(x), pairs, dt)
        acc = h if acc is None else fit(acc + h, dt)
    return fit(acc / len(resblocks), dt).to(dt)


def mrf_table(op: str, resblocks: Sequence[Sequence[Pair]], C: int, device: torch.device,
              max_branches: int, max_pairs: int, dtype: torch.dtype = torch.float32):
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
                _build.check_operand(op, f"branch {i} pair {j} {name}", w, device, dtype)
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
    once: the (K1, dilation, K2) table and the pointers (k1, b1, k2, b2)
    per pair.  It keeps the tensors alive.  A caller whose operands stay (a
    served model: 0.2 ms of host time a stage to check 54 tensors) builds it
    once and hands it to the form of its `dtype` with them.  The float32
    form packs the kernels on every call, from their swapped copies
    (`swapped`, built when None: k as (tap, c_out, c_in)); a bf16 table
    holds them packed as bf16 by one launch, here, which swaps their
    channel axes itself and so takes no swapped copies."""

    def __init__(self, resblocks: Sequence[Sequence[Pair]], swapped: Optional[Swapped],
                 device: torch.device, dtype: torch.dtype = torch.float32):
        lib = _build.library(NAME)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{NAME}: no kernel form for {dtype}")
        self.C, self.device, self.dtype = resblocks[0][0][0].shape[1], device, dtype
        self.nb, self.np_, self.ints, _ = mrf_table(
            NAME, resblocks, self.C, device, lib.fvt_fused_mrf_max_branches(),
            lib.fvt_fused_mrf_max_pairs())
        if dtype == torch.bfloat16:
            if swapped is not None:
                raise ValueError(f"{NAME_BF16}: the bf16 form packs the kernels as they are "
                                 f"given and takes no swapped copies")
            kernels = [[(k1, k2) for k1, _, _, k2, _ in pairs] for pairs in resblocks]
        else:
            if swapped is None:
                swapped = swap_channels(resblocks)
            _check_swapped(NAME, resblocks, swapped)
            kernels = swapped
        self.keep = (resblocks, swapped)
        ptrs = [p for pairs, ks in zip(resblocks, kernels)
                for (_, b1, _, _, b2), (k1, k2) in zip(pairs, ks)
                for p in (k1.data_ptr(), b1.data_ptr(), k2.data_ptr(), b2.data_ptr())]
        self.ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
        self.packed = None
        if dtype == torch.bfloat16:
            size_fn = lib.fvt_fused_mrf_bf16_packed_elems
            size_fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
            size_fn.restype = ctypes.c_longlong
            n_packed = size_fn(self.C, self.nb, self.np_, ctypes.addressof(self.ints))
            if n_packed < 0:
                raise ValueError(f"{NAME_BF16}: the kernel refuses this stage")
            self.packed = torch.empty(n_packed, dtype=dtype, device=device)
            fn = lib.fvt_fused_mrf_bf16_pack
            fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream().cuda_stream
                err = fn(self.packed.data_ptr(), self.C, self.nb, self.np_,
                         ctypes.addressof(self.ints), ctypes.addressof(self.ptrs), stream)
            if err != 0:
                raise RuntimeError(f"{NAME_BF16} kernel packing failed: CUDA error {err}")


def _stage_table(op: str, dtype: torch.dtype, x: torch.Tensor,
                 resblocks: Sequence[Sequence[Pair]], swapped: Optional[Swapped],
                 table: Optional[StageTable]):
    """-> (B, T, C, table) for the form of `dtype` (named `op`) on x."""
    if table is not None:
        _build.check_table(op, table, x)
    B, T, C = _build.check_x(op, x, KERNEL_WIDTHS, dtype)
    if table is None:
        if not resblocks or not resblocks[0]:
            raise ValueError(f"{op}: want at least one branch of at least one pair")
        table = StageTable(resblocks, swapped, x.device, dtype)
    if table.C != C or table.device != x.device:
        raise ValueError(f"{op}: the stage's operands are for C={table.C} on {table.device}, "
                         f"x is (B, T, {C}) on {x.device}")
    return B, T, C, table


def fused_mrf_stage_cuda(x: torch.Tensor, resblocks: Sequence[Sequence[Pair]],
                         swapped: Optional[Swapped] = None,
                         table: Optional[StageTable] = None) -> torch.Tensor:
    """Launch the forward kernel on x (B, T, C) float32, contiguous, on a
    CUDA device, C in `KERNEL_WIDTHS`.  `swapped`: `swap_channels(resblocks)`
    where the caller keeps it; `table`: `StageTable(resblocks, swapped,
    x.device)` where the caller keeps that too.  Records no graph: gradients
    come through `fused_mrf_stage`."""
    B, T, C, table = _stage_table(NAME, torch.float32, x, resblocks, swapped, table)
    lib = _build.library(NAME)
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


def fused_mrf_stage_bf16_cuda(x: torch.Tensor, resblocks: Sequence[Sequence[Pair]],
                              swapped: Optional[Swapped] = None,
                              table: Optional[StageTable] = None) -> torch.Tensor:
    """The forward kernel's bf16 form on x (B, T, C) bf16, contiguous, on a
    CUDA device: y bf16.  The operands are float32, as a model's
    parameters; `swapped` must be None (the form's pack swaps the kernels
    itself); `table`: `StageTable(resblocks, None, x.device,
    torch.bfloat16)` where the caller keeps it (its kernels packed as bf16
    once).  Records no graph: gradients come through `fused_mrf_stage`."""
    _build.refuse_autograd(NAME_BF16, [x] + [w for pairs in resblocks for p in pairs for w in p
                                             if isinstance(w, torch.Tensor)],
                           _build.no_graph("fused_mrf_stage"))
    B, T, C, table = _stage_table(NAME_BF16, torch.bfloat16, x, resblocks, swapped, table)
    lib = _build.library(NAME)
    y = torch.empty_like(x)
    if B == 0 or T == 0:
        return y
    # the caching allocator hands the same block back on every call
    scratch = torch.empty(2 * table.nb * B * T * C, dtype=torch.bfloat16, device=x.device)
    fn = lib.fvt_fused_mrf_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), scratch.data_ptr(), table.packed.data_ptr(), B, T,
                 C, table.nb, table.np_, ctypes.addressof(table.ints),
                 ctypes.addressof(table.ptrs), stream)
    _build.check_launch(NAME_BF16, err)
    return y


Grads = List[List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]]


def fused_mrf_stage_vjp_plain(x: torch.Tensor, resblocks: Sequence[Sequence[Pair]],
                              g: torch.Tensor) -> Tuple[torch.Tensor, Grads]:
    """The stage's vector-Jacobian product by autograd of the plain
    forward: (dx, per branch per pair (dk1, db1, dk2, db2)), kernels
    (tap, c_in, c_out) as they were given.  For bf16 x, the backward's bf16
    form: the float32 VJP of the float32 upcasts of x, g and the weights
    (float32 weights rounded to bf16 first), every result rounded to bf16
    once."""
    if x.dtype == BF16:
        up = [[tuple(w if isinstance(w, int) else fit(w.float(), BF16) for w in p)
               for p in pairs] for pairs in resblocks]
        dx, grads = fused_mrf_stage_vjp_plain(x.float(), up, fit(g.float(), BF16))
        return dx.to(BF16), [[tuple(t.to(BF16) for t in group) for group in pairs]
                             for pairs in grads]
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


def _run_backward(op: str, dtype: torch.dtype, x: torch.Tensor,
                  resblocks: Sequence[Sequence[Pair]],
                  g: torch.Tensor) -> Tuple[torch.Tensor, Grads]:
    """The backward kernel's form of `dtype` (named `op`): x, g and the
    stage's tensors of that type, the kernels (tap, c_in, c_out) as given
    (the recompute's forward convs read them with their channel axes
    swapped, which the kernel's pack launch does)."""
    B, T, C = _build.check_x(op, x, KERNEL_WIDTHS, dtype)
    if tuple(g.shape) != (B, T, C):
        raise ValueError(f"{op}: g has shape {tuple(g.shape)}, want {(B, T, C)}")
    _build.check_operand(op, "g", g, x.device, dtype)
    lib = _build.library(BWD_NAME)
    nb, np_, ints, ptr_arr = mrf_table(op, resblocks, C, x.device,
                                       lib.fvt_fused_mrf_bwd_max_branches(),
                                       lib.fvt_fused_mrf_bwd_max_pairs(), dtype)
    dx = torch.empty_like(x)
    grads = [[(torch.empty_like(k1), torch.empty_like(b1), torch.empty_like(k2),
               torch.empty_like(b2)) for k1, b1, _, k2, b2 in pairs] for pairs in resblocks]
    if B == 0 or T == 0:
        for pairs in grads:
            for group in pairs:
                for t in group:
                    t.zero_()
        return dx, grads
    bf16 = dtype == BF16
    outs = [t.data_ptr() for pairs in grads for group in pairs for t in group]
    size_fn = (lib.fvt_fused_mrf_bwd_bf16_scratch_floats if bf16
               else lib.fvt_fused_mrf_bwd_scratch_floats)
    size_fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    size_fn.restype = ctypes.c_longlong
    n_scratch = size_fn(B, T, C, nb, np_, ctypes.addressof(ints))
    if n_scratch < 0:
        raise ValueError(f"{op}: the kernel refuses this stage")
    # the caching allocator hands the same block back on every step
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    fn = lib.fvt_fused_mrf_bwd_bf16 if bf16 else lib.fvt_fused_mrf_bwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    out_arr = (ctypes.c_void_p * len(outs))(*outs)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(), scratch.data_ptr(), B, T, C, nb, np_,
                 ctypes.addressof(ints), ctypes.addressof(ptr_arr), ctypes.addressof(out_arr),
                 stream)
    _build.check_launch(op, err)
    return dx, grads


def fused_mrf_stage_vjp_cuda(x: torch.Tensor, resblocks: Sequence[Sequence[Pair]],
                             g: torch.Tensor) -> Tuple[torch.Tensor, Grads]:
    """Launch the backward kernel: from x and the cotangent g of the stage's
    output, (dx, per branch per pair (dk1, db1, dk2, db2)), float32, kernels
    (tap, c_in, c_out).  The stage is recomputed from x on the card."""
    return _run_backward(BWD_NAME, torch.float32, x, resblocks, g)


def fused_mrf_stage_vjp_bf16_cuda(x: torch.Tensor, resblocks: Sequence[Sequence[Pair]],
                                  g: torch.Tensor) -> Tuple[torch.Tensor, Grads]:
    """The backward kernel's bf16 form: x, g (B, T, C) and every weight and
    bias bf16 (a model's float32 parameters cast, as training in bf16 casts
    them) -> dx and the gradients, bf16, each the float32 VJP rounded once."""
    return _run_backward(BWD_NAME_BF16, BF16, x, resblocks, g)


def _pack(dilations, tensors) -> List[List[Pair]]:
    it = iter(tensors)
    return [[(next(it), next(it), d, next(it), next(it)) for d in branch] for branch in dilations]


class _FusedMRFStage(torch.autograd.Function):
    """The MRF stage on CUDA: forward kernel, backward kernel, both in x's
    type.  `forward_operands`: what the forward form reads, values only:
    (the stage's float32 operands, their swapped copies for float32 x or
    None for bf16 x, whose form packs the float32 values as the bf16 casts
    in `tensors` round them).  Saves x and `tensors` (bf16 for bf16 x); the
    backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, dilations, forward_operands, *tensors):
        ctx.dilations = dilations
        ctx.save_for_backward(x, *tensors)
        form = fused_mrf_stage_bf16_cuda if x.dtype == BF16 else fused_mrf_stage_cuda
        return form(x, *forward_operands)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, *tensors = ctx.saved_tensors
        vjp = fused_mrf_stage_vjp_bf16_cuda if x.dtype == BF16 else fused_mrf_stage_vjp_cuda
        dx, grads = vjp(x, _pack(ctx.dilations, tensors), g.to(x.dtype).contiguous())
        flat = [t for pairs in grads for group in pairs for t in group]
        return (dx, None, None, *flat)


def fused_mrf_stage(x: torch.Tensor, resblocks: Sequence[Sequence[Pair]],
                    swapped: Optional[Swapped] = None,
                    table: Optional[StageTable] = None) -> torch.Tensor:
    """Apply an MRF stage to x (B, T, C): the kernels on CUDA tensors, the
    forms of x's type, with their own backward (for bf16 x the weights are
    cast to bf16 for the backward form, and autograd carries their
    gradients back through the casts); the plain version on CPU tensors.
    `swapped`: for float32 x, `swap_channels(resblocks)` where the caller
    keeps it (the values only: no gradient flows through it); `table`: the
    `StageTable` of both in x's type, used where nothing needs a
    gradient."""
    if x.is_cuda:
        bf16 = x.dtype == BF16
        tensors = [w for pairs in resblocks for p in pairs for w in p
                   if isinstance(w, torch.Tensor)]
        if not (torch.is_grad_enabled() and any(t.requires_grad for t in [x] + tensors)):
            # nothing to differentiate
            return (fused_mrf_stage_bf16_cuda if bf16 else
                    fused_mrf_stage_cuda)(x, resblocks, swapped, table)
        dilations = tuple(tuple(int(p[2]) for p in pairs) for pairs in resblocks)
        tensors = [w.contiguous() for w in tensors]
        values = _pack(dilations, [w.detach().float() for w in tensors])
        if swapped is not None:
            swapped = [[(k1t.detach(), k2t.detach()) for k1t, k2t in sw] for sw in swapped]
        elif not bf16:
            with torch.no_grad():
                swapped = swap_channels(values)
        if bf16:
            tensors = [w.to(BF16) for w in tensors]
        return _FusedMRFStage.apply(x, dilations, (values, swapped), *tensors)
    return fused_mrf_stage_plain(x, resblocks)
