"""Fused MelGAN-family residual-stack chain: one launch per upsample stage.

Counterpart of `fastvocoder_tpu/ops/fused_resstack.py`.  A stage runs
sequential ResidualStacks, each

    leaky(0.2) -> reflect-pad -> dilated conv K -> leaky(0.2) -> 1x1 conv
    + a 1x1 skip conv of the stack's input.

`fused_residual_stacks` routes by device: CUDA tensors go to the
hand-written kernels, CPU tensors to `fused_residual_stacks_plain`, the
module semantics written out, which autograd differentiates.  On CUDA the
chain is a `torch.autograd.Function`: its forward is
`csrc/fused_resstack.cu`, one launch a stack, which mirrors each stack's
input at the sequence edges itself; its backward is
`csrc/fused_resstack_bwd.cu`, which recomputes the chain from x and returns
dx and every dW and db (`fused_residual_stacks_vjp_cuda`; the plain version
of the same function is `fused_residual_stacks_vjp_plain`).  The backward
needs every stack's margin to be at most T - 1, as torch's reflection pad
does.  Both kernels contract on the tensor cores in 3xTF32
(`csrc/mma_common.cuh`; `ops/tf32.py` models the arithmetic), which keeps
float32 accuracy.  They read the kernels packed by a launch of their own,
from the layout given here; the forward takes them from a `ChainTable`,
which a served model keeps (`models/layers.py`).

The forward has a bf16 form (`fused_residual_stacks_bf16_cuda`, counted as
`NAME_BF16`): bf16 x and y, the float32 kernels packed as bf16 in a
`ChainTable` of that type, one bf16 product a depth step with float32 sums,
rounded to bf16 where the JAX package's Pallas body rounds in bf16
(`fused_resstack.py:182-192`: every conv's output, each leaky-relu, the
bias cast before it is added, the stack's sum).  Its plain version is
`fused_residual_stacks_plain` given bf16 x.  Each form refuses the other's
x and the other's table.

So has the backward (`fused_residual_stacks_vjp_bf16_cuda`, counted as
`BWD_NAME_BF16`): bf16 x, g and weights in, dx and every dW and db out in
bf16, computed as the Pallas backward body computes them
(`fused_resstack.py:241-360, 419-430`): the float32 VJP of the float32
upcasts, rounded to bf16 once, on every row (the JAX package leaves the
mirrored edges to XLA's bf16 autograd; the kernel takes them in float32
too).  Its plain version is `fused_residual_stacks_vjp_plain` given bf16 x.
Training with compute_dtype bf16 (`--mixprecision`) goes through
`fused_residual_stacks`, which casts the float32 weights to bf16 (autograd
carries their bf16 gradients back through the casts into float32) and runs
both bf16 forms; the wrappers themselves record no graph.

Stacks are given as in the JAX package: per stack the tuple
(k_dilated (K, C, C), b_d (C,), dilation, k_1x1 (1, C, C), b_1 (C,),
k_skip (1, C, C), b_s (C,)), kernels laid out (tap, c_in, c_out).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from fastvocoder_tpu_torch.ops import _build
from fastvocoder_tpu_torch.ops.conv import conv1d, reflect_pad1d
from fastvocoder_tpu_torch.ops.precision import fit, widen

NAME = "fused_resstack"
NAME_BF16 = "fused_resstack_bf16"
BWD_NAME = "fused_resstack_bwd"
BWD_NAME_BF16 = "fused_resstack_bwd_bf16"
BF16 = torch.bfloat16
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
    """The chain with module semantics (reflect pads per stack), in x's
    type: for bf16 x the bf16 form's arithmetic, float32 sums of bf16
    operands rounded to bf16 where the kernel rounds."""
    dt = x.dtype
    h = widen(x)
    for stack in stacks:
        kd, bd, d, k1, b1, ks, bs = (w if isinstance(w, int) else fit(w, dt) for w in stack)
        t = fit(leaky_relu(h), dt)
        t = reflect_pad1d(t, stack_margin(kd.shape[0], d))
        t = fit(conv1d(t, _conv_weight(kd), bd, dilation=d), dt)
        t = fit(leaky_relu(t), dt)
        t = fit(conv1d(t, _conv_weight(k1), b1), dt)
        h = fit(t + fit(conv1d(h, _conv_weight(ks), bs), dt), dt)
    return h.to(dt)


def _check_stacks(op: str, stacks: Sequence[Stack], C: int, device: torch.device,
                  max_stacks: int, dtype: torch.dtype = torch.float32) -> int:
    """-> K after checking every operand of the chain."""
    if not 1 <= len(stacks) <= max_stacks:
        raise ValueError(f"{op}: want 1..{max_stacks} stacks, got {len(stacks)}")
    K = stacks[0][0].shape[0]
    for i, (kd, bd, d, k1, b1, ks, bs) in enumerate(stacks):
        if int(d) < 1:
            raise ValueError(f"{op}: stack {i} has dilation {d}, want >= 1")
        want = {"k_dilated": (kd, (K, C, C)), "b_d": (bd, (C,)),
                "k_1x1": (k1, (1, C, C)), "b_1": (b1, (C,)),
                "k_skip": (ks, (1, C, C)), "b_s": (bs, (C,))}
        for name, (w, shape) in want.items():
            if tuple(w.shape) != shape:
                raise ValueError(
                    f"{op}: stack {i} {name} has shape {tuple(w.shape)}, want {shape}"
                )
            _build.check_operand(op, f"stack {i} {name}", w, device, dtype)
    if K % 2 == 0:
        raise ValueError(f"{op}: want an odd kernel size, got {K}")
    return K


def _pointers(values) -> ctypes.Array:
    values = list(values)
    return (ctypes.c_void_p * len(values))(*values)


class ChainTable:
    """What the forward's C entry point takes of a chain's operands, checked
    once: the dilations, the bias pointers, and every kernel packed for the
    tensor cores (split into TF32 halves, or with `dtype` bf16 rounded to
    bf16, in the order the kernel reads them, by one launch).  It keeps the
    operands alive.  A caller whose operands stay (a served model) builds it
    once and hands it to the form of its `dtype` with them; built on every
    call, it costs the checks of 3 n + 3 n tensors and one launch."""

    def __init__(self, stacks: Sequence[Stack], device: torch.device,
                 dtype: torch.dtype = torch.float32):
        lib = _build.library(NAME)
        if not stacks:
            raise ValueError(f"{NAME}: want at least one stack")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{NAME}: no kernel form for {dtype}")
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.C, self.device, self.dtype = stacks[0][0].shape[1], device, dtype
        if self.C not in KERNEL_WIDTHS:
            raise ValueError(f"{NAME}: C={self.C} not in {KERNEL_WIDTHS}")
        self.n = len(stacks)
        self.K = _check_stacks(NAME, stacks, self.C, device, lib.fvt_fused_resstacks_max_stacks())
        self.keep = stacks
        self.dils = (ctypes.c_int * self.n)(*[int(s[2]) for s in stacks])
        self.biases = _pointers(w.data_ptr() for kd, bd, d, k1, b1, ks, bs in stacks
                                for w in (bd, b1, bs))
        bf16 = dtype == torch.bfloat16
        size_fn = (lib.fvt_fused_resstacks_bf16_packed_elems if bf16
                   else lib.fvt_fused_resstacks_packed_floats)
        size_fn.argtypes = [ctypes.c_int] * 3
        size_fn.restype = ctypes.c_longlong
        self.packed = torch.empty(size_fn(self.C, self.n, self.K), dtype=dtype, device=device)
        kernels = _pointers(w.data_ptr() for kd, bd, d, k1, b1, ks, bs in stacks
                            for w in (kd, k1, ks))
        fn = lib.fvt_fused_resstacks_bf16_pack if bf16 else lib.fvt_fused_resstacks_pack
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(self.packed.data_ptr(), self.C, self.n, self.K, ctypes.addressof(kernels),
                     stream)
        if err != 0:
            raise RuntimeError(f"{NAME} kernel packing failed: CUDA error {err}")


def _run_forward(op: str, dtype: torch.dtype, x: torch.Tensor, stacks: Sequence[Stack],
                 table: Optional[ChainTable]) -> torch.Tensor:
    """The forward kernel's form of `dtype` (named `op`) on x."""
    if table is not None:
        _build.check_table(op, table, x)
    B, T, C = _build.check_x(op, x, KERNEL_WIDTHS, dtype)
    lib = _build.library(NAME)
    if table is None:
        table = ChainTable(stacks, x.device, dtype)
    if table.C != C or table.device != x.device:
        raise ValueError(f"{op}: the chain's operands are for C={table.C} on {table.device}, "
                         f"x is (B, T, {C}) on {x.device}")
    y = torch.empty_like(x)
    if B == 0 or T == 0:
        return y
    size_fn = lib.fvt_fused_resstacks_scratch_floats
    size_fn.argtypes = [ctypes.c_int] * 4
    size_fn.restype = ctypes.c_longlong
    # the caching allocator hands the same block back on every call
    scratch = torch.empty(size_fn(B, T, C, table.n), dtype=dtype, device=x.device)
    fn = lib.fvt_fused_resstacks_bf16 if dtype == torch.bfloat16 else lib.fvt_fused_resstacks
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), scratch.data_ptr(), table.packed.data_ptr(), B, T,
                 C, table.n, table.K, ctypes.addressof(table.dils),
                 ctypes.addressof(table.biases), stream)
    _build.check_launch(op, err)
    return y


def fused_residual_stacks_cuda(x: torch.Tensor, stacks: Sequence[Stack],
                               table: Optional[ChainTable] = None) -> torch.Tensor:
    """Launch the forward kernel on x (B, T, C) float32, contiguous, on a
    CUDA device, C in `KERNEL_WIDTHS`.  `table`: `ChainTable(stacks,
    x.device)` where the caller keeps it.  Records no graph: gradients come
    through `fused_residual_stacks`."""
    return _run_forward(NAME, torch.float32, x, stacks, table)


def fused_residual_stacks_bf16_cuda(x: torch.Tensor, stacks: Sequence[Stack],
                                    table: Optional[ChainTable] = None) -> torch.Tensor:
    """The forward kernel's bf16 form on x (B, T, C) bf16, contiguous, on a
    CUDA device: y bf16.  `stacks` are float32, as a model's parameters;
    `table`: `ChainTable(stacks, x.device, torch.bfloat16)` where the caller
    keeps it.  Records no graph: gradients come through
    `fused_residual_stacks`."""
    _build.refuse_autograd(NAME_BF16, [x] + [w for s in stacks for w in s
                                             if isinstance(w, torch.Tensor)],
                           _build.no_graph("fused_residual_stacks"))
    return _run_forward(NAME_BF16, BF16, x, stacks, table)


Grads = List[Tuple[torch.Tensor, ...]]


def fused_residual_stacks_vjp_plain(x: torch.Tensor, stacks: Sequence[Stack],
                                    g: torch.Tensor) -> Tuple[torch.Tensor, Grads]:
    """The chain's vector-Jacobian product by autograd of the plain forward:
    (dx, per stack (dk_dilated, db_d, dk_1x1, db_1, dk_skip, db_s)), kernels
    (tap, c_in, c_out) as they were given.  For bf16 x, the backward's bf16
    form: the float32 VJP of the float32 upcasts of x, g and the weights
    (float32 weights rounded to bf16 first), every result rounded to bf16
    once."""
    if x.dtype == BF16:
        up = [tuple(w if isinstance(w, int) else fit(w.float(), BF16) for w in s)
              for s in stacks]
        dx, grads = fused_residual_stacks_vjp_plain(x.float(), up, fit(g.float(), BF16))
        return dx.to(BF16), [tuple(t.to(BF16) for t in group) for group in grads]
    with torch.enable_grad():
        xg = leaf_copy(x)
        leaves = [tuple(w if isinstance(w, int) else leaf_copy(w) for w in s)
                  for s in stacks]
        y = fused_residual_stacks_plain(xg, leaves)
        flat = [w for s in leaves for w in s if isinstance(w, torch.Tensor)]
        got = torch.autograd.grad(y, [xg] + flat, g)
    return got[0], [tuple(got[1 + 6 * i: 7 + 6 * i]) for i in range(len(stacks))]


def _run_backward(op: str, dtype: torch.dtype, x: torch.Tensor, stacks: Sequence[Stack],
                  g: torch.Tensor) -> Tuple[torch.Tensor, Grads]:
    """The backward kernel's form of `dtype` (named `op`): x, g and the
    stacks' tensors of that type."""
    B, T, C = _build.check_x(op, x, KERNEL_WIDTHS, dtype)
    lib = _build.library(BWD_NAME)
    K = _check_stacks(op, stacks, C, x.device, lib.fvt_fused_resstacks_bwd_max_stacks(), dtype)
    if tuple(g.shape) != (B, T, C):
        raise ValueError(f"{op}: g has shape {tuple(g.shape)}, want {(B, T, C)}")
    _build.check_operand(op, "g", g, x.device, dtype)
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
            f"{op}: a stack mirrors {margin} rows at each edge and needs T > {margin}, "
            f"got T={T}"
        )
    bf16 = dtype == BF16
    dil_arr = (ctypes.c_int * len(stacks))(*[int(s[2]) for s in stacks])
    size_fn = (lib.fvt_fused_resstacks_bwd_bf16_scratch_floats if bf16
               else lib.fvt_fused_resstacks_bwd_scratch_floats)
    size_fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    size_fn.restype = ctypes.c_longlong
    n_scratch = size_fn(B, T, C, len(stacks), K, ctypes.addressof(dil_arr))
    if n_scratch < 0:
        raise ValueError(f"{op}: the kernel refuses this chain")
    # the caching allocator hands the same block back on every step
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    fn = lib.fvt_fused_resstacks_bwd_bf16 if bf16 else lib.fvt_fused_resstacks_bwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    ptr_arr = _pointers(w.data_ptr() for s in stacks for w in s if isinstance(w, torch.Tensor))
    out_arr = _pointers(t.data_ptr() for group in grads for t in group)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(), scratch.data_ptr(), B, T, C,
                 len(stacks), K, ctypes.addressof(dil_arr), ctypes.addressof(ptr_arr),
                 ctypes.addressof(out_arr), stream)
    _build.check_launch(op, err)
    return dx, grads


def fused_residual_stacks_vjp_cuda(x: torch.Tensor, stacks: Sequence[Stack],
                                   g: torch.Tensor) -> Tuple[torch.Tensor, Grads]:
    """Launch the backward kernel: from x and the cotangent g of the chain's
    output, (dx, per stack (dk_dilated, db_d, dk_1x1, db_1, dk_skip, db_s)),
    float32.  The chain is recomputed from x on the card; the kernels are
    packed for the tensor cores, in both orientations, by the same call."""
    return _run_backward(BWD_NAME, torch.float32, x, stacks, g)


def fused_residual_stacks_vjp_bf16_cuda(x: torch.Tensor, stacks: Sequence[Stack],
                                        g: torch.Tensor) -> Tuple[torch.Tensor, Grads]:
    """The backward kernel's bf16 form: x, g (B, T, C) and every weight and
    bias bf16 (a model's float32 parameters cast, as training in bf16 casts
    them) -> dx and the gradients, bf16, each the float32 VJP rounded once."""
    return _run_backward(BWD_NAME_BF16, BF16, x, stacks, g)


def _pack(dilations, tensors) -> List[Stack]:
    it = iter(tensors)
    return [(next(it), next(it), d, next(it), next(it), next(it), next(it)) for d in dilations]


class _FusedResidualStacks(torch.autograd.Function):
    """The chain on CUDA: forward kernel, backward kernel, both in x's type.
    `values`: the chain's float32 operands, values only, which the forward
    form reads (for bf16 x its pack rounds them as the bf16 casts in
    `tensors` round them).  Saves x and `tensors` (bf16 for bf16 x); the
    backward recomputes the rest."""

    @staticmethod
    def forward(ctx, x, dilations, values, *tensors):
        ctx.dilations = dilations
        ctx.save_for_backward(x, *tensors)
        form = fused_residual_stacks_bf16_cuda if x.dtype == BF16 else fused_residual_stacks_cuda
        return form(x, values)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, *tensors = ctx.saved_tensors
        vjp = fused_residual_stacks_vjp_bf16_cuda if x.dtype == BF16 else \
            fused_residual_stacks_vjp_cuda
        dx, grads = vjp(x, _pack(ctx.dilations, tensors), g.to(x.dtype).contiguous())
        return (dx, None, None, *[t for group in grads for t in group])


def fused_residual_stacks(x: torch.Tensor, stacks: Sequence[Stack],
                          table: Optional[ChainTable] = None) -> torch.Tensor:
    """Apply a ResidualStack chain to x (B, T, C): the kernels on CUDA
    tensors, the forms of x's type, with their own backward (for bf16 x the
    weights are cast to bf16 for the backward form, and autograd carries
    their gradients back through the casts); the plain version on CPU
    tensors.  `table`: the chain's `ChainTable` of x's type, used where
    nothing needs a gradient."""
    if x.is_cuda:
        bf16 = x.dtype == BF16
        tensors = [w for s in stacks for w in s if isinstance(w, torch.Tensor)]
        if not (torch.is_grad_enabled() and any(t.requires_grad for t in [x] + tensors)):
            # nothing to differentiate
            return (fused_residual_stacks_bf16_cuda if bf16 else
                    fused_residual_stacks_cuda)(x, stacks, table)
        dilations = tuple(int(s[2]) for s in stacks)
        tensors = [w.contiguous() for w in tensors]
        values = _pack(dilations, [w.detach().float() for w in tensors])
        if bf16:
            tensors = [w.to(BF16) for w in tensors]
        return _FusedResidualStacks.apply(x, dilations, values, *tensors)
    return fused_residual_stacks_plain(x, stacks)
