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

At HiFiGAN light's width (C_out 16, stride 2, C_in 32) the bf16 form is
one launch, the TPU kernel's dataflow: a persistent block takes tiles of R
output rows and stages x's rows for the tile and a halo of H rows of h0
each side (`TailTable.plan`), then runs the upsample (a dense conv over input
rows with the block-Toeplitz weight of `blocked_upsample`), every branch's
pairs, the mean and the head from shared memory, and writes y once.  The
table then holds the upsample's taps packed after the MRF's
(`pack_blocked_upsample`).  Other widths run the five launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

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
# the shape the one-launch bf16 form takes (`csrc/fused_tail.cu`, fused::kC, kU)
FUSED_WIDTH, FUSED_STRIDE = 16, 2
CORE = 8  # rows and bf16 channels of a wgmma core matrix (16 bytes a row)


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


def blocked_upsample(up_kernel: torch.Tensor, stride: int, padding: int
                     ) -> Tuple[torch.Tensor, int, int]:
    """The transposed conv (K, Cin, Cout) of stride u as a dense conv over
    input rows: (W (Wj, Cin, u Cout), off, right) with output rows u q ..
    u q + u - 1 = sum_j x[q + j - off] @ W[j], channel block r of W's
    columns the output row u q + r (torch's semantics: out[t] = sum_k
    x[(t + padding - k) / u] kernel[k]).  The JAX package's
    `blocked_upconv_weight` at s_in = 1, s_out = u."""
    K, cin, cout = up_kernel.shape
    entries = []  # (input row offset, output row in the pair, tap)
    for rout in range(stride):
        for k in range(K):
            num = rout + padding - k
            if num % stride == 0:
                entries.append((num // stride, rout, k))
    jmin = min(e[0] for e in entries)
    jmax = max(e[0] for e in entries)
    w = up_kernel.new_zeros(jmax - jmin + 1, cin, stride * cout)
    for j, rout, k in entries:
        w[j - jmin, :, rout * cout:(rout + 1) * cout] += up_kernel[k]
    return w, -jmin, jmax


def pack_blocked_upsample(w: torch.Tensor) -> torch.Tensor:
    """W (Wj, K, N) (contracted, produced) -> bf16, flat, in the order the
    one-launch kernel reads it as a wgmma B operand: per tap, core matrices
    [K / 8][N / 8][8 produced][8 contracted] (`csrc/mma_common.cuh`, the
    unit of `Geo<N, bf16>` at N = K = 32: `pack_kernel`'s layout)."""
    wj, k, n = w.shape
    cores = w.reshape(wj, k // CORE, CORE, n // CORE, CORE)  # (j, kg, kk, ng, r8)
    return cores.permute(0, 1, 3, 4, 2).to(torch.bfloat16).reshape(-1).contiguous()


@dataclass(frozen=True)
class TailPlan:
    """How the one-launch tail tiles a call: `rows` (R) output rows a tile,
    `halo` (H) rows of h0 each side of it, a multiple of the stride; in
    output rows, the margins each branch's pairs consume on each side
    (`branch_margins`) and conv_post's (`post_margin`); the blocked
    upsample's `taps` and its margins in input rows (`up_margins`)."""

    rows: int
    halo: int
    branch_margins: Tuple[int, ...]
    post_margin: int
    taps: int
    up_margins: Tuple[int, int]
    tiles: int


def tail_margins(up_size: int, stride: int, padding: int, pair_sizes, post_size: int):
    """(halo, branch margins, post margin, taps, up margins) of a tail:
    `pair_sizes` per branch [(K1, dilation, K2), ...].  A same-padded conv
    of K taps at dilation d consumes (K - 1) d / 2 rows each side; h0's halo
    covers the largest branch plus conv_post, rounded up to whole input
    rows; the upsample's taps and margins are those of `blocked_upsample`."""
    branch = tuple(sum((k1 - 1) * d // 2 + (k2 - 1) // 2 for k1, d, k2 in pairs)
                   for pairs in pair_sizes)
    post = (post_size - 1) // 2
    halo = -(-(max(branch) + post) // stride) * stride
    offs = [(rout + padding - k) // stride for rout in range(stride) for k in range(up_size)
            if (rout + padding - k) % stride == 0]
    off, right = -min(offs), max(offs)
    return halo, branch, post, off + right + 1, (off, right)


def tile_rows(B: int, T: int, slots: int, rows_max: int) -> int:
    """R for B sequences of T output rows on `slots` persistent blocks, at
    most `rows_max` rows a tile: as few rounds of the grid as the largest
    tile allows, and then the smallest tile (a multiple of 16 rows) that
    keeps them, so that the rounds are evenly full."""
    if rows_max < 16:
        raise ValueError(f"{NAME_BF16}: no tile fits a block (at most {rows_max} rows)")
    per_seq = -(-T // rows_max)
    rounds = -(-B * per_seq // slots)
    per_seq = max(per_seq, rounds * slots // B)
    return min(rows_max, -(-(-(-T // per_seq)) // 16) * 16)


# the tail's kernels by role, as `fvt_fused_tail_launches` counts their launches
KERNEL_ROLES = ("tail_fused_bf16_kernel", "tail_upsample", "tail_pair", "tail_head")


def kernel_launches() -> Dict[str, int]:
    """Launches of each of the tail's kernels in this process (`KERNEL_ROLES`;
    the pair launches one a pair, both forms), as the library counts them
    where a launch succeeds: one call's kernels are the difference of two
    readings."""
    fn = _build.library(NAME).fvt_fused_tail_launches
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return {name: fn(i) for i, name in enumerate(KERNEL_ROLES)}


_SLOTS: Dict[torch.device, int] = {}


def _slots(device: torch.device) -> int:
    """Persistent blocks of the one-launch tail on `device`: one an SM."""
    if device not in _SLOTS:
        _SLOTS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SLOTS[device]


class TailTable:
    """What the kernel's C entry point takes of a tail's operands, checked
    once: the MRF's (K1, dilation, K2) table and pointers, its kernels
    packed for the tensor cores (split into TF32 halves, or with `dtype`
    bf16 rounded to bf16, in the order the pair launches read them, by one
    launch), and the upsample's and head's weights (for bf16 rounded copies).
    For the one-launch bf16 form (`fused`) the packed kernels are followed by
    the upsample's blocked taps (`up_off`), and the table holds the tile
    plan's fixed parts (`margins`: `tail_margins` of the tail; `rows_max`),
    so that a call only chooses R (`rows`).  It keeps the operands alive.  A caller whose
    operands stay (a served model) builds it once and hands it to the form
    of its `dtype`; built on every call it costs the checks of 41 tensors
    and one launch."""

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
        # the one-launch bf16 form where its block takes the tail: the
        # upsample's blocked taps after the MRF's
        self.fused, up_packed = False, None
        if bf16 and (C, stride, cin) == (FUSED_WIDTH, FUSED_STRIDE, FUSED_STRIDE * FUSED_WIDTH):
            pair_sizes = [[(p[0].shape[0], int(p[2]), p[3].shape[0]) for p in pairs]
                          for pairs in resblocks]
            self.margins = tail_margins(K, stride, padding, pair_sizes, Kp)
            self.halo, _, _, self.taps, (self.off_up, _) = self.margins
            reach = max(max((k1 - 1) * d // 2, (k2 - 1) // 2)
                        for pairs in pair_sizes for k1, d, k2 in pairs)
            self.up_off = -(-n_packed // 64) * 64  # on 128 bytes
            n_fused = self.up_off + self.taps * cin * stride * C
            self.rows_max = lib.fvt_tail_fused_max_rows(self.halo, self.taps, n_fused, reach)
            self.fused = self.rows_max >= 16
        if self.fused:
            up_packed = pack_blocked_upsample(blocked_upsample(self.up[0], stride, padding)[0])
            n_packed = n_fused
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
        if up_packed is not None:
            self.packed[self.up_off:].copy_(up_packed)

    def rows(self, B: int, T: int) -> int:
        """R of the one-launch form's tiles for B sequences of T output rows."""
        return tile_rows(B, T, _slots(self.device), self.rows_max)

    def plan(self, B: int, T: int) -> TailPlan:
        """The tiles of the one-launch form for B sequences of T output rows."""
        halo, branch, post, taps, up = self.margins
        rows = self.rows(B, T)
        return TailPlan(rows, halo, branch, post, taps, up, B * -(-T // rows))


# the C entries' arguments: the five launches' (`fvt_fused_tail`, its bf16
# form) and the one launch's (`fvt_fused_tail_bf16_tiled`)
_FIVE_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
              + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
              + [ctypes.c_void_p])
_TILED_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
               + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
               + [ctypes.c_void_p])


def _declared(fn, argtypes):
    """fn with its argument types, declared once a loaded library (ctypes
    keeps the function object): a call then builds no list of types."""
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


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
    lib = _build.library(NAME)
    (k_up, b_up), (k_post, b_post) = table.up, table.post
    if table.fused:
        fn = _declared(lib.fvt_fused_tail_bf16_tiled, _TILED_ARGS)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(x.data_ptr(), y.data_ptr(), table.packed.data_ptr(), table.packed.numel(),
                     table.up_off, B, T_in, cin, C, b_up.data_ptr(), table.stride, table.taps,
                     table.off_up, table.nb, table.np_, ctypes.addressof(table.ints),
                     ctypes.addressof(table.ptrs), k_post.data_ptr(), b_post.data_ptr(),
                     table.Kp, table.bands, table.rows(B, T), table.halo, _slots(dev), stream)
        _build.check_launch(op, err)
        return y
    # the caching allocator hands the same block back on every call
    scratch = torch.empty((2 * table.nb + 1) * B * T * C, dtype=dtype, device=dev)
    fn = _declared(lib.fvt_fused_tail_bf16 if dtype == torch.bfloat16 else lib.fvt_fused_tail,
                   _FIVE_ARGS)
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
    bands) bf16, in one launch at C_out 16, stride 2 and C_in 32 (HiFiGAN
    light), in five at the other widths.  The operands are float32, as a
    model's parameters; `table`: `TailTable(<the other operands>, x.device,
    torch.bfloat16)` where the caller keeps it."""
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
