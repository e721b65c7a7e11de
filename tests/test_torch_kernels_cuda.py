"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and `nvcc`; without a GPU every test here skips.
The file imports no JAX, so on a GPU machine without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: the plain versions run with TF32 off, so both sides are float32
and differ only in summation order.  The decode's bound is twice the worst-case
rounding of its 2C-term dot products; the chain's is the one the JAX
package's fused-stack test uses (isolated rows whose pre-activation sits
within rounding distance of the leaky-relu kink may flip branch), scaled by
the output's magnitude, and at least 90 % of rows must agree 100x tighter.
The MRF stage and the tail sum up to 6 convs of up to 11 C taps in a chain
(2816 products a row at C = 256), so their rows are held 30x looser than
the chain's (1e-5 of the magnitude), the MRF's maximum like the chain's and
the tail's, after tanh, within 1e-4.  The MRF and chain kernels and the
tail's MRF contract on the tensor cores in 3xTF32 (split operands, float32
sums), which is as close to float64 as float32 is
(`tests/test_torch_tf32_split.py`, `tests/test_torch_resstack_tf32.py`), so
they are held to the same bounds as the float32 CUDA-core kernels before
them.

The two backward kernels are held against the plain versions' autograd run
in float64 (`_f64`), so that only the kernel's own float32 rounding can put
a pre-activation on the other side of the leaky-relu kink.  One flipped
slope (about one element in a million) changes dx by a share of a weight's
size over every row the later convs' adjoints spread it to, 27 rows in the
chain and more in an MRF branch, and changes dW and db by one row's term of
their sums (measured on an H100 at (1, 2240, 256): without a flip every
gradient agrees to 1e-6 of its peak; with one, a run of 27 rows of dx is
off by 1e-2 and a dW by 1.5e-2).  Below 1000 rows the seeded cases have no
flip, and a fault at a tile's edge would show: every dW and db, a sum over
all B T rows, agrees within 2e-4 of its own peak, and 99.5 % of dx's rows
within 1e-4 of dx's peak.  From 1000 rows on a flip or two occur: dW and db
within 3e-2, 90 % of the rows.  Every row of dx is within 5e-2 of the peak
throughout.
"""

import os

import numpy as np
import pytest
import torch

from fastvocoder_tpu_torch.ops import _build
from fastvocoder_tpu_torch.ops.basis_decode import basis_decode, basis_decode_plain
from fastvocoder_tpu_torch.ops.fused_mrf import (
    fused_mrf_stage,
    fused_mrf_stage_cuda,
    fused_mrf_stage_plain,
    fused_mrf_stage_vjp_cuda,
    fused_mrf_stage_vjp_plain,
)
from fastvocoder_tpu_torch.ops.fused_resstack import (
    fused_residual_stacks,
    fused_residual_stacks_cuda,
    fused_residual_stacks_plain,
    fused_residual_stacks_vjp_cuda,
    fused_residual_stacks_vjp_plain,
)
from fastvocoder_tpu_torch.ops.fused_tail import fused_hifigan_tail_cuda, fused_hifigan_tail_plain

pytestmark = pytest.mark.cuda

EPS = float(np.finfo(np.float32).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stacks(C, device, seed=0, K=3, dilations=(1, 3, 9)):
    g = torch.Generator().manual_seed(seed)
    bound = 1.0 / np.sqrt(C * K)

    def u(*shape):
        return ((torch.rand(shape, generator=g) * 2 - 1) * bound).to(device)

    return [(u(K, C, C), u(C), d, u(1, C, C), u(C), u(1, C, C), u(C)) for d in dilations]


# tiles of 16 output frames (F + 1 of them a sequence): F = 1, one tile, one
# tile and one frame, two tiles and one frame, several sequences a block, and
# the training batch, whose blocks take 17 tiles each through the 3-tile ring
@pytest.mark.parametrize("B,F,C,L", [(1, 9360, 256, 30), (32, 1024, 256, 30), (3, 77, 256, 30),
                                     (2, 5, 64, 12), (1, 1, 256, 30), (1, 15, 256, 30),
                                     (1, 16, 256, 30), (1, 32, 256, 30), (5, 63, 256, 30),
                                     (32, 2240, 256, 30), (2, 40, 16, 40)])
def test_basis_decode_kernel_matches_plain(cuda, B, F, C, L):
    g = torch.Generator().manual_seed(B + F)
    w = torch.relu(torch.randn(B, F, C, generator=g)).to(cuda)
    basis = (0.1 * torch.randn(L, C, generator=g)).to(cuda)
    before = _build.launch_counts["basis_decode"]
    got = basis_decode(w, basis)
    torch.cuda.synchronize()
    assert _build.launch_counts["basis_decode"] == before + 1
    want = basis_decode_plain(w, basis)
    bound = 4 * C * EPS * basis_decode_plain(w.abs(), basis.abs())
    assert got.shape == (B, (F + 1) * (L // 2))
    assert torch.all((got - want).abs() <= bound)


def test_basis_decode_kernel_refuses_a_basis_longer_than_its_block(cuda):
    with pytest.raises(ValueError, match="takes L up to 40"):
        basis_decode(torch.ones(1, 4, 16, device=cuda), torch.ones(42, 16, device=cuda))


def test_basis_decode_kernel_gradient_is_plain_vjp(cuda):
    g = torch.Generator().manual_seed(3)
    w = torch.relu(torch.randn(2, 40, 256, generator=g)).to(cuda).requires_grad_()
    basis = (0.1 * torch.randn(30, 256, generator=g)).to(cuda).requires_grad_()
    cot = torch.randn(2, 41 * 15, generator=g).to(cuda)
    dw, db = torch.autograd.grad(basis_decode(w, basis), (w, basis), cot)
    dw_ref, db_ref = torch.autograd.grad(basis_decode_plain(w, basis), (w, basis), cot)
    torch.testing.assert_close(dw, dw_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db, db_ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("B,T,C", [(1, 2340, 256), (1, 9360, 256), (4, 2340, 256), (2, 40, 256),
                                   (1, 10, 256), (1, 4, 256), (2, 97, 128), (1, 300, 32)])
def test_fused_resstack_kernel_matches_plain(cuda, B, T, C):
    g = torch.Generator().manual_seed(T + C)
    x = (0.3 * torch.randn(B, T, C, generator=g)).to(cuda)
    stacks = _stacks(C, cuda, seed=T)
    before = _build.launch_counts["fused_resstack"]
    got = fused_residual_stacks_cuda(x, stacks)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_resstack"] == before + 1
    want = fused_residual_stacks_plain(x, stacks)
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs()
    assert err.max().item() <= 3e-4 * scale
    row_err = err.amax(dim=(0, 2))
    assert (row_err <= 3e-6 * scale).float().mean().item() > 0.9


def test_fused_resstack_kernel_is_forward_only(cuda):
    """The raw launcher records no graph; the gradient comes through
    `fused_residual_stacks` and its backward kernel."""
    x = torch.randn(1, 64, 256, device=cuda, requires_grad=True)
    stacks = _stacks(256, cuda)
    assert not fused_residual_stacks_cuda(x, stacks).requires_grad
    before = _build.launch_counts["fused_resstack_bwd"]
    fused_residual_stacks(x, stacks).sum().backward()
    assert _build.launch_counts["fused_resstack_bwd"] == before + 1
    assert x.grad is not None and torch.isfinite(x.grad).all()


def _f64(operands):
    """The same nested operands with every tensor in float64."""
    if isinstance(operands, torch.Tensor):
        return operands.double()
    if isinstance(operands, (list, tuple)):
        return type(operands)(_f64(o) for o in operands)
    return operands


def _assert_grads_close(dx, dx_ref, grads, grads_ref):
    peak = dx_ref.abs().max().item()
    err = (dx - dx_ref).abs()
    assert err.max().item() <= 5e-2 * peak
    share, w_tol = (0.995, 2e-4) if dx.shape[1] < 1000 else (0.9, 3e-2)
    assert (err.amax(dim=2) <= 1e-4 * peak).float().mean().item() >= share
    for got, want in zip(grads, grads_ref):
        assert got.shape == want.shape and got.is_contiguous()
        assert (got - want).abs().max().item() <= w_tol * want.abs().max().item()


# T = 10 is the least the mirrored edges of the d = 9 stack allow; 208 is the
# JAX package's gate (16 M, M = 13); 227 and 33 are no multiple of a tile
@pytest.mark.parametrize("B,T,C", [(1, 208, 256), (4, 227, 256), (1, 10, 256), (2, 33, 256),
                                   (1, 2240, 256), (4, 97, 128), (1, 300, 64), (2, 500, 32)])
def test_fused_resstack_bwd_kernel_matches_plain_vjp(cuda, B, T, C):
    gen = torch.Generator().manual_seed(T + C)
    x = (0.3 * torch.randn(B, T, C, generator=gen)).to(cuda)
    g = torch.randn(B, T, C, generator=gen).to(cuda)
    stacks = _stacks(C, cuda, seed=T)
    before = _build.launch_counts["fused_resstack_bwd"]
    dx, grads = fused_residual_stacks_vjp_cuda(x, stacks, g)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_resstack_bwd"] == before + 1
    dx_ref, grads_ref = fused_residual_stacks_vjp_plain(*_f64((x, stacks, g)))
    _assert_grads_close(dx, dx_ref, [t for s in grads for t in s],
                        [t for s in grads_ref for t in s])


def test_fused_resstack_bwd_kernel_refuses_a_margin_above_the_length(cuda):
    x = torch.zeros(1, 9, 256, device=cuda)
    with pytest.raises(ValueError, match="needs T > 9"):
        fused_residual_stacks_vjp_cuda(x, _stacks(256, cuda), x)


def test_fused_resstack_autograd_matches_plain_autograd(cuda):
    """Through the autograd.Function, with weights that are not leaves (a
    product, as weight norm makes them): the kernels' dW reaches the leaves."""
    gen = torch.Generator().manual_seed(11)
    x = (0.3 * torch.randn(2, 60, 256, generator=gen)).to(cuda).requires_grad_()
    leaves = [tuple(w if isinstance(w, int) else w.clone().requires_grad_() for w in s)
              for s in _stacks(256, cuda, seed=5)]
    flat = [w for s in leaves for w in s if isinstance(w, torch.Tensor)]
    scaled = [tuple(w if isinstance(w, int) else w * 1.5 for w in s) for s in leaves]
    cot = torch.randn(2, 60, 256, generator=gen).to(cuda)
    got = torch.autograd.grad(fused_residual_stacks(x, scaled), [x] + flat, cot, retain_graph=True)
    want = torch.autograd.grad(fused_residual_stacks_plain(x.double(), _f64(scaled)), [x] + flat,
                               cot.double())
    _assert_grads_close(got[0], want[0], got[1:], want[1:])


# The chain kernels' blocks own 64 rows at C = 256 and 128 below (a
# warpgroup of the tensor cores a 64 rows); T on both sides of each, and the
# least T: 1 forwards (a pad of 9 rows mirrors 9 times), m + 1 = 10 backwards.
CHAIN_ROWS = {32: 128, 64: 128, 128: 128, 256: 64}


def _chain_edge_cases(least):
    cases = []
    for C in (32, 64, 128, 256):
        R = CHAIN_ROWS[C]
        cases += [(1, least, C), (2, 63, C), (1, 64, C), (3, 65, C), (1, 127, C), (2, 129, C),
                  (1, R + 1, C)]
    return sorted(set(cases), key=lambda c: (c[2], c[1], c[0]))


@pytest.mark.parametrize("B,T,C", _chain_edge_cases(1))
def test_fused_resstack_kernel_matches_plain_at_tile_edges(cuda, B, T, C):
    g = torch.Generator().manual_seed(T + C + B)
    x = (0.3 * torch.randn(B, T, C, generator=g)).to(cuda)
    stacks = _stacks(C, cuda, seed=C + 1)
    _assert_rows_close(fused_residual_stacks_cuda(x, stacks), fused_residual_stacks_plain(x, stacks),
                       3e-4, 3e-6)


@pytest.mark.parametrize("B,T,C", _chain_edge_cases(10))
def test_fused_resstack_bwd_kernel_matches_plain_vjp_at_tile_edges(cuda, B, T, C):
    gen = torch.Generator().manual_seed(T + C + B)
    x = (0.3 * torch.randn(B, T, C, generator=gen)).to(cuda)
    g = torch.randn(B, T, C, generator=gen).to(cuda)
    stacks = _stacks(C, cuda, seed=C + 1)
    dx, grads = fused_residual_stacks_vjp_cuda(x, stacks, g)
    dx_ref, grads_ref = fused_residual_stacks_vjp_plain(*_f64((x, stacks, g)))
    _assert_grads_close(dx, dx_ref, [t for s in grads for t in s],
                        [t for s in grads_ref for t in s])


@pytest.mark.parametrize("B,T,C", [(4, 700, 256), (3, 900, 32)])
def test_fused_resstack_bwd_kernel_is_the_same_from_run_to_run(cuda, B, T, C):
    """dW is summed in stages in a fixed order, without atomics, and the
    mirrored edges are folded back in a launch of their own."""
    gen = torch.Generator().manual_seed(2)
    x = (0.3 * torch.randn(B, T, C, generator=gen)).to(cuda)
    g = torch.randn(B, T, C, generator=gen).to(cuda)
    stacks = _stacks(C, cuda, seed=1)
    dx1, g1 = fused_residual_stacks_vjp_cuda(x, stacks, g)
    dx2, g2 = fused_residual_stacks_vjp_cuda(x, stacks, g)
    assert torch.equal(dx1, dx2)
    for a, b in zip([t for s in g1 for t in s], [t for s in g2 for t in s]):
        assert torch.equal(a, b)


def test_fused_resstack_kernel_takes_a_kept_table(cuda):
    """The wrapper packs the chain's kernels itself or takes the caller's
    `ChainTable`: the same bits either way; a table of another width raises."""
    from fastvocoder_tpu_torch.ops.fused_resstack import ChainTable

    gen = torch.Generator().manual_seed(4)
    x = (0.3 * torch.randn(2, 80, 64, generator=gen)).to(cuda)
    stacks = _stacks(64, cuda, seed=2)
    table = ChainTable(stacks, x.device)
    assert torch.equal(fused_residual_stacks_cuda(x, stacks, table),
                       fused_residual_stacks_cuda(x, stacks))
    with pytest.raises(ValueError, match="operands are for C=64"):
        fused_residual_stacks_cuda(torch.zeros(1, 8, 32, device=cuda), stacks, table)


def test_apply_residual_stacks_follows_weight_writes_on_the_card(cuda):
    """A served stage keeps its checked and packed operands; an in-place
    write to one weight (what loading a checkpoint or an optimiser step
    does) rebuilds them."""
    from fastvocoder_tpu_torch.models.layers import ResidualStack, apply_residual_stacks

    torch.manual_seed(3)
    stacks = [ResidualStack(32, kernel_size=3, dilation=d).to(cuda).requires_grad_(False)
              for d in (1, 3, 9)]
    x = 0.3 * torch.randn(2, 200, 32, device=cuda)

    def modules():
        h = x
        for m in stacks:
            h = m(h)
        return h

    with torch.no_grad():
        before = _build.launch_counts["fused_resstack"]
        first = apply_residual_stacks(x, stacks)
        table = stacks[0]._chain_table
        assert apply_residual_stacks(x, stacks) is not first and stacks[0]._chain_table is table
        assert _build.launch_counts["fused_resstack"] == before + 2
        _assert_rows_close(first, modules(), 3e-4, 3e-6)
        stacks[1].skip.weight.mul_(1.5)
        second = apply_residual_stacks(x, stacks)
        assert stacks[0]._chain_table is not table
        _assert_rows_close(second, modules(), 3e-4, 3e-6)
        assert (second - first).abs().max().item() > 1e-3


def _assert_rows_close(got, want, tol, row_tol):
    """Max abs within tol and 90 % of rows within row_tol, both scaled by the
    output's magnitude."""
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs()
    assert err.max().item() <= tol * scale
    row_err = err.amax(dim=(0, 2))
    assert (row_err <= row_tol * scale).float().mean().item() > 0.9


def _resblocks(C, device, seed, kernels=(3, 7, 11), dilations=(1, 3, 5)):
    """Seeded ResBlock1 branches at torch's default conv init scale."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan_in):
        return ((torch.rand(shape, generator=g) * 2 - 1) / np.sqrt(fan_in)).to(device)

    return [[(u(K, C, C, fan_in=C * K), u(C, fan_in=C * K), d,
              u(K, C, C, fan_in=C * K), u(C, fan_in=C * K)) for d in dilations]
            for K in kernels]


@pytest.fixture(scope="module")
def hifigan_light():
    from fastvocoder_tpu_torch.hparams import load_model_config
    from fastvocoder_tpu_torch.models.factory import load_generator

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = os.path.join(os.path.dirname(__file__), "..")
    cfg = load_model_config("hifigan", os.path.join(root, "conf", "hifigan", "light.yaml"))
    gen, _ = load_generator(os.path.join(root, "docs", "checkpoints", "hifigan_light_clean2.npz"),
                            cfg, torch.device("cuda"))
    return gen


@pytest.mark.parametrize("stage,B,T", [(0, 1, 4680), (1, 1, 23400), (2, 1, 70200), (0, 4, 4680),
                                       (2, 4, 70200), (0, 1, 1), (1, 2, 7), (2, 1, 50)])
def test_fused_mrf_kernel_matches_plain_release_weights(cuda, hifigan_light, stage, B, T):
    blocks = [b.mrf_operands() for b in hifigan_light.mrfs[stage]]
    C = blocks[0][0][0].shape[1]
    g = torch.Generator().manual_seed(B * T + stage)
    x = (0.3 * torch.randn(B, T, C, generator=g)).to(cuda)
    before = _build.launch_counts["fused_mrf"]
    got = fused_mrf_stage_cuda(x, blocks)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_mrf"] == before + 1
    _assert_rows_close(got, fused_mrf_stage_plain(x, blocks), 3e-4, 1e-5)


@pytest.mark.parametrize("B,T,C", [(1, 1170, 256), (2, 50, 256), (1, 3, 16), (3, 333, 16)])
def test_fused_mrf_kernel_matches_plain_seeded(cuda, B, T, C):
    g = torch.Generator().manual_seed(T + C)
    x = (0.3 * torch.randn(B, T, C, generator=g)).to(cuda)
    blocks = _resblocks(C, cuda, seed=C)
    _assert_rows_close(fused_mrf_stage_cuda(x, blocks), fused_mrf_stage_plain(x, blocks),
                       3e-4, 1e-5)


@pytest.mark.parametrize("B,T,C", [(1, 1, 128), (2, 7, 64), (1, 50, 32), (4, 50, 16),
                                   (1, 1120, 128), (4, 333, 64), (1, 1700, 32), (4, 1100, 16),
                                   (2, 700, 16), (1, 300, 256)])
def test_fused_mrf_bwd_kernel_matches_plain_vjp(cuda, B, T, C):
    gen = torch.Generator().manual_seed(T + C)
    x = (0.3 * torch.randn(B, T, C, generator=gen)).to(cuda)
    g = torch.randn(B, T, C, generator=gen).to(cuda)
    blocks = _resblocks(C, cuda, seed=C)
    before = _build.launch_counts["fused_mrf_bwd"]
    dx, grads = fused_mrf_stage_vjp_cuda(x, blocks, g)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_mrf_bwd"] == before + 1
    dx_ref, grads_ref = fused_mrf_stage_vjp_plain(*_f64((x, blocks, g)))
    _assert_grads_close(dx, dx_ref, [t for br in grads for p in br for t in p],
                        [t for br in grads_ref for p in br for t in p])


# Rows a block of the MRF kernels owns, by width: a forward pair launch (64
# rows a warpgroup less the 2 x 5 rows of u the k = 11 branch recomputes),
# an adjoint conv of the backward, and a chunk of the weight gradient.
MRF_PAIR_ROWS = {16: 118, 32: 118, 64: 118, 128: 118, 256: 54}
MRF_CONV_ROWS = {16: 128, 32: 128, 64: 128, 128: 128, 256: 64}
MRF_WGRAD_ROWS = {16: 256, 32: 128, 64: 64, 128: 32, 256: 32}


def _edge_cases():
    """(B, T, C) at every width: T = 1, T below the 30-row halo, one below,
    at and one above a forward block's rows, one above an adjoint block's,
    and B = 3 at a length that is no multiple of a chunk."""
    cases = []
    for C in (16, 32, 64, 128, 256):
        R = MRF_PAIR_ROWS[C]
        cases += [(1, 1, C), (3, 7, C), (1, R - 1, C), (2, R, C), (1, R + 1, C),
                  (1, MRF_CONV_ROWS[C] + 1, C), (3, 2 * MRF_WGRAD_ROWS[C] + 5, C)]
    return cases


@pytest.mark.parametrize("B,T,C", _edge_cases())
def test_fused_mrf_kernel_matches_plain_at_tile_edges(cuda, B, T, C):
    g = torch.Generator().manual_seed(T + C)
    x = (0.3 * torch.randn(B, T, C, generator=g)).to(cuda)
    blocks = _resblocks(C, cuda, seed=C + 1)
    _assert_rows_close(fused_mrf_stage_cuda(x, blocks), fused_mrf_stage_plain(x, blocks),
                       3e-4, 1e-5)


@pytest.mark.parametrize("B,T,C", _edge_cases())
def test_fused_mrf_bwd_kernel_matches_plain_vjp_at_tile_edges(cuda, B, T, C):
    gen = torch.Generator().manual_seed(T + C)
    x = (0.3 * torch.randn(B, T, C, generator=gen)).to(cuda)
    g = torch.randn(B, T, C, generator=gen).to(cuda)
    blocks = _resblocks(C, cuda, seed=C + 1)
    dx, grads = fused_mrf_stage_vjp_cuda(x, blocks, g)
    dx_ref, grads_ref = fused_mrf_stage_vjp_plain(*_f64((x, blocks, g)))
    _assert_grads_close(dx, dx_ref, [t for br in grads for p in br for t in p],
                        [t for br in grads_ref for p in br for t in p])


# (1, 4680, 256) is HiFiGAN large's widest stage at a 585-frame utterance;
# (8, 2900, 128) is a grid of several waves of blocks
@pytest.mark.parametrize("B,T,C", [(1, 4680, 256), (8, 2900, 128)])
def test_fused_mrf_kernels_at_the_large_model_and_the_wide_block(cuda, B, T, C):
    gen = torch.Generator().manual_seed(T + C)
    x = (0.3 * torch.randn(B, T, C, generator=gen)).to(cuda)
    g = torch.randn(B, T, C, generator=gen).to(cuda)
    blocks = _resblocks(C, cuda, seed=C)
    _assert_rows_close(fused_mrf_stage_cuda(x, blocks), fused_mrf_stage_plain(x, blocks),
                       3e-4, 1e-5)
    dx, grads = fused_mrf_stage_vjp_cuda(x, blocks, g)
    dx_ref, grads_ref = fused_mrf_stage_vjp_plain(*_f64((x, blocks, g)))
    _assert_grads_close(dx, dx_ref, [t for br in grads for p in br for t in p],
                        [t for br in grads_ref for p in br for t in p])


def test_fused_mrf_kernels_take_cached_swapped_weights(cuda):
    """The wrappers build the (tap, c_out, c_in) copies themselves or take
    the caller's: the same bits either way; copies of another shape raise."""
    from fastvocoder_tpu_torch.ops.fused_mrf import swap_channels

    gen = torch.Generator().manual_seed(4)
    x = (0.3 * torch.randn(2, 80, 32, generator=gen)).to(cuda)
    g = torch.randn(2, 80, 32, generator=gen).to(cuda)
    blocks = _resblocks(32, cuda, seed=2)
    swapped = swap_channels(blocks)
    assert torch.equal(fused_mrf_stage_cuda(x, blocks), fused_mrf_stage_cuda(x, blocks, swapped))
    dx1, g1 = fused_mrf_stage_vjp_cuda(x, blocks, g)
    dx2, g2 = fused_mrf_stage_vjp_cuda(x, blocks, g, swapped)
    assert torch.equal(dx1, dx2)
    for a, b in zip([t for br in g1 for p in br for t in p], [t for br in g2 for p in br for t in p]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="swapped"):
        fused_mrf_stage_cuda(x, blocks, swapped[:2])
    # and the checked table of both, where the caller keeps that too
    from fastvocoder_tpu_torch.ops.fused_mrf import StageTable

    table = StageTable(blocks, swapped, x.device)
    assert torch.equal(fused_mrf_stage_cuda(x, blocks, swapped, table),
                       fused_mrf_stage_cuda(x, blocks))
    with pytest.raises(ValueError, match="operands are for C=32"):
        fused_mrf_stage_cuda(torch.zeros(1, 8, 64, device=cuda), blocks, swapped, table)


def test_apply_mrf_follows_weight_writes_on_the_card(cuda):
    """A served stage keeps its operands, their swapped copies and the checked
    table; an in-place write to one weight (what loading a checkpoint or an
    optimiser step does) rebuilds them."""
    from fastvocoder_tpu_torch.models.layers import ResBlock1, apply_mrf

    torch.manual_seed(3)
    blocks = [ResBlock1(32, kernel_size=k).to(cuda).requires_grad_(False) for k in (3, 7, 11)]
    x = 0.3 * torch.randn(2, 200, 32, device=cuda)

    def modules_mean():
        return sum(b(x) for b in blocks) / len(blocks)

    with torch.no_grad():
        before = _build.launch_counts["fused_mrf"]
        first = apply_mrf(x, blocks)
        table = blocks[0]._stage_table
        assert apply_mrf(x, blocks) is not first and blocks[0]._stage_table is table  # kept
        assert _build.launch_counts["fused_mrf"] == before + 2
        _assert_rows_close(first, modules_mean(), 3e-4, 1e-5)
        blocks[1].conv2_1.weight.mul_(1.5)
        second = apply_mrf(x, blocks)
        assert blocks[0]._stage_table is not table
        _assert_rows_close(second, modules_mean(), 3e-4, 1e-5)
        assert (second - first).abs().max().item() > 1e-3


def test_fused_mrf_bwd_kernel_release_weights(cuda, hifigan_light):
    blocks = [b.mrf_operands() for b in hifigan_light.mrfs[1]]
    # a seed without a leaky-relu flip (the docstring).  It was 9 while the
    # kernel contracted on the CUDA cores; with the tensor-core kernel's
    # roundings, of seeds 9 to 20 at this shape only 9 has a flip (a run of
    # 50 rows of dx), and other roundings put one on other seeds
    gen = torch.Generator().manual_seed(10)
    x = (0.3 * torch.randn(2, 700, 64, generator=gen)).to(cuda)
    g = torch.randn(2, 700, 64, generator=gen).to(cuda)
    dx, grads = fused_mrf_stage_vjp_cuda(x, blocks, g)
    dx_ref, grads_ref = fused_mrf_stage_vjp_plain(*_f64((x, blocks, g)))
    _assert_grads_close(dx, dx_ref, [t for br in grads for p in br for t in p],
                        [t for br in grads_ref for p in br for t in p])


# C = 16 and 32: the warpgroups of a block share a group of dW and add their
# sums through shared memory; C = 128: a warpgroup a group, many blocks a conv
@pytest.mark.parametrize("B,T,C", [(4, 900, 32), (3, 1300, 16), (2, 700, 128)])
def test_fused_mrf_bwd_kernel_is_the_same_from_run_to_run(cuda, B, T, C):
    """dW is summed in stages in a fixed order (the warpgroups of a block,
    then the blocks), without atomics."""
    gen = torch.Generator().manual_seed(2)
    x = (0.3 * torch.randn(B, T, C, generator=gen)).to(cuda)
    g = torch.randn(B, T, C, generator=gen).to(cuda)
    blocks = _resblocks(C, cuda, seed=1)
    dx1, g1 = fused_mrf_stage_vjp_cuda(x, blocks, g)
    dx2, g2 = fused_mrf_stage_vjp_cuda(x, blocks, g)
    assert torch.equal(dx1, dx2)
    for a, b in zip([t for br in g1 for p in br for t in p], [t for br in g2 for p in br for t in p]):
        assert torch.equal(a, b)


def test_fused_mrf_autograd_matches_plain_autograd(cuda):
    gen = torch.Generator().manual_seed(12)
    x = (0.3 * torch.randn(2, 90, 64, generator=gen)).to(cuda).requires_grad_()
    leaves = [[tuple(w if isinstance(w, int) else w.clone().requires_grad_() for w in p)
               for p in pairs] for pairs in _resblocks(64, cuda, seed=3)]
    flat = [w for pairs in leaves for p in pairs for w in p if isinstance(w, torch.Tensor)]
    scaled = [[tuple(w if isinstance(w, int) else w * 1.5 for w in p) for p in pairs]
              for pairs in leaves]
    cot = torch.randn(2, 90, 64, generator=gen).to(cuda)
    got = torch.autograd.grad(fused_mrf_stage(x, scaled), [x] + flat, cot, retain_graph=True)
    want = torch.autograd.grad(fused_mrf_stage_plain(x.double(), _f64(scaled)), [x] + flat,
                               cot.double())
    _assert_grads_close(got[0], want[0], got[1:], want[1:])


def _tail_operands(cin, cout, device, seed, bands=1):
    g = torch.Generator().manual_seed(seed)

    def u(*shape, fan_in):
        return ((torch.rand(shape, generator=g) * 2 - 1) / np.sqrt(fan_in)).to(device)

    return (u(4, cin, cout, fan_in=cout * 4), u(cout, fan_in=cout * 4), 2, 1,
            _resblocks(cout, device, seed), u(7, cout, bands, fan_in=cout * 7),
            u(bands, fan_in=cout * 7))


@pytest.mark.parametrize("B,T_in", [(1, 70200), (2, 35), (1, 1), (3, 4)])
def test_fused_tail_kernel_matches_plain_release_weights(cuda, hifigan_light, B, T_in):
    ops = hifigan_light.tail_operands()
    g = torch.Generator().manual_seed(T_in)
    x = (0.3 * torch.randn(B, T_in, 32, generator=g)).to(cuda)
    before = _build.launch_counts["fused_tail"]
    got = fused_hifigan_tail_cuda(x, *ops)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_tail"] == before + 1
    assert got.shape == (B, 2 * T_in, 1)
    _assert_rows_close(got, fused_hifigan_tail_plain(x, *ops), 1e-4, 1e-5)


@pytest.mark.parametrize("B,T_in,cin,cout,bands", [(1, 3000, 64, 32, 1), (2, 9, 64, 32, 4),
                                                   (1, 200, 32, 16, 1)])
def test_fused_tail_kernel_matches_plain_seeded(cuda, B, T_in, cin, cout, bands):
    ops = _tail_operands(cin, cout, cuda, seed=cin + T_in, bands=bands)
    g = torch.Generator().manual_seed(T_in)
    x = (0.3 * torch.randn(B, T_in, cin, generator=g)).to(cuda)
    _assert_rows_close(fused_hifigan_tail_cuda(x, *ops), fused_hifigan_tail_plain(x, *ops),
                       1e-4, 1e-5)


def _tail_edge_cases():
    """Lengths on both sides of the tail's tiles: the pair launches own 118
    output rows a block (128 rows less the k = 11 pairs' margins), the
    upsample 512 / C_out * 16 rows, the head 4096 / C_out; T = 2 T_in."""
    cases = [(2, 1, 32, 16), (1, 1, 64, 32)]
    cases += [(1, t, 32, 16) for t in (59, 60, 118, 119, 128, 129, 256, 257)]
    cases += [(2, t, 64, 32) for t in (59, 60, 64, 65, 118, 119, 128, 129)]
    return cases


@pytest.mark.parametrize("B,T_in,cin,cout", _tail_edge_cases())
def test_fused_tail_kernel_matches_plain_at_tile_edges(cuda, B, T_in, cin, cout):
    ops = _tail_operands(cin, cout, cuda, seed=cout + T_in)
    g = torch.Generator().manual_seed(T_in + 1)
    x = (0.3 * torch.randn(B, T_in, cin, generator=g)).to(cuda)
    got = fused_hifigan_tail_cuda(x, *ops)
    assert got.shape == (B, 2 * T_in, 1)
    _assert_rows_close(got, fused_hifigan_tail_plain(x, *ops), 1e-4, 1e-5)


def test_fused_tail_kernel_takes_a_kept_table(cuda):
    """A `TailTable` holds the checked operands and the packed MRF kernels:
    the same bits as a table built for the call, and x of another width is
    refused."""
    from fastvocoder_tpu_torch.ops.fused_tail import TailTable

    ops = _tail_operands(32, 16, cuda, seed=5)
    table = TailTable(*ops, cuda)
    x = (0.3 * torch.randn(2, 300, 32)).to(cuda)
    assert torch.equal(fused_hifigan_tail_cuda(x, *ops, table=table),
                       fused_hifigan_tail_cuda(x, *ops))
    with pytest.raises(ValueError, match="take \\(B, T_in, 32\\)"):
        fused_hifigan_tail_cuda(torch.zeros(1, 8, 64, device=cuda), *ops, table=table)


def test_hifigan_keeps_its_tail_table_until_a_weight_is_written(cuda):
    """A served HiFiGAN keeps its tail's table; an in-place write to a weight
    of the last stage rebuilds it, and the output follows the write."""
    from fastvocoder_tpu_torch.hparams import HiFiGANConfig
    from fastvocoder_tpu_torch.models.hifigan import HiFiGANGenerator

    torch.manual_seed(4)
    cfg = HiFiGANConfig(upsample_rates=(5, 2), upsample_initial_channel=64,
                        upsample_kernel_sizes=(10, 4))
    gen = HiFiGANGenerator(cfg).requires_grad_(False)
    cpu = HiFiGANGenerator(cfg).requires_grad_(False)
    gen.to(cuda)
    mel = torch.rand(1, 40, 80)
    with torch.no_grad():
        cpu.load_state_dict(gen.state_dict())
        first = gen(mel.to(cuda))
        table = gen._tail_table
        assert torch.equal(gen(mel.to(cuda)), first) and gen._tail_table is table  # kept
        _assert_rows_close(first[..., None], cpu(mel).to(cuda)[..., None], 1e-4, 1e-5)
        for m in (gen, cpu):
            m.resblock_1_2.conv2_1.weight.mul_(1.5)
        second = gen(mel.to(cuda))
        assert gen._tail_table is not table
        _assert_rows_close(second[..., None], cpu(mel).to(cuda)[..., None], 1e-4, 1e-5)
        assert (second - first).abs().max().item() > 1e-4


def test_mrf_and_tail_kernels_are_forward_only(cuda):
    """The MRF's raw launcher records no graph (its gradient comes through
    `fused_mrf_stage`); the tail kernel, inference only, refuses."""
    x = torch.randn(1, 64, 32, device=cuda, requires_grad=True)
    assert not fused_mrf_stage_cuda(x, _resblocks(32, cuda, 0)).requires_grad
    with pytest.raises(NotImplementedError):
        fused_hifigan_tail_cuda(x, *_tail_operands(32, 16, cuda, 0))


def test_mrf_kernel_refuses_other_widths(cuda):
    with pytest.raises(ValueError, match="not in"):
        fused_mrf_stage_cuda(torch.zeros(1, 8, 48, device=cuda), _resblocks(48, cuda, 0))
