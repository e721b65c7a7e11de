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

The bf16 forms (kernels 1, 2, 4 and 6; the last section) are held against
the plain versions of the same bf16 arithmetic (bf16 operands, float32
sums, rounded to bf16 at the same points) on the same inputs.  The two sum
in other orders, so an element that sits within float32 rounding of a bf16
rounding boundary or of the leaky-relu kink rounds the other way, and the
difference travels through the later convs: they are held within 1 % of the
plain output's peak, and the share of elements more than one bf16 ulp apart
is printed.  The decode rounds nothing after its float32 sums and keeps the
float32 form's bound.

The bf16 forms of the backward kernels (3b and 5b) widen their bf16
inputs, run the float32 forms' passes and round every result to bf16
once: each is held bit for bit against the float32 form on the widened
inputs, rounded (the float32 forms' arithmetic is held above), and against
its plain version run in float64 on the same bf16 inputs, element by
element: every element of dx within one bf16 ulp of its own value plus
1e-4 of dx's peak, of a dW or db within one ulp plus 2e-4 of its peak (the
float32 forms' bounds without a flip), but for the elements a leaky-relu
flip moves.  Those are found, not assumed: the plain version is run again
with the slope of every pre-activation within KINK_BAND (1e-5) of its
tensor's peak of the kink taken the other way, once each way, and an
element may be farther only where those runs move it, by no more than
they move it or than the float32 forms' bounds (5e-2 of dx's peak, 3e-2
of a dW's or db's), whichever is larger; 90 % of dx's rows within the
tight bound and every element of dx within 5e-2 of its peak, as the
float32 forms.  Whether the other slope alone explains every element is
printed (where many pre-activations lie near the kink their flips' moves
may cancel in the two runs, and the bounds stand in).
Their autograd paths, the differentiable bf16 decode and a bf16 training
step close the section.
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


@pytest.fixture(scope="module")
def melgan_original():
    from fastvocoder_tpu_torch.hparams import load_model_config
    from fastvocoder_tpu_torch.models.factory import load_generator

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = os.path.join(os.path.dirname(__file__), "..")
    cfg = load_model_config("melgan", os.path.join(root, "conf", "melgan", "original.yaml"))
    gen, _ = load_generator(os.path.join(root, "docs", "checkpoints", "melgan_clean.npz"),
                            cfg, torch.device("cuda"))
    return gen


# MelGAN original's four stages of a 585-frame utterance (C = 256, 128, 64,
# 32 over 5850 to 140,400 rows), with its release weights
@pytest.mark.parametrize("stage,T", [(0, 5850), (1, 35100), (2, 70200), (3, 140400)])
def test_fused_resstack_kernel_matches_plain_melgan_stages(cuda, melgan_original, stage, T):
    stacks = [m.chain_operands() for m in melgan_original.stacks[stage]]
    C = stacks[0][0].shape[1]
    g = torch.Generator().manual_seed(stage)
    x = (0.3 * torch.randn(1, T, C, generator=g)).to(cuda)
    _assert_rows_close(fused_residual_stacks_cuda(x, stacks), fused_residual_stacks_plain(x, stacks),
                       3e-4, 3e-6)


# the longest chain any path runs, C = 32 at 140,400 rows, on both sides of
# the 128-row blocks nearest it (140,288 and 140,416 rows are whole blocks)
@pytest.mark.parametrize("T", [140287, 140288, 140289, 140400, 140415, 140416, 140417])
def test_fused_resstack_kernel_matches_plain_at_melgan_length(cuda, T):
    g = torch.Generator().manual_seed(T)
    x = (0.3 * torch.randn(1, T, 32, generator=g)).to(cuda)
    stacks = _stacks(32, cuda, seed=33)
    _assert_rows_close(fused_residual_stacks_cuda(x, stacks), fused_residual_stacks_plain(x, stacks),
                       3e-4, 3e-6)


# MelGAN's training stages (crops of 140 frames; batch 2 here, 32 in
# chip_smoke.py) with the release weights, and C = 32 at 140,400 rows
@pytest.mark.parametrize("stage,B,T", [(0, 2, 1400), (1, 2, 8400), (2, 1, 16800), (3, 1, 33600),
                                       (3, 1, 140400), (3, 1, 140417)])
def test_fused_resstack_bwd_kernel_matches_plain_vjp_melgan_stages(cuda, melgan_original, stage,
                                                                   B, T):
    stacks = [m.chain_operands() for m in melgan_original.stacks[stage]]
    C = stacks[0][0].shape[1]
    gen = torch.Generator().manual_seed(10 * stage + B)
    x = (0.3 * torch.randn(B, T, C, generator=gen)).to(cuda)
    g = torch.randn(B, T, C, generator=gen).to(cuda)
    dx, grads = fused_residual_stacks_vjp_cuda(x, stacks, g)
    dx_ref, grads_ref = fused_residual_stacks_vjp_plain(*_f64((x, stacks, g)))
    _assert_grads_close(dx, dx_ref, [t for s in grads for t in s],
                        [t for s in grads_ref for t in s])


@pytest.mark.parametrize("kind", ["constant", "random"])
def test_nhv_impulse_train_on_the_card_is_the_cpus(cuda, kind):
    """NHV's impulse train sums its phase as integers, so the card's
    parallel cumsum fires on the very samples the CPU's does (585 frames,
    bench.py's 220 Hz contour and a random 150-250 Hz one with unvoiced
    frames)."""
    from fastvocoder_tpu_torch.models.nhv import impulse_train

    rng = np.random.default_rng(585)
    if kind == "constant":
        f0 = np.full((2, 585), 220.0, np.float32)
    else:
        f0 = rng.uniform(150.0, 250.0, (2, 585)).astype(np.float32)
        f0[rng.random((2, 585)) < 0.2] = 0.0
    f0 = torch.from_numpy(f0)
    got = impulse_train(f0.to(cuda), 240, 24000).cpu()
    want = impulse_train(f0, 240, 24000)
    assert want.sum() > 2000 if kind == "constant" else want.sum() > 1500
    assert torch.equal(got, want)


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
    """The forward wrappers build the (tap, c_out, c_in) copies themselves
    or take the caller's, under autograd too (where the backward kernel
    swaps the kernels it is given itself): the same bits either way; copies
    of another shape raise."""
    from fastvocoder_tpu_torch.ops.fused_mrf import swap_channels

    gen = torch.Generator().manual_seed(4)
    x = (0.3 * torch.randn(2, 80, 32, generator=gen)).to(cuda)
    g = torch.randn(2, 80, 32, generator=gen).to(cuda)
    blocks = _resblocks(32, cuda, seed=2)
    swapped = swap_channels(blocks)
    assert torch.equal(fused_mrf_stage_cuda(x, blocks), fused_mrf_stage_cuda(x, blocks, swapped))
    got = []
    for sw in (None, swapped):
        xg = x.clone().requires_grad_(True)
        y = fused_mrf_stage(xg, blocks, sw)
        y.backward(g)
        got.append((y.detach(), xg.grad))
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])
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


# ---- the bf16 forms ----

BF16 = torch.bfloat16


def _bf16_ulp(v):
    """One bf16 ulp at each element of v (float32): 2^(e - 7), e its binade."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _assert_bf16_close(got, want):
    """The bf16 form against its plain version: within 1 % of the plain
    output's peak; -> the share of elements more than one bf16 ulp apart."""
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want = got.float(), want.float()
    err = (got - want).abs()
    assert torch.isfinite(got).all()
    assert err.max().item() <= 0.01 * want.abs().max().item()
    share = (err > _bf16_ulp(want)).float().mean().item()
    print(f"max {err.max().item():.3e} of peak {want.abs().max().item():.3e}, "
          f"{share:.4f} of elements more than one ulp apart")
    return share


@pytest.mark.parametrize("B,F,C,L", [(1, 9360, 256, 30), (32, 2240, 256, 30), (3, 77, 256, 30),
                                     (1, 1, 256, 30), (1, 15, 256, 30), (1, 16, 256, 30),
                                     (5, 63, 256, 30), (2, 40, 16, 40), (2, 5, 64, 12)])
def test_basis_decode_bf16_kernel_matches_plain(cuda, B, F, C, L):
    from fastvocoder_tpu_torch.ops.basis_decode import basis_decode_bf16_cuda

    g = torch.Generator().manual_seed(B + F)
    w = torch.relu(torch.randn(B, F, C, generator=g)).to(cuda).to(BF16)
    basis = (0.1 * torch.randn(L, C, generator=g)).to(cuda).to(BF16)
    before = _build.launch_counts["basis_decode_bf16"]
    got = basis_decode(w, basis)
    torch.cuda.synchronize()
    assert _build.launch_counts["basis_decode_bf16"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (B, (F + 1) * (L // 2))
    want = basis_decode_plain(w, basis)
    bound = 4 * C * EPS * basis_decode_plain(w.abs(), basis.abs())
    assert torch.all((got - want).abs() <= bound)
    with pytest.raises(ValueError, match="takes torch.bfloat16 x"):
        basis_decode_bf16_cuda(w.float(), basis)


# Basis-MelGAN light's two stages and MelGAN original's four, at batch 1 of
# a 585-frame utterance, and the training crops' batch of 32
@pytest.mark.parametrize("B,T,C", [(1, 2340, 256), (1, 9360, 256), (1, 5850, 256), (1, 35100, 128),
                                   (1, 70200, 64), (1, 140400, 32), (32, 2240, 256), (4, 97, 128)])
def test_fused_resstack_bf16_kernel_matches_plain(cuda, B, T, C):
    g = torch.Generator().manual_seed(T + C)
    x = (0.3 * torch.randn(B, T, C, generator=g)).to(cuda).to(BF16)
    stacks = _stacks(C, cuda, seed=T)
    before = _build.launch_counts["fused_resstack_bf16"]
    got = fused_residual_stacks(x, stacks)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_resstack_bf16"] == before + 1
    assert got.dtype == BF16
    _assert_bf16_close(got, fused_residual_stacks_plain(x, stacks))


@pytest.mark.parametrize("B,T,C", _chain_edge_cases(1))
def test_fused_resstack_bf16_kernel_matches_plain_at_tile_edges(cuda, B, T, C):
    g = torch.Generator().manual_seed(T + C + B)
    x = (0.3 * torch.randn(B, T, C, generator=g)).to(cuda).to(BF16)
    stacks = _stacks(C, cuda, seed=C + 1)
    _assert_bf16_close(fused_residual_stacks(x, stacks), fused_residual_stacks_plain(x, stacks))


@pytest.mark.parametrize("stage,T", [(0, 5850), (1, 35100), (2, 70200), (3, 140400)])
def test_fused_resstack_bf16_kernel_matches_plain_melgan_stages(cuda, melgan_original, stage, T):
    stacks = [m.chain_operands() for m in melgan_original.stacks[stage]]
    C = stacks[0][0].shape[1]
    g = torch.Generator().manual_seed(stage)
    x = (0.3 * torch.randn(1, T, C, generator=g)).to(cuda).to(BF16)
    _assert_bf16_close(fused_residual_stacks(x, stacks), fused_residual_stacks_plain(x, stacks))


@pytest.mark.parametrize("stage,B,T", [(0, 1, 4680), (1, 1, 23400), (2, 1, 70200), (2, 4, 70200),
                                       (0, 1, 1), (1, 2, 7)])
def test_fused_mrf_bf16_kernel_matches_plain_release_weights(cuda, hifigan_light, stage, B, T):
    blocks = [b.mrf_operands() for b in hifigan_light.mrfs[stage]]
    C = blocks[0][0][0].shape[1]
    g = torch.Generator().manual_seed(B * T + stage)
    x = (0.3 * torch.randn(B, T, C, generator=g)).to(cuda).to(BF16)
    before = _build.launch_counts["fused_mrf_bf16"]
    got = fused_mrf_stage(x, blocks)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_mrf_bf16"] == before + 1
    assert got.dtype == BF16
    _assert_bf16_close(got, fused_mrf_stage_plain(x, blocks))


@pytest.mark.parametrize("B,T,C", _edge_cases())
def test_fused_mrf_bf16_kernel_matches_plain_at_tile_edges(cuda, B, T, C):
    g = torch.Generator().manual_seed(T + C)
    x = (0.3 * torch.randn(B, T, C, generator=g)).to(cuda).to(BF16)
    blocks = _resblocks(C, cuda, seed=C + 1)
    _assert_bf16_close(fused_mrf_stage(x, blocks), fused_mrf_stage_plain(x, blocks))


@pytest.mark.parametrize("B,T_in", [(1, 70200), (2, 35), (1, 1), (3, 4)])
def test_fused_tail_bf16_kernel_matches_plain_release_weights(cuda, hifigan_light, B, T_in):
    from fastvocoder_tpu_torch.ops.fused_tail import fused_hifigan_tail_bf16_cuda

    ops = hifigan_light.tail_operands()
    g = torch.Generator().manual_seed(T_in)
    x = (0.3 * torch.randn(B, T_in, 32, generator=g)).to(cuda).to(BF16)
    before = _build.launch_counts["fused_tail_bf16"]
    with torch.no_grad():
        got = fused_hifigan_tail_bf16_cuda(x, *ops)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_tail_bf16"] == before + 1
    assert got.shape == (B, 2 * T_in, 1) and got.dtype == BF16
    _assert_bf16_close(got, fused_hifigan_tail_plain(x, *ops))


@pytest.mark.parametrize("B,T_in,cin,cout", _tail_edge_cases() + [(2, 9, 64, 32)])
def test_fused_tail_bf16_kernel_matches_plain_at_tile_edges(cuda, B, T_in, cin, cout):
    from fastvocoder_tpu_torch.ops.fused_tail import fused_hifigan_tail_bf16_cuda

    ops = _tail_operands(cin, cout, cuda, seed=cout + T_in, bands=4 if T_in == 9 else 1)
    g = torch.Generator().manual_seed(T_in + 1)
    x = (0.3 * torch.randn(B, T_in, cin, generator=g)).to(cuda).to(BF16)
    _assert_bf16_close(fused_hifigan_tail_bf16_cuda(x, *ops), fused_hifigan_tail_plain(x, *ops))


def test_each_form_refuses_the_other_type_and_the_other_tables(cuda):
    """A form never casts: bf16 x to a float32 form, or float32 x to a bf16
    form, raises, and so does a kept table packed for the other type."""
    from fastvocoder_tpu_torch.ops.fused_mrf import StageTable, fused_mrf_stage_bf16_cuda
    from fastvocoder_tpu_torch.ops.fused_resstack import (
        ChainTable,
        fused_residual_stacks_bf16_cuda,
    )
    from fastvocoder_tpu_torch.ops.fused_tail import TailTable, fused_hifigan_tail_bf16_cuda

    g = torch.Generator().manual_seed(9)
    x = (0.3 * torch.randn(1, 80, 32, generator=g)).to(cuda)
    xb = x.to(BF16)
    stacks = _stacks(32, cuda, seed=3)
    blocks = _resblocks(32, cuda, seed=3)
    ops = _tail_operands(32, 16, cuda, seed=3)
    chains = {dt: ChainTable(stacks, cuda, dt) for dt in (torch.float32, BF16)}
    stages = {dt: StageTable(blocks, None, x.device, dt) for dt in (torch.float32, BF16)}
    tails = {dt: TailTable(*ops, cuda, dt) for dt in (torch.float32, BF16)}
    with pytest.raises(ValueError, match="takes torch.float32 x"):
        fused_residual_stacks_cuda(xb, stacks)
    with pytest.raises(ValueError, match="takes torch.bfloat16 x"):
        fused_residual_stacks_bf16_cuda(x, stacks)
    with pytest.raises(ValueError, match="packed for torch.float32"):
        fused_residual_stacks_bf16_cuda(xb, stacks, chains[torch.float32])
    with pytest.raises(ValueError, match="packed for torch.bfloat16"):
        fused_residual_stacks_cuda(x, stacks, chains[BF16])
    with pytest.raises(ValueError, match="takes torch.float32 x"):
        fused_mrf_stage_cuda(xb, blocks)
    with pytest.raises(ValueError, match="takes torch.bfloat16 x"):
        fused_mrf_stage_bf16_cuda(x, blocks)
    with pytest.raises(ValueError, match="packed for torch.float32"):
        fused_mrf_stage_bf16_cuda(xb, blocks, None, stages[torch.float32])
    with pytest.raises(ValueError, match="packed for torch.bfloat16"):
        fused_mrf_stage_cuda(x, blocks, None, stages[BF16])
    with torch.no_grad():
        with pytest.raises(ValueError, match="takes torch.float32 x"):
            fused_hifigan_tail_cuda(xb, *ops)
        with pytest.raises(ValueError, match="takes torch.bfloat16 x"):
            fused_hifigan_tail_bf16_cuda(x, *ops)
        with pytest.raises(ValueError, match="packed for torch.float32"):
            fused_hifigan_tail_bf16_cuda(xb, *ops, table=tails[torch.float32])
        with pytest.raises(ValueError, match="packed for torch.bfloat16"):
            fused_hifigan_tail_cuda(x, *ops, table=tails[BF16])
        # each kept table gives the bits of a table built for the call
        assert torch.equal(fused_residual_stacks_bf16_cuda(xb, stacks, chains[BF16]),
                           fused_residual_stacks_bf16_cuda(xb, stacks))
        assert torch.equal(fused_mrf_stage_bf16_cuda(xb, blocks, None, stages[BF16]),
                           fused_mrf_stage_bf16_cuda(xb, blocks))
        assert torch.equal(fused_hifigan_tail_bf16_cuda(xb, *ops, table=tails[BF16]),
                           fused_hifigan_tail_bf16_cuda(xb, *ops))


def test_bf16_forms_are_inference_only(cuda):
    """The bf16 forms' wrappers record no graph and refuse a tensor that
    wants a gradient; training in bf16 goes through the ops' autograd paths
    (below)."""
    from fastvocoder_tpu_torch.ops.fused_mrf import fused_mrf_stage_bf16_cuda
    from fastvocoder_tpu_torch.ops.fused_resstack import fused_residual_stacks_bf16_cuda

    x = torch.randn(1, 64, 32, device=cuda, dtype=BF16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="fused_residual_stacks"):
        fused_residual_stacks_bf16_cuda(x, _stacks(32, cuda))
    with pytest.raises(NotImplementedError, match="fused_mrf_stage"):
        fused_mrf_stage_bf16_cuda(x, _resblocks(32, cuda, 0))


@pytest.mark.parametrize("family", ["basis-melgan", "hifigan", "melgan"])
def test_bf16_generators_run_the_bf16_forms_and_keep_float32_weights(cuda, family):
    """A generator built with compute_dtype bf16 on the card launches the
    bf16 forms of its kernels and no float32 form, keeps its parameters in
    float32, and writes a float32 waveform whose deviation from its float32
    self is the bf16 arithmetic's: on these trained weights more than the
    JAX package's gate, on every implementation (`tests/test_torch_bf16_models.py`),
    so held by the root mean square to twice the CPU's bf16 path's (6 dB of
    SNR; a fault of layout or rounding point shows at the signal's scale)."""
    from fastvocoder_tpu_torch.hparams import load_model_config
    from fastvocoder_tpu_torch.models.factory import load_generator

    root = os.path.join(os.path.dirname(__file__), "..")
    conf, npz = {"basis-melgan": ("basis-melgan/light.yaml", "basis_melgan_clean2.npz"),
                 "hifigan": ("hifigan/light.yaml", "hifigan_light_clean2.npz"),
                 "melgan": ("melgan/original.yaml", "melgan_clean.npz")}[family]
    cfg = load_model_config(family, os.path.join(root, "conf", conf))
    path = os.path.join(root, "docs", "checkpoints", npz)
    g = torch.Generator().manual_seed(1)
    mel = torch.clamp(0.5 + 0.25 * torch.randn(1, 100, 80, generator=g), 0, 1)
    names = {"basis-melgan": ("fused_resstack", "basis_decode"),
             "hifigan": ("fused_mrf", "fused_tail"), "melgan": ("fused_resstack",)}[family]
    out = {}
    for where in (cuda, torch.device("cpu")):
        for dtype in (BF16, None):
            gen, _ = load_generator(path, cfg, where, compute_dtype=dtype)
            before = dict(_build.launch_counts)
            with torch.inference_mode():
                out[(where.type, dtype)] = gen.inference(mel.to(where)).cpu()
            if where.type == "cuda" and dtype == BF16:
                torch.cuda.synchronize()
                for name in names:
                    assert _build.launch_counts[name + "_bf16"] > before.get(name + "_bf16", 0)
                    assert _build.launch_counts[name] == before.get(name, 0)
                assert all(p.dtype == torch.float32 for p in gen.parameters())
    got, want = out[("cuda", BF16)], out[("cuda", None)]
    assert got.dtype == torch.float32 and got.shape == want.shape and torch.isfinite(got).all()

    def rms(d):
        return d.double().pow(2).mean().sqrt().item()

    assert rms(got - want) <= 2 * rms(out[("cpu", BF16)] - out[("cpu", None)])


# ---- the bf16 forms of the backward kernels (3b, 5b) and bf16 training ----


KINK_BAND = 1e-5  # of a pre-activation's peak: where float32 rounding may flip its slope


def _vjp_switching_at(vjp_plain, args, shift, near):
    """vjp_plain(*args), flattened, with every leaky-relu's derivative
    switching to 1 at `shift` KINK_BAND of its input's peak instead of at 0
    (the forward unchanged): -1 takes the slope of 1 for every input within
    the band, +1 the leaky slope.  `near`, if a list, gets per leaky-relu
    the number of its inputs within the band."""
    from fastvocoder_tpu_torch.ops import fused_mrf as fm
    from fastvocoder_tpu_torch.ops import fused_resstack as fr

    plain_leaky = fr.leaky_relu

    def leaky(v, slope=fr.SLOPE):
        y = plain_leaky(v, slope)
        if not v.requires_grad:
            return y
        d = v.detach()
        band = KINK_BAND * d.abs().max()
        if near is not None:
            near.append(int((d.abs() <= band).sum()))
        slopes = torch.full_like(d, slope).masked_fill_(d >= shift * band, 1.0)
        return y.detach() + (v - d) * slopes  # the value y, the derivative `slopes`

    saved = fr.leaky_relu, fm.leaky_relu
    fr.leaky_relu = fm.leaky_relu = leaky
    try:
        dx, grads = vjp_plain(*args)
    finally:
        fr.leaky_relu, fm.leaky_relu = saved
    return [dx] + list(_flat(grads))


def _assert_bf16_grads_close(dx, grads, vjp_plain, args64):
    """A bf16 backward form's dx and gradients against its plain version
    run in float64 on the same bf16 inputs, `args64` (the module
    docstring's rule)."""
    want = _vjp_switching_at(vjp_plain, args64, 0, None)  # the plain version's own slopes
    got = [dx] + list(grads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == BF16 and a.shape == b.shape and a.is_contiguous()
    tols = [1e-4] + [2e-4] * (len(got) - 1)
    caps = [5e-2] + [3e-2] * (len(got) - 1)  # the float32 forms' bounds where a flip acts
    peaks = [max(w.abs().max().item(), 1e-30) for w in want]
    # each element's error beyond one bf16 ulp and its tolerance
    errs = [(a.double() - w).abs() - _bf16_ulp(torch.maximum(a.double().abs(), w.abs()))
            - tol * peak for a, w, tol, peak in zip(got, want, tols, peaks)]
    rows_ok = (errs[0] <= 0).all(dim=2).float().mean().item()
    assert rows_ok >= 0.9
    assert (dx.double() - want[0]).abs().max().item() <= caps[0] * peaks[0]
    if all(e.max().item() <= 0 for e in errs):
        return
    # the float32 recompute may have put a pre-activation within its
    # rounding of the kink on the other side: an element farther must be
    # one that taking the other slope there moves, and by no more than it
    # moves it or than the float32 forms' bound
    near = []
    hi = _vjp_switching_at(vjp_plain, args64, -1, near)
    lo = _vjp_switching_at(vjp_plain, args64, 1, None)
    reach = [(h - w).abs() + (lo_ - w).abs() for h, lo_, w in zip(hi, lo, want)]
    moved = [r > 1e-6 * peak for r, peak in zip(reach, peaks)]
    explained = all(bool((e <= r).all()) for e, r in zip(errs, reach))
    print(f"beyond one bf16 ulp: dx {errs[0].max().item() / peaks[0]:.3e}, dW/db "
          f"{max(e.max().item() / p for e, p in zip(errs[1:], peaks[1:])):.3e} of the peak, "
          f"{rows_ok:.4f} of dx's rows within; {sum(near)} pre-activations within {KINK_BAND} of "
          f"their peak of the kink, whose other slope moves {moved[0].any(dim=2).float().mean():.4f}"
          f" of dx's rows and explains every element: {explained}")
    for e, r, m, cap, peak in zip(errs, reach, moved, caps, peaks):
        assert bool((e <= torch.where(m, r.clamp_min(cap * peak), 0.0)).all())


def _bf16_inputs(B, T, C, seed):
    gen = torch.Generator().manual_seed(seed)
    x = (0.3 * torch.randn(B, T, C, generator=gen)).to(BF16)
    return x, torch.randn(B, T, C, generator=gen).to(BF16)


def _to(tree, device, dtype=None):
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=dtype or tree.dtype)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(t, device, dtype) for t in tree)
    return tree


def _check_bwd_bf16(cuda, name, vjp_bf16, vjp_f32, vjp_plain, B, T, tree, seed):
    """The bf16 backward form `name` on seeded bf16 inputs: its launch, the
    float32 form's result on the widened inputs rounded once, bit for bit,
    and the plain version in float64 (the module docstring's rule)."""
    C = next(iter(_flat(tree))).shape[1]
    x, g = _to(_bf16_inputs(B, T, C, seed), cuda)
    tree = _to(tree, cuda, BF16)
    before = dict(_build.launch_counts)
    dx, grads = vjp_bf16(x, tree, g)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before.get(name, 0) + 1
    assert _build.launch_counts[name[:-5]] == before.get(name[:-5], 0)
    grads = list(_flat(grads))
    dx32, grads32 = vjp_f32(x.float(), _map(tree, lambda t: t.float()), g.float())
    assert torch.equal(dx, dx32.to(BF16))
    assert all(torch.equal(a, b.to(BF16)) for a, b in zip(grads, _flat(grads32)))
    _assert_bf16_grads_close(dx, grads, vjp_plain, _f64((x, tree, g)))


def _check_chain_bwd_bf16(cuda, B, T, stacks, seed):
    from fastvocoder_tpu_torch.ops.fused_resstack import fused_residual_stacks_vjp_bf16_cuda

    _check_bwd_bf16(cuda, "fused_resstack_bwd_bf16", fused_residual_stacks_vjp_bf16_cuda,
                    fused_residual_stacks_vjp_cuda, fused_residual_stacks_vjp_plain, B, T, stacks,
                    seed)


def _check_mrf_bwd_bf16(cuda, B, T, blocks, seed):
    from fastvocoder_tpu_torch.ops.fused_mrf import fused_mrf_stage_vjp_bf16_cuda

    _check_bwd_bf16(cuda, "fused_mrf_bwd_bf16", fused_mrf_stage_vjp_bf16_cuda,
                    fused_mrf_stage_vjp_cuda, fused_mrf_stage_vjp_plain, B, T, blocks, seed)


@pytest.mark.parametrize("B,T,C", [(1, 208, 256), (4, 227, 256), (1, 10, 256), (2, 33, 256),
                                   (1, 2240, 256), (8, 560, 256), (4, 97, 128), (1, 300, 64),
                                   (2, 500, 32)])
def test_fused_resstack_bwd_bf16_kernel_matches_plain_vjp(cuda, B, T, C):
    _check_chain_bwd_bf16(cuda, B, T, _stacks(C, cuda, seed=T), T + C)


@pytest.mark.parametrize("B,T,C", _chain_edge_cases(10))
def test_fused_resstack_bwd_bf16_kernel_matches_plain_vjp_at_tile_edges(cuda, B, T, C):
    _check_chain_bwd_bf16(cuda, B, T, _stacks(C, cuda, seed=C + 1), T + C + B)


@pytest.mark.parametrize("stage,B,T", [(0, 2, 1400), (1, 2, 8400), (2, 1, 16800), (3, 1, 33600)])
def test_fused_resstack_bwd_bf16_kernel_matches_plain_vjp_melgan_stages(cuda, melgan_original,
                                                                        stage, B, T):
    stacks = [m.chain_operands() for m in melgan_original.stacks[stage]]
    _check_chain_bwd_bf16(cuda, B, T, stacks, 10 * stage + B)


@pytest.mark.parametrize("B,T,C", [(1, 1, 128), (2, 7, 64), (1, 50, 32), (4, 50, 16),
                                   (1, 1120, 128), (4, 333, 64), (1, 1700, 32), (4, 1100, 16),
                                   (2, 700, 16), (1, 300, 256)])
def test_fused_mrf_bwd_bf16_kernel_matches_plain_vjp(cuda, B, T, C):
    _check_mrf_bwd_bf16(cuda, B, T, _resblocks(C, cuda, seed=C), T + C)


@pytest.mark.parametrize("B,T,C", _edge_cases())
def test_fused_mrf_bwd_bf16_kernel_matches_plain_vjp_at_tile_edges(cuda, B, T, C):
    _check_mrf_bwd_bf16(cuda, B, T, _resblocks(C, cuda, seed=C + 1), T + C)


# HiFiGAN light's four training stages (crops of 140 frames, batch 2)
@pytest.mark.parametrize("stage,T", [(0, 1120), (1, 8960), (2, 17920), (3, 35840)])
def test_fused_mrf_bwd_bf16_kernel_matches_plain_vjp_release_weights(cuda, hifigan_light, stage,
                                                                     T):
    blocks = [b.mrf_operands() for b in hifigan_light.mrfs[stage]]
    _check_mrf_bwd_bf16(cuda, 2, T, blocks, 20 + stage)


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(t, fn) for t in tree)
    return tree


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _flat(t)


@pytest.mark.parametrize("op", ["chain", "mrf"])
def test_bf16_autograd_runs_both_bf16_forms_into_float32_weights(cuda, op):
    """bf16 x and float32 weights (non-leaf products, as weight norm makes
    them) through `fused_residual_stacks` / `fused_mrf_stage` under
    autograd: the bf16 forward and backward forms launch, no float32 form;
    x's gradient comes back bf16, the weights' float32 (autograd's cast
    backward), and both are the plain bf16 backward's."""
    if op == "chain":
        name, fwd = "fused_resstack", fused_residual_stacks
        tree, vjp, T = _stacks(256, cuda, seed=5), fused_residual_stacks_vjp_plain, 60
    else:
        name, fwd = "fused_mrf", fused_mrf_stage
        tree, vjp, T = _resblocks(32, cuda, seed=5), fused_mrf_stage_vjp_plain, 60
    leaves = _map(tree, lambda t: t.clone().requires_grad_())
    ops = _map(leaves, lambda t: t * 1.5)
    leaves = list(_flat(leaves))
    C = leaves[0].shape[1]
    x, cot = _to(_bf16_inputs(2, T, C, 11), cuda)
    x.requires_grad_()
    before = dict(_build.launch_counts)
    y = fwd(x, ops)
    got = torch.autograd.grad(y, [x] + leaves, cot)
    torch.cuda.synchronize()
    for form, want in ((name, 0), (name + "_bwd", 0), (name + "_bf16", 1),
                       (name + "_bwd_bf16", 1)):
        assert _build.launch_counts[form] - before.get(form, 0) == want, form
    assert y.dtype == BF16 and got[0].dtype == BF16
    assert all(g.dtype == torch.float32 for g in got[1:])
    # d leaf = 1.5 d product, exact: the product's bf16 gradient, widened
    _assert_bf16_grads_close(got[0], [(g / 1.5).to(BF16) for g in got[1:]], vjp,
                             _f64((x.detach(), _map(ops, lambda t: t.detach().to(BF16)), cot)))


def test_basis_decode_bf16_kernel_gradient_is_plain_vjp(cuda):
    """The bf16 decode under autograd: kernel 1b forward, the plain VJP in
    bf16 backward; the float32 basis's gradient comes through its cast."""
    from fastvocoder_tpu_torch.ops.basis_decode import basis_decode_vjp

    g = torch.Generator().manual_seed(3)
    w = torch.relu(torch.randn(2, 40, 256, generator=g)).to(cuda).to(BF16).requires_grad_()
    basis = (0.1 * torch.randn(30, 256, generator=g)).to(cuda).requires_grad_()
    cot = torch.randn(2, 41 * 15, generator=g).to(cuda)
    before = dict(_build.launch_counts)
    dw, db = torch.autograd.grad(basis_decode(w, basis.to(BF16)), (w, basis), cot)
    assert _build.launch_counts["basis_decode_bf16"] == before.get("basis_decode_bf16", 0) + 1
    assert _build.launch_counts["basis_decode"] == before.get("basis_decode", 0)
    want_w, want_b = basis_decode_vjp(w.detach(), basis.detach().to(BF16), cot)
    assert dw.dtype == BF16 and db.dtype == torch.float32
    assert torch.equal(dw, want_w) and torch.equal(db, want_b.float())


@pytest.mark.parametrize("family", ["basis-melgan", "hifigan", "melgan"])
def test_bf16_training_step_runs_the_bf16_forms_and_keeps_float32_state(cuda, family):
    """One narrow GAN step with compute_dtype bf16 on the card: the bf16
    forms of the family's kernels, forward and backward, and no float32
    form; finite losses; float32 gradients, parameters and Adam state."""
    from fastvocoder_tpu_torch import hparams as thp
    from fastvocoder_tpu_torch.train.trainer import make_trainer

    archs = {"hifigan": thp.HiFiGANConfig(resblock_kernel_sizes=(3, 5),
                                          upsample_rates=(8, 5, 3, 2),
                                          upsample_initial_channel=256,
                                          upsample_kernel_sizes=(16, 10, 6, 4),
                                          resblock_dilation_sizes=((1, 3), (1, 3))),
             "basis-melgan": thp.BasisMelGANConfig(out_channels=32, channels=(32, 32, 32)),
             "melgan": thp.MelGANConfig(channels=(64, 32, 32, 32, 32),
                                        upsample_scales=(10, 6, 2, 2))}
    cfg = thp.ModelConfig(family, archs[family], lambda_stft=1.0)
    basis = None
    if family == "basis-melgan":
        basis = 0.1 * np.random.default_rng(3).standard_normal((30, 32)).astype(np.float32)
    tr = make_trainer(cfg, hp=thp.HP.replace(fixed_length=20), basis_signal_weight=basis,
                      disc_cfg=thp.TINY_DISC, keep_grads=True, compute_dtype=BF16)
    state = tr.init_state(0)
    rng = np.random.default_rng(4)
    mel = torch.from_numpy(rng.standard_normal((4, 20, 80)).astype(np.float32)).to(cuda)
    wav = torch.from_numpy(0.1 * rng.standard_normal((4, 4800)).astype(np.float32)).to(cuda)
    weight = None
    if family == "basis-melgan":
        weight = torch.from_numpy(rng.random((4, 320, 32)).astype(np.float32)).to(cuda)
    kernels = {"hifigan": ("fused_mrf", "fused_mrf_bwd"),
               "basis-melgan": ("fused_resstack", "fused_resstack_bwd", "basis_decode"),
               "melgan": ("fused_resstack", "fused_resstack_bwd")}[family]
    before = dict(_build.launch_counts)
    _, metrics = tr.pre_adv_step(state, mel, wav, weight)
    _, gan = tr.gan_step(state, mel, wav, weight)
    torch.cuda.synchronize()
    for k in kernels:
        assert _build.launch_counts[k + "_bf16"] > before.get(k + "_bf16", 0), k
        assert _build.launch_counts[k] == before.get(k, 0), k
    assert all(np.isfinite(float(v)) for v in list(metrics.values()) + list(gan.values()))
    for who, module, opt in (("generator", state.generator, state.gen_opt),
                             ("discriminator", state.discriminator, state.disc_opt)):
        assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
                   for g in tr.last_grads[who].values())
        assert all(p.dtype == torch.float32 for p in module.parameters())
        assert all(v.dtype == torch.float32 for st in opt.state.values() for v in st.values()
                   if isinstance(v, torch.Tensor) and v.dim() > 0)
