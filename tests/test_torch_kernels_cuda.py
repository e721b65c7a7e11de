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
the tail's, after tanh, within 1e-4.
"""

import os

import numpy as np
import pytest
import torch

from fastvocoder_tpu_torch.ops import _build
from fastvocoder_tpu_torch.ops.basis_decode import basis_decode, basis_decode_plain
from fastvocoder_tpu_torch.ops.fused_mrf import fused_mrf_stage_cuda, fused_mrf_stage_plain
from fastvocoder_tpu_torch.ops.fused_resstack import (
    fused_residual_stacks_cuda,
    fused_residual_stacks_plain,
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


@pytest.mark.parametrize("B,F,C,L", [(1, 9360, 256, 30), (32, 1024, 256, 30), (3, 77, 256, 30), (2, 5, 64, 12)])
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
    x = torch.randn(1, 64, 256, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        fused_residual_stacks_cuda(x, _stacks(256, cuda))


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


def test_mrf_and_tail_kernels_are_forward_only(cuda):
    x = torch.randn(1, 64, 32, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        fused_mrf_stage_cuda(x, _resblocks(32, cuda, 0))
    with pytest.raises(NotImplementedError):
        fused_hifigan_tail_cuda(x, *_tail_operands(32, 16, cuda, 0))


def test_mrf_kernel_refuses_other_widths(cuda):
    with pytest.raises(ValueError, match="not in"):
        fused_mrf_stage_cuda(torch.zeros(1, 8, 48, device=cuda), _resblocks(48, cuda, 0))
