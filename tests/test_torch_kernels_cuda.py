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
"""

import numpy as np
import pytest
import torch

from fastvocoder_tpu_torch.ops import _build
from fastvocoder_tpu_torch.ops.basis_decode import basis_decode, basis_decode_plain
from fastvocoder_tpu_torch.ops.fused_resstack import (
    fused_residual_stacks_cuda,
    fused_residual_stacks_plain,
)

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
