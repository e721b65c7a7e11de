"""The bf16 forms of the port's four inference kernels (kernels 1, 2, 4 and
6: `ops/basis_decode.py`, `ops/fused_resstack.py`, `ops/fused_mrf.py`,
`ops/fused_tail.py`) against the JAX package's Pallas bodies in bf16, on the
CPU.

Each plain version given bf16 input computes what the bf16 form computes:
bf16 operands (parameters rounded from float32), float32 sums, rounded to
bf16 where the Pallas body rounds.  The JAX side is the Pallas kernel in
interpret mode on bf16 input (`interpret=True`), which casts the float32
weights to bf16 itself.  Bit parity cannot be had in bf16, not even inside
the JAX package (its XLA chain and its Pallas chain differ in 62 % of the
elements): two float32 sums taken in other orders round to different bf16
neighbours, and the differences travel through the later convs.  So the
bound is the JAX package's own bf16 gate (`tests/test_quality_gate.py`),
max(2e-3, 1 % of the float32 output's peak), for the port against JAX in
bf16 and for the port's bf16 output against its own float32 output; the
share of elements more than one bf16 ulp apart is printed, not bounded.

Measured here (port against JAX in bf16; port against its float32 output;
the bound), chain of 3 stacks (dilations 1, 3, 9) on (2, 256, C): C = 128
1.95e-3, 2.21e-3, 3.22e-3, and C = 32 (the JAX kernel's blocked layout)
3.91e-3, 2.55e-3, 3.99e-3; MRF stage (k = 3 / 7 / 11, d = 1 / 3 / 5) on
(2, 256, C): C = 16 7.81e-3, 9.38e-3, 1.25e-2 and C = 32 7.81e-3, 9.27e-3,
1.12e-2; tail 32 -> 16 (T_in = 96) 9.8e-4, 1.41e-3, 2e-3; decode
(2, 200, 256), L = 30: 1.2e-7 (both sum the same bf16 products in
float32), 1.87e-3, 7.52e-3.  The chain at C = 32 is 2 bf16 ulps of its
peak's binade from JAX, 0.98 of the bound: the gate allows about 2 ulps at
these peaks, and the port and JAX differ by up to 2 there.

Also on the CPU: each form refuses x of the other type and a kept table
packed for the other type before it launches anything; the card's side of
both is in `tests/test_torch_kernels_cuda.py`.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvocoder_tpu.ops.basis_decode import basis_decode_pallas as jax_decode
from fastvocoder_tpu.ops.fused_mrf import fused_mrf_stage as jax_mrf
from fastvocoder_tpu.ops.fused_resstack import fused_residual_stacks as jax_chain
from fastvocoder_tpu.ops.fused_tail import fused_hifigan_tail as jax_tail
from fastvocoder_tpu_torch.ops import basis_decode as bd
from fastvocoder_tpu_torch.ops import fused_mrf as fm
from fastvocoder_tpu_torch.ops import fused_resstack as fr
from fastvocoder_tpu_torch.ops import fused_tail as ft
from fastvocoder_tpu_torch.ops.precision import check_compute_dtype, fit

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs, restored afterwards: the
    same float32 sums on every machine and worker count (pytest-xdist runs
    several test processes side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_ulp(v):
    """One bf16 ulp at each element of v: 2^(e - 7), e its binade."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def assert_bf16_gate(port, jax_bf16, port_f32):
    """The JAX package's bf16 gate, for the port against JAX in bf16 and
    against its own float32 output."""
    port, jax_bf16, port_f32 = (np.asarray(a, np.float32) for a in (port, jax_bf16, port_f32))
    assert port.shape == jax_bf16.shape == port_f32.shape
    bound = max(2e-3, 0.01 * float(np.abs(port_f32).max()))
    to_jax = np.abs(port - jax_bf16)
    print(f"port - jax {to_jax.max():.3e}, port - float32 {np.abs(port - port_f32).max():.3e}, "
          f"bound {bound:.3e}, {(to_jax > bf16_ulp(jax_bf16)).mean():.4f} of elements more than "
          "one ulp from jax")
    assert np.isfinite(port).all()
    assert to_jax.max() <= bound
    assert np.abs(port - port_f32).max() <= bound


def _tree(obj, conv):
    """Every numpy array of a nested tuple / list operand structure through
    `conv`; ints (dilations, strides) as they are."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree(o, conv) for o in obj)
    return obj if isinstance(obj, int) else conv(obj)


def _chain(C, seed):
    r = np.random.default_rng(seed)
    b = 1 / np.sqrt(3 * C)

    def u(*shape, scale=1.0):
        return (scale * r.uniform(-b, b, shape)).astype(np.float32)

    stacks = [(u(3, C, C), u(C), 3 ** j, u(1, C, C, scale=1.7), u(C), u(1, C, C, scale=1.7), u(C))
              for j in range(3)]
    return (0.3 * r.standard_normal((2, 256, C))).astype(np.float32), stacks


@pytest.mark.parametrize("C", [128, 32])  # 32: the JAX kernel's blocked layout
def test_chain_bf16_matches_jax_pallas_bf16(C):
    x, stacks = _chain(C, seed=C)
    want = jax_chain(jnp.asarray(x).astype(jnp.bfloat16), _tree(stacks, jnp.asarray), tile_q=128,
                     interpret=True)
    got = fr.fused_residual_stacks(torch.from_numpy(x).to(BF16), _tree(stacks, torch.from_numpy))
    own = fr.fused_residual_stacks(torch.from_numpy(x), _tree(stacks, torch.from_numpy))
    assert got.dtype == BF16 and got.shape == (2, 256, C)
    assert_bf16_gate(got.float(), np.asarray(want.astype(jnp.float32)), own)


def _branches(C, seed):
    r = np.random.default_rng(seed)
    out = []
    for rk in (3, 7, 11):
        b = 1 / np.sqrt(C * rk)
        out.append([(r.uniform(-b, b, (rk, C, C)).astype(np.float32),
                     r.uniform(-b, b, C).astype(np.float32), d,
                     r.uniform(-b, b, (rk, C, C)).astype(np.float32),
                     r.uniform(-b, b, C).astype(np.float32)) for d in (1, 3, 5)])
    return out


@pytest.mark.parametrize("C", [16, 32])
def test_mrf_bf16_matches_jax_pallas_bf16(C):
    r = np.random.default_rng(C)
    x = (0.3 * r.standard_normal((2, 256, C))).astype(np.float32)
    blocks = _branches(C, seed=C + 1)
    want = jax_mrf(jnp.asarray(x).astype(jnp.bfloat16), _tree(blocks, jnp.asarray), tile_q=64,
                   interpret=True)
    got = fm.fused_mrf_stage(torch.from_numpy(x).to(BF16), _tree(blocks, torch.from_numpy))
    own = fm.fused_mrf_stage(torch.from_numpy(x), _tree(blocks, torch.from_numpy))
    assert got.dtype == BF16
    assert_bf16_gate(got.float(), np.asarray(want.astype(jnp.float32)), own)


def test_tail_bf16_matches_jax_pallas_bf16():
    r = np.random.default_rng(32)

    def w(*shape, scale=0.08):
        return (scale * r.standard_normal(shape)).astype(np.float32)

    blocks = [[(w(rk, 16, 16), w(16, scale=0.05), d, w(rk, 16, 16), w(16, scale=0.05))
               for d in (1, 3, 5)] for rk in (3, 7, 11)]
    ops = (w(4, 32, 16), w(16, scale=0.1), 2, 1, blocks, w(7, 16, 1), w(1, scale=0.1))
    x = (0.3 * r.standard_normal((2, 96, 32))).astype(np.float32)
    want = jax_tail(jnp.asarray(x).astype(jnp.bfloat16), *_tree(ops, jnp.asarray), tile_q=16,
                    interpret=True)
    got = ft.fused_hifigan_tail(torch.from_numpy(x).to(BF16), *_tree(ops, torch.from_numpy))
    own = ft.fused_hifigan_tail(torch.from_numpy(x), *_tree(ops, torch.from_numpy))
    assert got.dtype == BF16 and got.shape == (2, 192, 1)
    assert_bf16_gate(got.float(), np.asarray(want.astype(jnp.float32)), own)


def test_decode_bf16_matches_jax_pallas_bf16():
    """The Pallas kernel's float32 output at every size (the JAX package's
    `auto` route would hand more than 65,536 rows to a bf16 einsum)."""
    r = np.random.default_rng(0)
    w = (0.1 * np.abs(r.standard_normal((2, 200, 256)))).astype(np.float32)
    basis = (0.1 * r.standard_normal((30, 256))).astype(np.float32)
    want = jax_decode(jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(basis), interpret=True)
    got = bd.basis_decode(torch.from_numpy(w).to(BF16), torch.from_numpy(basis))
    own = bd.basis_decode(torch.from_numpy(w), torch.from_numpy(basis))
    assert got.dtype == torch.float32 and got.shape == (2, 201 * 15)
    assert_bf16_gate(got, np.asarray(want), own)
    # the same bf16 products summed in float32: float32's rounding apart
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6


def test_plain_versions_round_where_the_kernels_round():
    """The rounding points of the plain bf16 chain, written out for one
    stack: every intermediate is a bf16 value."""
    x, stacks = _chain(32, seed=5)
    kd, bdias, d, k1, b1, ks, bs = (w if isinstance(w, int) else fit(torch.from_numpy(w), BF16)
                                    for w in stacks[0])
    h = torch.from_numpy(x).to(BF16).float()
    from fastvocoder_tpu_torch.ops.conv import conv1d, reflect_pad1d

    t = fit(fr.leaky_relu(h), BF16)
    t = fit(conv1d(reflect_pad1d(t, 1), kd.permute(2, 1, 0), bdias), BF16)
    t = fit(conv1d(fit(fr.leaky_relu(t), BF16), k1.permute(2, 1, 0), b1), BF16)
    want = fit(t + fit(conv1d(h, ks.permute(2, 1, 0), bs), BF16), BF16)
    got = fr.fused_residual_stacks_plain(torch.from_numpy(x).to(BF16),
                                         _tree(stacks[:1], torch.from_numpy))
    assert torch.equal(got.float(), want)


def test_compute_dtype_is_float32_or_bf16():
    assert check_compute_dtype(None) is None
    assert check_compute_dtype(torch.float32) is None
    assert check_compute_dtype(BF16) == BF16
    with pytest.raises(ValueError, match="compute_dtype"):
        check_compute_dtype(torch.float16)


def test_each_form_refuses_the_other_type_before_it_launches():
    """A form never casts its input: bf16 x to a float32 form, or float32 x
    to a bf16 form, raises; so does a kept table packed for the other type.
    Both before any kernel is built (on the CPU too)."""
    x, stacks = _chain(32, seed=1)
    stacks = _tree(stacks, torch.from_numpy)
    xf = torch.from_numpy(x)
    xb = xf.to(BF16)
    blocks = _tree(_branches(32, seed=2), torch.from_numpy)
    table_f32 = types.SimpleNamespace(dtype=torch.float32)
    table_bf16 = types.SimpleNamespace(dtype=BF16)
    with pytest.raises(ValueError, match="takes torch.float32 x, got torch.bfloat16"):
        fr.fused_residual_stacks_cuda(xb, stacks)
    with pytest.raises(ValueError, match="takes torch.bfloat16 x, got torch.float32"):
        fr.fused_residual_stacks_bf16_cuda(xf, stacks)
    with pytest.raises(ValueError, match="packed for torch.float32"):
        fr.fused_residual_stacks_bf16_cuda(xb, stacks, table_f32)
    with pytest.raises(ValueError, match="packed for torch.bfloat16"):
        fr.fused_residual_stacks_cuda(xf, stacks, table_bf16)
    with pytest.raises(ValueError, match="takes torch.float32 x"):
        fm.fused_mrf_stage_cuda(xb, blocks)
    with pytest.raises(ValueError, match="takes torch.bfloat16 x"):
        fm.fused_mrf_stage_bf16_cuda(xf, blocks)
    with pytest.raises(ValueError, match="packed for torch.float32"):
        fm.fused_mrf_stage_bf16_cuda(xb, blocks, None, table_f32)
    with pytest.raises(ValueError, match="packed for torch.bfloat16"):
        fm.fused_mrf_stage_cuda(xf, blocks, None, table_bf16)
    tail = (torch.zeros(4, 32, 16), torch.zeros(16), 2, 1, _tree(_branches(16, 3), torch.from_numpy),
            torch.zeros(7, 16, 1), torch.zeros(1))
    with pytest.raises(ValueError, match="takes torch.float32 x"):
        ft.fused_hifigan_tail_cuda(xb, *tail)
    with pytest.raises(ValueError, match="takes torch.bfloat16 x"):
        ft.fused_hifigan_tail_bf16_cuda(xf, *tail)
    with pytest.raises(ValueError, match="packed for torch.float32"):
        ft.fused_hifigan_tail_bf16_cuda(xb, *tail, table=table_f32)
    with pytest.raises(ValueError, match="packed for torch.bfloat16"):
        ft.fused_hifigan_tail_cuda(xf, *tail, table=table_bf16)
    w = torch.ones(1, 4, 16)
    with pytest.raises(ValueError, match="takes torch.float32 x"):
        bd.basis_decode_cuda(w.to(BF16), torch.ones(30, 16))
    with pytest.raises(ValueError, match="takes torch.bfloat16 x"):
        bd.basis_decode_bf16_cuda(w, torch.ones(30, 16, dtype=BF16))


def test_bf16_forms_are_inference_only():
    """The bf16 forms' wrappers record no graph: given a tensor that wants a
    gradient they refuse, before anything is built, and name the op whose
    autograd path trains in bf16."""
    xb = torch.zeros(1, 8, 32, dtype=BF16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="records no graph.*`fused_residual_stacks`"):
        fr.fused_residual_stacks_bf16_cuda(xb, _tree(_chain(32, 1)[1], torch.from_numpy))
    with pytest.raises(NotImplementedError, match="`fused_mrf_stage`"):
        fm.fused_mrf_stage_bf16_cuda(xb, _tree(_branches(32, seed=2), torch.from_numpy))
    with pytest.raises(NotImplementedError, match="`basis_decode`"):
        bd.basis_decode_bf16_cuda(torch.zeros(1, 4, 16, dtype=BF16, requires_grad=True),
                                  torch.ones(30, 16, dtype=BF16))
