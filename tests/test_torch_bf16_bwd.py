"""The bf16 forms of the port's two backward kernels (kernel 3b: the
residual-stack chain's, kernel 5b: the MRF stage's) against the JAX
package's Pallas backward bodies in bf16, on the CPU.

Their plain versions (`fused_residual_stacks_vjp_plain`,
`fused_mrf_stage_vjp_plain` given bf16 x) compute what the Pallas bodies
compute from bf16 inputs (`fastvocoder_tpu/ops/fused_resstack.py:241-360,
419-430`, `fused_mrf.py:259-264, 276-279, 452, 461`): x, g and the weights
upcast to float32, the forward recomputed and its adjoint taken in float32
(none of the forward's bf16 rounding points), dx and every dW and db
rounded to bf16 once.  The JAX side runs in interpret mode on bf16 input,
its weights bf16, as tests/test_fused_resstack.py and test_fused_mrf.py run
the kernels (`tile_q=32` and 16).  Held, per gradient, in bf16 ulps of its
peak (one ulp: 2^(e - 7) for the peak's binade e):

  * against JAX's float32 VJP of the plain chain / the module path of the
    same bf16 inputs, rounded to bf16: every element within one ulp of the
    peak (two float32 sums in other orders round to neighbouring bf16
    values).  Measured: chain dx 0.06 (C = 32) and 0.50 (C = 128), dW 0.06
    and 0.25; MRF dx 0.00 and 0.02, dW 0.06 and 0.50;
  * against the Pallas backward.  The MRF stage's whole tensors within two
    ulps of the peak (measured 1.00 at C = 32, 0.50 at 128): JAX sums the
    branches' dx in bf16 and, below C = 128, the bf16 partials of its
    blocked weights, where the port rounds once.  The chain's dx on the
    rows the JAX package computes in its Pallas body alone, [EDGE_ROWS,
    T - EDGE_ROWS), within one ulp (measured 0 and 0.125).  Its mirrored
    edges the JAX package leaves to XLA's bf16 autograd of the plain chain
    (bf16 rounding after every op) and adds to the body's in bf16: there
    the two differ by a few per cent of the peak (measured dx 5.9e-2 and
    3.3e-2 of the peak, dW 7.4e-2 and 8.2e-2), which is printed, not held
    (`ROADMAP.md` C: known numerics).

On the card the kernels are held to these plain versions
(`tests/test_torch_kernels_cuda.py`, `chip_smoke.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvocoder_tpu.ops.fused_mrf import fused_mrf_stage as jax_mrf
from fastvocoder_tpu.ops.fused_resstack import _std_chain
from fastvocoder_tpu.ops.fused_resstack import fused_residual_stacks as jax_chain
from fastvocoder_tpu_torch.ops import fused_mrf as fm
from fastvocoder_tpu_torch.ops import fused_resstack as fr
from tests import test_torch_fused_mrf_bwd as mrf_case
from tests import test_torch_fused_resstack_bwd as chain_case

BF16 = torch.bfloat16
EDGE_ROWS = 64  # the JAX chain's edge slices reach 52 (C = 128) and 55 (C = 32) rows


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the same float32 sums on
    every machine and worker count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulp(peak: float) -> float:
    return 2.0 ** (np.floor(np.log2(peak)) - 7)


def _bf(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _f32(a):
    return a.astype(jnp.float32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(_f32(jnp.asarray(a)))


def _torch_bf16(a):
    return torch.from_numpy(np.array(_f32(a))).to(BF16)


def _ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of want's peak."""
    want = _np(want)
    return float(np.abs(_np(got) - want).max() / _ulp(np.abs(want).max()))


@pytest.mark.parametrize("C,T", [(32, 256), (128, 256)])
def test_chain_bwd_bf16_is_the_float32_vjp_rounded_once(C, T):
    rng = np.random.default_rng(C + T)
    x = _bf((0.3 * rng.standard_normal((2, T, C))).astype(np.float32))
    g = _bf(rng.standard_normal((2, T, C)).astype(np.float32))
    wd = jax.tree_util.tree_map(_bf, chain_case._weights(C, 0))
    rebuild = chain_case._rebuild
    dx, grads = fr.fused_residual_stacks_vjp_plain(_torch_bf16(x), rebuild(wd, _torch_bf16),
                                                   _torch_bf16(g))
    assert dx.dtype == BF16 and all(t.dtype == BF16 for s in grads for t in s)

    _, vjp = jax.vjp(lambda x, w: _std_chain(x, rebuild(w, lambda a: a)), _f32(x),
                     jax.tree_util.tree_map(_f32, wd))
    rdx, rdw = vjp(_f32(g))
    assert _ulps(dx, _bf(rdx)) <= 1.0
    for s in range(len(grads)):
        for j, name in enumerate(chain_case.NAMES):
            assert _ulps(grads[s][j], _bf(rdw[s][j])) <= 1.0, f"stack {s} {name}"

    _, vjp = jax.vjp(lambda x, w: jax_chain(x, rebuild(w, lambda a: a), tile_q=32,
                                            interpret=True), x, wd)
    pdx, pdw = vjp(g)
    inner = slice(EDGE_ROWS, T - EDGE_ROWS)
    assert _ulps(dx[:, inner], np.asarray(_f32(pdx))[:, inner]) <= 1.0
    peak = np.abs(_np(pdx)).max()
    edge_dx = np.abs(_np(dx) - _np(pdx)).max() / peak
    edge_dw = max(np.abs(_np(grads[s][j]) - _np(pdw[s][j])).max() / np.abs(_np(pdw[s][j])).max()
                  for s in range(len(grads)) for j in range(6))
    print(f"C={C}: the mirrored edges against JAX's bf16 autograd: dx {edge_dx:.3e}, "
          f"dW {edge_dw:.3e} of the peak")


@pytest.mark.parametrize("C,T", [(32, 120), (128, 120)])
def test_mrf_bwd_bf16_is_the_float32_vjp_rounded_once(C, T):
    x, cot = mrf_case._inputs(2, T, C)
    x, g = _bf(x), _bf(cot)
    wd = jax.tree_util.tree_map(_bf, mrf_case._weights(C, 0))
    rebuild = mrf_case._rebuild
    dx, grads = fm.fused_mrf_stage_vjp_plain(_torch_bf16(x), rebuild(wd, _torch_bf16),
                                             _torch_bf16(g))
    assert dx.dtype == BF16

    _, vjp = jax.vjp(mrf_case._jax_plain_stage, _f32(x), jax.tree_util.tree_map(_f32, wd))
    rdx, rdw = vjp(_f32(g))
    _, vjp = jax.vjp(lambda x, w: jax_mrf(x, rebuild(w, lambda a: a), tile_q=16, interpret=True),
                     x, wd)
    pdx, pdw = vjp(g)
    assert _ulps(dx, _bf(rdx)) <= 1.0
    assert _ulps(dx, pdx) <= 2.0
    for i, pairs in enumerate(grads):
        for j, group in enumerate(pairs):
            for k, name in enumerate(("dk1", "db1", "dk2", "db2")):
                where = f"branch {i} pair {j} {name}"
                assert group[k].dtype == BF16
                assert _ulps(group[k], _bf(rdw[i][j][k])) <= 1.0, where
                assert _ulps(group[k], pdw[i][j][k]) <= 2.0, where


def test_plain_forms_round_float32_weights_to_bf16_first():
    """Given float32 weights (a model's parameters) and bf16 x, the plain
    bf16 backward rounds the weights as the kernel's callers cast them."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((0.3 * rng.standard_normal((1, 40, 32))).astype(np.float32)).to(BF16)
    g = torch.from_numpy(rng.standard_normal((1, 40, 32)).astype(np.float32)).to(BF16)
    stacks = chain_case._rebuild(chain_case._weights(32, 3), torch.from_numpy)
    rounded = [tuple(w if isinstance(w, int) else w.to(BF16) for w in s) for s in stacks]
    a = fr.fused_residual_stacks_vjp_plain(x, stacks, g)
    b = fr.fused_residual_stacks_vjp_plain(x, rounded, g)
    for u, v in zip([a[0]] + [t for s in a[1] for t in s], [b[0]] + [t for s in b[1] for t in s]):
        assert torch.equal(u, v)
    blocks = mrf_case._rebuild(mrf_case._weights(32, 3), torch.from_numpy)
    rounded = [[tuple(w if isinstance(w, int) else w.to(BF16) for w in p) for p in pairs]
               for pairs in blocks]
    a = fm.fused_mrf_stage_vjp_plain(x, blocks, g)
    b = fm.fused_mrf_stage_vjp_plain(x, rounded, g)
    flat = lambda r: [r[0]] + [t for pairs in r[1] for grp in pairs for t in grp]
    for u, v in zip(flat(a), flat(b)):
        assert torch.equal(u, v)
