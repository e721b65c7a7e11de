"""`LastLinear` (`fastvocoder_tpu_torch/models/layers.py`) against the JAX
package's module: leaky(0.2), BatchNorm, 1x1 weight-norm conv, twice, with
Flax's BatchNorm arithmetic (running averages at momentum 0.99, the biased
batch variance mean(x^2) - mean(x)^2, eps 1e-5), which `nn.BatchNorm1d`'s
defaults do not give (momentum 0.1 for the new batch, the unbiased
variance in the running average).

Weights are initialised on the JAX side and carried across with
`state_dict_from_jax(..., batch_stats=)`; they go back with
`jax_tree_from_state_dict` and `jax_batch_stats_from_state_dict`.  Held
within 1e-6: eval mode on random running statistics; train mode's outputs
and running statistics after two calls; the same two calls in two gloo
ranks of two rows each (global batch statistics, `tests/_torch_dp_child.py`)
against one process of four rows, with the parameters' gradients.
"""

import os

import jax
import numpy as np
import pytest
import torch
from _torch_dp_child import lastlinear, spawn

from fastvocoder_tpu.models.layers import LastLinear as JaxLastLinear
from fastvocoder_tpu_torch.checkpoint import (
    jax_batch_stats_from_state_dict,
    jax_tree_from_state_dict,
    state_dict_from_jax,
)
from fastvocoder_tpu_torch.models.layers import LastLinear

C, HIDDEN, OUT, TOL = 16, 24, 8, 1e-6


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _x(seed, B=4, T=10):
    return (np.random.default_rng(seed).standard_normal((B, T, C)) * 2 + 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def jax_vars():
    """The JAX module's variables, its running statistics set away from
    their initial zeros and ones."""
    variables = JaxLastLinear(HIDDEN, OUT).init(jax.random.PRNGKey(0), _x(0))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    for node in stats.values():
        node["mean"] = rng.standard_normal(node["mean"].shape).astype(np.float32)
        node["var"] = rng.uniform(0.5, 2.0, node["var"].shape).astype(np.float32)
    return {"params": jax.tree_util.tree_map(np.asarray, variables["params"]),
            "batch_stats": stats}


def _port(jax_vars, train):
    layer = LastLinear(C, HIDDEN, OUT, train=train)
    layer.load_state_dict(state_dict_from_jax(jax_vars["params"], fuse=False,
                                              batch_stats=jax_vars["batch_stats"]))
    return layer


def test_eval_mode_matches_jax(jax_vars):
    x = _x(2)
    want = np.asarray(JaxLastLinear(HIDDEN, OUT).apply(jax_vars, x))
    layer = _port(jax_vars, train=False)
    assert not layer.training
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_train_mode_matches_jax_running_statistics_included(jax_vars):
    """Two calls in train mode: each output from its batch's statistics,
    and the running statistics Flax's way (an `nn.BatchNorm1d` at its
    defaults is off by far more: momentum 0.1 and the unbiased variance)."""
    module = JaxLastLinear(HIDDEN, OUT, train=True)
    variables = dict(jax_vars)
    layer = _port(jax_vars, train=True)
    for seed in (3, 4):
        x = _x(seed)
        want, updates = module.apply(variables, x, mutable=["batch_stats"])
        variables = {"params": jax_vars["params"], "batch_stats": updates["batch_stats"]}
        got = layer(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    for node in ("bn_1", "bn_2"):
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(layer, node).state_dict()[ours].numpy(),
                np.asarray(variables["batch_stats"][node][theirs]), rtol=TOL, atol=TOL,
                err_msg=f"{node}.{ours}")
    torch_bn = torch.nn.BatchNorm1d(C)
    torch_bn(torch.from_numpy(_x(3)).reshape(-1, C))
    assert np.abs(torch_bn.running_mean.numpy()
                  - np.asarray(variables["batch_stats"]["bn_1"]["mean"])).max() > 1e-2


def test_weights_cross_both_ways(jax_vars):
    """The port's state back in JAX's layout, a train step's statistics
    included: the JAX module computes what the port does."""
    layer = _port(jax_vars, train=True)
    layer(torch.from_numpy(_x(5)))  # running statistics of its own
    layer.eval()
    params = _nest(jax_tree_from_state_dict(layer.state_dict()))
    stats = _nest(jax_batch_stats_from_state_dict(layer.state_dict()))
    assert set(params) == {"bn_1", "bn_2", "linear_1", "linear_2"}
    assert set(params["bn_1"]) == {"scale", "bias"} and set(stats["bn_2"]) == {"mean", "var"}
    x = _x(6)
    want = np.asarray(JaxLastLinear(HIDDEN, OUT).apply(
        {"params": params, "batch_stats": stats}, x))
    with torch.no_grad():
        np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(), want, rtol=TOL, atol=TOL)
    back = state_dict_from_jax(params, fuse=False, batch_stats=stats)
    for k, v in layer.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_train_mode_under_two_gloo_ranks_equals_one_process(jax_vars, tmp_path):
    """Each rank holds two rows of a batch of four; the statistics are the
    global batch's, their gradient summed over the ranks: the outputs, the
    running statistics and the parameters' mean gradients are the one
    process's."""
    layer = _port(jax_vars, train=True)
    rng = np.random.default_rng(7)
    spec = {f"init/{k}": v.numpy() for k, v in layer.state_dict().items()}
    spec.update(dims=np.array([C, HIDDEN, OUT]), x0=_x(8), x1=_x(9),
                g1=rng.standard_normal((4, 10, OUT)).astype(np.float32))
    np.savez(tmp_path / "lastlinear.npz", **spec)
    one = lastlinear(spec, slice(None))
    spawn("lastlinear", str(tmp_path))
    got = [dict(np.load(tmp_path / f"lastlinear.rank{r}.npz")) for r in range(2)]
    for r, res in enumerate(got):
        rows = slice(2 * r, 2 * r + 2)
        for k in ("y0", "y1"):
            np.testing.assert_allclose(res[k], one[k][rows], rtol=TOL, atol=TOL, err_msg=k)
        for k, want in one.items():
            if k.startswith("buf/"):
                np.testing.assert_allclose(res[k], want, rtol=TOL, atol=TOL, err_msg=k)
            elif k.startswith("grad/"):
                # the one process's gradient of the sum over all rows; the
                # ranks' mean of theirs is half of it
                np.testing.assert_allclose(2 * res[k], want, rtol=TOL,
                                           atol=TOL * np.abs(want).max(), err_msg=k)
    assert os.path.exists(tmp_path / "lastlinear.rank1.npz")
