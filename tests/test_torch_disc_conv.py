"""The discriminators' grouped strided conv (`ops/grouped_conv.py`, kernel
7) on the CPU: its plain channels-last versions against `F.conv1d` and
against the JAX package's grouped conv, the autograd Function's gradients
numerically, and which convs `ops/conv.py::conv1d` sends to the kernels.

Geometries: every downsample layer of the default discriminators, the MSD's
four (K = 41, padding 20: 16 -> 64, 64 -> 256, 256 -> 1024 with 16 outputs
a group, 1024 -> 1024 with 4) and the MFD's two (K = 25, padding 12), all at
stride 4 with 4 input channels a group, at tiny batches and lengths: a
multiple of the stride, one that is not, and one shorter than K.

Tolerances: float64 against float64 (`F.conv1d`, another summation order:
1e-12 of the peak); float32 against the JAX package's XLA conv, sums of up
to 4 K = 164 products a forward or input-gradient element and of B T_out
rows a weight-gradient element, in other orders: 1e-5 of each result's
peak.  The card's tests of the kernels are in `test_torch_kernels_cuda.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastvocoder_tpu.ops.conv import conv1d as jax_conv1d
from fastvocoder_tpu_torch.bin.kernel_times import disc_layers
from fastvocoder_tpu_torch.models.layers import Conv1d
from fastvocoder_tpu_torch.ops import _build, grouped_conv as gc
from fastvocoder_tpu_torch.ops import conv as conv_ops

# (cin, cout, K, padding) of the MSD's and the MFD's downsample convs, stride 4
GEOMETRIES = [(16, 64, 41, 20), (64, 256, 41, 20), (256, 1024, 41, 20), (1024, 1024, 41, 20),
              (64, 256, 25, 12), (256, 1024, 25, 12)]
LENGTHS = [(2, 48), (1, 37), (3, 9)]  # a multiple of the stride, one that is not, one under K
STRIDE = 4


def _inputs(cin, cout, K, B, T, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, cin))
    w = rng.standard_normal((cout, 4, K)) / np.sqrt(4 * K)
    b = 0.1 * rng.standard_normal(cout)
    T_out = gc.out_length(T, K, STRIDE, (K - 1) // 2)
    dy = rng.standard_normal((B, T_out, cout))
    return [torch.tensor(a, dtype=dtype) for a in (x, w, b, dy)]


def _peak_close(got, want, rel):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("B,T", LENGTHS)
@pytest.mark.parametrize("cin,cout,K,padding", GEOMETRIES)
def test_plain_matches_torch_conv1d(cin, cout, K, padding, B, T):
    x, w, b, dy = _inputs(cin, cout, K, B, T, seed=cin + K + T)
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    ref = F.conv1d(xr.transpose(1, 2), wr, br, stride=STRIDE, padding=padding,
                   groups=cin // 4).transpose(1, 2)
    dx_ref, dw_ref, db_ref = torch.autograd.grad(ref, (xr, wr, br), dy)
    _peak_close(gc.grouped_conv1d_plain(x, w, b, STRIDE, padding), ref.detach(), 1e-12)
    _peak_close(gc.grouped_conv1d_dx_plain(dy, w, x.shape, STRIDE, padding), dx_ref, 1e-12)
    dw, db = gc.grouped_conv1d_dw_plain(x, dy, K, STRIDE, padding)
    _peak_close(dw, dw_ref, 1e-12)
    _peak_close(db, db_ref, 1e-12)


@pytest.mark.parametrize("B,T", LENGTHS)
@pytest.mark.parametrize("cin,cout,K,padding", GEOMETRIES)
def test_plain_matches_the_jax_grouped_conv(cin, cout, K, padding, B, T):
    x, w, b, dy = (t.numpy() for t in _inputs(cin, cout, K, B, T, seed=cin * K + T,
                                              dtype=torch.float32))

    def jax_fn(x, kernel, bias):
        return jax_conv1d(x, kernel, bias, stride=STRIDE, padding=padding, groups=cin // 4)

    y_ref, vjp = jax.vjp(jax_fn, jnp.asarray(x), jnp.asarray(w.transpose(2, 1, 0)),
                         jnp.asarray(b))
    dx_ref, dk_ref, db_ref = (torch.from_numpy(np.array(a)) for a in vjp(jnp.asarray(dy)))
    xt, wt, bt, dyt = (torch.from_numpy(a) for a in (x, w, b, dy))
    _peak_close(gc.grouped_conv1d_plain(xt, wt, bt, STRIDE, padding),
                torch.from_numpy(np.array(y_ref)), 1e-5)
    _peak_close(gc.grouped_conv1d_dx_plain(dyt, wt, xt.shape, STRIDE, padding), dx_ref, 1e-5)
    dw, db = gc.grouped_conv1d_dw_plain(xt, dyt, K, STRIDE, padding)
    _peak_close(dw, dk_ref.permute(2, 1, 0), 1e-5)
    _peak_close(db, db_ref, 1e-5)


# (B, T, groups, outputs a group, K, padding): both discriminators' tap
# counts at narrow widths, and a short K at 8 outputs a group (the plain
# versions take any width)
GRADCHECK_CASES = [(1, 13, 2, 4, 41, 20), (2, 11, 2, 16, 25, 12), (1, 10, 3, 8, 9, 4)]


@pytest.mark.parametrize("B,T,G,N,K,padding", GRADCHECK_CASES)
def test_function_gradients_are_numerical(B, T, G, N, K, padding):
    rng = np.random.default_rng(K + N)
    args = [torch.tensor(rng.standard_normal(s), requires_grad=True)
            for s in ((B, T, 4 * G), (N * G, 4, K), (N * G,))]
    assert torch.autograd.gradcheck(
        lambda x, w, b: gc.grouped_conv1d(x, w, b, STRIDE, padding), args)


def _counting(monkeypatch, name):
    calls = []
    real = getattr(gc, name)

    def counted(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(gc, name, counted)
    return calls


@pytest.mark.parametrize("remat", [False, True])
def test_backward_computes_only_the_gradients_asked_for(monkeypatch, remat):
    """The Function's backward computes the gradients of the inputs that
    require one: with the conv's parameters frozen (as the trainer freezes
    the discriminator's for the generator's update) the input gradient
    alone; with them trained, the weight and bias gradients too.  The same
    under `torch.utils.checkpoint` (`--remat` recomputes `disc`)."""
    dx_calls = _counting(monkeypatch, "grouped_conv1d_dx_plain")
    dw_calls = _counting(monkeypatch, "grouped_conv1d_dw_plain")
    conv = Conv1d(8, 32, 9, stride=4, padding=4, groups=2, weight_norm=True)
    upstream = torch.randn(2, 40, 8, requires_grad=True)

    def run(x):
        return gc.grouped_conv1d(x, conv.effective_weight(), conv.bias, 4, 4)

    def output():
        h = upstream * 1.5
        if remat:
            return torch.utils.checkpoint.checkpoint(run, h, use_reentrant=False)
        return run(h)

    conv.requires_grad_(False)
    torch.autograd.grad(output().square().sum(), [upstream])
    assert (len(dx_calls), len(dw_calls)) == (1, 0)
    conv.requires_grad_(True)
    grads = torch.autograd.grad(output().square().sum(), list(conv.parameters()))
    assert (len(dx_calls), len(dw_calls)) == (2, 1)
    assert all(torch.isfinite(g).all() for g in grads)
    output().square().sum().backward()
    assert (len(dx_calls), len(dw_calls)) == (3, 2)
    with torch.no_grad():
        assert not output().requires_grad


@pytest.mark.parametrize("remat", [False, True])
def test_gan_step_computes_no_discriminator_weight_gradient_for_the_generator(monkeypatch,
                                                                                remat):
    """A `gan_step` with the grouped layers of 4 inputs and 16 outputs a
    group sent to the Function on the CPU: each runs forward 4 times (5
    with remat), back to its input 3 times and to its weights twice, in the
    discriminator's update alone, since the trainer freezes the
    discriminator's parameters for the generator's; they require a gradient
    again after the step."""
    from fastvocoder_tpu_torch import hparams as thp
    from fastvocoder_tpu_torch.train import trainer as ttrainer

    monkeypatch.setattr(conv_ops, "kernel_takes",
                        lambda device_type, *geometry: gc.kernel_takes("cuda", *geometry))
    y_calls = _counting(monkeypatch, "grouped_conv1d_plain")
    dx_calls = _counting(monkeypatch, "grouped_conv1d_dx_plain")
    dw_calls = _counting(monkeypatch, "grouped_conv1d_dw_plain")
    frames = 10
    cfg = thp.ModelConfig("hifigan", thp.HiFiGANConfig(
        resblock_kernel_sizes=(3,), upsample_rates=(8, 5, 3, 2), upsample_initial_channel=16,
        upsample_kernel_sizes=(16, 10, 6, 4), resblock_dilation_sizes=((1,),)), lambda_stft=5.0)
    tr = ttrainer.make_trainer(cfg, hp=thp.HP.replace(fixed_length=frames),
                               disc_cfg=thp.TINY_DISC, device="cpu", remat=remat)
    state = tr.init_state(0)
    rng = np.random.default_rng(3)
    mel = torch.from_numpy(rng.standard_normal((2, frames, 80)).astype(np.float32))
    wav = torch.from_numpy((0.1 * rng.standard_normal((2, frames * 240))).astype(np.float32))
    tr.gan_step(state, mel, wav)
    layers = len(y_calls) // (5 if remat else 4)
    assert layers >= 1 and len(y_calls) == (5 if remat else 4) * layers
    assert (len(dx_calls), len(dw_calls)) == (3 * layers, 2 * layers)
    assert all(p.requires_grad for p in state.discriminator.parameters())


@pytest.mark.parametrize("name,x_shape,w_shape,stride,padding", disc_layers(torch, B=1, samples=4800))
def test_the_kernels_take_every_downsample_layer_of_the_discriminators(name, x_shape, w_shape,
                                                                       stride, padding):
    cin, (cout, per, K) = x_shape[2], w_shape
    assert per == 4 and cin // 4 > 1, name
    assert gc.kernel_takes("cuda", torch.float32, cin, cout, cin // 4, K, stride, 1, padding,
                           padding), name
    assert not gc.kernel_takes("cuda", torch.bfloat16, cin, cout, cin // 4, K, stride, 1, padding,
                               padding), name
    assert not gc.kernel_takes("cpu", torch.float32, cin, cout, cin // 4, K, stride, 1, padding,
                               padding), name


@pytest.mark.parametrize("cin,cout,groups,K,stride,dilation,left,right", [
    (16, 64, 1, 41, 4, 1, 20, 20),  # one group
    (32, 64, 4, 41, 4, 1, 20, 20),  # 8 input channels a group
    (16, 64, 4, 41, 4, 2, 20, 20),  # dilated
    (16, 64, 4, 41, 4, 1, 20, 19),  # asymmetric padding
    (16, 128, 4, 41, 4, 1, 20, 20),  # 32 outputs a group
    (16, 8, 4, 41, 4, 1, 20, 20),  # 2 outputs a group
    (16, 32, 4, 41, 4, 1, 20, 20),  # 8 outputs a group
])
def test_other_convs_keep_their_path(cin, cout, groups, K, stride, dilation, left, right):
    assert not gc.kernel_takes("cuda", torch.float32, cin, cout, groups, K, stride, dilation,
                               left, right)


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_a_grouped_conv_on_the_cpu_keeps_torch_conv1d(monkeypatch, compute_dtype):
    """On the CPU, in float32 and in bf16 (`--mixprecision`), a grouped
    `Conv1d` runs `F.conv1d` as before: the op is never called and no
    kernel launch is counted."""

    def refuse(*args, **kwargs):
        raise AssertionError("the grouped-conv op was called")

    monkeypatch.setattr(conv_ops, "grouped_conv1d", refuse)
    conv = Conv1d(16, 64, 41, stride=4, padding=20, groups=4, weight_norm=True,
                  compute_dtype=compute_dtype)
    x = torch.randn(2, 48, 16)
    before = dict(_build.launch_counts)
    y = conv(x)
    want = F.conv1d(x.to(y.dtype).transpose(1, 2), conv.effective_weight().to(y.dtype),
                    conv.bias.to(y.dtype), stride=4, padding=20, groups=4).transpose(1, 2)
    assert y.shape == (2, 12, 64) and y.dtype == (compute_dtype or torch.float32)
    assert torch.equal(y, want)
    assert dict(_build.launch_counts) == before


def test_the_cuda_wrappers_refuse_a_cpu_tensor():
    x, w, b, dy = _inputs(16, 64, 41, 1, 48, 0, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        gc.grouped_conv1d_cuda(x, w, b, STRIDE, 20)
    with pytest.raises(ValueError, match="CUDA"):
        gc.grouped_conv1d_dx_cuda(dy, w, x.shape, STRIDE, 20)
    with pytest.raises(ValueError, match="CUDA"):
        gc.grouped_conv1d_dw_cuda(x, dy, 41, STRIDE, 20)
