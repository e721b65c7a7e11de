"""The port's discriminators (`fastvocoder_tpu_torch/models/discriminator/`)
against the JAX package's, on the CPU: every feature map of the MSD, the
MFD, the MPD and the composite (with and without the MPD), with weights
initialised on the JAX side and carried across by
`state_dict_from_jax(..., fuse=False)` (weight-norm gains kept; the MPD's
2-D kernels (kh, kw, Cin, Cout) become (Cout, Cin, kh, kw)).

Tolerance: 2e-5 of each feature map's peak at the tiny sizes and 1e-4 at
the reference's full widths (float32 sums of up to 41 x 256 products per
output, in different orders; the MFD's input passes through an FFT).  The
MPD, measured: 5.0e-7 of a map's peak at `TINY_DISC` (channels 4, 8, 8, 8)
and 2.8e-6 at the reference's (32, 128, 512, 1024), lengths that are a
multiple of no period but 7 (2401) or of none (4801), so that the reflect
pad runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvocoder_tpu import hparams as jhp
from fastvocoder_tpu.models.discriminator.mfd import (
    MultiResolutionSTFTDiscriminator as JaxMFD,
)
from fastvocoder_tpu.models.discriminator.mpd import MultiPeriodDiscriminator as JaxMPD
from fastvocoder_tpu.models.discriminator.msd import MelGANMultiScaleDiscriminator as JaxMSD
from fastvocoder_tpu.models.factory import build_discriminator as jax_build_discriminator
from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.checkpoint import state_dict_from_jax
from fastvocoder_tpu_torch.models.discriminator import (
    MelGANMultiScaleDiscriminator,
    MultiPeriodDiscriminator,
    MultiResolutionSTFTDiscriminator,
)
from fastvocoder_tpu_torch.models.factory import build_discriminator
from fastvocoder_tpu_torch.ops.conv import avg_pool1d


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs, restored afterwards:
    pytest-xdist runs several test processes side by side, and torch's
    default of a thread a core in each made these small-op tests over 20x
    slower (six processes on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wav(B, T, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T, dtype=np.float32)
    wav = np.stack([0.3 * np.sin(2 * np.pi * 180 * (i + 1) * t / 24000) for i in range(B)])
    return (wav + 0.05 * rng.standard_normal(wav.shape)).astype(np.float32)


def _carry(jmodule, tmodule, x):
    params = jax.jit(jmodule.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tmodule.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                                fuse=False))
    return params


def _assert_features(got, want, tol):
    assert len(got) == len(want)
    for i, (gs, ws) in enumerate(zip(got, want)):
        assert len(gs) == len(ws)
        for j, (g, w) in enumerate(zip(gs, ws)):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape, (i, j)
            err = np.abs(g.detach().numpy() - w).max()
            assert err <= tol * np.abs(w).max(), f"scale {i} layer {j}: {err:.3e}"


def test_msd_matches_jax_at_tiny_sizes():
    c = jhp.TINY_DISC
    x = _wav(2, 2400)[..., None]
    kw = dict(scales=c.msd_scales, channels=c.msd_channels,
              max_downsample_channels=c.msd_max_channels,
              downsample_scales=c.msd_downsample_scales)
    jm, tm = JaxMSD(**kw), MelGANMultiScaleDiscriminator(**kw)
    params = _carry(jm, tm, x)
    _assert_features(tm(torch.from_numpy(x)), jm.apply({"params": params}, jnp.asarray(x)), 2e-5)


def test_mfd_matches_jax_at_tiny_sizes():
    c = jhp.TINY_DISC
    x = _wav(2, 2400)
    kw = dict(fft_sizes=c.mfd_fft_sizes, hop_sizes=c.mfd_hop_sizes,
              win_lengths=c.mfd_win_lengths, channels=c.mfd_channels,
              max_downsample_channels=c.mfd_max_channels,
              downsample_scales=c.mfd_downsample_scales)
    jm, tm = JaxMFD(**kw), MultiResolutionSTFTDiscriminator(**kw)
    params = _carry(jm, tm, x)
    _assert_features(tm(torch.from_numpy(x)), jm.apply({"params": params}, jnp.asarray(x)), 2e-5)


@pytest.mark.parametrize("size,T,tol", [("tiny", 2400, 2e-5), ("full", 4800, 1e-4)])
def test_composite_matches_jax(size, T, tol):
    jcfg, tcfg = ((jhp.TINY_DISC, thp.TINY_DISC) if size == "tiny" else (jhp.DISC, thp.DISC))
    x = _wav(1 if size == "full" else 2, T)
    jm, tm = jax_build_discriminator(disc_cfg=jcfg), build_discriminator(tcfg)
    params = _carry(jm, tm, x)
    got = tm(torch.from_numpy(x))
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x))
    assert len(got) == jcfg.msd_scales + len(jcfg.mfd_fft_sizes)
    _assert_features(got, want, tol)


@pytest.mark.parametrize("size,T,tol", [("tiny", 2401, 2e-5), ("full", 4801, 1e-4)])
def test_mpd_matches_jax(size, T, tol):
    c = jhp.TINY_DISC if size == "tiny" else jhp.DISC
    x = _wav(2 if size == "tiny" else 1, T)[..., None]
    kw = dict(periods=c.mpd_periods, channels=c.mpd_channels)
    jm, tm = JaxMPD(**kw), MultiPeriodDiscriminator(**kw)
    params = _carry(jm, tm, x)
    assert tm.disc_0.conv_0.weight.shape == (c.mpd_channels[0], 1, 5, 1)
    got = tm(torch.from_numpy(x))
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x))
    assert [len(f) for f in got] == [7] * 5  # 5 activations, conv_post's map, the score
    _assert_features(got, want, tol)
    for p, feats in zip(c.mpd_periods, got):
        assert feats[-1].shape[1] == feats[-2].shape[1] * p  # the score, flattened


@pytest.mark.parametrize("size,T,tol", [("tiny", 2401, 2e-5), ("full", 4801, 1e-4)])
def test_composite_with_mpd_matches_jax(size, T, tol):
    jcfg, tcfg = ((jhp.TINY_DISC, thp.TINY_DISC) if size == "tiny" else (jhp.DISC, thp.DISC))
    x = _wav(1, T)
    jm = jax_build_discriminator(use_mpd=True, disc_cfg=jcfg)
    tm = build_discriminator(tcfg, use_mpd=True)
    params = _carry(jm, tm, x)
    got = tm(torch.from_numpy(x))
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x))
    assert len(got) == jcfg.msd_scales + len(jcfg.mfd_fft_sizes) + len(jcfg.mpd_periods)
    _assert_features(got, want, tol)


def test_discriminator_configs_are_the_jax_packages():
    import dataclasses

    assert dataclasses.asdict(thp.DISC) == dataclasses.asdict(jhp.DISC)
    assert dataclasses.asdict(thp.TINY_DISC) == dataclasses.asdict(jhp.TINY_DISC)


def test_gains_start_at_the_weight_norms_and_carry_gradients():
    torch.manual_seed(0)
    disc = build_discriminator(thp.TINY_DISC)
    conv = disc.msd.discs[0].downs[0]
    norm = conv.weight.detach().pow(2).sum(dim=(1, 2)).sqrt()
    torch.testing.assert_close(conv.g.detach(), norm)
    torch.testing.assert_close(conv.effective_weight(), conv.weight)
    sum(f[-1].sum() for f in disc(torch.from_numpy(_wav(1, 2400)))).backward()
    assert all(p.grad is not None for p in disc.parameters())


def test_avg_pool_leaves_the_padding_out_of_the_count():
    x = torch.arange(1.0, 9.0).reshape(1, 8, 1)
    got = avg_pool1d(x, 4, 2, 1, count_include_pad=False)[0, :, 0]
    torch.testing.assert_close(got, torch.tensor([2.0, 3.5, 5.5, 7.0]))


def test_mpd_waits():
    """The MPD no longer waits: `use_mpd` in the configuration or as an
    argument appends its five periods' outputs after the MSD's and MFD's."""
    plain = build_discriminator(thp.TINY_DISC)
    for disc in (build_discriminator(thp.TINY_DISC, use_mpd=True),
                 build_discriminator(dataclasses.replace(thp.TINY_DISC, use_mpd=True))):
        assert plain.mpd is None and len(disc.mpd.discs) == 5
        outs = disc(torch.from_numpy(_wav(1, 2400)))
        assert len(outs) == len(plain(torch.from_numpy(_wav(1, 2400)))) + 5
