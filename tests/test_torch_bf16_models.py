"""bf16 inference of the port's five generator families against the JAX
package's, on the CPU, and `compute_dtype` through `build_generator`,
`load_generator` and `Synthesizer`.

1. Each family at a narrow width, as `tests/test_torch_{hifigan,melgan,nhv}.py`
   build them: the JAX generator built with `compute_dtype=jnp.bfloat16`
   from its own init, and the port's built with `compute_dtype=torch.bfloat16`
   from the same tree (`state_dict_from_jax`, fused).  The port's waveform is
   held within the JAX package's bf16 gate, max(2e-3, 1 % of the float32
   peak), of JAX's bf16 waveform and of its own float32 waveform; its
   parameters stay float32 and its waveform is float32.  On the CPU the
   port's bf16 path is library convs in bf16 (its module path, as JAX's on
   the CPU is XLA convs in bf16) and the decode's plain bf16 version.  NHV
   takes JAX's own sources.  Measured (port against JAX in bf16; port
   against its float32 output; the bound): Basis-MelGAN (channels 16)
   3.40e-3, 2.18e-3, 4.13e-3; HiFiGAN (32 channels, rates 4, 2) 1.95e-3,
   2.12e-3, 2.85e-3; MultiBand-HiFiGAN 1.68e-3, 1.84e-3, 2.41e-3; MelGAN
   (channels 32 to 8) 1.95e-3, 1.98e-3, 2.05e-3; NHV 2.77e-4, 2.39e-4,
   1.57e-2.  A waveform peaking near 0.2 is 2 bf16 ulps of its binade from
   the gate's 2e-3; the JAX package's own narrow Basis-MelGAN is 4.19e-3
   from its float32 output (1.01 % of its peak).
2. The release checkpoints at full width on a seeded 64-frame mel: trained
   weights cost more than the gate in bf16, in the JAX package too (its
   gate's own test, `tests/test_quality_gate.py`, uses random init), so the
   port's bf16 deviation from its float32 waveform is held to no more than
   the JAX package's from its own.  Measured (peak; gate; JAX; port):
   Basis-MelGAN 3.38, 3.38e-2, 3.40e-2, 2.94e-2; HiFiGAN 0.727, 7.27e-3,
   3.96e-2, 2.58e-2; MultiBand-HiFiGAN 0.774, 7.74e-3, 2.61e-2, 2.43e-2;
   MelGAN 0.732, 7.32e-3, 1.11e-2, 1.04e-2; NHV (JAX's sources) 0.659,
   6.59e-3, 1.27e-2, 1.17e-2 (`ROADMAP.md` C, known numerics).
3. `compute_dtype` reaches every conv; `Synthesizer` in bf16 synthesizes
   what `load_generator(..., compute_dtype=bf16)` computes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvocoder_tpu import hparams as jhp
from fastvocoder_tpu.models import nhv as jnhv
from fastvocoder_tpu.models.factory import build_generator as jax_build_generator
from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.bin.synthesize import Synthesizer
from fastvocoder_tpu_torch.checkpoint import state_dict_from_jax
from fastvocoder_tpu_torch.models.factory import build_generator, load_generator
from fastvocoder_tpu_torch.models.layers import Conv1d, ConvTranspose1d

BF16 = torch.bfloat16
ROOT = os.path.join(os.path.dirname(__file__), "..")
HIFI = dict(resblock_kernel_sizes=(3, 5), upsample_rates=(4, 2), upsample_initial_channel=32,
            upsample_kernel_sizes=(8, 4), resblock_dilation_sizes=((1, 3), (1, 3)))
BASIS = dict(out_channels=16, channels=(16, 16, 16))
MELGAN = dict(channels=(32, 16, 16, 8, 8))
NHV = dict(channels=16, ccep_size=32, fir_taps=17, fft_size=512)
FAMILIES = {
    "basis-melgan": (jhp.BasisMelGANConfig(**BASIS), thp.BasisMelGANConfig(**BASIS)),
    "hifigan": (jhp.HiFiGANConfig(**HIFI), thp.HiFiGANConfig(**HIFI)),
    "multiband-hifigan": (jhp.HiFiGANConfig(**HIFI, out_bands=4),
                          thp.HiFiGANConfig(**HIFI, out_bands=4)),
    "melgan": (jhp.MelGANConfig(**MELGAN), thp.MelGANConfig(**MELGAN)),
    "nhv": (jhp.NHVConfig(**NHV), thp.NHVConfig(**NHV)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs, restored afterwards: the
    same sums on every worker count, and small ops 20x faster than with a
    thread a core in each of pytest-xdist's processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mel(T, seed, B=1):
    rng = np.random.default_rng(seed)
    return np.clip(0.5 + 0.25 * rng.standard_normal((B, T, 80)), 0, 1).astype(np.float32)


def _gate(got, want_bf16, own_f32):
    bound = max(2e-3, 0.01 * float(np.abs(own_f32).max()))
    print(f"port - jax {np.abs(got - want_bf16).max():.3e}, port - float32 "
          f"{np.abs(got - own_f32).max():.3e}, bound {bound:.3e}")
    assert np.isfinite(got).all()
    assert np.abs(got - want_bf16).max() <= bound
    assert np.abs(got - own_f32).max() <= bound


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_narrow_generator_in_bf16_matches_jax_in_bf16(name):
    jarch, tarch = FAMILIES[name]
    jcfg, tcfg = jhp.ModelConfig(name, jarch), thp.ModelConfig(name, tarch)
    x = _mel(12, 1, B=2)
    kw = {}
    if name == "basis-melgan":
        kw["basis_signal_weight"] = (0.1 * np.random.default_rng(2).standard_normal((30, 16))
                                     ).astype(np.float32)
    if name == "nhv":
        f0 = np.random.default_rng(3).uniform(150, 250, (2, 12)).astype(np.float32)
        x = np.concatenate([x, f0[..., None]], axis=-1)
    jf32 = jax_build_generator(jcfg, **kw)
    jbf16 = jax_build_generator(jcfg, compute_dtype=jnp.bfloat16, **kw)
    params = jax.jit(jf32.init)(jax.random.PRNGKey(0), x)["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    method = {"basis-melgan": "inference", "multiband-hifigan": "synthesize"}.get(name)
    if method:
        want = np.asarray(jbf16.apply({"params": params}, x, method=getattr(jbf16, method)))
    else:
        want = np.asarray(jbf16.apply({"params": params}, x))
    call = {}
    if name == "nhv":
        harm = jnhv.impulse_train(jnp.asarray(x[..., 80]), 240, 24000)
        noise = 0.3 * jax.random.normal(jax.random.PRNGKey(0), harm.shape, jnp.float32)
        call["sources"] = (torch.from_numpy(np.array(harm)), torch.from_numpy(np.array(noise)))
    outs = {}
    for dtype in (torch.float32, BF16):
        gen = build_generator(tcfg, compute_dtype=dtype, **kw)
        gen.load_state_dict(state_dict_from_jax(tree))
        with torch.inference_mode():
            fn = gen if name == "nhv" else gen.inference
            outs[dtype] = fn(torch.from_numpy(x), **call)
        assert outs[dtype].dtype == torch.float32
        assert all(p.dtype == torch.float32 for p in gen.parameters())
    assert outs[BF16].shape == want.shape
    _gate(outs[BF16].numpy(), want.astype(np.float32), outs[torch.float32].numpy())


RELEASE = {
    "basis-melgan": ("basis-melgan/light.yaml", "basis_melgan_clean2.npz"),
    "hifigan": ("hifigan/light.yaml", "hifigan_light_clean2.npz"),
    "multiband-hifigan": ("multiband-hifigan/light.yaml", "mb_hifigan_light_clean.npz"),
    "melgan": ("melgan/original.yaml", "melgan_clean.npz"),
    "nhv": ("nhv/default.yaml", "nhv_clean.npz"),
}


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.mark.parametrize("name", sorted(RELEASE))
def test_release_checkpoint_in_bf16_is_as_close_to_float32_as_jax(name):
    """On trained weights bf16 costs more than the gate, in the JAX package
    too: its bf16 waveform is further than max(2e-3, 1 % of the peak) from
    its float32 one (the gate's own test uses random init).  The port's bf16
    waveform is held to no more than the JAX package's bf16 deviation from
    float32, on the same release weights and seeded 64-frame mel."""
    from fastvocoder_tpu.hparams import load_model_config as jax_load_config
    from fastvocoder_tpu.train.checkpoint import fuse_weight_norm

    conf, npz = (os.path.join(ROOT, "conf", RELEASE[name][0]),
                 os.path.join(ROOT, "docs", "checkpoints", RELEASE[name][1]))
    mel = _mel(64, 0)
    with np.load(npz) as z:
        params = _unflatten({k[len("param:"):]: z[k].astype(np.float32)
                             for k in z.files if k.startswith("param:")})
    call = {}
    if name == "nhv":  # a 220 Hz f0 and JAX's own sources; no weight norm to fuse
        mel = np.concatenate([mel, np.full((1, 64, 1), 220.0, np.float32)], axis=-1)
        harm = jnhv.impulse_train(jnp.asarray(mel[..., 80]), 240, 24000)
        noise = 0.3 * jax.random.normal(jax.random.PRNGKey(0), harm.shape, jnp.float32)
        call["sources"] = (torch.from_numpy(np.array(harm)), torch.from_numpy(np.array(noise)))
    else:
        params = fuse_weight_norm(params)
    jax_out, port_out = {}, {}
    for jdt, tdt in ((None, None), (jnp.bfloat16, BF16)):
        wn = {} if name == "nhv" else {"weight_norm": False}
        g = jax_build_generator(jax_load_config(name, conf), compute_dtype=jdt, **wn)
        method = {"basis-melgan": "inference", "multiband-hifigan": "synthesize"}.get(name)
        kw = {"method": getattr(g, method)} if method else {}
        jax_out[tdt] = np.asarray(jax.jit(lambda p, m: g.apply({"params": p}, m, **kw))(params, mel),
                                  np.float32)
        gen, _ = load_generator(npz, thp.load_model_config(name, conf), torch.device("cpu"),
                                compute_dtype=tdt)
        with torch.inference_mode():
            port_out[tdt] = (gen if call else gen.inference)(torch.from_numpy(mel), **call).numpy()
    jax_dev = np.abs(jax_out[BF16] - jax_out[None]).max()
    port_dev = np.abs(port_out[BF16] - port_out[None]).max()
    peak = np.abs(jax_out[None]).max()
    print(f"{name}: peak {peak:.3g}, gate {max(2e-3, 0.01 * peak):.3e}, bf16 from float32: "
          f"jax {jax_dev:.3e}, port {port_dev:.3e}; port - jax in bf16 "
          f"{np.abs(port_out[BF16] - jax_out[BF16]).max():.3e}")
    assert np.isfinite(port_out[BF16]).all()
    assert port_dev <= jax_dev


def test_compute_dtype_reaches_every_conv():
    """`build_generator(..., compute_dtype=bf16)` hands it to every conv of
    the trunk, which casts to it on the call; float32 builds none."""
    tcfg = thp.ModelConfig("hifigan", thp.HiFiGANConfig(**HIFI))
    gen = build_generator(tcfg, compute_dtype=BF16)
    convs = [m for m in gen.modules() if isinstance(m, (Conv1d, ConvTranspose1d))]
    assert convs and all(m.compute_dtype == BF16 for m in convs)
    assert all(m.compute_dtype is None
               for m in build_generator(tcfg, compute_dtype=torch.float32).modules()
               if isinstance(m, (Conv1d, ConvTranspose1d)))
    with torch.inference_mode():
        assert convs[0](torch.zeros(1, 5, 80)).dtype == BF16
    with pytest.raises(ValueError, match="compute_dtype"):
        build_generator(tcfg, compute_dtype=torch.float16)


def test_synthesizer_in_bf16_on_the_release_checkpoint():
    """`Synthesizer(compute_dtype=bf16)` on `basis_melgan_clean2.npz` at
    full width synthesizes what `load_generator(..., compute_dtype=bf16)`
    computes, bit for bit, which is not the float32 waveform; the loaded
    parameters stay float32 and the waveform is float32."""
    npz = os.path.join(ROOT, "docs", "checkpoints", "basis_melgan_clean2.npz")
    conf = os.path.join(ROOT, "conf", "basis-melgan", "light.yaml")
    mel = _mel(24, 5)[0]
    bf16 = Synthesizer(npz, conf, "basis-melgan", device="cpu", compute_dtype=BF16)
    est, est_remove, bias = bf16.synthesize(mel)
    assert est.dtype == np.float32 and np.isfinite(est).all()
    np.testing.assert_array_equal(est - bias, est_remove)
    assert all(p.dtype == torch.float32 for p in bf16.generator.parameters())
    gen, _ = load_generator(npz, thp.load_model_config("basis-melgan", conf), torch.device("cpu"),
                            compute_dtype=BF16)
    assert gen.conv_pre.compute_dtype == BF16 and not gen.conv_pre.weight.requires_grad
    with torch.inference_mode():
        want = gen.inference(torch.from_numpy(mel[None]))[0].numpy()
    np.testing.assert_array_equal(est, want)
    f32 = Synthesizer(npz, conf, "basis-melgan", device="cpu")._run(mel)
    assert f32.shape == est.shape and np.abs(f32 - est).max() > 0
