"""The port's NHV (`models/nhv.py`), its f0 conditioning (`dsp/f0.py`) and
overlap-add (`ops/overlap_add.py`) against the JAX package's, on the CPU,
and NHV's entry points with `device="cpu"`.

1. `extract_f0` and `f0_to_condition`: bit-equal to the JAX package's
   numpy functions.
2. `overlap_and_add`: the cases of `tests/test_overlap_add.py`, against a
   numpy loop and the JAX function, within 1e-5 (measured 4.8e-7).
3. `impulse_train`, against JAX's float32 train, by the rule the port
   keeps: the same number of impulses; every JAX impulse has one of the
   port's within one sample; where a position differs, JAX's float32
   phase at it (or the sample before) lies within its own rounding of an
   integer (its distance from the port's exact phase); the count of moved
   impulses is printed.  The port's phase is exact, so no order of
   summation moves its impulses (`tests/test_torch_kernels_cuda.py` holds
   the card's train equal to the CPU's).
4. `FilterEstimator` and the LTV filter on the same inputs, within 1e-5 of
   the peak (measured 3.2e-7 and 3.0e-7 of it).
5. Whole generators with JAX's own sources passed in (its impulse train and
   `0.3 * normal(PRNGKey(0))`), so that the filter path is held exactly:
   a narrow generator in the weight-norm form with a trained-looking FIR,
   within 1e-5 of the peak (measured 2.5e-7 fused, 2.9e-7 with the gains
   kept), and
   `docs/checkpoints/nhv_clean.npz` (step 12000) at full width on a
   seeded 64-frame mel with a 220 Hz f0, within 1e-4 of the peak
   (measured 5.0e-6 of it, 3.3e-6 at a peak of 0.66).  Moved impulses
   (printed): none at 64 frames; 48 of 2574 at 585 frames and 220 Hz, 14
   of 1853 with the random contour (both over a batch of 2).
6. The entry points: an 80-channel mel without f0 is refused, `synthesize`
   with `f0=` equals `synthesize` of the packed tensor, the RTF protocol
   reads `<name>.mel.npy` with its `<name>.f0.npy` and packed files, and
   `ServingModel` serves (T, 81) requests.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvocoder_tpu import hparams as jhp
from fastvocoder_tpu.dsp import f0 as jf0
from fastvocoder_tpu.models import nhv as jnhv
from fastvocoder_tpu.models.factory import build_generator as jax_build_generator
from fastvocoder_tpu.ops.overlap_add import overlap_and_add as jax_overlap_and_add
from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.bin.synthesize import Synthesizer
from fastvocoder_tpu_torch.bin.test import run_test
from fastvocoder_tpu_torch.checkpoint import load_release_npz, state_dict_from_jax
from fastvocoder_tpu_torch.dsp.f0 import extract_f0, f0_to_condition
from fastvocoder_tpu_torch.models import nhv
from fastvocoder_tpu_torch.models.factory import build_generator
from fastvocoder_tpu_torch.ops.overlap_add import overlap_and_add
from fastvocoder_tpu_torch.serving import ServingModel

ROOT = os.path.join(os.path.dirname(__file__), "..")
NHV = (os.path.join(ROOT, "docs", "checkpoints", "nhv_clean.npz"),
       os.path.join(ROOT, "conf", "nhv", "default.yaml"), "nhv")
TINY = dict(channels=16, ccep_size=32, fir_taps=17, fft_size=512)
HOP, SR = 240, 24000


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


def _mel(T, seed, B=1):
    rng = np.random.default_rng(seed)
    return np.clip(0.5 + 0.25 * rng.standard_normal((B, T, 80)), 0, 1).astype(np.float32)


def _f0(kind, T, B=1, seed=0):
    """(B, T) f0: "constant" 220 Hz (bench.py's contour), or "random"
    150-250 Hz with 20 % of the frames unvoiced."""
    if kind == "constant":
        return np.full((B, T), 220.0, np.float32)
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(150.0, 250.0, (B, T)).astype(np.float32)
    f0[rng.random((B, T)) < 0.2] = 0.0
    return f0


def _cond(T, seed, f0_kind="constant", B=1):
    f0 = _f0(f0_kind, T, B, seed)
    return np.concatenate([_mel(T, seed, B), f0[..., None]], axis=-1)


def _jax_sources(cond):
    """JAX's own inference sources for `cond`."""
    harm = jnhv.impulse_train(jnp.asarray(cond[..., 80]), HOP, SR)
    noise = 0.3 * jax.random.normal(jax.random.PRNGKey(0), harm.shape, jnp.float32)
    return torch.from_numpy(np.array(harm)), torch.from_numpy(np.array(noise))


def _close(got, want, rel):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"max abs {err:.3e}, peak {np.abs(want).max():.3e}"


# ---- 1. f0 ----

def test_extract_f0_is_the_jax_packages():
    sr = 24000
    t = np.arange(sr) / sr
    rng = np.random.default_rng(3)
    wavs = [0.5 * np.sin(2 * np.pi * hz * t).astype(np.float32) for hz in (110.0, 220.0, 330.5)]
    wavs += [np.zeros(6000, np.float32), rng.standard_normal(12000).astype(np.float32),
             (0.3 * np.sin(2 * np.pi * 180 * t[:9000]) + 0.05 * rng.standard_normal(9000))
             .astype(np.float32)]
    for wav in wavs:
        got, want = extract_f0(wav), jf0.extract_f0(wav)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    mid = extract_f0(wavs[1])[10:-10]
    assert np.abs(mid - 220.0).max() < 220.0 * 0.03  # a pure tone's pitch


def test_f0_to_condition_is_the_jax_packages():
    mel, f0 = _mel(30, 1)[0], _f0("random", 27)[0]
    got, want = f0_to_condition(mel, f0), jf0.f0_to_condition(mel, f0)
    assert got.shape == (27, 81)
    np.testing.assert_array_equal(got, want)


# ---- 2. overlap-add ----

def _np_overlap_add(signal, step):
    *outer, frames, L = signal.shape
    out = np.zeros((*outer, (frames - 1) * step + L), dtype=signal.dtype)
    for i in range(frames):
        out[..., i * step: i * step + L] += signal[..., i, :]
    return out


@pytest.mark.parametrize(
    "frames,L,step",
    [(10, 30, 15), (7, 30, 15), (5, 64, 32), (6, 30, 10), (4, 12, 9), (3, 8, 8), (9, 20, 6)],
)
def test_overlap_add_matches_numpy_and_jax(frames, L, step):
    x = np.random.default_rng(frames * L + step).standard_normal((2, frames, L)).astype(np.float32)
    got = overlap_and_add(torch.from_numpy(x), step).numpy()
    ref = _np_overlap_add(x, step)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_overlap_and_add(jnp.asarray(x), step)),
                               rtol=1e-5, atol=1e-5)


def test_overlap_add_refuses_a_step_beyond_the_frame():
    with pytest.raises(ValueError, match="frame_step"):
        overlap_and_add(torch.zeros(1, 3, 4), 5)


# ---- 3. the impulse train ----

def _jax_phase(f0):
    """JAX's float32 phase, written out as `models/nhv.py::impulse_train`
    computes it."""
    B, T = f0.shape
    pos = jnp.arange(T * HOP) / HOP
    i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, T - 1)
    i1 = jnp.clip(i0 + 1, 0, T - 1)
    frac = pos - i0
    f0 = jnp.asarray(f0)
    return np.asarray(jnp.cumsum((f0[:, i0] * (1.0 - frac) + f0[:, i1] * frac) / SR, axis=1))


def _exact_phase(f0):
    """The phase the port's integers stand for, in float64."""
    q = np.round(f0.astype(np.float64) * nhv.F0_SCALE).astype(np.int64)
    B, T = f0.shape
    nxt = np.minimum(np.arange(T) + 1, T - 1)
    j = 2 * np.arange(HOP)
    inc = q[:, :, None] * (2 * HOP - j) + q[:, nxt, None] * j
    return np.cumsum(inc.reshape(B, -1), axis=1) / float(2 * HOP * SR * nhv.F0_SCALE)


@pytest.mark.parametrize("kind,T", [("constant", 64), ("constant", 585), ("random", 64),
                                    ("random", 585)])
def test_impulse_train_keeps_the_rule_against_jax(kind, T):
    f0 = _f0(kind, T, B=2, seed=T)
    want = np.asarray(jnhv.impulse_train(jnp.asarray(f0), HOP, SR))
    got = nhv.impulse_train(torch.from_numpy(f0), HOP, SR).numpy()
    assert got.shape == want.shape == (2, T * HOP) and got.dtype == np.float32
    pj, pe = _jax_phase(f0), _exact_phase(f0)
    fired = np.concatenate([np.floor(pj[:, :1]) > 0, np.diff(np.floor(pj), axis=1) > 0], axis=1)
    np.testing.assert_array_equal(fired, want > 0)  # the phase written out is JAX's
    moved = 0
    for b in range(2):
        jpos, tpos = np.flatnonzero(want[b]), np.flatnonzero(got[b])
        assert len(jpos) == len(tpos)
        assert np.abs(jpos - tpos).max(initial=0) <= 1
        moved += int((jpos != tpos).sum())
        # a position differs only where JAX's phase lies within its float32
        # rounding (its distance from the exact phase) of an integer
        dist = np.abs(pj[b] - np.round(pj[b]))
        near = dist <= np.abs(pj[b] - pe[b])
        for n in np.flatnonzero(want[b] != got[b]):
            assert near[n] or (n > 0 and near[n - 1]), (b, n)
    print(f"impulse_train {kind} f0, {T} frames x 2: {int((want > 0).sum())} impulses, "
          f"{moved} moved by one sample; JAX's float32 phase off the exact one by up to "
          f"{np.abs(pj - pe).max():.2e}")


def test_impulse_train_of_silence_is_empty_and_the_phase_exact():
    assert nhv.impulse_train(torch.zeros(2, 9), HOP, SR).sum() == 0
    # a 200 Hz contour fires every 120 samples exactly, from sample 119
    # (phase 1 after 120 samples of 1/120)
    imp = nhv.impulse_train(torch.full((1, 40), 200.0), HOP, SR)[0].numpy()
    np.testing.assert_array_equal(np.flatnonzero(imp), np.arange(119, 40 * HOP, 120))


# ---- 4. filter estimator and LTV filter ----

def test_filter_estimator_and_ltv_filter_match_jax():
    mel = _mel(12, 4, B=2)
    jfe = jnhv.FilterEstimator(channels=16, n_layers=3, kernel_size=3, ccep_size=32)
    params = jax.jit(jfe.init)(jax.random.PRNGKey(2), mel)["params"]
    tfe = nhv.FilterEstimator(80, channels=16, n_layers=3, kernel_size=3, ccep_size=32,
                              weight_norm=True)
    tfe.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                            fuse=False))
    want = np.asarray(jfe.apply({"params": params}, mel))
    with torch.no_grad():
        got = tfe(torch.from_numpy(mel)).numpy()
    _close(got, want, 1e-5)

    rng = np.random.default_rng(5)
    src = rng.standard_normal((2, 12 * HOP)).astype(np.float32)
    ccep = (0.3 * rng.standard_normal((2, 12, 32))).astype(np.float32)
    ccep[0, 3, 0] = 12.0  # a log-gain past the clamp at 8
    jgen = jnhv.NHVGenerator(cfg=jhp.NHVConfig(**TINY))
    want = np.asarray(jgen.apply({}, jnp.asarray(src), jnp.asarray(ccep),
                                 method=jnhv.NHVGenerator._ltv_filter))
    got = nhv.ltv_filter(torch.from_numpy(src), torch.from_numpy(ccep), HOP, 480, 512).numpy()
    assert got.shape == (2, 12 * HOP)
    _close(got, want, 1e-5)


# ---- 5. whole generators with JAX's sources ----

def test_narrow_generator_matches_jax_with_its_sources():
    cond = _cond(12, 6, "random", B=2)
    jgen = jax_build_generator(jhp.ModelConfig("nhv", jhp.NHVConfig(**TINY)))
    params = jax.jit(jgen.init)(jax.random.PRNGKey(0), cond)["params"]
    rng = np.random.default_rng(7)
    params = dict(params, fir=params["fir"] + 0.1 * rng.standard_normal(params["fir"].shape)
                  .astype(np.float32))  # not the delta it starts at
    tree = jax.tree_util.tree_map(np.asarray, params)
    want = np.asarray(jgen.apply({"params": params}, cond))
    sources = _jax_sources(cond)
    tcfg = thp.ModelConfig("nhv", thp.NHVConfig(**TINY))
    for weight_norm in (True, False):
        gen = build_generator(tcfg, weight_norm=weight_norm)
        gen.load_state_dict(state_dict_from_jax(tree, fuse=not weight_norm))
        with torch.no_grad():
            got = gen(torch.from_numpy(cond), sources=sources).numpy()
        assert got.shape == (2, 12 * HOP)
        _close(got, want, 1e-5)


def test_release_checkpoint_matches_jax_with_its_sources():
    npz, conf, name = NHV
    ckpt = load_release_npz(npz)
    assert ckpt["model_name"] == name and ckpt["pattern"] is None
    assert tuple(ckpt["state_dict"]["fir"].shape) == (129, 1, 1)
    with np.load(npz) as z:
        flat = {k[len("param:"):]: z[k].astype(np.float32) for k in z.files
                if k.startswith("param:")}
        assert json.loads(str(z["meta"]))["step"] == 12000
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    cond = _cond(64, 0)
    jgen = jax_build_generator(jhp.load_model_config(name, conf))
    want = np.asarray(jax.jit(lambda p, c: jgen.apply({"params": p}, c))(tree, cond))
    tgen = build_generator(thp.load_model_config(name, conf))
    tgen.load_state_dict(ckpt["state_dict"])  # strict: every key carried
    with torch.no_grad():
        got = tgen(torch.from_numpy(cond), sources=_jax_sources(cond)).numpy()
        own = tgen.inference(torch.from_numpy(cond)).numpy()
    assert got.shape == want.shape == own.shape == (1, 64 * HOP)
    _close(got, want, 1e-4)
    assert np.isfinite(own).all()  # the port's own sources: other noise, same filters


def test_inference_noise_is_deterministic_and_f0_free_without_voicing():
    gen = build_generator(thp.ModelConfig("nhv", thp.NHVConfig(**TINY)))
    cond = torch.from_numpy(_cond(8, 2))
    with torch.no_grad():
        a, b = gen.inference(cond), gen.inference(cond)
        harm, noise = gen.sources(cond[..., 80])
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert harm.sum() > 0 and 0.25 < noise.std().item() < 0.35
    with pytest.raises(ValueError, match="mel \\+ f0"):
        gen.inference(cond[..., :80])


# ---- 6. entry points ----

@pytest.fixture(scope="module")
def nhv_synth():
    return Synthesizer(*NHV, device="cpu")


def test_synthesizer_takes_f0_beside_the_mel(nhv_synth):
    cond = _cond(30, 8, "random")[0]
    with pytest.raises(ValueError, match="mel \\+ f0"):
        nhv_synth.synthesize(cond[:, :80])
    packed = nhv_synth.synthesize(cond)
    split = nhv_synth.synthesize(cond[:, :80], f0=cond[:, 80])
    for a, b in zip(packed, split):
        assert a.shape == (30 * HOP,)
        np.testing.assert_array_equal(a, b)
    est, est_remove, bias = packed
    np.testing.assert_array_equal(est - bias, est_remove)
    # the bias is the zero conditioning's: f0 = 0, the noise source alone
    with torch.inference_mode():
        want = nhv_synth.generator(torch.zeros(1, 30, 81))[0].numpy()
    np.testing.assert_array_equal(bias, want)


def test_rtf_protocol_reads_mel_and_f0_files(tmp_path):
    cond = _cond(20, 9, "random")[0]
    np.save(tmp_path / "a.mel.npy", cond[:, :80].T)
    np.save(tmp_path / "a.f0.npy", cond[:, 80])
    np.save(tmp_path / "b.npy", _cond(12, 10)[0].T)  # packed (81, T)
    rtf = run_test(["--checkpoint_path", NHV[0], "--file_path", str(tmp_path),
                    "--config", NHV[1], "--model_name", "nhv", "--device", "cpu"])
    assert np.isfinite(rtf) and rtf > 0
    assert not list(tmp_path.glob("*.wav"))
    np.save(tmp_path / "c.npy", cond[:, :80].T)  # a mel without its f0
    with pytest.raises(ValueError, match="mel \\+ f0"):
        run_test(["--checkpoint_path", NHV[0], "--file_path", str(tmp_path),
                  "--config", NHV[1], "--model_name", "nhv", "--device", "cpu"])


def test_serving_model_serves_nhv(nhv_synth):
    model = ServingModel(*NHV, bucket_frames=32, max_batch=4, device="cpu")
    assert model.input_channels == 81
    conds = [_cond(T, 11 + T, "random")[0] for T in (12, 30)]
    with pytest.raises(ValueError, match="81"):
        model.validate(conds[0][:, :80])
    for cond, wav in zip(conds, model(conds)):
        assert wav.shape == (cond.shape[0] * HOP,) and np.isfinite(wav).all()


@pytest.mark.parametrize("family", ["melgan", "nhv"])
def test_entry_points_of_the_new_families_need_cuda_unless_told_cpu(tmp_path, family):
    from fastvocoder_tpu_torch.bin.serve import run_serve

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal only shows without it")
    npz = os.path.join(ROOT, "docs", "checkpoints", f"{family}_clean.npz")
    conf = os.path.join(ROOT, "conf", family, "original.yaml" if family == "melgan"
                        else "default.yaml")
    for call in (lambda: Synthesizer(npz, conf, family),
                 lambda: ServingModel(npz, conf, family),
                 lambda: run_test(["--checkpoint_path", npz, "--file_path", str(tmp_path),
                                   "--config", conf, "--model_name", family]),
                 lambda: run_serve(["--checkpoint_path", npz, "--config", conf, "--model_name",
                                    family, "--port", "0"], block=False)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
