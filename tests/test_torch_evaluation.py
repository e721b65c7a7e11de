"""The port's evaluation (`fastvocoder_tpu_torch/bin/evaluation.py`) on
the CPU against the JAX package's: `evaluate` with Basis-MelGAN light's
release weights (`docs/checkpoints/basis_melgan_clean2.npz`, restored to a
published `.pth.tar` that both packages load) over 2 items, every metric
within 1e-4 relative and MCD within 1e-3 dB; MCD's identity and order
cases (mirroring tests/test_eval_metrics.py); and `run_evaluation`'s
summary and JSON."""

import json
import os

import numpy as np
import pytest
import torch

from fastvocoder_tpu.bin import evaluation as jax_eval
from fastvocoder_tpu.bin.synthesize import Synthesizer as JaxSynthesizer
from fastvocoder_tpu.dsp import audio as jax_audio
from fastvocoder_tpu.hparams import load_model_config as jax_config
from fastvocoder_tpu.train.checkpoint import save_published as jax_save_published
from fastvocoder_tpu_torch.bin import evaluation
from fastvocoder_tpu_torch.bin.synthesize import Synthesizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "docs", "checkpoints", "basis_melgan_clean2.npz")
CONF = os.path.join(ROOT, "conf", "basis-melgan", "light.yaml")
GOLDEN = os.path.join(ROOT, "tests", "goldens", "mel_golden.npz")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (pytest-xdist runs several
    test processes side by side), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def release_tree(npz: str):
    """A release checkpoint -> (meta, its JAX parameter tree, pattern),
    float32."""
    with np.load(npz) as z:
        meta = json.loads(str(z["meta"]))
        tree = {}
        for k in z.files:
            if k.startswith("param:"):
                *parents, leaf = k[len("param:"):].split("/")
                node = tree
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = z[k].astype(np.float32)
        return meta, tree, z["pattern"].astype(np.float32)


def restore_release(npz: str, conf: str, out: str) -> str:
    """A release checkpoint -> the published `{model, pattern}` file the
    JAX package writes for it (tools/export_release_checkpoint.py restore)."""
    meta, tree, pattern = release_tree(npz)
    jax_save_published(out, jax_config(meta["model_name"], conf), tree, pattern)
    return out


@pytest.fixture(scope="module")
def items(tmp_path_factory):
    """Two eval items (the mel golden's wav and a seeded one) with their
    mels, as index files."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(2)
    t = np.arange(19200) / 24000
    wavs = [np.load(GOLDEN)["wav"].astype(np.float32),
            (0.3 * np.sin(2 * np.pi * 210 * t) + 0.03 * rng.standard_normal(t.size)
             ).astype(np.float32)]
    audio_idx, mel_idx = [], []
    for i, wav in enumerate(wavs):
        np.save(root / f"e{i}.wav.npy", wav)
        np.save(root / f"e{i}.wav.mel.npy", jax_audio.melspectrogram(wav))
        audio_idx.append(str(root / f"e{i}.wav.npy"))
        mel_idx.append(str(root / f"e{i}.wav.mel.npy"))
    (root / "audio").write_text("\n".join(audio_idx) + "\n")
    (root / "mel").write_text("\n".join(mel_idx) + "\n")
    ckpt = restore_release(NPZ, CONF, str(root / "basis_melgan_clean2.pth.tar"))
    return root, ckpt


def test_evaluate_is_jaxs(items):
    root, ckpt = items
    audio_list, mel_list = evaluation.load_data(str(root / "audio"), str(root / "mel"), [0, 1])
    got = evaluation.evaluate(Synthesizer(ckpt, CONF, "basis-melgan", bucket_frames=64,
                                          device="cpu"), audio_list, mel_list)
    want = jax_eval.evaluate(JaxSynthesizer(ckpt, CONF, "basis-melgan", bucket_frames=64),
                             audio_list, mel_list)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["frames"] == w["frames"]
        for k in ("mr_stft", "spectral_convergence", "log_mag_l1", "wav_l1"):
            assert abs(g[k] - w[k]) <= 1e-4 * abs(w[k]), (k, g[k], w[k])
        assert abs(g["mcd_db"] - w["mcd_db"]) <= 1e-3


def test_mcd_identity_is_zero():
    wav = (0.3 * np.random.default_rng(0).standard_normal(24000)).astype(np.float32)
    assert evaluation.mel_cepstral_distortion(wav, wav, device="cpu") == 0.0


def test_mcd_orders_similarity_as_jax():
    rng = np.random.default_rng(1)
    t = np.arange(24000) / 24000
    ref = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    close = ref + 0.01 * rng.standard_normal(ref.shape).astype(np.float32)
    far = (0.4 * rng.standard_normal(ref.shape)).astype(np.float32)
    mcd = lambda a, b: evaluation.mel_cepstral_distortion(a, b, device="cpu")
    assert mcd(close, ref) < mcd(far, ref)
    for a in (close, far):
        assert abs(mcd(a, ref) - jax_eval.mel_cepstral_distortion(a, ref)) <= 1e-6


def test_run_evaluation_summary_and_json(items, capsys):
    root, ckpt = items
    out = root / "eval.json"
    summary = evaluation.run_evaluation([
        "--checkpoint_path", ckpt, "--model_name", "basis-melgan", "--config", CONF,
        "--audio_index_path", str(root / "audio"), "--mel_index_path", str(root / "mel"),
        "--num_items", "5", "--output", str(out), "--device", "cpu"])
    assert set(summary) == set(evaluation.METRICS) and np.isfinite(list(summary.values())).all()
    saved = json.loads(out.read_text())
    assert len(saved["items"]) == 2 and saved["mean"] == summary
    assert "item 1:" in capsys.readouterr().out
    assert summary["wav_l1"] == float(np.mean([r["wav_l1"] for r in saved["items"]]))
