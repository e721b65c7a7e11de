"""The port's preprocessing (`fastvocoder_tpu_torch/data/preprocess.py`,
`bin/preprocess.py`) on the CPU against the JAX package's on the same 12
seeded wavs (one at 48 kHz, one at 22.05 kHz, the rest at 24 kHz) and a
corrupt one: the port's host pool on and off, its `<name>.npy` equal to
JAX's, its `<name>.mel.npy` within 1e-6, the `<name>.f0.npy` files equal
with `extract_f0`, the same seeded splits, and the corrupt file reported
and left out by both."""

import os

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from fastvocoder_tpu.data import preprocess as jax_pre
from fastvocoder_tpu.hparams import HP as JAX_HP
from fastvocoder_tpu_torch.bin.preprocess import run_preprocess
from fastvocoder_tpu_torch.data import preprocess as pre
from fastvocoder_tpu_torch.hparams import HP

SIZES = dict(train_size=8, valid_size=2, eval_size=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (pytest-xdist runs several
    test processes side by side), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """12 seeded wavs of 0.4-0.7 s and a corrupt file, and their index."""
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(11)
    paths = []
    for i in range(12):
        sr = {0: 48000, 1: 22050}.get(i, 24000)
        t = np.arange(int(rng.uniform(0.4, 0.7) * sr)) / sr
        y = 0.4 * np.sin(2 * np.pi * (150 + 35 * i) * t) + 0.05 * rng.standard_normal(t.size)
        p = root / f"utt_{i}.wav"
        scipy.io.wavfile.write(str(p), sr, (y * 30000).astype(np.int16))
        paths.append(str(p))
    bad = root / "corrupt.wav"
    bad.write_bytes(b"RIFF\x00\x01not a wav file at all")
    paths.insert(5, str(bad))
    index = root / "index.txt"
    index.write_text("\n".join(paths) + "\n")
    return str(index)


def _run_jax(index, out, extract_f0):
    a, m = jax_pre.preprocess(index, str(out), JAX_HP, multiprocess=False, extract_f0=extract_f0)
    jax_pre.write_splits(a, m, str(out / "audio"), str(out / "mel"), JAX_HP.replace(**SIZES),
                         seed=5)
    return a, m


@pytest.mark.parametrize("multiprocess,extract_f0", [(False, True), (True, False)])
def test_preprocess_is_jaxs(wavs, tmp_path, capsys, multiprocess, extract_f0):
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    ja, jm = _run_jax(wavs, jax_out, extract_f0)
    assert "ERROR processing" in capsys.readouterr().out
    a, m = pre.preprocess(wavs, str(port_out), HP, multiprocess=multiprocess, max_workers=2,
                          extract_f0=extract_f0, device="cpu")
    said = capsys.readouterr().out
    assert "ERROR processing" in said and "corrupt.wav" in said and "1/13 files failed" in said
    pre.write_splits(a, m, str(port_out / "audio"), str(port_out / "mel"), HP.replace(**SIZES),
                     seed=5)
    assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in ja]
    assert [os.path.basename(p) for p in m] == [os.path.basename(p) for p in jm]
    assert len(a) == 12
    for got_wav, want_wav, got_mel, want_mel in zip(a, ja, m, jm):
        gw, ww = np.load(got_wav), np.load(want_wav)
        assert gw.dtype == ww.dtype == np.float32 and np.array_equal(gw, ww)
        gm, wm = np.load(got_mel), np.load(want_mel)
        assert gm.shape == wm.shape and gm.dtype == wm.dtype
        assert np.abs(gm - wm).max() <= 1e-6
        f0_got, f0_want = (p.replace(".mel.npy", ".f0.npy") for p in (got_mel, want_mel))
        assert os.path.exists(f0_got) == os.path.exists(f0_want) == extract_f0
        if extract_f0:
            assert np.array_equal(np.load(f0_got), np.load(f0_want))
    for kind in ("audio", "mel"):
        for split in ("train", "valid", "eval"):
            got = (port_out / kind / split).read_text().replace(str(port_out), "<out>")
            want = (jax_out / kind / split).read_text().replace(str(jax_out), "<out>")
            assert got == want and got.count("\n") == SIZES[f"{split}_size"]


def test_extract_one_reports_a_failure(tmp_path, capsys):
    bad = tmp_path / "x.wav"
    bad.write_bytes(b"nothing")
    assert pre.extract_one(str(bad), str(tmp_path / "x.mel.npy"), str(tmp_path / "x.npy"),
                           device="cpu") is None
    assert "ERROR processing" in capsys.readouterr().out


def test_run_preprocess_writes_the_splits(wavs, tmp_path):
    run_preprocess(["--data_path", wavs, "--save_path", str(tmp_path / "p"),
                    "--audio_index_path", str(tmp_path / "a"),
                    "--mel_index_path", str(tmp_path / "m"), "--no_multiprocess",
                    "--train_size", "8", "--valid_size", "2", "--eval_size", "2",
                    "--device", "cpu"])
    assert sum(f.endswith(".mel.npy") for f in os.listdir(tmp_path / "p")) == 12
    lines = [(tmp_path / "m" / s).read_text().splitlines() for s in ("train", "valid", "eval")]
    assert sorted(sum(lines, [])) == sorted(
        str(tmp_path / "p" / f) for f in os.listdir(tmp_path / "p") if f.endswith(".mel.npy"))
