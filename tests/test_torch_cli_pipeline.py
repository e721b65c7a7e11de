"""The port's end-to-end pipeline on the CPU, through its launcher and its
CLI (`fastvocoder_tpu_torch/bin/{launcher, cli}.py`), the port's mirror of
tests/test_cli_pipeline.py:

    preprocess -> train -> synthesize -> publish -> test -> evaluation

on 12 synthetic wavs with a tiny MelGAN and `TINY_DISC`, every stage with
`--device cpu`.  Preprocess, train and publish run as
`MODE=<mode> python -m fastvocoder_tpu_torch.bin.launcher` (in this process,
through `runpy`), synthesize, test and evaluation through `cli.main`.
TensorBoard's writer is replaced by the no-op one the trainer takes where
TensorBoard is missing (its import pulls in TensorFlow, about 15 s).
"""

import os
import runpy
import sys

import numpy as np
import pytest
import scipy.io.wavfile
import torch

import fastvocoder_tpu_torch.bin.train as train_mod
from fastvocoder_tpu_torch.bin import cli
from fastvocoder_tpu_torch.bin.launcher import MODES
from fastvocoder_tpu_torch.hparams import HP, TINY_DISC
from fastvocoder_tpu_torch.train.trainer import make_trainer

TINY_MELGAN = (
    "in_channels: 80\nout_channels: 1\nkernel_size: 7\n"
    "channels: [8, 8, 8, 8, 8]\nupsample_scales: [10, 6, 2, 2]\n"
    "stack_kernel_size: 3\nstacks: 3\nuse_weight_norm: True\n"
    "use_causal_conv: False\nbias: True\nmultiband: False\n"
    "lamda_stft: 1.0\nuse_feature_map_loss: True\n"
)


@pytest.fixture
def workspace(tmp_path, monkeypatch):
    """12 synthetic 0.6 s wavs and their index; cwd moved to tmp."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(3)
    (tmp_path / "wavs").mkdir()
    paths = []
    sr = HP.sample_rate
    for i in range(12):
        t = np.arange(int(0.6 * sr)) / sr
        y = 0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t) + 0.05 * rng.standard_normal(t.size)
        p = tmp_path / "wavs" / f"utt_{i}.wav"
        scipy.io.wavfile.write(str(p), sr, (y * 32000).astype(np.int16))
        paths.append(str(p))
    (tmp_path / "index.txt").write_text("\n".join(paths) + "\n")
    return tmp_path


def _launch(monkeypatch, mode, argv):
    """`MODE=<mode> python -m fastvocoder_tpu_torch.bin.launcher <argv>`."""
    monkeypatch.setenv("MODE", mode)
    monkeypatch.setattr(sys, "argv", ["launcher"] + argv)
    # as in a fresh process, where nothing has imported the module yet
    monkeypatch.delitem(sys.modules, "fastvocoder_tpu_torch.bin.launcher", raising=False)
    runpy.run_module("fastvocoder_tpu_torch.bin.launcher", run_name="__main__")


def test_full_cli_pipeline(workspace, monkeypatch):
    tmp = workspace
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(train_mod, "make_trainer",
                        lambda *a, **k: make_trainer(*a, **{**k, "disc_cfg": TINY_DISC}))
    monkeypatch.setattr(train_mod, "_make_writer", lambda logdir: train_mod._NoopWriter())
    try:
        # 1. preprocess
        _launch(monkeypatch, "preprocess", [
            "--data_path", str(tmp / "index.txt"), "--save_path", str(tmp / "processed"),
            "--audio_index_path", str(tmp / "idx_audio"),
            "--mel_index_path", str(tmp / "idx_mel"), "--no_multiprocess",
            "--train_size", "8", "--valid_size", "2", "--eval_size", "2", "--device", "cpu"])
        for split in ("train", "valid", "eval"):
            assert (tmp / "idx_audio" / split).exists() and (tmp / "idx_mel" / split).exists()
        assert sum(f.endswith(".mel.npy") for f in os.listdir(tmp / "processed")) == 12

        # 2. train: 2 steps of a tiny MelGAN
        conf = tmp / "tiny.yaml"
        conf.write_text(TINY_MELGAN)
        _launch(monkeypatch, "train", [
            "--audio_index_path", str(tmp / "idx_audio" / "train"),
            "--mel_index_path", str(tmp / "idx_mel" / "train"),
            "--audio_index_valid_path", str(tmp / "idx_audio" / "valid"),
            "--mel_index_valid_path", str(tmp / "idx_mel" / "valid"),
            "--model_name", "melgan", "--config", str(conf),
            "--batch_size", "2", "--batch_expand_size", "2", "--fixed_length", "10",
            "--max_steps", "2", "--save_step", "2", "--valid_step", "10000",
            "--stall_exit_s", "0", "--device", "cpu"])
        run_dir = tmp / "checkpoint" / os.listdir(tmp / "checkpoint")[0]
        ckpt = str(run_dir / "checkpoint_2.pth.tar")
        assert os.path.exists(ckpt)

        # 3. synthesize: 4 wavs, the Griffin-Lim reference included
        out_wav = str(tmp / "out.wav")
        assert cli.main(["synthesize", "--checkpoint_path", ckpt,
                         "--mel_path", str(tmp / "processed" / "utt_0.wav.mel.npy"),
                         "--wav_path", out_wav, "--model_name", "melgan",
                         "--config", str(conf), "--device", "cpu"]) == 0
        for name in ("out.wav", "out.remove.wav", "out.bias.wav", "out.gl.wav"):
            sr, y = scipy.io.wavfile.read(tmp / name)
            assert sr == HP.sample_rate and y.shape == (61 * 240 if name != "out.gl.wav"
                                                        else 60 * 240,), name

        # 4. publish
        published = str(tmp / "published.pth.tar")
        _launch(monkeypatch, "publish", ["--checkpoint_path", ckpt, "--model_name", "melgan",
                                         "--config", str(conf), "--save_path", published,
                                         "--device", "cpu"])
        assert os.path.exists(published)

        # 5. test: the RTF protocol over two eval mels, on the published file
        (tmp / "eval_mels").mkdir()
        for i in (0, 1):
            np.save(tmp / "eval_mels" / f"e{i}.mel.npy",
                    np.load(tmp / "processed" / f"utt_{i}.wav.mel.npy"))
        assert cli.main(["test", "--checkpoint_path", published,
                         "--file_path", str(tmp / "eval_mels"), "--model_name", "melgan",
                         "--config", str(conf), "--device", "cpu"]) == 0

        # 6. evaluation over the eval split
        assert cli.main(["evaluation", "--checkpoint_path", ckpt, "--model_name", "melgan",
                         "--config", str(conf),
                         "--audio_index_path", str(tmp / "idx_audio" / "eval"),
                         "--mel_index_path", str(tmp / "idx_mel" / "eval"),
                         "--num_items", "2", "--output", str(tmp / "eval.json"),
                         "--device", "cpu"]) == 0
        assert (tmp / "eval.json").exists()
    finally:
        torch.set_num_threads(n_threads)


def test_cli_usage_and_unknown_modes(monkeypatch, capsys):
    assert cli.main([]) == 0 and "fastvocoder-torch <" in capsys.readouterr().out
    assert set(MODES) == {"train", "preprocess", "synthesize", "publish", "test", "evaluation",
                          "serve"}
    with pytest.raises(SystemExit, match="unknown mode"):
        cli.main(["dance"])
    with pytest.raises(SystemExit, match="unknown MODE"):
        _launch(monkeypatch, "dance", [])
