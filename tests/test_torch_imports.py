"""The port stands alone: no module of `fastvocoder_tpu_torch/`, and not
`chip_smoke.py`, imports JAX, Flax or anything of the JAX package, not even
its JAX-free modules.  Checked on the source (AST), so imports inside
functions count too."""

import ast
import os
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fastvocoder_tpu")
SOURCES = sorted((ROOT / "fastvocoder_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(ast.parse(path.read_text(), str(path)))
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert "fastvocoder_tpu_torch/ops/fused_resstack.py" in names
    assert "fastvocoder_tpu_torch/serving/server.py" in names
    for new in ("bin/train.py", "train/trainer.py", "train/checkpoint.py", "data/dataset.py",
                "dsp/stft.py", "losses/__init__.py", "losses/gan.py", "losses/stft_loss.py",
                "models/discriminator/msd.py", "models/discriminator/mfd.py",
                "models/discriminator/composite.py", "models/melgan.py", "models/nhv.py",
                "models/discriminator/mpd.py", "dsp/f0.py", "ops/overlap_add.py",
                "runtime/__init__.py", "runtime/prefetch.py", "runtime/profiler.py",
                "data/device_cache.py", "dsp/mel.py", "dsp/audio.py", "dsp/griffin_lim.py",
                "data/preprocess.py", "models/streaming.py", "bin/preprocess.py",
                "bin/evaluation.py", "bin/publish.py", "bin/launcher.py", "bin/cli.py",
                "bin/__init__.py", "parallel/__init__.py", "parallel/distributed.py",
                "parallel/mesh.py"):
        assert f"fastvocoder_tpu_torch/{new}" in names
    assert "chip_smoke.py" in names


def test_scan_catches_a_jax_import():
    tree = ast.parse("def f():\n    from fastvocoder_tpu.hparams import HP\n    import jax.numpy\n")
    assert [m.split(".")[0] for m in _imported(tree)] == ["fastvocoder_tpu", "jax"]


def _entry_points(tmp_path):
    """The pipeline's entry points, each called as a user would without a
    device argument (CUDA by default); the data-parallel ones under the
    environment `torchrun` sets."""
    from unittest import mock

    import numpy as np

    from fastvocoder_tpu_torch.bin.evaluation import run_evaluation
    from fastvocoder_tpu_torch.bin.preprocess import run_preprocess
    from fastvocoder_tpu_torch.bin.publish import publish_model, run_publisher
    from fastvocoder_tpu_torch.data.preprocess import extract_one, preprocess
    from fastvocoder_tpu_torch.dsp import audio, griffin_lim
    from fastvocoder_tpu_torch.hparams import load_model_config
    from fastvocoder_tpu_torch.models.factory import build_generator
    from fastvocoder_tpu_torch.models.streaming import StreamingSynthesizer
    from fastvocoder_tpu_torch.bin.serve import run_serve
    from fastvocoder_tpu_torch.bin.train import run_train
    from fastvocoder_tpu_torch.parallel import make_mesh, maybe_initialize_distributed

    torchrun = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": "1"}

    def under_torchrun(fn):
        def call():
            with mock.patch.dict(os.environ, torchrun):
                return fn()
        return call

    conf = str(ROOT / "conf" / "basis-melgan" / "light.yaml")
    index = tmp_path / "index.txt"
    index.write_text("")
    mel = np.zeros((80, 4), np.float32)
    wav = np.zeros(960, np.float32)
    return {
        "run_preprocess": lambda: run_preprocess(["--data_path", str(index),
                                                  "--save_path", str(tmp_path / "p")]),
        "preprocess": lambda: preprocess(str(index), str(tmp_path / "p")),
        "extract_one": lambda: extract_one("a.wav", "a.mel.npy", "a.npy"),
        "run_evaluation": lambda: run_evaluation([
            "--checkpoint_path", str(ROOT / "docs" / "checkpoints" / "basis_melgan_clean2.npz"),
            "--model_name", "basis-melgan", "--config", conf]),
        "run_publisher": lambda: run_publisher(["--checkpoint_path", "x.pth.tar",
                                                "--model_name", "basis-melgan",
                                                "--config", conf, "--save_path", "y.pth.tar"]),
        "publish_model": lambda: publish_model("x.pth.tar", conf, "basis-melgan", "y.pth.tar"),
        "StreamingSynthesizer.for_model": lambda: StreamingSynthesizer.for_model(
            build_generator(load_model_config("basis-melgan", conf)), "basis-melgan"),
        "StreamingSynthesizer": lambda: StreamingSynthesizer(lambda m: m, 240),
        "inv_mel_spectrogram": lambda: griffin_lim.inv_mel_spectrogram(mel),
        "audio.inv_mel_spectrogram": lambda: audio.inv_mel_spectrogram(mel),
        "melspectrogram": lambda: audio.melspectrogram(wav),
        "spectrogram": lambda: audio.spectrogram(wav),
        "maybe_initialize_distributed": under_torchrun(maybe_initialize_distributed),
        "run_train (torchrun)": under_torchrun(lambda: run_train([
            "--model_name", "basis-melgan", "--config", conf])),
        "make_mesh": make_mesh,
        "run_serve --mesh all": lambda: run_serve([
            "--checkpoint_path", str(ROOT / "docs" / "checkpoints" / "basis_melgan_clean2.npz"),
            "--config", conf, "--port", "0", "--mesh", "all"], block=False),
    }


ENTRY_POINTS = ("run_preprocess", "preprocess", "extract_one", "run_evaluation", "run_publisher",
                "publish_model", "StreamingSynthesizer.for_model", "StreamingSynthesizer",
                "inv_mel_spectrogram", "audio.inv_mel_spectrogram", "melspectrogram",
                "spectrogram", "maybe_initialize_distributed", "run_train (torchrun)", "make_mesh",
                "run_serve --mesh all")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_pipeline_entry_points_raise_without_cuda(tmp_path, name):
    """Without a card an entry point raises unless it is given the CPU: no
    path carries on on the CPU by itself."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the entry points run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points(tmp_path)[name]()
