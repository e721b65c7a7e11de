"""The port stands alone: no module of `fastvocoder_tpu_torch/`, and not
`chip_smoke.py`, imports JAX, Flax or anything of the JAX package, not even
its JAX-free modules.  Checked on the source (AST), so imports inside
functions count too."""

import ast
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
                "data/device_cache.py"):
        assert f"fastvocoder_tpu_torch/{new}" in names
    assert "chip_smoke.py" in names


def test_scan_catches_a_jax_import():
    tree = ast.parse("def f():\n    from fastvocoder_tpu.hparams import HP\n    import jax.numpy\n")
    assert [m.split(".")[0] for m in _imported(tree)] == ["fastvocoder_tpu", "jax"]
