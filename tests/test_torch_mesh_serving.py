"""Mesh serving of the port on the CPU: `BatchedSynthesizer(mesh=...)`,
`ServingModel(mesh=...)` and `bin/serve.py --mesh all`, the counterparts
of the JAX package's `mesh=` (`tests/test_batched.py`).

A mesh here is a list of devices, one replica of the generator a device;
on the CPU the devices are all `cpu`, as two replicas may share one card.
Held: the mesh's waveforms equal the one-device path's (the same
arithmetic, rows padded to a multiple of the mesh's size by repeating the
last row and trimmed), and the JAX package's on its 8-device virtual mesh
from the same weights and mels within 1e-5; `warmup` rounds rows as
`__call__` does; the HTTP server with `--mesh all --device cpu` answers 2
concurrent requests and reports its mesh's size on /healthz.
"""

import io
import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from fastvocoder_tpu.hparams import MelGANConfig as JaxMelGANConfig
from fastvocoder_tpu.hparams import ModelConfig as JaxModelConfig
from fastvocoder_tpu.models.batched import BatchedSynthesizer as JaxBatched
from fastvocoder_tpu.models.factory import build_generator as jax_build_generator
from fastvocoder_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fastvocoder_tpu_torch.bin.serve import run_serve
from fastvocoder_tpu_torch.checkpoint import state_dict_from_jax
from fastvocoder_tpu_torch.hparams import MelGANConfig, ModelConfig
from fastvocoder_tpu_torch.models.batched import BatchedSynthesizer
from fastvocoder_tpu_torch.models.factory import build_generator
from fastvocoder_tpu_torch.parallel import make_mesh
from fastvocoder_tpu_torch.serving import ServingModel

ROOT = os.path.join(os.path.dirname(__file__), "..")
NPZ = os.path.join(ROOT, "docs", "checkpoints", "basis_melgan_clean2.npz")
CONF = os.path.join(ROOT, "conf", "basis-melgan", "light.yaml")
LENGTHS = [10, 25, 25, 40, 70, 12, 30]  # 5 in the 32-frame bucket: rows pad to the mesh


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def melgan():
    """A narrow MelGAN initialised on the JAX side: (its JAX forward, its
    params, the port's generator with the same weights)."""
    gen = jax_build_generator(JaxModelConfig(model_name="melgan",
                                             arch=JaxMelGANConfig(channels=(8, 8, 8, 8, 8))))
    params = jax.jit(gen.init)(jax.random.PRNGKey(0), np.zeros((1, 8, 80), np.float32))["params"]
    port = build_generator(ModelConfig(model_name="melgan",
                                       arch=MelGANConfig(channels=(8, 8, 8, 8, 8))))
    port.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return (lambda p, m: gen.apply({"params": p}, m)), params, port.eval()


def _mels():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((T, 80)).astype(np.float32) for T in LENGTHS]


def _replicas(port, n):
    """n replicas of `port`, each a module of its own (its own kept
    tables), as a mesh holds them."""
    import copy

    return [copy.deepcopy(port) for _ in range(n)]


def test_mesh_equals_one_device_and_jax(melgan):
    jax_fwd, params, port = melgan
    mels = _mels()
    mesh = make_mesh(["cpu"] * 3)
    seen = []

    def counting(model):
        def fwd(m):
            seen.append(m.shape[0])
            return model.inference(m)
        return fwd

    sharded = BatchedSynthesizer([counting(r) for r in _replicas(port, 3)], 240,
                                 bucket_frames=32, max_batch=8, mesh=mesh)(mels)
    plain = BatchedSynthesizer(port.inference, 240, torch.device("cpu"), bucket_frames=32,
                               max_batch=8)(mels)
    # the 32-frame bucket holds 5 mels (10, 25, 25, 12, 30), the 64- and
    # 96-frame buckets one each: rows padded to 6, 3 and 3, 2 or 1 a replica
    assert sorted(seen) == [1, 1, 1, 1, 1, 1, 2, 2, 2]
    want = JaxBatched(jax_fwd, params, samples_per_frame=240, bucket_frames=32, max_batch=8,
                      mesh=jax_make_mesh(jax.devices()[:8]))(mels)
    for m, a, b, w in zip(mels, sharded, plain, want):
        assert a.shape == b.shape == w.shape == (m.shape[0] * 240,)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, np.asarray(w), rtol=1e-5, atol=1e-5)


def test_warmup_rounds_rows_to_the_mesh(melgan):
    _, _, port = melgan
    rows = []

    def fwd(m):
        rows.append(m.shape[0])
        return port.inference(m)

    bs = BatchedSynthesizer([fwd, fwd, fwd], 240, bucket_frames=32, max_batch=8,
                            batch_pad="pow2", mesh=make_mesh(["cpu"] * 3))
    # group sizes 1, 2, 4, 8 padded to the mesh: 3, 3, 6, 9 rows, 3 shapes
    assert bs.warmup([20]) == 3
    assert sorted(set(rows)) == [1, 2, 3]


def test_mesh_needs_a_forward_a_device():
    with pytest.raises(ValueError, match="3 devices"):
        BatchedSynthesizer([lambda m: m], 240, mesh=make_mesh(["cpu"] * 3))


def test_serving_model_on_a_mesh_equals_one_device():
    mels = [np.clip(0.5 + 0.25 * np.random.default_rng(i).standard_normal((T, 80)), 0, 1)
            .astype(np.float32) for i, T in enumerate((60, 130, 70))]
    one = ServingModel(NPZ, CONF, "basis-melgan", max_batch=4, device="cpu")
    two = ServingModel(NPZ, CONF, "basis-melgan", max_batch=4, mesh=make_mesh(["cpu", "cpu"]))
    assert (one.mesh_size, two.mesh_size) == (1, 2)
    assert two.batched.forwards[0].__self__ is not two.batched.forwards[1].__self__
    for a, b in zip(two(mels), one(mels)):
        np.testing.assert_array_equal(a, b)


def test_serve_mesh_all_answers_and_reports_its_mesh():
    httpd, batcher = run_serve(["--checkpoint_path", NPZ, "--config", CONF, "--port", "0",
                                "--max_batch", "4", "--mesh", "all", "--device", "cpu"],
                               block=False)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        mels = [np.clip(0.5 + 0.25 * np.random.default_rng(i).standard_normal((T, 80)), 0, 1)
                .astype(np.float32) for i, T in enumerate((60, 90))]
        results = [None, None]

        def one(i):
            buf = io.BytesIO()
            np.save(buf, mels[i])
            req = urllib.request.Request(url + "/synthesize", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                results[i] = (r.status, np.load(io.BytesIO(r.read())))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        want = ServingModel(NPZ, CONF, "basis-melgan", max_batch=4, device="cpu")(mels)
        for (status, wav), w in zip(results, want):
            assert status == 200
            np.testing.assert_allclose(wav, w, rtol=0, atol=1e-5)
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["mesh_size"] == 1 and health["requests_served"] == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()


def test_every_kernel_launch_sets_its_device():
    """Replicas on several cards launch each kernel on its own card: every
    wrapper takes the stream it launches on inside `torch.cuda.device(...)`
    of its operands' device, so that the libraries' per-device caches
    (`csrc/smem_attr.cuh`, the decode's grid size) key on that card.  One
    card cannot show a wrong device, so this reads the wrappers' source:
    every `torch.cuda.current_stream()` lies inside such a `with`."""
    import ast
    import pathlib

    def is_call(node, dotted):
        return isinstance(node, ast.Call) and ast.unparse(node.func) == dotted

    found = 0
    for path in sorted((pathlib.Path(ROOT) / "fastvocoder_tpu_torch" / "ops").glob("*.py")):
        tree = ast.parse(path.read_text())
        guarded = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.With) and any(
                    is_call(item.context_expr, "torch.cuda.device") for item in node.items):
                guarded.update(id(n) for n in ast.walk(node))
        for node in ast.walk(tree):
            if is_call(node, "torch.cuda.current_stream"):
                found += 1
                assert id(node) in guarded, f"{path.name}:{node.lineno} takes a stream outside " \
                                            "torch.cuda.device(...)"
    assert found >= 10  # every launch and packing of the six kernels
