"""The port's serving and entry points on the CPU (`device="cpu"`).

* `ServingModel` on the release checkpoint against the JAX package's
  `ServingModel` on the same weights, restored to a `.pth.tar` by
  `tools/export_release_checkpoint.py restore`: max abs 1e-4 (float32
  summation order only; waveforms peak near 3.4).
* The HTTP round trip of `bin/serve.py` against the port's `ServingModel`,
  and with `--bf16 1` against a `ServingModel(compute_dtype=bf16)`, whose
  parameters stay float32 (bf16 serving; the bound is the JAX package's
  bf16 gate, max(2e-3, 1 % of the peak), as a bucket's batch may run other
  library algorithms).
* `bin/test.py` (RTF protocol) and `bin/synthesize.py` end to end.
* Entry points refuse to run without CUDA unless given `device="cpu"`.
* The port's copies of the batcher and server, with stub synthesizers.
"""

import io
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fastvocoder_tpu_torch.bin.serve import run_serve
from fastvocoder_tpu_torch.bin.synthesize import Synthesizer, run_synthesizer
from fastvocoder_tpu_torch.bin.test import run_test
from fastvocoder_tpu_torch.models.batched import BatchedSynthesizer
from fastvocoder_tpu_torch.serving import DynamicBatcher, ServingModel, make_server, run_server

ROOT = os.path.join(os.path.dirname(__file__), "..")
NPZ = os.path.join(ROOT, "docs", "checkpoints", "basis_melgan_clean2.npz")
CONF = os.path.join(ROOT, "conf", "basis-melgan", "light.yaml")
LENGTHS = (20, 45, 64)


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


def _mels():
    rng = np.random.default_rng(7)
    return [np.clip(0.5 + 0.25 * rng.standard_normal((T, 80)), 0, 1).astype(np.float32)
            for T in LENGTHS]


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def port_model():
    return ServingModel(NPZ, CONF, "basis-melgan", bucket_frames=64, max_batch=4, device="cpu")


def test_serving_model_matches_jax(tmp_path, port_model):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from export_release_checkpoint import main as release_main
    from fastvocoder_tpu.serving import ServingModel as JaxServingModel

    pth = str(tmp_path / "basis.pth.tar")
    release_main(["restore", "--npz", NPZ, "--out", pth, "--config", CONF])
    jax_model = JaxServingModel(pth, CONF, "basis-melgan", bucket_frames=64, max_batch=4)
    mels = _mels()
    want = jax_model(mels)
    got = port_model(mels)
    for g, w, m in zip(got, want, mels):
        assert g.shape == w.shape == (m.shape[0] * 240,)
        assert np.abs(g - w).max() <= 1e-4


def test_http_round_trip(port_model):
    httpd, batcher = run_serve(
        ["--checkpoint_path", NPZ, "--config", CONF, "--port", "0",
         "--max_batch", "4", "--device", "cpu"],
        block=False,
    )
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        mels = _mels()
        results = [None] * len(mels)

        def one(i):
            results[i] = _post(url + "/synthesize", _npy(mels[i]))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(mels))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        want = port_model(mels)
        for (status, body), w in zip(results, want):
            assert status == 200
            np.testing.assert_allclose(np.load(io.BytesIO(body)), w, rtol=0, atol=1e-5)
        status, _ = _post(url + "/synthesize", _npy(np.zeros((5, 7), np.float32)))
        assert status == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()


def test_bf16_http_round_trip():
    httpd, batcher = run_serve(
        ["--checkpoint_path", NPZ, "--config", CONF, "--port", "0", "--max_batch", "4",
         "--bf16", "1", "--device", "cpu"],
        block=False,
    )
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        mels = _mels()
        results = [None] * len(mels)

        def one(i):
            results[i] = _post(url + "/synthesize", _npy(mels[i]))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(mels))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    model = ServingModel(NPZ, CONF, "basis-melgan", bucket_frames=64, max_batch=4, device="cpu",
                         compute_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.generator.parameters())
    assert model.generator.conv_pre.compute_dtype == torch.bfloat16
    for (status, body), w, m in zip(results, model(mels), mels):
        assert status == 200
        got = np.load(io.BytesIO(body))
        assert got.dtype == np.float32 and got.shape == w.shape == (m.shape[0] * 240,)
        assert np.abs(got - w).max() <= max(2e-3, 0.01 * np.abs(w).max())


def test_rtf_protocol_and_synthesize_cli(tmp_path):
    mel = _mels()[0]
    np.save(tmp_path / "utt.npy", mel.T)
    rtf = run_test(["--checkpoint_path", NPZ, "--file_path", str(tmp_path),
                    "--config", CONF, "--device", "cpu"])
    assert np.isfinite(rtf) and rtf > 0
    assert (tmp_path / "utt.npy.wav").exists()

    wav = tmp_path / "out.wav"
    run_synthesizer(["--checkpoint_path", NPZ, "--mel_path", str(tmp_path / "utt.npy"),
                     "--wav_path", str(wav), "--config", CONF, "--device", "cpu"])
    for name in ("out.wav", "out.remove.wav", "out.bias.wav", "out.gl.wav"):
        assert (tmp_path / name).stat().st_size > 44


def test_bucketed_synthesis_keeps_the_raw_length():
    mel = _mels()[1]
    exact = Synthesizer(NPZ, CONF, "basis-melgan", device="cpu")
    bucketed = Synthesizer(NPZ, CONF, "basis-melgan", bucket_frames=64, device="cpu")
    a, b = exact._run(mel), bucketed._run(mel)
    assert a.shape == b.shape == ((45 * 16 - 1) * 15 + 30,)
    est, est_remove, bias = exact.synthesize(mel)
    np.testing.assert_allclose(est - bias, est_remove, rtol=0, atol=0)


def test_entry_points_need_cuda_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal only shows without it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Synthesizer(NPZ, CONF, "basis-melgan")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingModel(NPZ, CONF, "basis-melgan")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_test(["--checkpoint_path", NPZ, "--file_path", str(tmp_path), "--config", CONF])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_serve(["--checkpoint_path", NPZ, "--config", CONF, "--port", "0"], block=False)


def test_bf16_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal only shows without it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Synthesizer(NPZ, CONF, "basis-melgan", compute_dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingModel(NPZ, CONF, "basis-melgan", compute_dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_serve(["--checkpoint_path", NPZ, "--config", CONF, "--port", "0", "--bf16", "1"],
                  block=False)


@pytest.mark.parametrize("batch_pad", ["exact", "pow2"])
def test_batched_synthesizer_groups_and_trims(batch_pad):
    calls = []

    def forward(mel):
        calls.append(tuple(mel.shape))
        return mel.sum(-1).repeat_interleave(3, dim=1)

    bs = BatchedSynthesizer(forward, samples_per_frame=3, device=torch.device("cpu"),
                            bucket_frames=8, max_batch=4, batch_pad=batch_pad)
    mels = [np.full((T, 2), i, np.float32) for i, T in enumerate((3, 9, 5, 7))]
    out = bs(mels)
    for i, (o, m) in enumerate(zip(out, mels)):
        np.testing.assert_array_equal(o, np.full(m.shape[0] * 3, 2.0 * i))
    rows = sorted(c[0] for c in calls)
    assert rows == ([1, 3] if batch_pad == "exact" else [1, 4])
    assert sorted(c[1] for c in calls) == [8, 16]


def test_dynamic_batcher_coalesces_and_reports_errors():
    seen = []

    def synth(mels):
        seen.append(len(mels))
        if any(m.shape[0] == 0 for m in mels):
            raise ValueError("empty")
        return [m.sum(axis=1) for m in mels]

    batcher = DynamicBatcher(synth, max_batch=8, max_wait_ms=50)
    try:
        futs = [batcher.submit(np.ones((3, 2), np.float32)) for _ in range(4)]
        assert [f.result(timeout=10).tolist() for f in futs] == [[2.0] * 3] * 4
        assert sum(seen) == 4 and max(seen) > 1
        with pytest.raises(ValueError):
            batcher(np.ones((0, 2), np.float32))
        assert batcher(np.ones((1, 2), np.float32)).tolist() == [2.0]
    finally:
        batcher.close()


def test_server_rejects_bad_requests():
    httpd, batcher = make_server(lambda mels: [m[:, 0] for m in mels],
                                 input_channels=4, port=0, max_wait_ms=1)
    run_server(httpd, batcher)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert _post(url + "/synthesize", b"not npy")[0] == 400
        assert _post(url + "/synthesize", _npy(np.zeros((3, 5), np.float32)))[0] == 400
        assert _post(url + "/nowhere", _npy(np.zeros((3, 4), np.float32)))[0] == 404
        status, body = _post(url + "/synthesize", _npy(np.ones((3, 4), np.float32)))
        assert status == 200 and np.load(io.BytesIO(body)).tolist() == [1.0] * 3
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
