"""The port's training input on the CPU: `data/device_cache.py`'s
`DeviceCorpus` and `runtime/`'s `prefetch_to_device` and `trace`.

The cases of `tests/test_device_cache.py` and `tests/test_runtime.py`,
mirrored (crops equal to the host pipeline's exactly, the weight target
in bf16 within its rounding); then the port's `DeviceCorpus` against the
JAX package's on one corpus: the same batches, bit for bit (mel, wav and
the bf16 weight), over an epoch boundary and past `weight_until`; and
both refuse to run without a card unless told the CPU.
"""

import threading
import time

import numpy as np
import pytest
import torch

from fastvocoder_tpu_torch.data.dataset import BufferDataset, collate, num_batches_per_epoch
from fastvocoder_tpu_torch.data.device_cache import DeviceCorpus
from fastvocoder_tpu_torch.hparams import HP
from fastvocoder_tpu_torch.runtime import annotate, prefetch_to_device, trace

L = 30


@pytest.fixture
def hp():
    return HP.replace(fixed_length=10, batch_size=2, batch_expand_size=2)


@pytest.fixture
def buffer(hp):
    rng = np.random.default_rng(0)
    return [{"mel": rng.standard_normal((12 + i, 80)).astype(np.float32),
             "wav": rng.standard_normal(((12 + i) * hp.hop_size,)).astype(np.float32)}
            for i in range(6)]


def _with_weights(buffer, hp, seed=1):
    wstep = hp.hop_size // (L // 2)
    rng = np.random.default_rng(seed)
    for it in buffer:
        it["weight"] = np.abs(rng.standard_normal((it["mel"].shape[0] * wstep, 16))
                              ).astype(np.float32)
    return buffer


def _np(t):
    return t.float().numpy()


def test_gather_matches_host_collate(hp, buffer):
    corpus = DeviceCorpus(BufferDataset(buffer, hp), hp=hp, device="cpu", log=lambda m: None)
    idx, starts = np.array([1, 3, 5]), np.array([2, 0, 4])
    out = corpus.gather(idx, starts)
    ref = collate([{"mel": buffer[i]["mel"][s: s + hp.fixed_length],
                    "wav": buffer[i]["wav"][s * hp.hop_size: (s + hp.fixed_length) * hp.hop_size]}
                   for i, s in zip(idx, starts)], hp)
    np.testing.assert_array_equal(_np(out["mel"]), ref["mel"])
    np.testing.assert_array_equal(_np(out["wav"]), ref["wav"])


@pytest.mark.parametrize("short", [[0], list(range(6))])
def test_gather_pads_short_utterances_like_host(hp, buffer, short):
    """An utterance shorter than fixed_length reads zero padding, what the
    host path's collate pads it with; also when every utterance is (the
    padded rows then reach past the longest one)."""
    for i in short:
        buffer[i] = {"mel": buffer[i]["mel"][:6], "wav": buffer[i]["wav"][: 6 * hp.hop_size]}
    corpus = DeviceCorpus(BufferDataset(buffer, hp), hp=hp, device="cpu", log=lambda m: None)
    idx = np.array([0, short[-1]])
    out = corpus.gather(idx, np.zeros(2, np.int64))
    ref = collate([buffer[i] for i in idx], hp)
    np.testing.assert_array_equal(_np(out["mel"]), ref["mel"])
    np.testing.assert_array_equal(_np(out["wav"]), ref["wav"])


def test_weight_gather_and_boundary_drop(hp, buffer):
    """The weight target is gathered in bf16 (its rounding of the float32
    target, exactly) up to `weight_until`, and left out after it."""
    wstep = hp.hop_size // (L // 2)
    corpus = DeviceCorpus(BufferDataset(_with_weights(buffer, hp), hp), hp=hp, L=L,
                          device="cpu", log=lambda m: None)
    out = corpus.gather(np.array([2]), np.array([1]), with_weight=True)
    assert out["weight"].dtype == torch.bfloat16
    assert tuple(out["weight"].shape) == (1, hp.fixed_length * wstep, 16)
    ref = torch.from_numpy(buffer[2]["weight"][wstep: (1 + hp.fixed_length) * wstep])
    torch.testing.assert_close(out["weight"][0], ref.to(torch.bfloat16), rtol=0, atol=0)
    seen = []
    for step, batch in enumerate(corpus.batches(seed=0, batch_size=2, weight_until=2), start=1):
        seen.append("weight" in batch)
        if step == 4:
            break
    assert seen == [True, True, False, False]


def test_sample_crops_distribution(hp, buffer):
    corpus = DeviceCorpus(BufferDataset(buffer, hp), hp=hp, device="cpu", log=lambda m: None)
    rng = np.random.default_rng(0)
    idx = np.arange(6)
    for _ in range(20):
        starts = corpus.sample_crops(rng, idx)
        lens = corpus.frames[idx]
        assert (starts >= 0).all()
        # a crop never reads past the utterance's frames
        assert (starts + hp.fixed_length <= np.maximum(lens, hp.fixed_length)).all()
        # utterances of at most fixed_length + 1 frames start at 0 (crop_item's rule)
        assert (starts[lens <= hp.fixed_length + 1] == 0).all()


def test_epoch_batch_count_matches_host_arithmetic(hp, buffer):
    corpus = DeviceCorpus(BufferDataset(buffer, hp), hp=hp.replace(epochs=1), device="cpu",
                          log=lambda m: None)
    assert sum(1 for _ in corpus.batches(seed=0)) == num_batches_per_epoch(len(buffer), hp)


@pytest.mark.parametrize("start", [1, 3, 5])
def test_a_resumed_stream_goes_on_where_the_unbroken_one_was(hp, buffer, start):
    """`start_step` skips the batches a run before consumed: the stream
    from there is the unbroken stream's tail (crop draws included), across
    epoch boundaries (2 batches an epoch here)."""
    corpus = DeviceCorpus(BufferDataset(_with_weights(buffer, hp), hp), hp=hp.replace(epochs=3),
                          L=L, device="cpu", log=lambda m: None)
    whole = list(corpus.batches(seed=4, weight_until=4))
    tail = list(corpus.batches(seed=4, start_step=start, weight_until=4))
    assert len(tail) == len(whole) - start
    for a, b in zip(whole[start:], tail):
        assert set(a) == set(b)
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=0, atol=0)


def test_device_corpus_batches_equal_jax(hp, buffer):
    """The JAX package's `DeviceCorpus` and the port's, on one corpus with
    weight targets and one seed, cut the same batches bit for bit (mel,
    wav and the bf16 weight), over three epochs (2 batches each) and past
    `weight_until`."""
    import jax
    from fastvocoder_tpu.data.dataset import BufferDataset as JaxBufferDataset
    from fastvocoder_tpu.data.device_cache import DeviceCorpus as JaxDeviceCorpus
    from fastvocoder_tpu.hparams import HP as JHP

    buffer = _with_weights(buffer, hp)
    jhp = JHP.replace(fixed_length=10, batch_size=2, batch_expand_size=2, epochs=3)
    tcorpus = DeviceCorpus(BufferDataset(buffer, hp), hp=hp.replace(epochs=3),
                           L=L, device="cpu", log=lambda m: None)
    jcorpus = JaxDeviceCorpus(JaxBufferDataset(buffer, jhp), hp=jhp, L=L, log=lambda m: None)
    got = list(tcorpus.batches(seed=7, weight_until=3))
    want = list(jcorpus.batches(seed=7, weight_until=3))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(_np(g[k]), np.asarray(jax.device_get(w[k]), np.float32),
                                          err_msg=k)
    assert ["weight" in g for g in got] == [True] * 3 + [False] * 3


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        with annotate("a_step"):
            torch.ones(4).sum()
    assert "a_step" in (tmp_path / "trace.json").read_text()


def test_prefetch_yields_all_batches():
    rng = np.random.default_rng(0)
    batches = [{"mel": rng.standard_normal((2, 4, 8)).astype(np.float32)} for _ in range(5)]
    out = list(prefetch_to_device(iter(batches), "cpu", size=2))
    assert len(out) == 5
    for a, b in zip(out, batches):
        assert isinstance(a["mel"], torch.Tensor)
        np.testing.assert_array_equal(a["mel"].numpy(), b["mel"])


def test_prefetch_propagates_errors():
    def gen():
        yield {"x": np.zeros((1,), np.float32)}
        raise RuntimeError("boom")

    it = prefetch_to_device(gen(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetch_early_exit_unblocks_producer():
    """Abandoning the generator mid-stream (a max_steps return) lets the
    producer thread end instead of blocking on the full queue."""
    n_before = threading.active_count()
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield {"x": np.full((4,), i, np.float32)}

    it = prefetch_to_device(gen(), "cpu", size=2)
    assert float(next(it)["x"][0]) == 0.0
    it.close()  # what GC does when the consumer returns early
    deadline = time.time() + 5.0
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before, "producer thread leaked"
    assert len(produced) < 100, "producer ran the whole stream after close"


def test_prefetch_slow_consumer_sees_end_of_stream():
    """The end of the stream reaches a consumer slower than the producer
    (the queue full when the producer ends)."""
    batches = [{"x": np.full((4,), i, np.float32)} for i in range(4)]
    got, start = [], time.time()
    for b in prefetch_to_device(iter(batches), "cpu", size=2):
        time.sleep(0.2)
        got.append(float(b["x"][0]))
        assert time.time() - start < 30.0, "consumer hung after last batch"
    assert got == [0.0, 1.0, 2.0, 3.0]


def test_prefetch_error_reaches_slow_consumer():
    def gen():
        for i in range(3):
            yield {"x": np.full((4,), i, np.float32)}
        raise RuntimeError("boom")

    it = prefetch_to_device(gen(), "cpu", size=1)
    with pytest.raises(RuntimeError, match="boom"):
        for _ in range(10):
            next(it)
            time.sleep(0.2)


def test_prefetch_and_device_corpus_need_a_card_unless_told_the_cpu(hp, buffer):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(prefetch_to_device(iter([{"x": np.zeros(2)}])))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceCorpus(BufferDataset(buffer, hp), hp=hp, log=lambda m: None)
