"""The port's span recorder (`runtime/profiler.py`) and the spans of the
request batcher, the bucketed synthesizer, the device corpus and the
trainer, on the CPU.

* Off, the recorder keeps nothing and `annotate` is one shared no-op; on,
  spans nest per thread, a second thread's spans are kept, the buffer is
  bounded, and a running `torch.profiler` turns it on.
* `DynamicBatcher` over `BatchedSynthesizer`: one `synth.group` per
  (bucket, group) with its five children, `batcher.call`'s request ids those
  of the submits, and the counts read from the spans' identifiers (generator
  calls, rows, padding rows, frames computed and useful, requests a call)
  equal to what the benchmark's wrappers (`fvbench/drivers/serve.py::build`)
  derive for `rows_per_forward`, `pad_share` and `batch_rows`.
* `gan_step` and `pre_adv_step`: each phase once a step, in order, under
  `train.step`.
* `trace(logdir)`: the program's spans on the Chrome trace's clock, within
  100 us of a `record_function` opened with them.
"""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.data.device_cache import DeviceCorpus
from fastvocoder_tpu_torch.models.batched import BatchedSynthesizer
from fastvocoder_tpu_torch.runtime import profiler
from fastvocoder_tpu_torch.serving import DynamicBatcher
from fastvocoder_tpu_torch.train import trainer as ttrainer

FIXED = 10


@pytest.fixture(autouse=True)
def clean_recorder():
    profiler.disable()
    profiler.drain()
    yield
    profiler.disable()
    profiler.drain()


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _children(spans, parent):
    return [s for s in sorted(spans, key=lambda s: s.start_ns) if s.parent == parent.id]


def test_off_records_nothing_and_shares_one_noop():
    a, b = profiler.annotate("x"), profiler.annotate("y", step=3)
    assert a is b is profiler._NOOP
    with a, b:
        pass
    rec = profiler.drain()
    assert rec.spans == [] and rec.dropped == 0


def test_nesting_gives_parent_ids_on_each_thread():
    profiler.enable()
    barrier = threading.Barrier(2)

    def nest(tag):
        with profiler.annotate(f"{tag}.outer"):
            barrier.wait(timeout=10)  # both threads' outer spans open at once
            with profiler.annotate(f"{tag}.inner", step=7):
                pass

    th = threading.Thread(target=nest, args=("b",), name="second")
    th.start()
    nest("a")
    th.join(timeout=10)
    assert not th.is_alive()
    by_name = {s.name: s for s in profiler.drain().spans}
    assert set(by_name) == {"a.outer", "a.inner", "b.outer", "b.inner"}
    for tag in "ab":
        outer, inner = by_name[f"{tag}.outer"], by_name[f"{tag}.inner"]
        assert outer.parent == 0 and inner.parent == outer.id
        assert inner.thread == outer.thread and inner.ids == {"step": 7}
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert by_name["a.outer"].thread != by_name["b.outer"].thread


def test_a_second_threads_spans_are_kept():
    profiler.enable()

    def work():
        with profiler.annotate("worker.span", requests=[4, 5]):
            pass

    th = threading.Thread(target=work, name="the-worker")
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    rec = profiler.drain()
    (span,) = rec.spans
    assert span.ids == {"requests": [4, 5]} and span.thread != threading.get_native_id()
    assert rec.threads[span.thread] == "the-worker"
    assert profiler.drain().spans == []  # drained


def test_the_buffer_is_bounded():
    rec = profiler.Recorder(capacity=4)
    rec.on = True
    for i in range(10):
        with profiler._Open(rec, f"s{i}", None):
            pass
    out = rec.drain()
    assert [s.name for s in out.spans] == ["s6", "s7", "s8", "s9"]
    assert out.dropped == 6 and rec.drain().dropped == 0


def test_a_running_profiler_turns_the_recorder_on():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.annotate("profiled"):
            pass
    assert profiler.annotate("after") is profiler._NOOP
    with profiler.annotate("after"):
        pass
    rec = profiler.drain()
    assert [s.name for s in rec.spans] == ["profiled"]


def _forward(hop):
    def forward(mel):
        return mel.mean(-1).repeat_interleave(hop, dim=1)
    return forward


def test_synthesizer_groups_and_batcher_calls():
    """One `synth.group` per (bucket, group), its children in order, under
    `synth.call` under `batcher.call`, whose request ids are the submits'."""
    hop = 3
    synth = BatchedSynthesizer(_forward(hop), samples_per_frame=hop, device=torch.device("cpu"),
                               bucket_frames=8, max_batch=2, batch_pad="pow2")
    batcher = DynamicBatcher(synth, max_batch=4, max_wait_ms=200)
    lengths = (3, 9, 5, 7, 12, 2, 16)
    profiler.enable()
    try:
        futs = [batcher.submit(np.full((T, 4), i, np.float32)) for i, T in enumerate(lengths)]
        outs = [f.result(timeout=30) for f in futs]
    finally:
        batcher.close()
    for i, (o, T) in enumerate(zip(outs, lengths)):
        np.testing.assert_array_equal(o, np.full(T * hop, float(i), np.float32))
    rec = profiler.drain()
    spans = rec.spans
    by_id = {s.id: s for s in spans}
    named = lambda n: [s for s in spans if s.name == n]  # noqa: E731
    submits = {s.ids["request"]: s for s in named("batcher.submit")}
    assert len(submits) == len(lengths)
    calls = named("batcher.call")
    served = [r for c in calls for r in c.ids["requests"]]
    assert sorted(served) == sorted(submits)
    worker = calls[0].thread
    assert all(s.thread == worker for s in named("batcher.wait") + named("batcher.collect"))
    assert all(s.thread == threading.get_native_id() for s in submits.values())
    for c in calls:
        kids = _children(spans, c)
        assert [k.name for k in kids] == ["synth.call", "batcher.resolve"]
        # every request of the call was submitted before the call began
        assert all(submits[r].end_ns <= c.start_ns for r in c.ids["requests"])
    groups = named("synth.group")
    want = 0
    for c in calls:
        per_bucket = {}
        for r in c.ids["requests"]:
            T = lengths[r - min(submits)]
            per_bucket[-(-T // 8) * 8] = per_bucket.get(-(-T // 8) * 8, 0) + 1
        want += sum(-(-n // 2) for n in per_bucket.values())  # max_batch 2 a group
    assert len(groups) == want
    for g in groups:
        assert by_id[g.parent].name == "synth.call"
        assert [k.name for k in _children(spans, g)] == [
            "synth.pad", "synth.h2d", "synth.launch", "synth.d2h", "synth.trim"]
        assert g.ids["bucket"] % 8 == 0 and g.ids["rows"] in (1, 2)
        assert g.ids["utterances"] <= g.ids["rows"]  # pow2: padding rows repeat the last
        assert g.ids["bucket"] - 8 < g.ids["frames"] / g.ids["utterances"] <= g.ids["bucket"]
    assert sum(g.ids["utterances"] for g in groups) == len(lengths)
    assert sum(g.ids["frames"] for g in groups) == sum(lengths)


@pytest.mark.parametrize("batch_pad", ["exact", "pow2"])
def test_counters_equal_the_benchmark_wrappers(batch_pad):
    """The counts read from the program's spans (a `synth.group` a
    generator call, with its rows, utterances and their frames; a
    `batcher.call` with its request ids) give the numbers `fvbench`'s
    wrappers derive for `rows_per_forward.serve`, `pad_share.*` and
    `batch_rows.serve` on the same calls."""
    from fvbench.drivers.serve import build

    hop = 4
    ctx = types.SimpleNamespace(
        mix={"synthesizer": {"bucket_frames": 8, "max_batch": 4, "batch_pad": batch_pad},
             "batcher": {"max_batch": 6, "max_wait_ms": 20.0}},
        record={}, hop=hop, device=torch.device("cpu"))
    _, batcher = build(ctx, _forward(hop))
    rng = np.random.default_rng(0)
    mels = [np.zeros((int(T), 80), np.float32) for T in rng.integers(1, 40, 23)]
    profiler.enable()
    try:
        futs = []
        for m in mels:
            futs.append(batcher.submit(m))
            time.sleep(float(rng.uniform(0, 0.004)))
        for f in futs:
            f.result(timeout=30)
    finally:
        batcher.close()
    spans = profiler.drain().spans
    groups = [s.ids for s in spans if s.name == "synth.group"]
    requests = [len(s.ids["requests"]) for s in spans if s.name == "batcher.call"]
    forwards, rows = len(groups), sum(g["rows"] for g in groups)
    pad_rows = sum(g["rows"] - g["utterances"] for g in groups)
    frames = sum(g["rows"] * g["bucket"] for g in groups)
    useful_frames = sum(g["frames"] for g in groups)
    calls, synth_calls = ctx.record["forward_calls"], ctx.record["synth_calls"]
    length = {id(m): m.shape[0] for m in mels}
    # rows_per_forward.serve
    assert forwards == len(calls) and rows == sum(r for _, _, r, _ in calls)
    assert rows / forwards == sum(r for _, _, r, _ in calls) / len(calls)
    # pad_share: frames computed and the requests' own frames
    computed = sum(r * f for _, _, r, f in calls)
    useful = sum(length[i] for _, ids, _, _ in synth_calls for i in ids)
    assert (frames, useful_frames) == (computed, useful)
    assert pad_rows == rows - len(mels)  # each request is one row
    # batch_rows.serve: requests a synthesize call
    assert len(requests) == len(synth_calls)
    assert sum(requests) / len(requests) == \
        sum(len(ids) for _, ids, _, _ in synth_calls) / len(synth_calls)
    if batch_pad == "exact":
        assert pad_rows == 0


def _hifigan():
    arch = thp.HiFiGANConfig(resblock_kernel_sizes=(3,), upsample_rates=(8, 5, 3, 2),
                             upsample_initial_channel=16, upsample_kernel_sizes=(16, 10, 6, 4),
                             resblock_dilation_sizes=((1,),))
    return thp.ModelConfig("hifigan", arch), None


def _basis():
    basis = (0.1 * np.random.default_rng(3).standard_normal((30, 16))).astype(np.float32)
    return thp.ModelConfig("basis-melgan", thp.BasisMelGANConfig(
        out_channels=16, channels=(16, 16, 16)), lambda_stft=1.0), basis


GEN = ["train.gen_forward", "train.recon_loss", "train.gen_backward", "train.gen_update"]
GAN = ["train.gen_forward", "train.recon_loss", "train.disc", "train.gen_backward",
       "train.gen_update", "train.gen_rerun", "train.disc_forward_loss",
       "train.disc_backward", "train.disc_update"]


@pytest.mark.parametrize("step, make", [("pre_adv_step", _basis), ("gan_step", _hifigan)],
                         ids=["pre_adv_step", "gan_step"])
def test_trainer_phases_cover_each_step_in_order(step, make, one_torch_thread):
    cfg, basis = make()
    tr = ttrainer.make_trainer(cfg, hp=thp.HP.replace(fixed_length=FIXED),
                               basis_signal_weight=basis, disc_cfg=thp.TINY_DISC, device="cpu")
    state = tr.init_state(0)
    rng = np.random.default_rng(7)
    mel = torch.from_numpy(rng.standard_normal((2, FIXED, 80)).astype(np.float32))
    wav = torch.from_numpy((0.1 * rng.standard_normal((2, FIXED * 240))).astype(np.float32))
    weight = (torch.from_numpy(rng.random((2, FIXED * 16, 16)).astype(np.float32))
              if basis is not None else None)
    profiler.enable()
    for _ in range(2):
        getattr(tr, step)(state, mel, wav, weight)
    rec = profiler.drain()
    steps = sorted((s for s in rec.spans if s.name == "train.step"), key=lambda s: s.start_ns)
    assert [s.ids["step"] for s in steps] == [1, 2]
    want = GEN if step == "pre_adv_step" else GAN
    for s in steps:
        kids = _children(rec.spans, s)
        assert [k.name for k in kids] == want
        assert all(k.ids == {"step": s.ids["step"]} for k in kids)
        assert all(s.start_ns <= k.start_ns and k.end_ns <= s.end_ns for k in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    assert len(rec.spans) == 2 * (1 + len(want))


def test_device_corpus_gather_is_a_span_with_its_crops():
    rng = np.random.default_rng(0)
    items = [{"mel": rng.random((T, 80), dtype=np.float32),
              "wav": rng.random(T * 240, dtype=np.float32)} for T in (20, 30, 25)]
    dc = DeviceCorpus(items, hp=thp.HP.replace(fixed_length=FIXED), device="cpu",
                      log=lambda m: None)
    profiler.enable()
    b = dc.gather(np.array([0, 2]), np.array([3, 5]))
    rec = profiler.drain()
    assert b["mel"].shape == (2, FIXED, 80)
    assert [s.name for s in rec.spans] == ["data.gather"]


def test_trace_puts_spans_on_the_trace_clock(tmp_path):
    """A program span and a `record_function` opened together land within
    100 us of each other in the exported trace; the worker thread's span is
    on a track of its own."""
    def work():
        with profiler.annotate("worker.span"):
            time.sleep(0.002)

    with profiler.trace(str(tmp_path)):
        for _ in range(3):
            with profiler.annotate("together"), torch.profiler.record_function("together.rf"):
                torch.ones(8).sum()
        th = threading.Thread(target=work, name="tracked-worker")
        th.start()
        th.join(timeout=10)
    assert profiler.annotate("after") is profiler._NOOP
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = sorted(e["ts"] for e in events if e.get("name") == "together")
    rfs = sorted(e["ts"] for e in events if e.get("name") == "together.rf"
                 and e.get("cat") == "user_annotation")
    assert len(spans) == len(rfs) == 3
    assert max(abs(a - b) for a, b in zip(spans, rfs)) < 100.0
    (w,) = [e for e in events if e.get("name") == "worker.span"]
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name" and e["pid"] == w["pid"]}
    assert names[w["tid"]].startswith("tracked-worker") and w["dur"] >= 2000.0
