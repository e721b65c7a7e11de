"""The program's spans on the device trace's clock (`fvbench/spans.py`), on
spans and events written by hand: kernels attributed through their launches
to the step thread's open span, idle time intersected with `batcher.call`,
readers returning None for a program without the recorder, and raising for
one whose recorder kept nothing in the traced slice."""

import types

import pytest

from fastvocoder_tpu_torch.runtime import profiler
from fastvocoder_tpu_torch.runtime.profiler import Recording, Span
from fvbench import spans
from fvbench.registry import Registry
from fvbench.trace import WINDOW

T0 = 5_000_000_000  # the anchor, perf_counter_ns: the window's start, trace us 1000


def span(name, a_us, b_us, thread, sid, parent=0, **ids):
    """A span from `a_us` to `b_us` microseconds after the anchor."""
    return Span(name, T0 + int(a_us * 1e3), T0 + int(b_us * 1e3), thread, sid, parent,
                ids or None)


def window(*events):
    return [("user_annotation", WINDOW, 1000.0, 1000.0, 0)] + list(events)


def launch(at, corr):
    return ("cuda_runtime", "cudaLaunchKernel", at, 5.0, corr)


def kernel(at, dur, corr):
    return ("kernel", "k", at, dur, corr)


def make(span_list, events):
    return spans.ProgramSlice(span_list, T0, T0 + 1_000_000, lambda: iter(events))


def test_kernels_follow_their_launch_to_the_step_threads_span():
    """A backward's kernels are launched from another thread (autograd's);
    each is attributed to the span open on the step's thread at its launch."""
    main = 11
    s = make([span("data.gather", 20, 90, main, 1),
              span("train.step", 100, 900, main, 2, step=1),
              span("train.gen_forward", 110, 300, main, 3, 2, step=1),
              span("train.gen_backward", 300, 700, main, 4, 2, step=1),
              span("train.gen_update", 700, 890, main, 5, 2, step=1)],
             window(launch(1050, 1), launch(1150, 2), launch(1400, 3), launch(1895, 4),
                    launch(1950, 5),
                    kernel(1060, 3, 1), kernel(1200, 10, 2), kernel(1450, 20, 3),
                    kernel(1900, 1, 4), kernel(1960, 7, 5), kernel(1970, 9, 99)))
    steps, by_name, total = s.steps
    assert [x.ids["step"] for x in steps] == [1]
    # launches at 1050-1895 us: from the step's data.gather to its end; the
    # kernel launched after it (1950) and the one with no launch are left out
    assert dict(by_name) == {"data.gather": 3, "train.gen_forward": 10,
                             "train.gen_backward": 20, "train.step": 1}
    assert total == 34
    assert s.step_device_ms(("train.gen_forward", "train.gen_backward")) == pytest.approx(0.03)
    assert s.step_device_ms(("train.disc",)) == 0.0
    assert s.mean_ms("train.step") == pytest.approx(0.8)
    assert s.mean_ms("data.gather") == pytest.approx(0.07)


def test_idle_time_intersected_with_batcher_call():
    worker, load = 21, 22
    s = make([span("batcher.wait", 0, 40, worker, 1),
              span("batcher.collect", 40, 50, worker, 2),
              span("batcher.call", 50, 700, worker, 3, requests=[1, 2]),
              span("synth.call", 60, 690, worker, 4, 3),
              span("batcher.wait", 700, 1000, worker, 5),
              span("batcher.submit", 30, 31, load, 6, request=1),
              span("batcher.submit", 45, 46, load, 7, request=2)],
             window(kernel(1100, 100, 1), kernel(1500, 100, 2)))
    # busy 1100-1200 and 1500-1600 us: idle 1000-1100, 1200-1500, 1600-2000;
    # inside batcher.call (1050-1700): 50 + 300 + 100 us of the 1000-us window
    assert s.idle_share_within("batcher.call") == pytest.approx(45.0)
    assert s.work_thread == worker
    idle = s.idle_by_span()
    assert idle["batcher.wait"] == pytest.approx(40 + 300)
    assert idle["batcher.collect"] == pytest.approx(10)
    assert idle["batcher.call"] == pytest.approx(10 + 10)  # outside synth.call
    assert idle["synth.call"] == pytest.approx(40 + 300 + 90)
    assert idle.get(None, 0.0) == pytest.approx(0.0)
    assert s.idle_share_within("synth.group") is None
    # no call ran while the two requests waited
    assert s.behind_call_ms() == 0.0


def test_a_request_waits_behind_a_running_call():
    w = 31
    s = make([span("batcher.call", 10, 300, w, 1, requests=[1]),
              span("batcher.submit", 100, 101, 32, 2, request=2),
              span("batcher.call", 400, 600, w, 3, requests=[2])], window())
    # request 2: submitted at 101 us, behind the first call until 300 us
    assert s.behind_call_ms() == pytest.approx((300 - 101) / 1e3)


def test_host_ms_per_call_sums_the_group_children_that_do_not_wait():
    w = 41
    s = make([span("synth.group", 0, 100, w, 1, bucket=64, rows=2),
              span("synth.pad", 0, 10, w, 2, 1), span("synth.h2d", 10, 15, w, 3, 1),
              span("synth.launch", 15, 25, w, 4, 1), span("synth.d2h", 25, 95, w, 5, 1),
              span("synth.trim", 95, 100, w, 6, 1)], window())
    assert s.host_ms_per_call() == pytest.approx(0.030)


def test_innermost_segments():
    segs = spans.innermost([(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (6, 8, "d"), (12, 13, "e")])
    assert segs == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 5, "b"), (5, 6, "a"),
                    (6, 8, "d"), (8, 10, "a"), (12, 13, "e")]
    got = spans.by_segment(segs, [(1, 3.5), (9, 14)])
    assert dict(got) == pytest.approx({"a": 2, "b": 1, "c": 0.5, "e": 1, None: 3})


METRICS = ["idle_host_share.serve", "host_ms.train", "gen_device_ms.train",
           "behind_call_ms.serve"]


def traced_run():
    ctx = types.SimpleNamespace(_anchor=T0 / 1e9, _stopped=object())
    return types.SimpleNamespace(ctx=ctx, traced={"end": T0 / 1e9 + 1.0})


@pytest.mark.parametrize("metric", METRICS)
def test_a_reader_without_spans_returns_none(metric, monkeypatch):
    read = Registry.load().reader(metric)
    monkeypatch.delattr(profiler, "drain")
    assert read(traced_run()) is None  # a program without the recorder
    assert read(types.SimpleNamespace(traced=None)) is None  # an untraced run


@pytest.mark.parametrize("metric", METRICS)
def test_a_traced_run_that_recorded_nothing_raises(metric, monkeypatch):
    read = Registry.load().reader(metric)
    # one span, closed before the slice's anchor
    early = Span("batcher.wait", T0 - 2000, T0 - 1000, 1, 1, 0, None)
    monkeypatch.setattr(profiler, "drain", lambda: Recording([early], {}, 0))
    with pytest.raises(RuntimeError, match="no span in the traced slice"):
        read(traced_run())
