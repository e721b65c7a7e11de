"""The reduction of a device trace to numbers, on a trace written by hand."""

import pytest

from fvbench.trace import WINDOW, reduce


def ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_reduce():
    events = [
        ev("user_annotation", WINDOW, 1000.0, 1000.0),
        # a call on the host clock's [0.0001, 0.0003] s after the anchor: 1100-1300 us
        ev("cuda_runtime", "cudaLaunchKernel", 1150.0, 5.0, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 1250.0, 5.0, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 1500.0, 5.0, correlation=3),  # outside it
        ev("kernel", "void (anonymous namespace)::mrf_pair_kernel<3>(float*)", 1200.0, 100.0,
           correlation=1),
        ev("kernel", "void mrf_mean_kernel(float*)", 1350.0, 100.0, correlation=2),  # after it
        ev("kernel", "void mrf_mean_kernel(float*)", 1400.0, 100.0, correlation=3),  # overlaps
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1900.0, 200.0),  # past the window
        ev("cpu_op", "aten::copy_", 1520.0, 300.0),
        ev("cpu_op", "aten::to", 1510.0, 400.0),
    ]
    s = reduce(events, calls=[(5.0001, 5.0003)], anchor=5.0)
    assert s.window_s == pytest.approx(1e-3)
    # busy: 1200-1300, 1350-1500, 1900-2000 (the copy cut at the window's end)
    assert s.busy_s == pytest.approx(350e-6)
    # kernels launched inside the call, the one that ran after it too
    assert s.span_device_s == pytest.approx(200e-6)
    assert dict(s.device_ops) == pytest.approx({"mrf_pair_kernel": 100e-6,
                                                "mrf_mean_kernel": 200e-6,
                                                "Memcpy_DtoH": 100e-6})
    gaps = dict(s.idle_gaps)
    # 1000-1200 and 1300-1350 have no host event; 1500-1900 is inside aten::copy_
    assert gaps["no_host_event_after_window_start"] == pytest.approx(200e-6)
    assert gaps["no_host_event_after_mrf_pair_kernel"] == pytest.approx(50e-6)
    assert gaps["aten::copy_"] == pytest.approx(400e-6)
