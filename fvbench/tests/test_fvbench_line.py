"""The result line has exactly the contract's keys, `checks` last; a run
without a card prints no result and exits non-zero; the process check
compares top-level module names whole."""

import json
import sys
import time

import torch

from fvbench import run as fvrun
from fvbench.tests import tiny
from fvbench.trace import TraceSummary

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def test_result_keys(tmp_path):
    reg = tiny.write(str(tmp_path))
    cell = reg.cell("tiny_basis.offline")
    ctx = fvrun.execute(cell, 7, 0.3, False, torch.device("cpu"), time.perf_counter())
    out = fvrun.result(ctx, reg)
    assert list(out) == KEYS
    assert set(out["device"]) == DEVICE_KEYS
    assert set(out["metrics"]) == {"setup_s", "audio_s_per_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    json.loads(json.dumps(out))

    ctx.trace = True
    ctx.summary = TraceSummary(window_s=1.0, busy_s=0.25, span_device_s=0.1,
                               device_ops=[("k", 0.25)], idle_gaps=[("h", 0.75)])
    ctx.record["traced"] = {"end": 0.0, "progress": ctx.progress, "calls": 2}
    traced = fvrun.result(ctx, reg)
    assert list(traced) == KEYS[:5] + ["breakdown", "checks"]
    assert set(traced["device"]) == DEVICE_KEYS | {"busy_s", "window_s"}
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "audio_s_per_s" not in traced["metrics"]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = fvrun.main(["--workload", "hifigan_large.serve", "--seed", str(2 ** 31 + 3),
                     "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    assert fvrun.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fastvocoder_tpu_torch_like", sys)
    assert fvrun.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fastvocoder_tpu.ops", sys)
    assert fvrun.forbidden_modules() == ["fastvocoder_tpu"]
