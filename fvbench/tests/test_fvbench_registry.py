"""A configuration, a traffic mix, a cell's limits and a per-layer metric are
found by name from files of their own: a temporary folder that adds them
runs without an edit to any file of the benchmark."""

import json
import os
import time

import pytest
import torch

from fvbench import run as fvrun
from fvbench.registry import HERE, Registry
from fvbench.tests import tiny
from fvbench.trace import TraceSummary

ROWS_SEEN = '''"""Rows of every generator call, summed."""


def read(run):
    rows = [c[2] for c in run.calls]
    return float(sum(rows)) if rows else None
'''


def test_shipped_cells_resolve():
    reg = Registry.load()
    for w in reg.benchmark["workloads"]:
        cell = reg.cell(w["name"])
        assert cell.mix["driver"] in ("serve", "offline", "train")
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
        for m in cell.per_layer:
            assert callable(reg.reader(m["name"]))
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}


def test_added_files_are_found_by_name(tmp_path):
    reg = tiny.write(str(tmp_path), metric_source=ROWS_SEEN)
    cell = reg.cell("tiny_hifigan.serve")
    assert cell.config_path == os.path.join(str(tmp_path), "configs", "tiny_hifigan.json")
    assert cell.mix["arrivals"]["rate"] == 40.0
    assert "rows_seen.serve" in [m["name"] for m in cell.per_layer]
    # the shipped files are still found beside the added ones
    assert reg.find("mixes", "serve", ".json") == os.path.join(HERE, "mixes", "serve.json")

    ctx = fvrun.execute(cell, 2 ** 31 + 5, 0.5, False, torch.device("cpu"), time.perf_counter())
    ctx.trace = True  # read the per-layer metrics from a stand-in trace
    ctx.summary = TraceSummary(window_s=1.0, busy_s=0.5, span_device_s=0.0)
    ctx.record["traced"] = {"end": ctx.record["done"][-1], "progress": 0, "calls": 3}
    metrics = fvrun.result(ctx, reg)["metrics"]
    # counted over the traced slice: its first three generator calls
    assert metrics["rows_seen.serve"]["value"] == sum(c[2] for c in ctx.record["forward_calls"][:3])
    assert metrics["idle_share.serve"]["value"] == pytest.approx(50.0)
    # a reader with nothing to read leaves its metric out
    assert "fwd_roofline.serve" not in metrics


def test_unknown_names_are_refused(tmp_path):
    reg = tiny.write(str(tmp_path))
    with pytest.raises(KeyError):
        reg.cell("no_such.cell")
    bench = json.loads(json.dumps(reg.benchmark))
    bench["workloads"][0]["traffic"] = "no_such_mix"
    with pytest.raises(FileNotFoundError):
        Registry(bench, reg.roots).cell(bench["workloads"][0]["name"])
