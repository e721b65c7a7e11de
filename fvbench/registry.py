"""Finds what a cell is made of, by name.

`BENCHMARK.json` names each cell's configuration and traffic mix, and each
per-layer metric.  Everything else is a file of its own under the
benchmark's folder, found by that name:

  configs/<config>.json    the configuration as it is run
  mixes/<traffic>.json     the traffic mix: parameters the drivers read
  limits/<cell>.json       the limits of the numbers that decide `correct`
  metrics/<metric>.py      a per-layer metric's reader: `read(run)`

A configuration names its plain reference networks, modules under
`reference/`: its generator's by `reference`, its discriminator's by
`disc_reference` (`discriminators`, the MSD and MFD, where it names none).
Each reference module declares `param_shapes(cfg)`, `TRANSPOSED` and
`STREAM`, the seed stream of its weights' draw (`weights.py`), which the
generator's and the discriminator's of one configuration may not share; a
generator's adds `inference` and `train_forward`, a discriminator's
`forward(P, wav, disc_cfg)`.

So a later change adds a cell, a configuration, a mix, a metric or a
reference network by adding files and entries, and edits none.  `roots`
lists the folders searched, the first that holds a file winning; the tests
add a temporary one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    config_path: str
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Registry:
    benchmark: dict
    roots: Sequence[str] = field(default_factory=lambda: [HERE])

    @classmethod
    def load(cls, benchmark_path: Optional[str] = None, roots: Sequence[str] = ()) -> "Registry":
        path = benchmark_path or os.path.join(REPO, "BENCHMARK.json")
        return cls(_read_json(path), list(roots) + [HERE])

    def find(self, kind: str, name: str, ext: str) -> str:
        for root in self.roots:
            path = os.path.join(root, kind, name + ext)
            if os.path.isfile(path):
                return path
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: looked for {kind}/{name}{ext} "
                                f"under {list(self.roots)}")

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.benchmark["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in the benchmark; have {sorted(cells)}")
        w = cells[name]
        config_path = self.find("configs", w["config"], ".json")

        def applies(metric: dict) -> bool:
            return "workloads" not in metric or name in metric["workloads"]

        e2e = [m for m in self.benchmark["end_to_end"] if applies(m)]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in self.benchmark["per_layer"]
                     if applies(m) and m["moves"] in reported]
        return Cell(name=name, config_name=w["config"], traffic=w["traffic"], chips=w["chips"],
                    config=_read_json(config_path), config_path=config_path,
                    mix=_read_json(self.find("mixes", w["traffic"], ".json")),
                    limits=_read_json(self.find("limits", name, ".json")),
                    end_to_end=e2e, per_layer=per_layer)

    def reader(self, metric: str):
        """The `read(run) -> float or None` of metrics/<metric>.py."""
        path = self.find("metrics", metric, ".py")
        spec = importlib.util.spec_from_file_location(f"fvbench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
