"""A benchmark at CPU sizes, written as files of their own into a temporary
folder and found by name, as a later change adds a configuration, a mix, a
cell's limits or a metric: the shipped configurations with their widths cut
and the shipped mixes with their sizes cut."""

from __future__ import annotations

import json
import os

from fvbench.registry import HERE, Registry

TINY_DISC = {"msd_scales": 2, "msd_channels": 4, "msd_max_channels": 32,
             "msd_downsample_scales": [4, 4], "mfd_fft_sizes": [256], "mfd_hop_sizes": [64],
             "mfd_win_lengths": [128], "mfd_channels": 8, "mfd_max_channels": 32,
             "mfd_downsample_scales": [4]}

CELLS = {
    "tiny_hifigan.serve": ("tiny_hifigan", "tiny_serve", {"wave_err": 1e-5}),
    "tiny_basis.offline": ("tiny_basis", "tiny_offline", {"wave_err": 1e-5}),
    "tiny_hifigan.train_gan": ("tiny_hifigan", "tiny_train_gan",
                               {"first_loss_gap": 1e-5, "grad_gap": 5e-3, "change_gap": 5e-2}),
    "tiny_basis.train_pre_adv": ("tiny_basis", "tiny_train_pre_adv",
                                 {"first_loss_gap": 1e-5, "grad_gap": 5e-3, "change_gap": 5e-2}),
}


def _read(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def _write(root: str, kind: str, name: str, obj) -> None:
    os.makedirs(os.path.join(root, kind), exist_ok=True)
    with open(os.path.join(root, kind, name), "w") as f:
        f.write(obj if isinstance(obj, str) else json.dumps(obj))


def write(root: str, metric_source: str = "") -> Registry:
    """The tiny benchmark under `root`; with `metric_source`, one more
    per-layer metric, `rows_seen.serve`, read by that source."""
    hifi = dict(_read("configs", "hifigan_large"), upsample_initial_channel=32,
                discriminator=TINY_DISC)
    basis = dict(_read("configs", "basis_melgan_light"), channels=[16, 16, 16], out_channels=16,
                 discriminator=TINY_DISC)
    short = {"law": "lognormal", "median": 12, "sigma": 0.45, "min": 8, "max": 40}
    serve = dict(_read("mixes", "serve"), lengths=short,
                 arrivals={"process": "poisson", "rate": 40.0}, check={"sample": 4})
    serve["synthesizer"] = dict(serve["synthesizer"], bucket_frames=8, max_batch=4)
    offline = dict(_read("mixes", "offline"), lengths=short, chunk=8, check={"sample": 8})
    offline["synthesizer"] = dict(offline["synthesizer"], bucket_frames=8, max_batch=4)
    corpus = {"utterances": 6, "min_frames": 24, "max_frames": 30}
    train_gan = dict(_read("mixes", "train_gan"), batch=2, frames=16, corpus=corpus)
    train_pre = dict(_read("mixes", "train_pre_adv"), batch=2, frames=16, corpus=corpus)
    for kind, name, obj in (("configs", "tiny_hifigan", hifi), ("configs", "tiny_basis", basis),
                            ("mixes", "tiny_serve", serve), ("mixes", "tiny_offline", offline),
                            ("mixes", "tiny_train_gan", train_gan),
                            ("mixes", "tiny_train_pre_adv", train_pre)):
        _write(root, kind, name + ".json", obj)
    with open(os.path.join(HERE, os.pardir, "BENCHMARK.json")) as f:
        bench = json.load(f)
    renamed = {"hifigan_large.serve": "tiny_hifigan.serve",
               "basis_melgan_light.offline": "tiny_basis.offline",
               "hifigan_large.train_gan": "tiny_hifigan.train_gan",
               "basis_melgan_light.train_pre_adv": "tiny_basis.train_pre_adv"}
    bench["workloads"] = []
    for cell, (config, mix, limits) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": config, "traffic": mix, "chips": 1,
                                   "why": "CPU size"})
        _write(root, "limits", cell + ".json", limits)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [renamed[w] for w in m["workloads"]]
    if metric_source:
        _write(root, "metrics", "rows_seen.serve.py", metric_source)
        bench["per_layer"].append({"name": "rows_seen.serve", "unit": "rows", "better": "higher",
                                   "source": "program_counter", "layer": "bucketed batching",
                                   "moves": "latency_p95_ms",
                                   "workloads": ["tiny_hifigan.serve"]})
    return Registry(bench, [root, HERE])
