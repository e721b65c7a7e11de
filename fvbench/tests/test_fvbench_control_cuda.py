"""The control on the card: the reference put in the program's place and
computed in TF32 (the precision below float32 with TF32 off) fails the
cell's own limits, while the program passes them, at sizes a test run holds
(widths the kernels take, short mels, four crops).  Needs a card."""

import json
import os
import time

import pytest
import torch

from fvbench import control
from fvbench import run as fvrun
from fvbench.registry import HERE, Registry
from fvbench.tests.tiny import TINY_DISC

pytestmark = pytest.mark.cuda

SHIPPED = {"card_hifigan.serve": ("card_hifigan", "card_serve", "hifigan_large.serve"),
           "card_basis.offline": ("card_basis", "card_offline", "basis_melgan_light.offline"),
           "card_hifigan.train_gan": ("card_hifigan", "card_train_gan",
                                      "hifigan_large.train_gan"),
           "card_basis.train_pre_adv": ("card_basis", "card_train_pre_adv",
                                        "basis_melgan_light.train_pre_adv")}


def _read(kind, name):
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def _write(root, kind, name, obj):
    os.makedirs(os.path.join(root, kind), exist_ok=True)
    with open(os.path.join(root, kind, name + ".json"), "w") as f:
        json.dump(obj, f)


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run only there")
    root = str(tmp_path_factory.mktemp("card"))
    short = {"law": "lognormal", "median": 40, "sigma": 0.45, "min": 20, "max": 90}
    corpus = {"utterances": 8, "min_frames": 40, "max_frames": 50}
    files = {
        ("configs", "card_hifigan"): dict(_read("configs", "hifigan_large"),
                                          upsample_initial_channel=256,
                                          discriminator=TINY_DISC),
        ("configs", "card_basis"): dict(_read("configs", "basis_melgan_light"),
                                        discriminator=TINY_DISC),
        ("mixes", "card_serve"): dict(_read("mixes", "serve"), lengths=short,
                                      check={"sample": 6}),
        ("mixes", "card_offline"): dict(_read("mixes", "offline"), lengths=short, chunk=32,
                                        check={"sample": 6}),
        ("mixes", "card_train_gan"): dict(_read("mixes", "train_gan"), batch=4, frames=32,
                                          corpus=corpus),
        ("mixes", "card_train_pre_adv"): dict(_read("mixes", "train_pre_adv"), batch=4,
                                              frames=32, corpus=corpus),
    }
    for (kind, name), obj in files.items():
        _write(root, kind, name, obj)
    with open(os.path.join(HERE, os.pardir, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"] = []
    for cell, (config, mix, shipped) in SHIPPED.items():
        bench["workloads"].append({"name": cell, "config": config, "traffic": mix, "chips": 1,
                                   "why": "test size"})
        _write(root, "limits", cell, _read("limits", shipped))
    renamed = {shipped: cell for cell, (_, _, shipped) in SHIPPED.items()}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [renamed[w] for w in m["workloads"]]
    return Registry(bench, [root, HERE])


def _correct(reg, name, seed, role):
    cell = reg.cell(name)
    device = torch.device("cuda", 0)
    if role == "control" and cell.mix["driver"] == "train":
        checks = control.train_control(cell, seed, device)
        return all(v <= cell.limits[k] for k, v in checks.items())
    override = control.tf32_forward(cell, seed, device) if role == "control" else None
    ctx = fvrun.execute(cell, seed, 0.5, False, device, time.perf_counter(), override)
    return fvrun.result(ctx, reg)["correct"]


@pytest.mark.parametrize("name", list(SHIPPED))
def test_program_passes_control_fails(card, name):
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        assert _correct(card, name, seed, "program"), seed
        assert not _correct(card, name, seed, "control"), seed
