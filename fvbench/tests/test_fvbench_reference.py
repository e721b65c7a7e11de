"""The plain reference against the program on the CPU at small widths and
lengths (the program's CPU path is its kernels' plain versions), and the
reference's FLOP count against the analytic one."""

import json
import os

import pytest
import torch

from fvbench import program, weights
from fvbench.reference import basis_melgan, discriminators, flops, hifigan
from fvbench.reference.train import ReferenceTrainer
from fvbench.registry import HERE, Cell
from fvbench.tests.tiny import TINY_DISC


def _cell(tmp_path, name: str, **changes) -> Cell:
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        cfg = dict(json.load(f), discriminator=TINY_DISC, **changes)
    path = os.path.join(str(tmp_path), name + ".json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return Cell(name, name, "t", 1, cfg, path, {}, {}, [], [])


CASES = [("hifigan_large", hifigan, {"upsample_initial_channel": 32}),
         ("basis_melgan_light", basis_melgan, {"channels": [16, 16, 16], "out_channels": 16})]


@pytest.mark.parametrize("name,ref,changes", CASES, ids=[c[0] for c in CASES])
def test_served_forward_matches(tmp_path, name, ref, changes):
    cell = _cell(tmp_path, name, **changes)
    P = weights.make_params(ref, cell.config, 11, "cpu", weight_norm=False)
    gen = program.serving_generator(cell, P, "cpu")
    mel = torch.rand(3, 21, 80, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = gen.inference(mel), ref.inference(P, mel, cell.config)
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("name,ref,changes", CASES, ids=[c[0] for c in CASES])
def test_training_steps_match(tmp_path, name, ref, changes):
    cell = _cell(tmp_path, name, **changes)
    cfg, kind = cell.config, cell.config["reference"]
    trainer, state = program.trainer_and_state(
        cell, weights.make_params(ref, cfg, 4, "cpu"),
        weights.make_params(discriminators, TINY_DISC, 4, "cpu"), "cpu")
    reference = ReferenceTrainer(
        family=ref, disc_family=discriminators, arch=cfg, disc_cfg=TINY_DISC,
        lambda_stft=cfg["lamda_stft"], use_feature_map_loss=cfg["use_feature_map_loss"],
        gen=weights.make_params(ref, cfg, 4, "cpu", grad=True),
        disc=weights.make_params(discriminators, TINY_DISC, 4, "cpu", grad=True))
    g = torch.Generator().manual_seed(2)
    for _ in range(2):
        mel = torch.rand(2, 20, 80, generator=g)
        wav = 0.1 * torch.randn(2, 20 * 240, generator=g)
        if kind == "hifigan":
            _, m = trainer.gan_step(state, mel, wav)
            r = reference.gan_step(mel, wav)
            assert float(m["discriminator_loss"]) == pytest.approx(r["discriminator"], rel=1e-5)
        else:
            w = torch.rand(2, 20 * 16, 16, generator=g)
            _, m = trainer.pre_adv_step(state, mel, wav, weight=w)
            r = reference.pre_adv_step(mel, wav, w)
        assert float(m["total_loss"]) == pytest.approx(r["generator"], rel=1e-5)
    # Adam moves a weight whose gradient is rounding's size by a whole step
    # of either sign, so the parameters are held by their change's norm a
    # leaf, as the benchmark's check holds them
    start = weights.make_params(ref, cfg, 4, "cpu")
    for n, p in state.generator.named_parameters():
        if n.startswith("basis_signal."):
            continue
        got = torch.linalg.vector_norm(p.detach() - start[n])
        want = torch.linalg.vector_norm(reference.gen[n].detach() - start[n])
        assert float(abs(got - want) / want) < 2e-3, n


def test_hifigan_large_flops_against_analytic():
    """HiFiGAN large's served forward: 126 C^2 multiply-adds a sample in each
    MRF stage (C = 256, 128, 64, 32 at 8, 40, 120, 240 samples a frame),
    plus the upsampling convs, conv_pre and conv_post: 249.5 M MACs a
    frame."""
    with open(os.path.join(HERE, "configs", "hifigan_large.json")) as f:
        arch = json.load(f)
    mrf = sum(126 * C * C * n for C, n in ((256, 8), (128, 40), (64, 120), (32, 240)))
    ups = sum(k * cin * cout * n for k, cin, cout, n in
              ((16, 512, 256, 1), (10, 256, 128, 8), (6, 128, 64, 40), (4, 64, 32, 120)))
    macs = mrf + ups + 7 * 80 * 512 + 7 * 32 * 240
    a, b = flops.per_frame(hifigan, arch)
    assert a == pytest.approx(2 * macs, rel=0.01)
    assert abs(b) < 0.01 * a * 64  # the edges of the zero-padded convs
    assert 245e6 < macs < 255e6


def test_reference_imports_nothing_of_the_program():
    import ast

    root = os.path.join(HERE, "reference")
    for name in os.listdir(root):
        if name.endswith(".py"):
            with open(os.path.join(root, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for mod in mods:
                    assert mod.split(".")[0] not in ("fastvocoder_tpu_torch", "fastvocoder_tpu",
                                                     "jax"), (name, mod)
