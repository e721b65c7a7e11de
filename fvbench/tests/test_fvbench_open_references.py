"""A configuration brings its own reference networks by new files.

Each reference module declares the seed stream of its draw (`STREAM`); a
configuration names its generator's reference (`reference`) and its
discriminator's (`disc_reference`, `discriminators` where it names none);
weights of any rank are drawn and weight-normalised alike.  The shipped
cells draw the same bits and count the same FLOPs as before the references
named their own streams (digests and counts taken at commit f1158a2 with
`fvbench/weights.py`'s draw of that commit, on the CPU).  A test-only
generator and a test-only discriminator with a 4-D sub-discriminator go
through the weights, the reference trainer, the FLOP counter and the
control without an edit to any file of the benchmark."""

import hashlib
import json
import math
import os
import re
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from fvbench import common, control, disc_reference_of, reference_of, traffic, weights
from fvbench.drivers import train
from fvbench.reference import basis_melgan, discriminators, flops, hifigan
from fvbench.reference.nn import conv, conv_transpose, effective_weight, leaky, reflect
from fvbench.reference.train import ReferenceTrainer
from fvbench.registry import HERE, Cell
from fvbench.tests.tiny import TINY_DISC

FAMILIES = {"hifigan_large": hifigan, "basis_melgan_light": basis_melgan}

# (leaves, sha256 of every leaf's name, shape and bytes in layout order, first 32 hex digits)
PARENT_DIGESTS = {
    ("hifigan_large", "generator", 0, True): (234, "4429d96b703c011c0420f4c7b97e8da9"),
    ("hifigan_large", "generator", 0, False): (156, "039deb96dd7be5dcc3967c26cb787c4f"),
    ("hifigan_large", "discriminator", 0, True): (108, "ee52f72b3b2eb25250d255222e0c00e6"),
    ("hifigan_large", "generator", 4, True): (234, "89bd134237aefedaf70603792e8683d4"),
    ("hifigan_large", "generator", 4, False): (156, "e4471e05cd9a4af211a241e80b42bae9"),
    ("hifigan_large", "discriminator", 4, True): (108, "2a0be870b0872b1c62754f9b1cf57a9f"),
    ("basis_melgan_light", "generator", 0, True): (64, "2b29acde1f12b82a3b982a66050d43c4"),
    ("basis_melgan_light", "generator", 0, False): (43, "f1532974ec2f6e95e433b6f6edb19416"),
    ("basis_melgan_light", "discriminator", 0, True): (108, "ee52f72b3b2eb25250d255222e0c00e6"),
    ("basis_melgan_light", "generator", 4, True): (64, "9efb6a09dc340375e5c57fe8c03a5891"),
    ("basis_melgan_light", "generator", 4, False): (43, "28b48c993e0f51d29e04cf2db201f90c"),
    ("basis_melgan_light", "discriminator", 4, True): (108, "2a0be870b0872b1c62754f9b1cf57a9f"),
}

# the served forward's (a, b) of a T-frame row, and a training step's FLOPs
PARENT_PER_FRAME = {"hifigan_large": (499082240.0, 0.0), "basis_melgan_light": (45096960.0, 0.0)}
PARENT_STEP = {("hifigan_large", "train_gan"): 13291613564928,
               ("basis_melgan_light", "train_pre_adv"): 1209637273600}


def _read(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def _cell(config: dict, mix: dict) -> Cell:
    return Cell("toy.cell", "toy", "toy", 1, config, "", mix, {}, [], [])


def _digest(P) -> str:
    h = hashlib.sha256()
    for name, t in P.items():
        h.update(name.encode())
        h.update(repr(tuple(t.shape)).encode())
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:32]


# ---- the shipped cells: the same bits and the same counts ----

@pytest.mark.parametrize("key", sorted(PARENT_DIGESTS), ids=lambda k: "-".join(map(str, k)))
def test_shipped_leaves_are_the_parents_bits(key):
    config, net, seed, weight_norm = key
    cfg = _read("configs", config)
    cell = _cell(cfg, {})
    if net == "generator":
        module, sizes = reference_of(cell), cfg
    else:
        module, sizes = disc_reference_of(cell), cfg["discriminator"]
    P = weights.make_params(module, sizes, seed, "cpu", weight_norm=weight_norm)
    assert (len(P), _digest(P)) == PARENT_DIGESTS[key]


@pytest.mark.parametrize("config", sorted(PARENT_PER_FRAME))
def test_shipped_served_flops_are_the_parents(config):
    cfg = _read("configs", config)
    assert flops.per_frame(reference_of(_cell(cfg, {})), cfg) == PARENT_PER_FRAME[config]


@pytest.mark.parametrize("config,mix_name", sorted(PARENT_STEP))
def test_shipped_step_flops_are_the_parents(config, mix_name):
    cfg, mix = _read("configs", config), _read("mixes", mix_name)
    cell = _cell(cfg, mix)
    got = flops.train_step_flops(
        ReferenceTrainer, reference_of(cell), disc_reference_of(cell), cfg, cfg["discriminator"],
        mix["step"], mix["batch"], mix["frames"], cfg["hop_size"], cfg["lamda_stft"],
        cfg["use_feature_map_loss"], cfg["out_channels"] if mix.get("weight_target") else 0)
    assert got == PARENT_STEP[(config, mix_name)]


def test_a_configuration_without_disc_reference_takes_the_composite():
    for config in FAMILIES:
        cfg = _read("configs", config)
        assert "disc_reference" not in cfg
        assert disc_reference_of(_cell(cfg, {})) is discriminators
    assert (hifigan.STREAM, basis_melgan.STREAM, discriminators.STREAM) == (1, 2, 3)


# ---- a test-only generator and discriminator, brought by the configuration ----

HOP = 240
PERIOD_WIDTHS = (4, 8)


def _toy_gen_shapes(arch: dict):
    return {"conv_pre": (8, 80, 3), "up_0": (8, 4, HOP), "conv_post": (1, 4, 3)}


def _toy_gen_forward(P, mel, arch):
    x = leaky(conv(mel.transpose(1, 2), P, "conv_pre", padding=1), 0.1)
    x = leaky(conv_transpose(x, P, "up_0", stride=HOP, padding=0, output_padding=0), 0.1)
    return torch.tanh(conv(x, P, "conv_post", padding=1))[:, 0]


def _toy_disc_shapes(disc: dict):
    shapes = discriminators.param_shapes(disc)
    cin = 1
    for i, c in enumerate(PERIOD_WIDTHS):
        shapes[f"period.conv_{i}"] = (c, cin, 5, 1)
        cin = c
    shapes["period.conv_post"] = (1, cin, 3, 1)
    return shapes


def _conv2d(x, P, name: str, stride=1, padding=0):
    return F.conv2d(x, effective_weight(P, name), P.get(name + ".bias"), stride=stride,
                    padding=padding)


def _period_stack(P, wav, period: int):
    """The waveform folded by its period, (B, 1, T / p, p), through (5, 1)
    convs of stride (3, 1) and a (3, 1) score conv."""
    x = wav[:, None, :]
    pad = -x.shape[-1] % period
    if pad:
        x = reflect(x, 0, pad)
    h = x.view(x.shape[0], 1, -1, period)
    outs = []
    for i in range(len(PERIOD_WIDTHS)):
        h = leaky(_conv2d(h, P, f"period.conv_{i}", stride=(3, 1), padding=(2, 0)), 0.1)
        outs.append(h)
    outs.append(_conv2d(h, P, "period.conv_post", padding=(1, 0)))
    return tuple(outs)


def _toy_disc_forward(P, wav, disc: dict):
    return discriminators.forward(P, wav, disc) + (_period_stack(P, wav, disc["toy_period"]),)


def _module(name: str, **attrs):
    mod = types.ModuleType(f"fvbench.reference.{name}")
    for k, v in attrs.items():
        setattr(mod, k, v)
    return mod


TOY_GEN = _module("toy_gen", param_shapes=_toy_gen_shapes, TRANSPOSED=re.compile(r"up_\d+$"),
                  STREAM=5, forward=_toy_gen_forward, inference=_toy_gen_forward,
                  train_forward=lambda P, mel, arch: (_toy_gen_forward(P, mel, arch), None))
TOY_DISC = _module("toy_disc", param_shapes=_toy_disc_shapes, TRANSPOSED=None, STREAM=7,
                   forward=_toy_disc_forward)
TOY_DISC_CFG = dict(TINY_DISC, toy_period=3)
TOY_CONFIG = {"reference": "toy_gen", "disc_reference": "toy_disc", "hop_size": HOP,
              "sample_rate": 24000, "lamda_stft": 1.0, "use_feature_map_loss": True,
              "discriminator": TOY_DISC_CFG}
TOY_MIX = {"driver": "train", "step": "gan_step", "batch": 2, "frames": 16,
           "corpus": {"utterances": 6, "min_frames": 24, "max_frames": 30}, "check_steps": 3}


@pytest.fixture
def toy(monkeypatch):
    monkeypatch.setitem(sys.modules, "fvbench.reference.toy_gen", TOY_GEN)
    monkeypatch.setitem(sys.modules, "fvbench.reference.toy_disc", TOY_DISC)
    return _cell(dict(TOY_CONFIG), dict(TOY_MIX))


def test_toy_references_are_found_by_the_configuration(toy):
    assert reference_of(toy) is TOY_GEN
    assert disc_reference_of(toy) is TOY_DISC


def test_toy_leaves_names_shapes_gains_and_streams(toy):
    seed = 2 ** 31 + 9
    D = weights.make_params(disc_reference_of(toy), TOY_DISC_CFG, seed, "cpu")
    G = weights.make_params(reference_of(toy), TOY_CONFIG, seed, "cpu")
    shapes = _toy_disc_shapes(TOY_DISC_CFG)
    assert list(D) == [f"{n}.{leaf}" for n in shapes for leaf in ("weight", "bias", "g")]
    assert list(G) == ["conv_pre.weight", "conv_pre.bias", "conv_pre.g", "up_0.weight",
                       "up_0.bias", "up_0.gt", "conv_post.weight", "conv_post.bias",
                       "conv_post.g"]
    for name, shape in shapes.items():
        w = D[name + ".weight"]
        assert tuple(w.shape) == shape and tuple(D[name + ".bias"].shape) == (shape[0],)
        bound = math.prod(shape[1:]) ** -0.5
        assert float(w.abs().max()) <= bound and float(D[name + ".bias"].abs().max()) <= bound
        norm = torch.sqrt(torch.sum(w * w, dim=tuple(range(1, w.dim()))))
        assert torch.equal(D[name + ".g"], norm)
    assert tuple(D["period.conv_1.weight"].shape) == (8, 4, 5, 1)
    assert tuple(G["up_0.bias"].shape) == (4,) and tuple(G["up_0.gt"].shape) == (8,)
    # each network is one draw of its own stream: seed * 4 + STREAM
    for P, module in ((G, TOY_GEN), (D, TOY_DISC)):
        first = next(iter(P.values()))
        raw = torch.rand(first.numel(), generator=torch.Generator().manual_seed(
            seed * 4 + module.STREAM))
        want = raw.view(first.shape).mul(2).sub(1).mul(math.prod(first.shape[1:]) ** -0.5)
        assert torch.equal(first, want)
    # the composite's leaves inside the toy come from the toy's stream, not the composite's
    plain = weights.make_params(discriminators, TINY_DISC, seed, "cpu")
    assert not torch.equal(plain["msd.disc_0.conv_first.weight"],
                           D["msd.disc_0.conv_first.weight"])


def test_toy_weight_norm_of_a_4d_conv_starts_at_the_weight(toy):
    P = weights.make_params(TOY_DISC, TOY_DISC_CFG, 3, "cpu")
    wav = torch.rand(2, 600, generator=torch.Generator().manual_seed(0)) - 0.5
    plain = {k: v for k, v in P.items() if not k.endswith(".g")}
    got = _period_stack(P, wav, 3)
    want = _period_stack(plain, wav, 3)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-5, atol=1e-6)


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def test_toy_flops_count_on_the_meta_device(toy):
    rows, frames = 2, 16
    wav = torch.empty(rows, frames * HOP, device="meta")
    D = weights.meta_params(TOY_DISC, TOY_DISC_CFG, weight_norm=True)
    extra = (_count(lambda: TOY_DISC.forward(D, wav, TOY_DISC_CFG))
             - _count(lambda: discriminators.forward(D, wav, TOY_DISC_CFG)))
    # the period stack alone: 2 * outputs * Cin * KH * KW a conv, the waveform folded by 3
    h, cin, macs = frames * HOP // 3, 1, 0
    for c in PERIOD_WIDTHS:
        h = (h + 4 - 5) // 3 + 1
        macs += rows * c * h * 3 * cin * 5
        cin = c
    macs += rows * 1 * h * 3 * cin * 3
    assert extra == 2 * macs

    args = (TOY_CONFIG, TOY_DISC_CFG, "gan_step", rows, frames, HOP, 1.0, True)
    toy_step = flops.train_step_flops(ReferenceTrainer, TOY_GEN, TOY_DISC, *args)
    plain_step = flops.train_step_flops(ReferenceTrainer, TOY_GEN, discriminators, *args)
    # four forward passes of the discriminator a step, and their backward
    assert toy_step - plain_step > 4 * extra


def test_toy_reference_run_reads_every_leaf(toy):
    ctx = common.Context(cell=toy, seed=2 ** 31 + 21, seconds=0.0, trace=False,
                         device=torch.device("cpu"), t_start=time.perf_counter())
    items = train.corpus(ctx)
    first = {net: control._trained_names(toy, net) for net in ("generator", "discriminator")}
    assert "period.conv_0.g" in first["discriminator"] and "up_0.gt" in first["generator"]
    frames = np.array([it["mel"].shape[0] for it in items])
    stream = traffic.crops(ctx.seed, frames, TOY_MIX["batch"], TOY_MIX["frames"])
    checked = [stream.next() for _ in range(TOY_MIX["check_steps"])]
    got = train.reference_run(ctx, items, checked, True, first)
    assert len(got["losses"]) == 3 and all(len(ls) == 2 for ls in got["losses"])
    for net in first:
        assert set(got["grads"][net]) == set(first[net]) == set(got["change"][net])
    assert got["grads"]["discriminator"]["period.conv_1.weight"] > 0
    assert got["change"]["discriminator"]["period.conv_post.weight"] > 0


def test_toy_control_against_itself_reads_zero_on_the_cpu(toy):
    # the TF32 switch moves nothing on the CPU: the reference against itself
    checks = control.train_control(toy, 2 ** 31 + 22, torch.device("cpu"))
    assert checks == {"first_loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}


# ---- what is refused ----

def test_a_reference_without_stream_is_refused():
    bare = _module("bare", param_shapes=_toy_gen_shapes, TRANSPOSED=None)
    with pytest.raises(AttributeError, match="fvbench.reference.bare"):
        weights.make_params(bare, {}, 0, "cpu")
    with pytest.raises(AttributeError, match="fvbench.reference.bare"):
        weights.meta_params(bare, {}, weight_norm=False)


def test_a_generator_and_discriminator_sharing_a_stream_are_refused(monkeypatch):
    same = _module("same_stream", param_shapes=_toy_disc_shapes, TRANSPOSED=None,
                   STREAM=TOY_GEN.STREAM, forward=_toy_disc_forward)
    monkeypatch.setitem(sys.modules, "fvbench.reference.toy_gen", TOY_GEN)
    monkeypatch.setitem(sys.modules, "fvbench.reference.same_stream", same)
    cell = _cell(dict(TOY_CONFIG, disc_reference="same_stream"), dict(TOY_MIX))
    with pytest.raises(ValueError, match="share the seed stream 5"):
        disc_reference_of(cell)
    with pytest.raises(ValueError, match="share the seed stream"):
        control._trained_names(cell, "discriminator")
