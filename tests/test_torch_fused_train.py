"""`--fused_train 0` in the port (`fastvocoder_tpu_torch/bin/train.py`,
`make_trainer(fused_train=False)`): the training form's residual-stack and
MRF stages run as the modules' library convs instead of the kernels, the
JAX package's `FASTVOCODER_FUSED_TRAIN=0` (`fastvocoder_tpu/ops/
fused_resstack.py:56-100`, `fastvocoder_tpu/models/hifigan.py:41-62`).

On the CPU both values run the modules: the kernels' plain versions are
the modules' own arithmetic, so `run_train --fused_train 0` must give
`-1`'s losses and weights bit for bit; that the flag reaches the stage
modules is checked on the trained generator.  The JAX package's `auto` is
off on the CPU too, so the port-against-JAX trainer tests
(`tests/test_torch_trainer.py` and the others) already hold the port's CPU
module path against JAX's module path; they are not repeated here.  The
card's 0-against-1 steps are in `tests/test_torch_kernels_cuda.py` and
`chip_smoke.py::fused_train_phase`.

`models.layers.stage_runs_kernels`, the one decision, is a function of
the device and the stages alone, so it is checked here for a CUDA device
without a card: the training form under `fused_train=False` takes the
modules, under True the kernels; the fused (inference) form takes the
kernels under either; causal stacks and ResBlock2 blocks take the modules
under both; the CPU takes the modules always.
"""

import pytest
import torch
from test_torch_train_driver import _argv, corpus, one_torch_thread  # noqa: F401

from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.bin import train as train_mod
from fastvocoder_tpu_torch.bin.train import run_train
from fastvocoder_tpu_torch.hparams import TINY_DISC
from fastvocoder_tpu_torch.models.factory import build_generator
from fastvocoder_tpu_torch.models.layers import (
    ResBlock1,
    ResBlock2,
    ResidualStack,
    stage_runs_kernels,
)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The runs here write no TensorBoard events (importing it costs about
    15 s a process); `all_scalars.json` is still written."""
    monkeypatch.setattr(train_mod, "_make_writer", lambda logdir: train_mod._NoopWriter())


def _stage_modules(generator):
    return [m for m in generator.modules() if isinstance(m, (ResidualStack, ResBlock1))]


def _assert_same_run(got, want):
    assert got.history == want.history  # every logged value of every step, bit for bit
    for a, b in ((got.generator, want.generator), (got.discriminator, want.discriminator)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), k


@pytest.mark.parametrize("model", ["hifigan", "basis-melgan", "melgan"])
def test_fused_train_0_gives_the_steps_of_minus_1_on_the_cpu(corpus, model):
    """3 steps across the discriminator boundary (2 pre-adversarial, 1 GAN
    step), a validation pass at step 3: the same losses and weights."""
    runs = {}
    for flag in (0, -1):
        runs[flag] = run_train(_argv(corpus, model, corpus / f"run_{model}_{flag}", max_steps=3,
                                     save_step=3, valid_step=3, fused_train=flag),
                               disc_cfg=TINY_DISC)
    assert [s for s, _ in runs[0].history] == [1, 2, 3]
    assert "discriminator_loss" in dict(runs[0].history)[3]
    _assert_same_run(runs[0], runs[-1])
    for flag, want in ((0, False), (-1, True)):
        stages = _stage_modules(runs[flag].generator)
        assert stages and all(m.fused_train is want and m.weight_norm for m in stages)
        assert not any(stage_runs_kernels(CUDA, [m]) for m in stages) if flag == 0 else \
            all(stage_runs_kernels(CUDA, [m]) for m in stages)


def test_fused_train_0_composes_with_the_runtime_flags_and_resumes(corpus):
    """`--fused_train 0` with `--mixprecision 1 --remat 1 --device_cache 1`
    is `-1`'s run with the same flags; a `--fused_train 0` run cut at step 2
    and resumed from its run directory ends where the unbroken run does,
    its checkpoint loaded into modules built under the switch."""
    flags = dict(mixprecision=1, remat=1, device_cache=1, max_steps=3, save_step=3,
                 valid_step=3)
    runs = {flag: run_train(_argv(corpus, "hifigan", corpus / f"all_{flag}", fused_train=flag,
                                  **flags), disc_cfg=TINY_DISC)
            for flag in (0, -1)}
    _assert_same_run(runs[0], runs[-1])
    assert all(m.fused_train is False and m.compute_dtype == torch.bfloat16
               for m in _stage_modules(runs[0].generator))

    cut = corpus / "cut"
    run_train(_argv(corpus, "hifigan", cut, max_steps=2, fused_train=0), disc_cfg=TINY_DISC)
    resumed = run_train(_argv(corpus, "hifigan", cut, max_steps=3, fused_train=0,
                              checkpoint_path=cut / "checkpoint"), disc_cfg=TINY_DISC)
    unbroken = run_train(_argv(corpus, "hifigan", corpus / "unbroken", max_steps=3,
                               fused_train=0), disc_cfg=TINY_DISC)
    assert [s for s, _ in resumed.history] == [3]
    assert all(m.fused_train is False for m in _stage_modules(resumed.generator))
    assert resumed.history == unbroken.history[2:]
    for (k, v), w in zip(resumed.generator.state_dict().items(),
                         unbroken.generator.state_dict().values()):
        assert torch.equal(v, w), k


def _stack(weight_norm, fused_train, causal=False):
    return ResidualStack(8, weight_norm=weight_norm, fused_train=fused_train,
                         use_causal_conv=causal)


def _block(kind, weight_norm, fused_train):
    return kind(8, kernel_size=3, dilations=(1, 3), weight_norm=weight_norm,
                fused_train=fused_train)


@pytest.mark.parametrize("device", [CUDA, CPU], ids=["cuda", "cpu"])
@pytest.mark.parametrize("weight_norm,fused_train,want", [
    (True, False, False),   # the training form under --fused_train 0: the modules
    (True, True, True),     # the training form under -1 or 1: the kernels
    (False, False, True),   # the inference form: the kernels under either
    (False, True, True),
], ids=["train_0", "train_1", "inference_0", "inference_1"])
@pytest.mark.parametrize("stage", ["stacks", "mrf"])
def test_the_stage_routing(device, weight_norm, fused_train, want, stage):
    if stage == "stacks":
        modules = [_stack(weight_norm, fused_train) for _ in range(3)]
    else:
        modules = [_block(ResBlock1, weight_norm, fused_train) for _ in range(2)]
    assert stage_runs_kernels(device, modules) is (want and device.type == "cuda")


@pytest.mark.parametrize("weight_norm", [True, False], ids=["train", "inference"])
@pytest.mark.parametrize("fused_train", [True, False], ids=["1", "0"])
def test_causal_stacks_and_resblock2_take_the_modules_under_both(weight_norm, fused_train):
    for modules in ([_stack(weight_norm, fused_train, causal=True) for _ in range(3)],
                    [_block(ResBlock2, weight_norm, fused_train) for _ in range(2)],
                    [_stack(weight_norm, fused_train),
                     _stack(weight_norm, fused_train, causal=True)]):
        assert stage_runs_kernels(CUDA, modules) is False


@pytest.mark.parametrize("model", ["hifigan", "multiband-hifigan", "basis-melgan", "melgan"])
def test_build_generator_carries_the_switch_to_every_stage(model):
    """`build_generator(..., fused_train=)` reaches every stage module; the
    inference form (the default, as `Synthesizer` and serving build it)
    keeps the kernels whatever it is given."""
    arch = {"hifigan": thp.HiFiGANConfig(upsample_initial_channel=32),
            "multiband-hifigan": thp.HiFiGANConfig(upsample_initial_channel=32, out_bands=4),
            "basis-melgan": thp.BasisMelGANConfig(out_channels=16, channels=(16, 16, 16)),
            "melgan": thp.MelGANConfig(channels=(32, 16, 16, 8, 8))}[model]
    cfg = thp.ModelConfig(model, arch)
    for weight_norm in (True, False):
        for fused_train in (True, False):
            gen = build_generator(cfg, weight_norm=weight_norm, fused_train=fused_train)
            stages = _stage_modules(gen)
            assert stages and all(m.fused_train is fused_train for m in stages)
            want = fused_train or not weight_norm
            assert all(stage_runs_kernels(CUDA, [m]) is want for m in stages)
    assert all(m.fused_train for m in _stage_modules(build_generator(cfg)))
