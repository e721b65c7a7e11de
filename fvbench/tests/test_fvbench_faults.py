"""The check that decides `correct` fails a broken timed path: each cell kind
is driven on the CPU, past the harness's look for a card, with a fault
planted underneath, and `correct` comes out false; unbroken, true.  The
cells run on one chip, so no exchange between chips can be left out."""

import contextlib
import time

import pytest
import torch

from fastvocoder_tpu_torch.models.basis_melgan import BasisMelGANGenerator
from fastvocoder_tpu_torch.models.hifigan import HiFiGANGenerator
from fastvocoder_tpu_torch.train.trainer import Trainer
from fvbench import control
from fvbench import run as fvrun
from fvbench.tests import tiny

SERVED = {"tiny_hifigan.serve": HiFiGANGenerator, "tiny_basis.offline": BasisMelGANGenerator}
TRAINED = ["tiny_hifigan.train_gan", "tiny_basis.train_pre_adv"]


@pytest.fixture(scope="module")
def reg(tmp_path_factory):
    return tiny.write(str(tmp_path_factory.mktemp("tiny")))


def correct(reg, name: str, seconds: float = 0.3) -> bool:
    cell = reg.cell(name)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # a window's work does not hang on other test processes
    try:
        ctx = fvrun.execute(cell, 2 ** 31 + 101, seconds, False, torch.device("cpu"),
                            time.perf_counter())
    finally:
        torch.set_num_threads(threads)
    return fvrun.result(ctx, reg)["correct"]


@contextlib.contextmanager
def patched(cls, name, make):
    saved = getattr(cls, name)
    setattr(cls, name, make(saved))
    try:
        yield
    finally:
        setattr(cls, name, saved)


def altered(inference):
    """An answer altered where it is produced: the first sample of every
    waveform off by a hundredth of the peak."""
    def wrapped(self, mel):
        y = inference(self, mel).clone()
        y[:, 0] += 0.01 * y.abs().max()
        return y
    return wrapped


def half_rows(inference):
    """Half the batch left out: the rows past the first half come back zero."""
    def wrapped(self, mel):
        y = inference(self, mel).clone()
        y[mel.shape[0] // 2:] = 0
        return y
    return wrapped


def unchanged(step):
    """A step that returns its state unchanged: the losses computed, no
    optimiser step taken."""
    def wrapped(self, state, *args, **kw):
        saved = {id(p): p.detach().clone() for m in (state.generator, state.discriminator)
                 for p in m.parameters()}
        out = step(self, state, *args, **kw)
        with torch.no_grad():
            for m in (state.generator, state.discriminator):
                for p in m.parameters():
                    p.copy_(saved[id(p)])
        return out
    return wrapped


@pytest.mark.parametrize("name", list(SERVED) + TRAINED)
def test_sound_run_is_correct(reg, name):
    assert correct(reg, name)


@pytest.mark.parametrize("fault", [altered, half_rows], ids=["answer_altered", "half_batch"])
@pytest.mark.parametrize("name", list(SERVED))
def test_served_fault_fails(reg, name, fault):
    # a window of several chunks, so that the sample holds rows past a group's first half
    # however busy the host is
    with patched(SERVED[name], "inference", fault):
        assert not correct(reg, name, seconds=2.0)


@pytest.mark.parametrize("name", TRAINED)
def test_half_batch_fails(reg, name):
    with control.half_batch():
        assert not correct(reg, name)


@pytest.mark.parametrize("name", TRAINED)
def test_unchanged_state_fails(reg, name):
    step = "gan_step" if name.endswith("gan") else "pre_adv_step"
    with patched(Trainer, step, unchanged):
        assert not correct(reg, name)
