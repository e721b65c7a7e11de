"""`make_trainer(remat=True)` (`--remat`) on the CPU: the generator
forward recomputed in the backward computes the step it computes without
remat.

The port's counterpart of `tests/test_trainer.py::test_remat_step_matches_standard`,
for HiFiGAN and Basis-MelGAN (narrow, random init), both step kinds, in
float32 and in bf16 (`compute_dtype=torch.bfloat16`).  On the CPU the
recompute runs the same plain ops in the same order in one torch thread,
so the losses, the gradients before the clip and the parameters after the
step are held equal bit for bit (the JAX test allows XLA's refusion of the
recompute: rtol 1e-5 on losses).  The JAX package's remat step is held
against its standard step by its own test; the port's standard step
against JAX's by `tests/test_torch_trainer.py`.
"""

import numpy as np
import pytest
import torch

from fastvocoder_tpu_torch import hparams as thp
from fastvocoder_tpu_torch.train import trainer as ttrainer

FIXED = 10
HIFI_ARCH = dict(resblock_kernel_sizes=(3, 5), upsample_rates=(8, 5, 3, 2),
                 upsample_initial_channel=32, upsample_kernel_sizes=(16, 10, 6, 4),
                 resblock_dilation_sizes=((1, 3), (1, 3)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    if name == "hifigan":
        return thp.ModelConfig("hifigan", thp.HiFiGANConfig(**HIFI_ARCH), lambda_stft=5.0), None
    basis = (0.1 * np.random.default_rng(3).standard_normal((30, 16))).astype(np.float32)
    return (thp.ModelConfig("basis-melgan", thp.BasisMelGANConfig(out_channels=16,
                                                                  channels=(16, 16, 16)),
                            lambda_stft=1.0), basis)


def _batch(name):
    rng = np.random.default_rng(7)
    mel = torch.from_numpy(rng.standard_normal((2, FIXED, 80)).astype(np.float32))
    wav = torch.from_numpy((0.1 * rng.standard_normal((2, FIXED * 240))).astype(np.float32))
    weight = None
    if name == "basis-melgan":
        weight = torch.from_numpy(rng.random((2, FIXED * 16, 16)).astype(np.float32))
    return mel, wav, weight


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("step", ["pre_adv_step", "gan_step"])
@pytest.mark.parametrize("name", ["hifigan", "basis-melgan"])
def test_remat_step_matches_standard(name, step, dtype):
    cfg, basis = _cfg(name)
    mel, wav, weight = _batch(name)
    outs = []
    for remat in (False, True):
        tr = ttrainer.make_trainer(cfg, hp=thp.HP.replace(fixed_length=FIXED),
                                   basis_signal_weight=basis, disc_cfg=thp.TINY_DISC,
                                   device="cpu", keep_grads=True, compute_dtype=dtype,
                                   remat=remat)
        assert tr.remat == remat
        state = tr.init_state(0)
        _, metrics = getattr(tr, step)(state, mel, wav, weight)
        outs.append((metrics, tr.last_grads, state))
    (m0, g0, s0), (m1, g1, s1) = outs
    assert set(m0) == set(m1)
    for k in m0:
        assert float(m1[k]) == float(m0[k]), k
    assert set(g0) == set(g1) == ({"generator"} if step == "pre_adv_step"
                                  else {"generator", "discriminator"})
    for who in g0:
        for k, g in g0[who].items():
            torch.testing.assert_close(g1[who][k], g, rtol=0, atol=0, msg=f"{who} {k}")
    for a, b in ((s0.generator, s1.generator), (s0.discriminator, s1.discriminator)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            torch.testing.assert_close(w, v, rtol=0, atol=0, msg=k)


def test_remat_recomputes_the_generator_forward():
    """Under remat the generator forward runs once more in the backward:
    its forward hooks count 2 calls a pre-adversarial step, not 1."""
    cfg, _ = _cfg("hifigan")
    mel, wav, _ = _batch("hifigan")
    calls = []
    for remat in (False, True):
        tr = ttrainer.make_trainer(cfg, hp=thp.HP.replace(fixed_length=FIXED),
                                   disc_cfg=thp.TINY_DISC, device="cpu", remat=remat)
        state = tr.init_state(0)
        n = [0]
        state.generator.conv_pre.register_forward_hook(lambda *a: n.__setitem__(0, n[0] + 1))
        tr.pre_adv_step(state, mel, wav)
        calls.append(n[0])
    assert calls == [1, 2]
