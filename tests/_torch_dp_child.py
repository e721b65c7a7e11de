"""A rank of a two-process gloo group on the CPU, for the port's data
parallelism tests (`tests/test_torch_distributed.py`,
`tests/test_torch_layers_lastlinear.py`), and the parent's side: `spawn`
starts both ranks and waits for them.

    python tests/_torch_dp_child.py <mode> <work dir>

with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the environment.
Modes:

  * `steps`: each (case, type) of `RUNS` (tiny MelGAN, Basis-MelGAN with the
    weight target, HiFiGAN's GAN step against `TINY_DISC`, NHV, in float32;
    Basis-MelGAN in float64 too) from the state and the global batches in
    `<work dir>/<case>.<type>.npz`, `N_STEPS` steps on this rank's rows, the
    reduced metrics, gradients, clip norms and parameters of every step to
    `<work dir>/<case>.<type>.rank<r>.npz`;
  * `lastlinear`: `LastLinear` in training mode on this rank's rows of
    `<work dir>/lastlinear.npz`, twice, then a backward: outputs, running
    statistics and the parameters' reduced gradients to
    `<work dir>/lastlinear.rank<r>.npz`;
  * `train`: `bin/train.py::run_train` with the arguments of
    `<work dir>/argv.json` (`TINY_DISC`; the TensorBoard writer off), the
    logged history and final step to `<work dir>/train.rank<r>.json`.  With
    CLOCK_AHEAD_S set, this rank's clock runs that many seconds ahead.

Imports neither JAX nor the JAX package: it stands for a rank of a run of
the port, which has neither.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXED, N_STEPS, WORLD = 10, 2, 2
CASES = ("melgan", "basis-melgan", "hifigan", "nhv")
RUNS = tuple((case, "float32") for case in CASES) + (("basis-melgan", "float64"),)
HIFI_ARCH = dict(resblock_kernel_sizes=(3, 5), upsample_rates=(8, 5, 3, 2),
                 upsample_initial_channel=32, upsample_kernel_sizes=(16, 10, 6, 4),
                 resblock_dilation_sizes=((1, 3), (1, 3)))
BASIS_ARCH = dict(out_channels=16, channels=(16, 16, 16))
NHV_ARCH = dict(channels=16, ccep_size=32, fir_taps=17, fft_size=512)


def step_kind(case: str) -> str:
    return "gan_step" if case == "hifigan" else "pre_adv_step"


def model_config(hp, case: str):
    """The case's configuration in `hp`, either package's hparams module."""
    if case == "melgan":
        return hp.ModelConfig("melgan", hp.MelGANConfig(channels=(8, 8, 8, 8, 8)), lambda_stft=1.0)
    if case == "basis-melgan":
        return hp.ModelConfig(case, hp.BasisMelGANConfig(**BASIS_ARCH), lambda_stft=1.0)
    if case == "hifigan":
        return hp.ModelConfig(case, hp.HiFiGANConfig(**HIFI_ARCH), lambda_stft=5.0)
    return hp.ModelConfig(case, hp.NHVConfig(**NHV_ARCH), lambda_stft=5.0)


def basis(case: str):
    if case != "basis-melgan":
        return None
    return (0.1 * np.random.default_rng(3).standard_normal((30, 16))).astype(np.float32)


def global_batch(case: str, step: int, B: int = 2 * WORLD):
    """A seeded global batch of B rows whose halves differ in loudness (the
    first half at 0.1x, the second at 1x), so that a spectral convergence
    computed shard by shard would show: (mel, wav, weight or None)."""
    rng = np.random.default_rng(100 + step)
    mel = rng.standard_normal((B, FIXED, 80)).astype(np.float32)
    t = np.arange(FIXED * 240, dtype=np.float32)
    wav = np.stack([0.3 * np.sin(2 * np.pi * 220 * (i + 1) * t / 24000) for i in range(B)])
    wav = wav + 0.01 * rng.standard_normal(wav.shape)
    wav *= np.where(np.arange(B) < B // 2, 0.1, 1.0)[:, None]
    wav = wav.astype(np.float32)
    weight = None
    if case == "basis-melgan":
        weight = rng.random((B, FIXED * 16, 16)).astype(np.float32)
    if case == "nhv":
        f0 = rng.uniform(150.0, 250.0, (B, FIXED)).astype(np.float32)
        f0[rng.random((B, FIXED)) < 0.2] = 0.0
        mel = np.concatenate([mel, f0[..., None]], axis=-1)
    return mel, wav, weight


def port_trainer(case: str, init: dict, noise=None, dp=None, dtype: str = "float32"):
    """The port's trainer of `case` on the CPU from the state dicts in
    `init` (`gen.*`, `disc.*`), its modules in `dtype`, keeping its
    gradients; `noise` is NHV's draw of a step as `noise[step]` (the global
    batch's)."""
    import torch

    from fastvocoder_tpu_torch import hparams as thp
    from fastvocoder_tpu_torch.train.trainer import make_trainer

    kw = {}
    if noise is not None:
        def draw(step, shape):
            assert tuple(shape) == noise[step].shape, (shape, noise[step].shape)
            return torch.from_numpy(noise[step]).to(getattr(torch, dtype))

        kw["noise"] = draw
    tr = make_trainer(model_config(thp, case), hp=thp.HP.replace(fixed_length=FIXED),
                      basis_signal_weight=basis(case), disc_cfg=thp.TINY_DISC, device="cpu",
                      keep_grads=True, dp=dp, **kw)
    state = tr.init_state(0)
    for prefix, module in (("gen.", state.generator), ("disc.", state.discriminator)):
        module.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in init.items()
                                if k.startswith(prefix)})
        module.to(getattr(torch, dtype))
    return tr, state


def run_steps(case: str, spec: dict, rows: slice, dp=None, dtype: str = "float32") -> dict:
    """`N_STEPS` steps of `case` in `dtype` on `rows` of each global batch of
    `spec`;
    -> {name: array}: per step s the metrics (`m<s>/<name>`, global with
    `dp`), the clip norms (`n<s>/<who>`), the gradients (`g<s>/<who>/<name>`)
    and the parameters after it (`p<s>/<gen|disc>.<name>`)."""
    import torch

    from fastvocoder_tpu_torch.parallel import reduce_metrics

    noise = [spec[f"noise{s}"] for s in range(N_STEPS)] if case == "nhv" else None
    tr, state = port_trainer(case, {k[5:]: v for k, v in spec.items() if k.startswith("init/")},
                             noise, dp, dtype)
    out = {}
    for s in range(N_STEPS):
        args = [torch.from_numpy(spec[f"{k}{s}"][rows]).to(getattr(torch, dtype))
                if f"{k}{s}" in spec else None for k in ("mel", "wav", "weight")]
        _, metrics = getattr(tr, step_kind(case))(state, *args)
        (metrics,) = reduce_metrics([metrics], dp)
        out.update({f"m{s}/{k}": v.numpy() for k, v in metrics.items()})
        out.update({f"n{s}/{k}": v.detach().numpy() for k, v in tr.last_norms.items()})
        out.update({f"g{s}/{who}/{n}": g.numpy() for who, grads in tr.last_grads.items()
                    for n, g in grads.items()})
        for prefix, module in (("gen.", state.generator), ("disc.", state.discriminator)):
            out.update({f"p{s}/{prefix}{k}": v.detach().clone().numpy()
                        for k, v in module.state_dict().items()})
    return out


def lastlinear(spec: dict, rows: slice, dp=None) -> dict:
    """`LastLinear` in training mode from `spec`'s state, two calls on
    `rows` of `spec`'s x0 and x1, then the gradient of sum(y1 * spec's g1)
    (the ranks' mean with `dp`, as a step reduces it); -> outputs, running
    statistics and gradients."""
    import torch

    from fastvocoder_tpu_torch.models.layers import LastLinear

    c, hidden, out_c = (int(v) for v in spec["dims"])
    layer = LastLinear(c, hidden, out_c, train=True, dp=dp)
    layer.load_state_dict({k[5:]: torch.from_numpy(v) for k, v in spec.items()
                           if k.startswith("init/")})
    y0 = layer(torch.from_numpy(spec["x0"][rows]))
    y1 = layer(torch.from_numpy(spec["x1"][rows]))
    params = [p for _, p in layer.named_parameters()]
    grads = torch.autograd.grad((y1 * torch.from_numpy(spec["g1"][rows])).sum(), params)
    if dp is not None:
        grads = dp.all_reduce_mean(grads)
    res = {"y0": y0.detach().numpy(), "y1": y1.detach().numpy()}
    res.update({f"buf/{k}": v.numpy() for k, v in layer.named_buffers()})
    res.update({f"grad/{n}": g.numpy() for (n, _), g in zip(layer.named_parameters(), grads)})
    return res


def main(mode: str, work: str) -> None:
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    from fastvocoder_tpu_torch.parallel import DataParallel, maybe_initialize_distributed

    rank, world = maybe_initialize_distributed("cpu")
    assert world == WORLD, world
    if mode == "train":
        ahead = float(os.environ.get("CLOCK_AHEAD_S", "0"))
        if ahead:
            real = time.time
            time.time = lambda: real() + ahead
        from fastvocoder_tpu_torch.bin import train as train_mod
        from fastvocoder_tpu_torch.hparams import TINY_DISC

        train_mod._make_writer = lambda logdir: train_mod._NoopWriter()
        with open(os.path.join(work, "argv.json")) as f:
            state = train_mod.run_train(json.load(f), disc_cfg=TINY_DISC)
        with open(os.path.join(work, f"train.rank{rank}.json"), "w") as f:
            json.dump({"step": state.step, "history": state.history}, f)
    else:
        dp = DataParallel.current()
        if mode == "lastlinear":
            with np.load(os.path.join(work, "lastlinear.npz")) as z:
                spec = dict(z)
            n = spec["x0"].shape[0] // world
            np.savez(os.path.join(work, f"lastlinear.rank{rank}.npz"),
                     **lastlinear(spec, dp.rows(n), dp))
        else:
            for case, dtype in RUNS:
                with np.load(os.path.join(work, f"{case}.{dtype}.npz")) as z:
                    spec = dict(z)
                n = spec["wav0"].shape[0] // world
                np.savez(os.path.join(work, f"{case}.{dtype}.rank{rank}.npz"),
                         **run_steps(case, spec, dp.rows(n), dp, dtype))
    torch.distributed.destroy_process_group()
    print(f"rank {rank} of {world}: {mode} done", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(mode: str, work: str, env_by_rank=None, timeout: float = 120.0):
    """Run both ranks of `mode` on `work`; -> their outputs.  Raises if a
    rank fails, or kills both and raises when one has not ended within
    `timeout` seconds (a rendezvous or a collective that hangs).  One
    retry with a fresh port, which another process may take between its
    choice and the rendezvous."""
    for attempt in range(2):
        port = _free_port()
        procs = []
        for rank in range(WORLD):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            env.pop("PYTEST_CURRENT_TEST", None)
            env.update((env_by_rank or {}).get(rank, {}))
            procs.append(subprocess.Popen([sys.executable, __file__, mode, work], env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        outputs, deadline = [], time.monotonic() + timeout
        try:
            for p in procs:
                outputs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0]
                               .decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            raise AssertionError(f"{mode}: the ranks did not end within {timeout} s")
        if all(p.returncode == 0 for p in procs):
            return outputs
        in_use = any("address already in use" in o.lower() for o in outputs)
        if not in_use or attempt:
            raise AssertionError(f"{mode}: a rank failed:\n" + "\n".join(
                f"--- rank {r} (exit {p.returncode}):\n{o[-4000:]}"
                for r, (p, o) in enumerate(zip(procs, outputs))))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
