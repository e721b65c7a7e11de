"""The port's training entry point (`fastvocoder_tpu_torch/bin/train.py`) on the
CPU: `run_train` over a corpus of 8 utterances in the reference's file
format, a tiny discriminator, a few steps across the
`discriminator_train_start_steps` boundary, checkpoints, a resume that
continues as the unbroken run does, a validation pass, and the flags that
wait.  Then the checkpoint a run wrote loads where a release checkpoint
does (`Synthesizer`, `bin/test.py`, `ServingModel`) and synthesizes what
the trained generator computes; a file of neither format is refused.
MelGAN trains with `--use_mpd 1` (its GAN step against MSD + MFD + MPD),
NHV on the corpus's `<name>.f0.npy` files (f0 packed as mel channel 80,
validation included), and each is then served from its own checkpoint.
"""

import json
import os

import numpy as np
import pytest
import torch

from fastvocoder_tpu_torch.bin.synthesize import Synthesizer
from fastvocoder_tpu_torch.bin.test import run_test
from fastvocoder_tpu_torch.bin.train import WAITING, run_train
from fastvocoder_tpu_torch.data.dataset import (
    BufferDataset,
    WeightDataset,
    batch_iterator,
    collate,
    crop_item,
    load_data_to_buffer,
    num_batches_per_epoch,
    to_device,
)
from fastvocoder_tpu_torch.hparams import HP, TINY_DISC
from fastvocoder_tpu_torch.serving import ServingModel
from fastvocoder_tpu_torch.train.checkpoint import latest_checkpoint

HIFI_YAML = (
    "resblock_kernel_sizes: [3, 5]\nupsample_rates: [8, 5, 3, 2]\n"
    "upsample_initial_channel: 32\nresblock_type: '1'\n"
    "upsample_kernel_sizes: [16, 10, 6, 4]\nresblock_dilation_sizes: [[1, 3], [1, 3]]\n"
    "transposedconv: True\nbias: True\nmultiband: False\nlamda_stft: 5.0\n"
    "use_feature_map_loss: True\n"
)
MELGAN_YAML = (
    "in_channels: 80\nout_channels: 1\nkernel_size: 7\nchannels: [32, 16, 16, 8, 8]\n"
    "upsample_scales: [10, 6, 2, 2]\nstack_kernel_size: 3\nstacks: 3\n"
    "use_weight_norm: True\nuse_causal_conv: False\nlamda_stft: 1.0\n"
)
NHV_YAML = (
    "in_channels: 80\nchannels: 16\nn_layers: 2\nkernel_size: 3\nccep_size: 32\n"
    "fir_taps: 17\nfft_size: 512\nwin_length: 480\nhop_size: 240\nsample_rate: 24000\n"
    "lamda_stft: 5.0\n"
)
CONFS = {"hifigan": "hifigan.yaml", "basis-melgan": "basis.yaml", "melgan": "melgan.yaml",
         "nhv": "nhv.yaml"}
BASIS_YAML = (
    "L: 30\nin_channels: 80\nout_channels: 16\nkernel_size: 7\nchannels: [16, 16, 16]\n"
    "upsample_scales: [4, 4]\nstack_kernel_size: 3\nstacks: 3\nuse_weight_norm: True\n"
    "use_causal_conv: False\ntransposedconv: True\nbias: True\nlamda_stft: 1.0\n"
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs, restored afterwards:
    pytest-xdist runs several test processes side by side, and torch's
    default of a thread a core in each made these small-op tests over 20x
    slower (six processes on eight cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def corpus(tmp_path):
    """8 (wav.npy, mel.npy, f0.npy) triples of 60-100 frames, the two index
    files, Basis-MelGAN weight targets and a basis, four model configs."""
    rng = np.random.default_rng(1)
    audio_idx, mel_idx = [], []
    os.makedirs(tmp_path / "weight")
    for i in range(8):
        frames = int(rng.integers(60, 100))
        wav = (0.3 * np.sin(np.linspace(0, 200, frames * 240))).astype(np.float32)
        np.save(tmp_path / f"{i}.wav.npy", wav)
        np.save(tmp_path / f"{i}.mel.npy", rng.random((80, frames)).astype(np.float32))
        f0 = rng.uniform(150.0, 250.0, frames + 1).astype(np.float32)  # one frame long
        f0[rng.random(frames + 1) < 0.2] = 0.0
        np.save(tmp_path / f"{i}.f0.npy", f0)
        np.save(tmp_path / "weight" / f"{i}.wav.npy",
                rng.random((16, frames * 16)).astype(np.float32))
        audio_idx.append(str(tmp_path / f"{i}.wav.npy"))
        mel_idx.append(str(tmp_path / f"{i}.mel.npy"))
    (tmp_path / "audio.txt").write_text("\n".join(audio_idx) + "\n")
    (tmp_path / "mel.txt").write_text("\n".join(mel_idx) + "\n")
    np.save(tmp_path / "basis_signal_weight.npy",
            (0.1 * rng.standard_normal((30, 16))).astype(np.float32))
    for model, text in (("hifigan", HIFI_YAML), ("basis-melgan", BASIS_YAML),
                        ("melgan", MELGAN_YAML), ("nhv", NHV_YAML)):
        (tmp_path / CONFS[model]).write_text(text)
    return tmp_path


def _conf(model):
    return CONFS[model]


def _argv(corpus, model, run_dir, **kw):
    conf = _conf(model)
    args = {
        "audio_index_path": corpus / "audio.txt", "mel_index_path": corpus / "mel.txt",
        "audio_index_valid_path": corpus / "audio.txt",
        "mel_index_valid_path": corpus / "mel.txt",
        "model_name": model, "config": corpus / conf, "run_dir": run_dir,
        "basis_dataset_path": corpus, "batch_size": 2, "batch_expand_size": 2,
        "fixed_length": 10, "save_step": 4, "valid_step": 4, "valid_num": 2,
        "discriminator_train_start_steps": 2, "device": "cpu", **kw,
    }
    return [f"--{k}={v}" for k, v in args.items()]


def _only_dir(path):
    (name,) = os.listdir(path)
    return path / name


def test_run_train_crosses_the_discriminator_boundary_and_resumes(corpus):
    run_dir = corpus / "run"
    state = run_train(_argv(corpus, "hifigan", run_dir, max_steps=5), disc_cfg=TINY_DISC)
    assert state.step == 5 and state.gen_updates == 5 and state.disc_updates == 3
    history = dict(state.history)
    assert sorted(history) == [1, 2, 3, 4, 5]
    assert set(history[2]) == {"stft_loss", "total_loss"}  # pre-adversarial
    assert set(history[3]) == {"stft_loss", "total_loss", "adversarial_loss",
                               "feature_map_loss", "discriminator_loss"}
    assert all(np.isfinite(v) for m in history.values() for v in m.values())

    logdir = _only_dir(run_dir / "logger")
    assert len((logdir / "total_loss.txt").read_text().splitlines()) == 5
    assert len((logdir / "stft_loss.txt").read_text().splitlines()) == 5
    assert "step [5/" in (logdir / "logger.txt").read_text()
    scalars = json.loads((logdir / "all_scalars.json").read_text())
    assert [s for s, _ in scalars["valid_stft_loss"]] == [4]  # the validation pass
    assert np.isfinite(scalars["valid_stft_loss"][0][1])
    saved = sorted(os.listdir(_only_dir(run_dir / "checkpoint")))
    assert saved == ["checkpoint_4.pth.tar", "checkpoint_5.pth.tar"]  # save_step and the tail

    # a second run, cut at step 3 and resumed from its run directory, ends
    # where the unbroken run did: same batches, same weights
    cut = corpus / "cut"
    run_train(_argv(corpus, "hifigan", cut, max_steps=3), disc_cfg=TINY_DISC)
    resumed = run_train(_argv(corpus, "hifigan", cut, max_steps=5,
                              checkpoint_path=cut / "checkpoint"), disc_cfg=TINY_DISC)
    assert resumed.step == 5 and [s for s, _ in resumed.history] == [4, 5]
    for a, b in ((state.generator, resumed.generator),
                 (state.discriminator, resumed.discriminator)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            torch.testing.assert_close(w, v, rtol=0, atol=0, msg=k)


def test_run_train_basis_melgan_drops_the_weight_target_past_the_boundary(corpus):
    state = run_train(_argv(corpus, "basis-melgan", corpus / "run_b", max_steps=3),
                      disc_cfg=TINY_DISC)
    history = dict(state.history)
    assert "weight_loss" in history[1] and "weight_loss" in history[2]
    assert "weight_loss" not in history[3] and "adversarial_loss" in history[3]
    basis = np.load(corpus / "basis_signal_weight.npy")
    np.testing.assert_array_equal(state.generator.basis_signal.basis.detach().numpy(), basis)


@pytest.mark.parametrize("flag", sorted(WAITING))
def test_a_waiting_flag_raises(corpus, flag):
    with pytest.raises(NotImplementedError, match=flag):
        run_train(_argv(corpus, "hifigan", corpus / "run_w", max_steps=1, **{flag: 1}),
                  disc_cfg=TINY_DISC)


def test_run_train_raises_without_a_card_unless_asked_for_the_cpu(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [a for a in _argv(corpus, "hifigan", corpus / "run_c", max_steps=1)
            if not a.startswith("--device")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_train(argv, disc_cfg=TINY_DISC)


def test_dataset_crops_collates_and_batches(corpus):
    hp = HP.replace(fixed_length=10, batch_size=2, batch_expand_size=2)
    buffer = load_data_to_buffer(str(corpus / "audio.txt"), str(corpus / "mel.txt"),
                                 log=lambda m: None)
    assert len(buffer) == 8 and buffer[0]["mel"].shape[1] == 80
    ds = BufferDataset(buffer, hp)
    item = crop_item(buffer[0], np.random.default_rng(0), hp)
    assert item["mel"].shape == (10, 80) and item["wav"].shape == (2400,)
    short = collate([{"mel": buffer[0]["mel"][:4], "wav": buffer[0]["wav"][:960]}], hp)
    assert short["mel"].shape == (1, 10, 80) and not short["wav"][0, 960:].any()
    batches = list(batch_iterator(ds, hp, seed=3, epoch=0))
    assert len(batches) == num_batches_per_epoch(8, hp) == 4
    again = list(batch_iterator(ds, hp, seed=3, epoch=0))
    np.testing.assert_array_equal(batches[1]["wav"], again[1]["wav"])  # seeded
    assert not np.array_equal(batches[1]["wav"],
                              list(batch_iterator(ds, hp, seed=3, epoch=1))[1]["wav"])

    wds = WeightDataset.from_index_files(str(corpus / "audio.txt"), str(corpus / "mel.txt"), 30,
                                         weight_dir=str(corpus / "weight"), hp=hp)
    wb = next(batch_iterator(wds, hp, seed=0, L=30))
    assert wb["weight"].shape == (2, 160, 16) and wds.mel_length(0) == buffer[0]["mel"].shape[0]
    moved = to_device(wb, torch.device("cpu"))
    assert moved["mel"].dtype == torch.float32 and tuple(moved["wav"].shape) == (2, 2400)


def test_buffer_cache_is_rebuilt_for_another_index(corpus):
    cache = str(corpus / "features.bin")
    logs = []
    first = load_data_to_buffer(str(corpus / "audio.txt"), str(corpus / "mel.txt"), cache,
                                log=logs.append)
    load_data_to_buffer(str(corpus / "audio.txt"), str(corpus / "mel.txt"), cache,
                        log=logs.append)
    assert any("loading buffer" in m for m in logs)
    fewer = load_data_to_buffer(str(corpus / "audio.txt"), str(corpus / "mel.txt"), cache,
                                test_size=3, log=logs.append)
    assert len(first) == 8 and len(fewer) == 3
    assert any("different index" in m for m in logs)


@pytest.mark.parametrize("model", ["hifigan", "basis-melgan"])
def test_a_trained_checkpoint_synthesizes_what_the_trained_generator_computes(corpus, model):
    """A run's checkpoint in `Synthesizer`: its waveform is the trained
    weight-norm generator's within 1e-5 of the peak (weight norm fused in
    float32)."""
    run_dir = corpus / f"trained_{model}"
    state = run_train(_argv(corpus, model, run_dir, max_steps=3, save_step=3),
                      disc_cfg=TINY_DISC)
    path = latest_checkpoint(str(run_dir))
    assert path.endswith("checkpoint_3.pth.tar")
    mel = np.random.default_rng(5).random((23, 80)).astype(np.float32)
    synth = Synthesizer(path, str(corpus / _conf(model)), model, device="cpu")
    assert synth.pattern is None
    got = synth._run(mel)
    with torch.no_grad():
        want = state.generator.eval().inference(torch.from_numpy(mel)[None])[0].numpy()
    assert got.shape == want.shape and np.all(np.isfinite(got))
    peak = np.abs(want).max()
    assert peak > 0 and np.abs(got - want).max() <= 1e-5 * peak


def test_a_trained_checkpoint_serves_and_runs_the_rtf_protocol(corpus):
    run_dir = corpus / "served"
    state = run_train(_argv(corpus, "hifigan", run_dir, max_steps=2, save_step=2),
                      disc_cfg=TINY_DISC)
    path = latest_checkpoint(str(run_dir))
    conf = str(corpus / _conf("hifigan"))
    mel = np.random.default_rng(6).random((32, 80)).astype(np.float32)  # two whole buckets
    (served,) = ServingModel(path, conf, "hifigan", bucket_frames=16, max_batch=2,
                             device="cpu")([mel])
    with torch.no_grad():
        want = state.generator.eval().inference(torch.from_numpy(mel)[None])[0].numpy()
    assert served.shape == want.shape
    assert np.abs(served - want).max() <= 1e-5 * np.abs(want).max()
    mels = corpus / "mels"
    os.makedirs(mels)
    np.save(mels / "a.npy", mel)
    rtf = run_test([f"--checkpoint_path={path}", f"--file_path={mels}", "--model_name=hifigan",
                    f"--config={conf}", "--device=cpu"])
    assert np.isfinite(rtf) and rtf > 0


def test_a_file_of_neither_checkpoint_format_is_refused(corpus):
    conf = str(corpus / _conf("hifigan"))
    npy = corpus / "not_a_checkpoint.npz"  # the extension decides nothing
    np.save(corpus / "plain.npy", np.zeros(3))
    os.replace(corpus / "plain.npy", npy)
    tensor = corpus / "tensor.pth.tar"
    torch.save({"generator": {}}, tensor)
    with pytest.raises(ValueError, match="neither a release checkpoint"):
        Synthesizer(str(npy), conf, "hifigan", device="cpu")
    with pytest.raises(ValueError, match="not a checkpoint of this package's trainer"):
        Synthesizer(str(tensor), conf, "hifigan", device="cpu")
    run_train(_argv(corpus, "basis-melgan", corpus / "run_b", max_steps=1, save_step=1),
              disc_cfg=TINY_DISC)
    with pytest.raises(ValueError, match="holds a 'basis-melgan' model, not 'hifigan'"):
        Synthesizer(latest_checkpoint(str(corpus / "run_b")), conf, "hifigan", device="cpu")


def test_dataset_packs_f0_as_mel_channel_80(corpus):
    hp = HP.replace(batch_size=2, batch_expand_size=2, fixed_length=10)
    buf = load_data_to_buffer(str(corpus / "audio.txt"), str(corpus / "mel.txt"),
                              log=lambda m: None, with_f0=True)
    assert all(item["f0"].shape == (item["mel"].shape[0],) for item in buf)  # cut to the mel
    item = crop_item(buf[0], np.random.default_rng(0), hp)
    batch = collate([item, crop_item(buf[1], np.random.default_rng(1), hp)], hp)
    assert batch["mel"].shape == (2, 10, 81)
    np.testing.assert_array_equal(batch["mel"][0, :, :80], item["mel"])
    np.testing.assert_array_equal(batch["mel"][0, :, 80], item["f0"])
    start = int(np.flatnonzero((buf[0]["mel"] == item["mel"][0]).all(axis=1))[0])
    np.testing.assert_array_equal(item["f0"], buf[0]["f0"][start: start + 10])  # cropped alike


@pytest.mark.parametrize("model,flags", [("melgan", {"use_mpd": 1}), ("nhv", {})])
def test_run_train_melgan_with_the_mpd_and_nhv_with_f0_then_serve(corpus, model, flags):
    """3 steps across the boundary (two pre-adversarial, one GAN step), a
    validation pass; the checkpoint synthesizes, through `Synthesizer`,
    what the trained generator computes, within 1e-5 of the peak."""
    run_dir = corpus / f"run_{model}"
    state = run_train(_argv(corpus, model, run_dir, max_steps=3, save_step=3, valid_step=3,
                            **flags), disc_cfg=TINY_DISC)
    history = dict(state.history)
    assert "adversarial_loss" in history[3] and "adversarial_loss" not in history[2]
    assert all(np.isfinite(v) for m in history.values() for v in m.values())
    assert (state.discriminator.mpd is not None) == (model == "melgan")
    scalars = json.loads((_only_dir(run_dir / "logger") / "all_scalars.json").read_text())
    assert np.isfinite(scalars["valid_stft_loss"][0][1])
    path = latest_checkpoint(str(run_dir))
    assert path.endswith("checkpoint_3.pth.tar")
    synth = Synthesizer(path, str(corpus / _conf(model)), model, device="cpu")
    mel = np.random.default_rng(5).random((23, 80)).astype(np.float32)
    if model == "nhv":
        f0 = np.full(23, 200.0, np.float32)
        got = synth.synthesize(mel, f0=f0)[0]
        cond = np.concatenate([mel, f0[:, None]], axis=1)
    else:
        got, cond = synth.synthesize(mel)[0], mel
    with torch.no_grad():
        want = state.generator.eval().inference(torch.from_numpy(cond)[None])[0].numpy()
    assert got.shape == want.shape == (23 * 240,) and np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
