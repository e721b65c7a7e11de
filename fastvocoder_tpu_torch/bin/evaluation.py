"""Evaluation entry point: objective metrics over the eval split.

Counterpart of `fastvocoder_tpu/bin/evaluation.py` (the reference's own
evaluation script is broken): synthesize every eval item with a checkpoint
(`Synthesizer`, 64-frame buckets), compare it with the ground truth, and
report per item and on average the MR-STFT distance (spectral convergence
plus log-magnitude L1 at the training resolutions, `losses/stft_loss.py`,
on the device), the waveform L1 and the mel-cepstral distortion (the port's
`melspectrogram` on the device, `scipy.fftpack.dct` on the host).  Runs on
CUDA unless `--device cpu`:

  python -m fastvocoder_tpu_torch.bin.evaluation --checkpoint_path ckpt.pth.tar \\
      --model_name hifigan --config conf/hifigan/light.yaml \\
      --audio_index_path dataset/audio/eval --mel_index_path dataset/mel/eval
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
from scipy.fftpack import dct

from fastvocoder_tpu_torch.bin.synthesize import Synthesizer
from fastvocoder_tpu_torch.data.dataset import parse_path_file
from fastvocoder_tpu_torch.dsp import audio
from fastvocoder_tpu_torch.dsp.f0 import extract_f0
from fastvocoder_tpu_torch.hparams import HP
from fastvocoder_tpu_torch.losses.stft_loss import multi_resolution_stft_loss

METRICS = ("mr_stft", "spectral_convergence", "log_mag_l1", "wav_l1", "mcd_db")


def load_data(audio_index_path, mel_index_path, index_list, with_f0=False):
    """The indexed items' (audio_list, mel_list[, f0_list]) as float32
    arrays; with `with_f0` (NHV) each mel's `<name>.f0.npy`, else f0
    extracted from its audio."""
    audio_index = parse_path_file(audio_index_path)
    mel_index = parse_path_file(mel_index_path)
    audio_list, mel_list, f0_list = [], [], []
    for index in index_list:
        audio_list.append(np.load(audio_index[index]).astype(np.float32))
        mel_list.append(np.load(mel_index[index]).astype(np.float32))
        if with_f0:
            f0_path = mel_index[index].replace(".mel.npy", ".f0.npy")
            if os.path.exists(f0_path):
                f0_list.append(np.load(f0_path).astype(np.float32))
            else:
                f0_list.append(extract_f0(audio_list[-1]))
    if with_f0:
        return audio_list, mel_list, f0_list
    return audio_list, mel_list


def mel_cepstral_distortion(est: np.ndarray, ref: np.ndarray, hp=HP, n_mcc: int = 13,
                            device="cuda") -> float:
    """MCD in dB: the mean Euclidean distance between mel-cepstral vectors
    (DCT-II of the normalised log-mel, c1..c_{n_mcc}, c0 left out), times
    10 sqrt(2) / ln 10."""

    def mcc(wav):
        mel = audio.melspectrogram(wav, hp, device=device).T  # (T, 80)
        return dct(mel, type=2, axis=1, norm="ortho")[:, 1 : n_mcc + 1]

    a, b = mcc(est), mcc(ref)
    t = min(a.shape[0], b.shape[0])
    dist = np.sqrt(np.sum((a[:t] - b[:t]) ** 2, axis=1))
    return float((10.0 * np.sqrt(2.0) / np.log(10.0)) * dist.mean())


def evaluate(synthesizer: Synthesizer, audio_list, mel_list, hp=HP, f0_list=None):
    """-> a list of per-item metric dicts (the JAX package's keys)."""
    dev = synthesizer.device
    results = []
    for i, (wav, mel) in enumerate(zip(audio_list, mel_list)):
        if mel.shape[0] == hp.num_mels:  # (80, T) -> (T, 80)
            mel = mel.T
        f0 = f0_list[i] if f0_list else None
        _, est_remove, _ = synthesizer.synthesize(mel, f0=f0)
        n = min(est_remove.shape[0], wav.shape[0])
        est_c, wav_c = est_remove[:n], wav[:n]
        with torch.inference_mode():
            sc, mag = multi_resolution_stft_loss(torch.from_numpy(est_c)[None].to(dev),
                                                 torch.from_numpy(wav_c)[None].to(dev))
        results.append({
            "mr_stft": float(sc) + float(mag),
            "spectral_convergence": float(sc),
            "log_mag_l1": float(mag),
            "wav_l1": float(np.mean(np.abs(est_c - wav_c))),
            "mcd_db": mel_cepstral_distortion(est_c, wav_c, hp, device=dev),
            "frames": int(mel.shape[0]),
        })
    return results


def run_evaluation(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", type=str, required=True)
    parser.add_argument("--model_name", type=str, required=True,
                        help="basis-melgan, hifigan, multiband-hifigan, melgan or nhv")
    parser.add_argument("--config", type=str, required=True,
                        help="path to model configuration file")
    parser.add_argument("--audio_index_path", type=str,
                        default=os.path.join("dataset", "audio", "eval"))
    parser.add_argument("--mel_index_path", type=str,
                        default=os.path.join("dataset", "mel", "eval"))
    parser.add_argument("--num_items", type=int, default=6,
                        help="evaluate the first N eval items (the reference used 6)")
    parser.add_argument("--output", type=str, default="", help="optional JSON results file")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    synthesizer = Synthesizer(args.checkpoint_path, args.config, args.model_name, HP,
                              bucket_frames=64, device=args.device)
    n = min(args.num_items, len(parse_path_file(args.audio_index_path)))
    is_nhv = args.model_name == "nhv"
    loaded = load_data(args.audio_index_path, args.mel_index_path, list(range(n)),
                       with_f0=is_nhv)
    results = evaluate(synthesizer, loaded[0], loaded[1], f0_list=loaded[2] if is_nhv else None)
    summary = {k: float(np.mean([r[k] for r in results])) for k in METRICS}
    for i, r in enumerate(results):
        print(f"item {i}: " + " ".join(f"{k}={v:.4f}" for k, v in r.items()))
    print("mean: " + " ".join(f"{k}={v:.4f}" for k, v in summary.items()))
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"items": results, "mean": summary}, f, indent=2)
    return summary


if __name__ == "__main__":
    run_evaluation()
