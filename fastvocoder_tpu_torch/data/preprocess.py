"""Feature extraction: wav -> (wav.npy, mel.npy[, f0.npy]) and the
train / valid / eval index files.

Counterpart of `fastvocoder_tpu/data/preprocess.py` (reference
bin/preprocess.py): per file, load at 24 kHz unencoded, extract the
normalised mel (`dsp.audio.melspectrogram`), save `<name>.npy` (the wav,
float32) and `<name>.mel.npy` (the mel, float64) into `save_path`, with
`extract_f0` also `<name>.f0.npy`; then shuffle and write the index files
of sizes hp.train_size / valid_size / eval_size.  A file that fails is
reported and left out, as in the JAX package.

The work is split between the host and the device.  A pool's workers (a
`spawn` context: a process that has initialised CUDA cannot fork workers
that use it) decode, resample and, with `extract_f0`, estimate f0, all
numpy / scipy; the parent computes each mel on `device` as the results come
back in order, and writes the files.  Without the pool the parent does all
of it.
"""

from __future__ import annotations

import multiprocessing
import os
import random
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from fastvocoder_tpu_torch import resolve_device
from fastvocoder_tpu_torch.data.dataset import parse_path_file
from fastvocoder_tpu_torch.dsp import audio
from fastvocoder_tpu_torch.dsp.f0 import extract_f0 as _extract_f0
from fastvocoder_tpu_torch.hparams import HP, Hparams

Loaded = Tuple[np.ndarray, Optional[np.ndarray]]


def load_one(wav_filepath: str, hp: Hparams = HP, extract_f0: bool = False) -> Loaded:
    """The host's part of one file: (wav float32, f0 or None)."""
    y = audio.load_wav(wav_filepath, sample_rate=hp.sample_rate, encode=False)
    return y, (_extract_f0(y, hp) if extract_f0 else None)


def _host_job(wav_filepath: str, hp: Hparams, extract_f0: bool) -> Union[Loaded, str]:
    """`load_one` in a worker: its result, or the error's message."""
    try:
        return load_one(wav_filepath, hp, extract_f0)
    except Exception as e:  # noqa: BLE001 - per-file isolation
        return str(e)


def _write_one(loaded: Loaded, mel_filepath: str, new_wav_filepath: str, hp: Hparams,
               device: torch.device) -> int:
    y, f0 = loaded
    mel = audio.melspectrogram(y, hp, device=device)  # (80, T)
    np.save(mel_filepath, mel)
    np.save(new_wav_filepath, y)
    if f0 is not None:  # NHV conditioning (dsp/f0.py)
        np.save(mel_filepath.replace(".mel.npy", ".f0.npy"), f0[: mel.shape[1]])
    return int(mel.shape[1])


def _finish(job, loaded: Union[Loaded, str], hp: Hparams, device: torch.device
            ) -> Optional[int]:
    wav_filepath, mel_filepath, new_wav_filepath = job
    try:
        if isinstance(loaded, str):
            raise RuntimeError(loaded)
        return _write_one(loaded, mel_filepath, new_wav_filepath, hp, device)
    except Exception as e:  # noqa: BLE001 - per-file isolation
        print(f"ERROR processing {wav_filepath}: {e}")
        return None


def extract_one(wav_filepath: str, mel_filepath: str, new_wav_filepath: str, hp: Hparams = HP,
                extract_f0: bool = False, device="cuda") -> Optional[int]:
    """One file, host and device part; -> the mel's frame count, or None
    on failure (reported)."""
    dev = resolve_device(device)
    job = (wav_filepath, mel_filepath, new_wav_filepath)
    return _finish(job, _host_job(wav_filepath, hp, extract_f0), hp, dev)


def preprocess(
    data_path_file: str,
    save_path: str,
    hp: Hparams = HP,
    multiprocess: bool = True,
    max_workers: Optional[int] = None,
    extract_f0: bool = False,
    device="cuda",
) -> Tuple[List[str], List[str]]:
    """Extract features for every wav in the index file; -> (audio_index,
    mel_index) path lists, failed files left out."""
    dev = resolve_device(device)
    os.makedirs(save_path, exist_ok=True)
    jobs = []
    for wav_filepath in parse_path_file(data_path_file):
        wav_filename = os.path.basename(wav_filepath)
        jobs.append((wav_filepath, os.path.join(save_path, f"{wav_filename}.mel.npy"),
                     os.path.join(save_path, f"{wav_filename}.npy")))

    host = partial(_host_job, hp=hp, extract_f0=extract_f0)
    if multiprocess:
        workers = max_workers or max(1, multiprocessing.cpu_count() // 2)
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            loaded = ex.map(host, [job[0] for job in jobs], chunksize=8)
            lengths = [_finish(job, got, hp, dev) for job, got in zip(jobs, loaded)]
    else:
        lengths = [_finish(job, host(job[0]), hp, dev) for job in jobs]

    audio_index, mel_index, ok_lengths = [], [], []
    for (_, mel_fp, new_wav_fp), n in zip(jobs, lengths):
        if n is None:
            continue
        audio_index.append(new_wav_fp)
        mel_index.append(mel_fp)
        ok_lengths.append(n)
    if ok_lengths:
        print(f"min length of mel spectrogram is {min(ok_lengths)}.")
    failed = len(jobs) - len(ok_lengths)
    if failed:
        print(f"WARNING: {failed}/{len(jobs)} files failed feature extraction")
    return audio_index, mel_index


def write_file(audio_index: List[str], mel_index: List[str], index_list, file_name: str,
               audio_index_path: str, mel_index_path: str):
    with open(os.path.join(audio_index_path, file_name), "w", encoding="utf-8") as f:
        for index in index_list:
            f.write(audio_index[index] + "\n")
    with open(os.path.join(mel_index_path, file_name), "w", encoding="utf-8") as f:
        for index in index_list:
            f.write(mel_index[index] + "\n")


def write_splits(audio_index: List[str], mel_index: List[str], audio_index_path: str,
                 mel_index_path: str, hp: Hparams = HP, seed: Optional[int] = None):
    """Shuffled train / valid / eval index files (reference
    bin/preprocess.py:99-107); `seed` makes the shuffle `random.Random(seed)`'s."""
    os.makedirs(audio_index_path, exist_ok=True)
    os.makedirs(mel_index_path, exist_ok=True)
    total = hp.train_size + hp.valid_size + hp.eval_size
    assert len(audio_index) >= total, f"need {total} processed files, have {len(audio_index)}"
    index_list = list(range(total))
    if seed is not None:
        random.Random(seed).shuffle(index_list)
    else:
        random.shuffle(index_list)
    a, b = hp.train_size, hp.train_size + hp.valid_size
    for name, part in (("train", index_list[:a]), ("valid", index_list[a:b]),
                       ("eval", index_list[b:total])):
        write_file(audio_index, mel_index, part, name, audio_index_path, mel_index_path)
