"""Preprocess entry point (counterpart of `fastvocoder_tpu/bin/preprocess.py`,
reference bin/preprocess.py:84-107): extract features for a wav index file
(`data/preprocess.py`: decoding in a pool of host workers, mels on the
device), then write shuffled train / valid / eval index files.  Runs the
mels on CUDA unless `--device cpu`."""

from __future__ import annotations

import argparse
import os

from fastvocoder_tpu_torch.data.preprocess import preprocess, write_splits
from fastvocoder_tpu_torch.hparams import HP


def run_preprocess(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str, default=os.path.join("dataset", "ljspeech.txt"))
    parser.add_argument("--save_path", type=str, default=os.path.join("dataset", "processed"))
    parser.add_argument("--audio_index_path", type=str, default=os.path.join("dataset", "audio"))
    parser.add_argument("--mel_index_path", type=str, default=os.path.join("dataset", "mel"))
    parser.add_argument("--no_multiprocess", action="store_true")
    parser.add_argument("--extract_f0", action="store_true",
                        help="also write <name>.f0.npy (NHV conditioning)")
    parser.add_argument("--train_size", type=int, default=HP.train_size)
    parser.add_argument("--valid_size", type=int, default=HP.valid_size)
    parser.add_argument("--eval_size", type=int, default=HP.eval_size)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the mels are computed: cuda (raises without a GPU) or cpu")
    args = parser.parse_args(argv)

    hp = HP.replace(train_size=args.train_size, valid_size=args.valid_size,
                    eval_size=args.eval_size)
    audio_index, mel_index = preprocess(
        args.data_path, args.save_path, hp, multiprocess=not args.no_multiprocess,
        extract_f0=args.extract_f0, device=args.device)
    write_splits(audio_index, mel_index, args.audio_index_path, args.mel_index_path, hp)


if __name__ == "__main__":
    run_preprocess()
