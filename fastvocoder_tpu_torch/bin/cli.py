"""`fastvocoder-torch <mode> [args...]`: the port's console entry point
(counterpart of `fastvocoder_tpu/bin/cli.py`, whose `fastvocoder` script
runs the JAX package):

    fastvocoder-torch preprocess --data_path dataset/ljspeech.txt
    fastvocoder-torch train --model_name basis-melgan --config conf/basis-melgan/light.yaml
    python -m fastvocoder_tpu_torch.bin.cli synthesize --checkpoint_path ckpt.pth.tar ...
"""

from __future__ import annotations

import sys

from fastvocoder_tpu_torch.bin.launcher import MODES, dispatch


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: fastvocoder-torch <{'|'.join(MODES)}> [args...]")
        return 0
    mode, rest = argv[0], argv[1:]
    if mode not in MODES:
        raise SystemExit(f"unknown mode {mode!r}; want one of {MODES}")
    dispatch(mode, rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
