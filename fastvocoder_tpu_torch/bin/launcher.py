"""Mode launcher: dispatches on the MODE environment variable (counterpart
of `fastvocoder_tpu/bin/launcher.py`, reference bin/launcher.py:9-19).

    MODE=preprocess python -m fastvocoder_tpu_torch.bin.launcher --data_path ...
    MODE=train python fastvocoder_tpu_torch/bin/launcher.py --model_name ...

Run as a module or by path (it puts the repository's root on `sys.path`).
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)

MODES = ("train", "preprocess", "synthesize", "publish", "test", "evaluation", "serve")


def dispatch(mode, argv=None):
    """Run `mode`'s entry point on `argv` (None: the command line)."""
    from fastvocoder_tpu_torch import bin as entry_points

    run = {
        "train": entry_points.run_train,
        "preprocess": entry_points.run_preprocess,
        "synthesize": entry_points.run_synthesizer,
        "publish": entry_points.run_publisher,
        "test": entry_points.run_test,
        "evaluation": entry_points.run_evaluation,
        "serve": entry_points.run_serve,
    }.get(mode)
    if run is None:
        raise SystemExit(f"unknown MODE={mode!r}; want {'|'.join(MODES)}")
    return run(argv)


if __name__ == "__main__":
    import logging

    logging.basicConfig(level=logging.INFO)
    dispatch(os.getenv("MODE"))
