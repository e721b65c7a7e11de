"""Entry points: train, preprocess, synthesize, publish, test (RTF),
evaluation and serve, each a `run_*(argv)`; `launcher.py` dispatches on
MODE, `cli.py` on a subcommand."""

from fastvocoder_tpu_torch.bin.evaluation import run_evaluation
from fastvocoder_tpu_torch.bin.preprocess import run_preprocess
from fastvocoder_tpu_torch.bin.publish import run_publisher
from fastvocoder_tpu_torch.bin.serve import run_serve
from fastvocoder_tpu_torch.bin.synthesize import run_synthesizer
from fastvocoder_tpu_torch.bin.test import run_test
from fastvocoder_tpu_torch.bin.train import run_train

__all__ = [
    "run_evaluation",
    "run_preprocess",
    "run_publisher",
    "run_serve",
    "run_synthesizer",
    "run_test",
    "run_train",
]
