"""Whole step (`train/trainer.py`): device milliseconds a step of the
generator: the kernels launched in `train.gen_forward`, `train.gen_backward`
and `train.gen_rerun`; each kernel matched to its launch, and the launch to
the step thread's innermost span (`fvbench/spans.py`)."""

from fvbench import spans

NAMES = ("train.gen_forward", "train.gen_backward", "train.gen_rerun")


def read(run):
    s = spans.slice_of(run)
    return None if s is None else s.step_device_ms(NAMES)
