"""Whole step (`train/trainer.py`): device milliseconds a step of the
discriminators: the kernels launched in `train.disc`,
`train.disc_forward_loss` and `train.disc_backward`; each kernel matched to
its launch, and the launch to the step thread's innermost span
(`fvbench/spans.py`)."""

from fvbench import spans

NAMES = ("train.disc", "train.disc_forward_loss", "train.disc_backward")


def read(run):
    s = spans.slice_of(run)
    return None if s is None else s.step_device_ms(NAMES)
