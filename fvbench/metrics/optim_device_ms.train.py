"""Whole step (`train/trainer.py`): device milliseconds a step of the
optimisers: the kernels launched in `train.gen_update` and
`train.disc_update` (the clip and Adam); each kernel matched to its launch,
and the launch to the step thread's innermost span (`fvbench/spans.py`)."""

from fvbench import spans

NAMES = ("train.gen_update", "train.disc_update")


def read(run):
    s = spans.slice_of(run)
    return None if s is None else s.step_device_ms(NAMES)
