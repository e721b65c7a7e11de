"""Whole step (`train/trainer.py`): device milliseconds a step of the
reconstruction loss: the kernels launched in `train.recon_loss` (the MR-STFT
loss and the weight L1); each kernel matched to its launch, and the launch
to the step thread's innermost span (`fvbench/spans.py`)."""

from fvbench import spans

NAMES = ("train.recon_loss",)


def read(run):
    s = spans.slice_of(run)
    return None if s is None else s.step_device_ms(NAMES)
