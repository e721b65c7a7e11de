"""The whole step: the reference's FLOPs of a training step (forward and
backward, FFTs not counted) times the steps, over the traced window at
the peak."""


def read(run):
    return run.train_mfu()
