"""The whole step: the reference's FLOPs of the audio completed in the
traced window, at the utterances' own lengths, over the window at the peak."""


def read(run):
    return run.served_mfu()
