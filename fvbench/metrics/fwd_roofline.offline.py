"""Generator kernels (`ops/`, `csrc/`, cuDNN): the forwards' roofline bound
over the device time of every kernel launched inside the benchmark's span
around each generator call."""


def read(run):
    return run.forward_roofline()
