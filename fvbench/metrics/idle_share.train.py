"""The device: the share of the traced window in which no kernel, copy or
set ran (`torch.profiler`)."""


def read(run):
    return run.idle_share()
