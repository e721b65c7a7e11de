"""Whole step (`train/trainer.py`): the mean `train.step` span, the host's
time to issue one step, from the program's spans.

Read in the profiled slice, so it includes the profiler's cost on the host
(its record of every operator and launch): an upper bound on the untraced
host time, not that time (`fvbench/spans.py`)."""

from fvbench import spans


def read(run):
    s = spans.slice_of(run)
    return None if s is None else s.mean_ms("train.step")
