"""Input pipeline (`data/device_cache.py`): the mean `data.gather` span, the
host's time to cut a step's crops on the card, from the program's spans.

Read in the profiled slice, so it includes the profiler's cost on the host
(its record of every operator and launch): an upper bound on the untraced
host time, not that time (`fvbench/spans.py`)."""

from fvbench import spans


def read(run):
    s = spans.slice_of(run)
    return None if s is None else s.mean_ms("data.gather")
