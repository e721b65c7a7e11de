"""Bucketed batching (`models/batched.py`): mean host milliseconds a
generator call (`synth.group`) spends in `synth.pad`, `synth.h2d`,
`synth.launch` and `synth.trim` (and `serve.pattern` where the service
subtracts a pattern): the work around a call that does not wait on the
card, from the program's spans.

Read in the profiled slice, so it includes the profiler's cost on the host
(its record of every operator and launch): an upper bound on the untraced
host time, not that time (`fvbench/spans.py`)."""

from fvbench import spans


def read(run):
    s = spans.slice_of(run)
    return None if s is None else s.host_ms_per_call()
