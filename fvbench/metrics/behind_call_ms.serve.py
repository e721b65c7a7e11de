"""Request batching (`serving/batcher.py`): mean milliseconds a request
spent, from its `batcher.submit`, waiting for `batcher.call`s already
running (0 where the worker was waiting or collecting): the cost of the one
serial worker, from the program's spans (`fvbench/spans.py`)."""

from fvbench import spans


def read(run):
    s = spans.slice_of(run)
    return None if s is None else s.behind_call_ms()
