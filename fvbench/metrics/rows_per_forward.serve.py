"""Bucketed batching (`models/batched.py`): rows per generator call, pow2
padding rows included, from the benchmark's wrapper around the forward."""


def read(run):
    rows = [c[2] for c in run.calls]
    return sum(rows) / len(rows) if rows else None
