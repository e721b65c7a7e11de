"""Bucketed batching (`models/batched.py`): frames computed for bucket
padding over all frames computed, from the forwards' shapes."""


def read(run):
    return run.pad_share()
