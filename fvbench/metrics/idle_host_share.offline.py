"""Bucketed batching (`models/batched.py`): share of the traced window in
which the card is idle while the offline cell's loop is inside a synthesize
call (`synth.call`), from the program's spans on the device trace's clock
(`fvbench/spans.py`)."""

from fvbench import spans


def read(run):
    s = spans.slice_of(run)
    return None if s is None else s.idle_share_within("synth.call")
