"""Request batching (`serving/batcher.py`): share of the traced window in
which the card is idle while the batcher's worker is inside `batcher.call`
(the host's work on the serving path, not the wait for requests), from the
program's spans on the device trace's clock (`fvbench/spans.py`)."""

from fvbench import spans


def read(run):
    s = spans.slice_of(run)
    return None if s is None else s.idle_share_within("batcher.call")
