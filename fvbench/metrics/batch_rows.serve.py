"""Request batching (`serving/batcher.py`): requests per synthesize call."""


def read(run):
    calls = run.synth_calls
    return sum(len(c[1]) for c in calls) / len(calls) if calls else None
