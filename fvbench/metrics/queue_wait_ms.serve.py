"""Request batching (`serving/batcher.py`): the mean time from a request's
due time to the start of the synthesize call that serves it, from the
benchmark's wrapper around that callable."""


def read(run):
    due = dict(zip(run.record.get("mel_ids", []), run.record.get("due", [])))
    waits = [(t - due[i]) * 1e3 for t, ids, _, _ in run.synth_calls for i in ids if i in due]
    return sum(waits) / len(waits) if waits else None
