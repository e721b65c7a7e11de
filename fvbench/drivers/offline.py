"""Offline synthesis: a batch job's utterances, chunk after chunk, through
the program's bucketed synthesizer (`models/batched.py::BatchedSynthesizer`)
and the served generator's `inference`.

Every chunk holds the same multiset of lengths in another order, so each
does the same work.  `audio_s_per_s` is the audio of the chunks completed in
the window over the window's time, which ends when the last chunk's
waveforms are on the host.  Set-up runs one chunk: the window's shapes
exactly.  After the window, a sample drawn from the seed (one utterance of
every chunk, and the first chunk's longest) is held against the reference.

Mix keys: `lengths`, `mel` (`fvbench/traffic.py`); `chunk` (utterances a
chunk); `synthesizer` {bucket_frames, batch_pad, max_batch}; `check`
{sample}.
"""

from __future__ import annotations

import time

import numpy as np

from fvbench import common, program, traffic
from fvbench.drivers.serve import build, reset


def run(ctx):
    mix = ctx.mix
    n = mix["chunk"]
    pool = traffic.MelPool(mix["mel"], ctx.seed)
    g = traffic.rng(ctx.seed, 5)

    params = ctx.serving_params()
    forward_fn = (ctx.forward_override
                  or program.serving_generator(ctx.cell, params, ctx.device).inference)
    synth, _ = build(ctx, forward_fn, batcher=False)

    def chunk(c):
        Ts = traffic.lengths(mix["lengths"], n, ctx.seed, stream=100 + c)
        return Ts, pool.many(Ts)

    ctx.phase("weights and program")
    synth(chunk(-1)[1])  # set-up: the window's shapes
    common.sync(ctx.device)
    ctx.phase("warm-up")
    reset(ctx.record)

    kept, frames, chunks = {}, 0, 0
    with ctx.window():
        t0 = ctx.t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            Ts, mels = chunk(chunks)
            wavs = synth(mels)
            pick = int(np.argmax(Ts)) if chunks == 0 else int(g.integers(n))
            kept[(chunks, pick)] = (mels[pick], int(Ts[pick]), wavs[pick])
            frames += int(Ts.sum())
            chunks += 1
            ctx.progress = {"frames": frames, "utterances": chunks * n}
            ctx.tick()
        t1 = time.perf_counter()
    ctx.record["useful_frames"] = frames
    ctx.window_done(attempted=chunks * n, failed=0)
    ctx.e2e["audio_s_per_s"] = frames * ctx.hop / ctx.cell.config["sample_rate"] / (t1 - t0)
    del synth, forward_fn
    ctx.free()

    keys = sorted(kept)
    sample = [keys[0]] + [keys[int(i) + 1] for i in g.choice(
        len(keys) - 1, min(mix["check"]["sample"], len(keys)) - 1, replace=False)]
    mels = [kept[k][0] for k in sample]
    Ts = [kept[k][1] for k in sample]
    outputs = {i: kept[k][2] for i, k in enumerate(sample)}
    ctx.checks["wave_err"] = common.served_error(ctx, params, mels, Ts, range(len(sample)),
                                                 outputs)
    return ctx
