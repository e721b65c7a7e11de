"""Open-loop serving: requests due on a schedule, through the program's
request batcher (`serving/batcher.py::DynamicBatcher`) into its bucketed
synthesizer (`models/batched.py::BatchedSynthesizer`) and the served
generator's `inference`.

A load thread submits each request at its due time and records how late it
ran.  A request is timed from its due time until its waveform is back on
the host (the batcher resolves its future after the synthesizer returned
numpy arrays); one that fails or is refused counts as over every limit.
`latency_p95_ms` is the 95th percentile over every request due in the
window.  After the window, a sample drawn from the seed, the longest
request in it, is held against the reference: each mel zero-padded to its
bucket as the service pads it, the plain forward, the waveform trimmed to
its frames.

Mix keys: `lengths`, `arrivals`, `mel` (`fvbench/traffic.py`); `batcher`
{max_batch, max_wait_ms}; `synthesizer` {bucket_frames, batch_pad,
max_batch}; `check` {sample}.  Set-up warms every group size the
synthesizer can run at every bucket the length law reaches.
"""

from __future__ import annotations

import threading
import time
from functools import partial

import numpy as np
import torch

from fastvocoder_tpu_torch.models.batched import BatchedSynthesizer
from fastvocoder_tpu_torch.serving.batcher import DynamicBatcher, QueueFull
from fvbench import common, program, traffic

FAILED_MS = 3.6e6  # a failed request's latency: over every limit
DRAIN_S = 60.0


def reset(rec: dict) -> None:
    """Empty the counters the wrappers keep (after set-up)."""
    rec.update(forward_calls=[], synth_calls=[])


def build(ctx, forward_fn, batcher: bool = True):
    """The program's synthesizer (and with `batcher` its request batcher)
    around `forward_fn`, with the benchmark's counting wrappers."""
    syn_cfg = ctx.mix["synthesizer"]
    rec = ctx.record
    reset(rec)

    def forward(mel: torch.Tensor) -> torch.Tensor:
        t = time.perf_counter()
        out = forward_fn(mel)
        rec["forward_calls"].append((t, time.perf_counter(), mel.shape[0], mel.shape[1]))
        return out

    synth = BatchedSynthesizer(forward, samples_per_frame=ctx.hop, device=ctx.device,
                               bucket_frames=syn_cfg["bucket_frames"],
                               max_batch=syn_cfg["max_batch"], batch_pad=syn_cfg["batch_pad"])

    def synthesize(mels):
        t, first = time.perf_counter(), len(rec["forward_calls"])
        out = synth(mels)
        # its start, its requests, and the generator calls it made
        rec["synth_calls"].append((t, [id(m) for m in mels], first, len(rec["forward_calls"])))
        return out

    if not batcher:
        return synthesize, None
    bat_cfg = ctx.mix["batcher"]
    return synth, DynamicBatcher(synthesize, max_batch=bat_cfg["max_batch"],
                                 max_wait_ms=bat_cfg["max_wait_ms"])


def group_sizes(syn_cfg: dict) -> list:
    """The rows a group can run at: the synthesizer's own rule
    (`models/batched.py::BatchedSynthesizer._group_size`) worked out again."""
    m = syn_cfg["max_batch"]
    if syn_cfg["batch_pad"] == "exact":
        return list(range(1, m + 1))
    return sorted({min(1 << (k - 1).bit_length(), m) for k in range(1, m + 1)})


def warm(ctx, synth, Ts) -> None:
    """Every (bucket, rows) shape the window can meet."""
    syn_cfg = ctx.mix["synthesizer"]
    for Tb in sorted({traffic.bucket(int(T), syn_cfg["bucket_frames"]) for T in Ts}):
        for rows in group_sizes(syn_cfg):
            synth([np.zeros((Tb, 80), np.float32)] * rows)
    common.sync(ctx.device)


def offer(ctx, batcher, mels, due_rel, keep):
    """Submit each request at its due time; -> per request (due, done or
    None, failed), the load thread's lateness, the backlog after one second
    and at the window's end, and the kept futures."""
    n = len(mels)
    done = [None] * n
    failed = [False] * n
    late = np.zeros(n)
    kept = {}
    completed = [0]
    backlog = {}

    def on_done(i, fut):
        done[i] = time.perf_counter()
        completed[0] += 1
        if fut.exception() is not None:
            failed[i] = True

    t0 = ctx.t0 = time.perf_counter() + 0.05
    due = t0 + due_rel

    def load():
        for i in range(n):
            wait = due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            if "1s" not in backlog and due[i] - t0 >= 1.0:
                backlog["1s"] = i - completed[0]
            late[i] = time.perf_counter() - due[i]
            try:
                fut = batcher.submit(mels[i])
            except QueueFull:
                failed[i] = True
                done[i] = time.perf_counter()
                completed[0] += 1
                continue
            if i in keep:
                kept[i] = fut
            fut.add_done_callback(partial(on_done, i))
        backlog["end"] = n - completed[0]

    thread = threading.Thread(target=load, name="fvbench-load")
    thread.start()
    while thread.is_alive():
        thread.join(0.05)
        ctx.tick()
    deadline = time.perf_counter() + DRAIN_S
    while completed[0] < n and time.perf_counter() < deadline:
        time.sleep(0.001)
        ctx.tick()
    return t0, due, done, failed, late, backlog, kept


def run(ctx):
    cfg, mix = ctx.cell.config, ctx.mix
    n_due = traffic.arrivals(mix["arrivals"], ctx.seconds, ctx.seed)
    Ts = traffic.lengths(mix["lengths"], len(n_due), ctx.seed)
    pool = traffic.MelPool(mix["mel"], ctx.seed)
    mels = pool.many(Ts)
    g = traffic.rng(ctx.seed, 5)
    longest = int(np.argmax(Ts))
    keep = set(g.choice(len(Ts), min(mix["check"]["sample"], len(Ts)) - 1, replace=False).tolist())
    keep.add(longest)

    params = ctx.serving_params()
    forward_fn = (ctx.forward_override
                  or program.serving_generator(ctx.cell, params, ctx.device).inference)
    synth, batcher = build(ctx, forward_fn)
    ctx.phase("weights and program")
    warm(ctx, synth, Ts)
    ctx.phase("warm-up")
    reset(ctx.record)

    with ctx.window():
        t0, due, done, failed, late, backlog, kept = offer(ctx, batcher, mels, n_due, keep)
    batcher.close()

    lat = np.array([FAILED_MS if failed[i] or done[i] is None else (done[i] - due[i]) * 1e3
                    for i in range(len(Ts))])
    rec = ctx.record
    rec.update(due=due, done=done, Ts=Ts, mel_ids=[id(m) for m in mels], latency_ms=lat,
               late_s=late,
               backlog=backlog, completed=[done[i] is not None and not failed[i]
                                           for i in range(len(Ts))])
    stalls = [f"{due[i] - t0:.2f} s: {late[i] * 1e3:.0f} ms" for i in np.flatnonzero(late > 0.02)]
    ctx.stderr(f"load thread late: p50 {np.median(late) * 1e3:.3f} ms, max "
               f"{late.max() * 1e3:.3f} ms, over 20 ms at {stalls[:12]}; backlog after 1 s "
               f"{backlog.get('1s')}, at the end {backlog['end']}; largest group "
               f"{max((c[2] for c in rec['forward_calls']), default=0)} rows; {ctx.gc_pauses()}")
    outputs = {i: f.result() for i, f in kept.items() if f.exception() is None}
    ctx.window_done(attempted=len(Ts), failed=int(sum(failed) + sum(d is None for d in done)))
    del synth, batcher, forward_fn
    ctx.free()

    ctx.e2e["latency_p95_ms"] = float(np.percentile(lat, 95))
    ctx.checks["wave_err"] = common.served_error(ctx, params, mels, Ts, sorted(keep), outputs)
    return ctx
