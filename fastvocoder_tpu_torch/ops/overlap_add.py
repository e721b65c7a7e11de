"""Overlap-add of frames, as pads, reshapes and adds.

Counterpart of `fastvocoder_tpu/ops/overlap_add.py`, which is plain XLA (no
Pallas kernel), so plain PyTorch is its port: each frame is cut into
`frame_step`-sized chunks (the frame zero-padded up to a multiple of the
step), and chunk c of frame f lands on subframe f + c, so
ceil(frame_length / frame_step) padded adds build the output, with no
scatter.  NHV's LTV filter overlap-adds its filtered frames with it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def overlap_and_add(signal: torch.Tensor, frame_step: int) -> torch.Tensor:
    """(..., frames, frame_length) -> (..., (frames - 1) * frame_step +
    frame_length): frame f added in at sample f * frame_step."""
    *outer, frames, frame_length = signal.shape
    if frame_step > frame_length:
        raise ValueError("frame_step must be <= frame_length")
    k = math.ceil(frame_length / frame_step)  # chunks a frame
    pad = k * frame_step - frame_length
    if pad:
        signal = F.pad(signal, (0, pad))
    chunks = signal.reshape(*outer, frames, k, frame_step)
    out_subframes = frames + k - 1
    out = None
    for c in range(k):
        # chunk c of frame f covers samples (f + c) * frame_step onward
        part = F.pad(chunks[..., c, :], (0, 0, c, out_subframes - frames - c))
        out = part if out is None else out + part
    return out.reshape(*outer, out_subframes * frame_step)[..., : (frames - 1) * frame_step
                                                           + frame_length]
