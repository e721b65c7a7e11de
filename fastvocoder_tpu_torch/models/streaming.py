"""Chunked / streaming synthesis for mels of any length.

Counterpart of `fastvocoder_tpu/models/streaming.py`.  Inference runs over
fixed-size mel chunks with a halo of context frames on each side, so every
chunk has the one shape `chunk + 2 * halo`: the generator's kept kernel
tables (`ChainTable`, `StageTable`, `TailTable`) and cuDNN's plans serve
every chunk.  The generators are fully convolutional, so interior samples
equal the full pass once the halo covers the receptive field (every
shipped generator's field is a few mel frames; `DEFAULT_HALO` = 32 frames
exceeds all of them); only the sequence's edges see the chunk's own reflect
padding.

Basis-MelGAN streams natively: its raw decode emits `frames * hop + L / 2`
samples (the last overlap-add ramp, which the reference's bin/test.py:85-88
trims), so `tail_samples = L // 2` absorbs the ramp per chunk, and the
published checkpoint's `pattern` zero-mel bias (reference
bin/publish.py:67-75) is subtracted position-aligned as the stream
advances.  `StreamingSynthesizer.for_model` wires each family.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from fastvocoder_tpu_torch import resolve_device

DEFAULT_HALO = 32


def check_pattern_covers(pattern: Optional[np.ndarray], n_samples: int):
    """Published zero-mel bias must cover the utterance (reference
    bin/test.py:85-88; 300 s publish, bin/publish.py:69)."""
    if pattern is not None and pattern.shape[0] < n_samples:
        raise ValueError(
            f"pattern covers {pattern.shape[0]} samples but the utterance "
            f"needs {n_samples}; publish with a longer zero-mel "
            "(reference supports 300 s, bin/publish.py:69)"
        )


class StreamingSynthesizer:
    """Fixed-chunk streaming around a mel -> waveform function.

    `forward(mel (1, T, C) on `device`) -> waveform (1, T * samples_per_frame
    + tail_samples)`, a tensor or an array.  Every shipped generator's
    `inference` preserves frame length (`tail_samples=0`) except
    Basis-MelGAN's raw decode, whose last overlap-add ramp adds `L // 2`
    samples.  `pattern`, when given, is the model's zero-mel response (a
    published checkpoint's `pattern`), subtracted position-aligned: the
    streaming form of the reference's `est - pattern[:len(est)]`
    (bin/test.py:85-91).
    """

    def __init__(
        self,
        forward: Callable,
        samples_per_frame: int,
        chunk_frames: int = 256,
        halo_frames: int = DEFAULT_HALO,
        tail_samples: int = 0,
        pattern: Optional[np.ndarray] = None,
        device="cuda",
    ):
        self.forward = forward
        self.device = resolve_device(device)
        self.spf = samples_per_frame
        self.chunk = chunk_frames
        self.halo = halo_frames
        self.tail = tail_samples
        self.pattern = None if pattern is None else np.asarray(pattern)

    @classmethod
    def for_model(cls, generator: torch.nn.Module, model_name: str, hop_size: int = 240,
                  pattern: Optional[np.ndarray] = None, device="cuda",
                  **kw) -> "StreamingSynthesizer":
        """The streamer of a port generator (`models.factory`), moved to
        `device`: its `inference`, and Basis-MelGAN's `tail_samples`."""
        dev = resolve_device(device)
        generator.to(dev)
        tail = generator.cfg.L // 2 if model_name == "basis-melgan" else 0
        return cls(generator.inference, samples_per_frame=hop_size, tail_samples=tail,
                   pattern=pattern, device=dev, **kw)

    def _run(self, piece: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            wav = self.forward(torch.from_numpy(np.ascontiguousarray(piece[None], np.float32))
                               .to(self.device))
        if isinstance(wav, torch.Tensor):
            wav = wav.float().cpu().numpy()
        return np.asarray(wav)[0]

    def __call__(self, mel: np.ndarray) -> np.ndarray:
        """mel (T, C) -> waveform (T * samples_per_frame,), chunk by chunk
        at one shape."""
        T = mel.shape[0]
        h, c = self.halo, self.chunk
        check_pattern_covers(self.pattern, T * self.spf)
        out = np.zeros((T * self.spf,), dtype=np.float32)
        want = c + 2 * h
        start = 0
        while start < T:
            end = min(start + c, T)
            lo = max(0, start - h)
            hi = min(T, end + h)
            piece = mel[lo:hi]
            # pad to the fixed shape; numpy's reflect takes at most len - 1
            # a time, so short final pieces pad in rounds
            pad = want - piece.shape[0]
            while pad > 0:
                if piece.shape[0] == 1:
                    piece = np.repeat(piece, want, axis=0)[:want]
                    break
                step = min(pad, piece.shape[0] - 1)
                piece = np.pad(piece, ((0, step), (0, 0)), mode="reflect")
                pad = want - piece.shape[0]
            wav = self._run(piece)
            if wav.shape[0] != want * self.spf + self.tail:
                raise ValueError(
                    f"forward emitted {wav.shape[0]} samples for {want} frames (expected "
                    f"{want * self.spf + self.tail}); pass tail_samples=L//2 for "
                    "basis-melgan's raw decode or use StreamingSynthesizer.for_model")
            a = (start - lo) * self.spf  # trim the halo and the tail back out
            out[start * self.spf : end * self.spf] = wav[a : a + (end - start) * self.spf]
            start = end
        if self.pattern is not None:
            out = out - self.pattern[: out.shape[0]]
        return out
