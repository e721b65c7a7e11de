"""Pseudo-QMF analysis / synthesis filterbank, channels last.

Counterpart of `fastvocoder_tpu/ops/pqmf.py` (reference
model/generator/pqmf.py:15-135): a Kaiser-windowed sinc prototype
(taps = 62, cutoff ratio 0.142, beta = 9.0), cosine-modulated into
`subbands` analysis and synthesis filters.  Analysis is one strided conv,
synthesis one transposed conv (the zero-stuffing conv of the reference
folded into it); both are library calls, as the JAX package leaves them to
XLA.  The filters are buffers, not parameters: checkpoints carry none.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def design_prototype_filter(taps: int = 62, cutoff_ratio: float = 0.142,
                            beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass prototype, (taps + 1,)."""
    if taps % 2 != 0:
        raise ValueError("the number of taps must be even")
    if not 0.0 < cutoff_ratio < 1.0:
        raise ValueError("cutoff_ratio must lie in (0, 1)")
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = cutoff_ratio  # the sinc's limit at n = 0
    return h_i * np.kaiser(taps + 1, beta)


class PQMF(nn.Module):
    def __init__(self, subbands: int = 4, taps: int = 62, cutoff_ratio: float = 0.142,
                 beta: float = 9.0):
        super().__init__()
        h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
        n = np.arange(taps + 1)
        h_analysis = np.zeros((subbands, taps + 1))
        h_synthesis = np.zeros((subbands, taps + 1))
        for k in range(subbands):
            mod = (2 * k + 1) * (np.pi / (2 * subbands)) * (n - taps / 2)
            h_analysis[k] = 2 * h_proto * np.cos(mod + (-1) ** k * np.pi / 4)
            h_synthesis[k] = 2 * h_proto * np.cos(mod - (-1) ** k * np.pi / 4)
        self.subbands = subbands
        self.taps = taps
        # conv1d weight (subbands, 1, taps + 1)
        self.register_buffer(
            "analysis_filter", torch.tensor(h_analysis[:, None, :], dtype=torch.float32),
            persistent=False)
        # conv_transpose1d weight (subbands, 1, taps + 1): the synthesis
        # filters reversed (a transposed conv flips its kernel), times
        # `subbands` for the power lost to zero-stuffing (reference
        # pqmf.py:131-134)
        self.register_buffer(
            "synthesis_filter",
            torch.tensor(h_synthesis[:, None, ::-1] * subbands, dtype=torch.float32),
            persistent=False)

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, 1) -> (B, ceil(T / subbands), subbands)."""
        y = F.conv1d(x.transpose(1, 2), self.analysis_filter, stride=self.subbands,
                     padding=self.taps // 2)
        return y.transpose(1, 2).contiguous()

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, subbands) -> (B, T * subbands, 1): y[n] = sum_k
        xz[n + k - taps/2] . h[k], xz the input zero-stuffed to the full
        rate."""
        s, p = self.subbands, self.taps // 2
        # a transposed conv of kernel taps + 1, padding taps - p gives
        # (T - 1) s + 1 samples; output_padding s - 1 adds the last s - 1
        y = F.conv_transpose1d(x.transpose(1, 2), self.synthesis_filter, stride=s,
                               padding=self.taps - p, output_padding=s - 1)
        return y.transpose(1, 2).contiguous()
