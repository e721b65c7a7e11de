"""Streaming support (counterpart of `fastvocoder_tpu/models/streaming.py`).
Only the pattern-coverage check is ported so far; chunked streaming is in
ROADMAP queue A."""

from __future__ import annotations

from typing import Optional

import numpy as np


def check_pattern_covers(pattern: Optional[np.ndarray], n_samples: int):
    """Published zero-mel bias must cover the utterance (reference
    bin/test.py:85-88; 300 s publish, bin/publish.py:69)."""
    if pattern is not None and pattern.shape[0] < n_samples:
        raise ValueError(
            f"pattern covers {pattern.shape[0]} samples but the utterance "
            f"needs {n_samples}; publish with a longer zero-mel "
            "(reference supports 300 s, bin/publish.py:69)"
        )
