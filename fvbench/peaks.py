"""The table of peaks and the roofline bound (the arithmetic of
`chip_smoke.py::bound_ms`, `bound_bf16_ms`, copied so that the yardstick
lives with the benchmark).

Published peaks of one NVIDIA H100 SXM at its 700 W limit, dense, without
sparsity.  A cell is held to the peak of the precision its configuration
states: float32 to dense TF32 (no float32-accurate path on the card runs
faster), bf16 to dense bf16.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {
    "float32": 495e12,   # dense TF32 on the tensor cores
    "bfloat16": 989e12,  # dense bf16 on the tensor cores
}


def peak_flops(dtype: str) -> float:
    return PEAK_FLOP_PER_S[dtype]


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """The least time the card could take: the operations at the peak of
    `dtype`, or each input byte read and each output byte written once at
    the memory's bandwidth, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOP_PER_S[dtype])
