"""The compute types of the port, and bf16 rounding.

A model built with `compute_dtype=torch.bfloat16` keeps its parameters in
float32 and computes in bf16, as the JAX package's `compute_dtype` does:
activations, kernels and biases cast to bf16 before every conv, float32
sums inside, the waveform float32.  So does a trainer made with it (bf16
mixed-precision training: float32 parameters, optimiser state and losses).
Each kernel has a float32 form and a bf16 form; the plain versions of the
bf16 forms carry bf16 values in float32 tensors and round with `fit` where
the kernels (and the JAX package's Pallas bodies) round.
"""

from __future__ import annotations

from typing import Optional

import torch

def check_compute_dtype(dtype: Optional[torch.dtype]) -> Optional[torch.dtype]:
    """-> the compute type (None for float32) after refusing a type the
    port has no kernel forms for."""
    if dtype is None or dtype == torch.float32:
        return None
    if dtype != torch.bfloat16:
        raise ValueError(f"compute_dtype must be None, torch.float32 or torch.bfloat16, "
                         f"got {dtype}")
    return dtype


def fit(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t as a form of `dtype` stores it: rounded to the nearest bf16 and
    held in float32 for bf16, t itself for any other type."""
    if dtype != torch.bfloat16:
        return t
    return t.to(dtype).to(torch.float32)


def widen(t: torch.Tensor) -> torch.Tensor:
    """bf16 values in float32, where a plain version does its sums; t itself
    in any other type (float32, or float64 for a reference)."""
    return t.float() if t.dtype == torch.bfloat16 else t
