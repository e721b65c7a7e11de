"""fastvocoder_tpu_torch — the PyTorch / CUDA port of fastvocoder_tpu.

Runs Basis-MelGAN inference and serving on an NVIDIA H100.  The JAX package
`fastvocoder_tpu` beside it is the reference; this package imports nothing
of it.  Public functions keep its layout: mel (B, T, 80), basis weights
(B, F, C), waveform (B, N).

  * ops/     — conv primitives and the two hand-written CUDA kernels
               (`csrc/`): the basis decode and the fused residual-stack
               chain, each beside its plain PyTorch version.
  * models/  — the Basis-MelGAN generator, batched synthesis.
  * serving/ — request batching and the HTTP frontend.
  * bin/     — synthesize / test (RTF) / serve entry points.

Entry points run on CUDA unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks for
    the CPU; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: fastvocoder_tpu_torch runs on the GPU; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return device
