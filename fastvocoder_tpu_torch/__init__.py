"""fastvocoder_tpu_torch — the PyTorch / CUDA port of fastvocoder_tpu.

Runs all five generator families of the JAX package (Basis-MelGAN,
HiFiGAN, MultiBand-HiFiGAN, MelGAN, NHV) through synthesis, serving and GAN
training on an NVIDIA H100, with the MSD, MFD and MPD discriminators.  The
JAX package `fastvocoder_tpu` beside it is the reference; this package
imports nothing of it.  Public functions keep its layout: mel (B, T, 80),
NHV's conditioning (B, T, 81) with f0 on channel 80, basis weights
(B, F, C), waveform (B, N).

  * ops/     — conv primitives, PQMF, overlap-add, and the six hand-written
               CUDA kernels (`csrc/`): the basis decode, the residual-stack
               chain forward and backward, the HiFiGAN MRF stage forward and
               backward and the HiFiGAN tail, each beside its plain PyTorch
               version.
  * models/  — the five generators, the discriminators, batched synthesis.
  * dsp/, losses/, data/, train/ — STFT, f0, the GAN losses, the data
               pipeline and the trainer.
  * serving/ — request batching and the HTTP frontend.
  * bin/     — synthesize / test (RTF) / serve / train entry points.

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
