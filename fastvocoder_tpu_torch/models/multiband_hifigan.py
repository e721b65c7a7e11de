"""MultiBand-HiFiGAN generator, channels last.

Counterpart of `fastvocoder_tpu/models/multiband_hifigan.py` (reference
model/generator/multiband_hifigan.py:14-137): the HiFiGAN trunk (`trunk`,
the checkpoint's `trunk/` prefix) with a 4-band conv_post, then PQMF
synthesis to the full band.  The forward call returns the sub-band signal,
as training needs it; `synthesize` (also `inference`) the waveform.  With
`compute_dtype=torch.bfloat16` the trunk computes in bf16 and hands PQMF its
float32 output, as the JAX package does (`fastvocoder_tpu/ops/pqmf.py:72-74`).
"""

from __future__ import annotations

import torch
from torch import nn

from fastvocoder_tpu_torch.hparams import HiFiGANConfig
from fastvocoder_tpu_torch.models.hifigan import HiFiGANGenerator
from fastvocoder_tpu_torch.ops.pqmf import PQMF


class MultiBandHiFiGANGenerator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig, weight_norm: bool = False, compute_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.trunk = HiFiGANGenerator(cfg, weight_norm=weight_norm, compute_dtype=compute_dtype)
        self.pqmf = PQMF(subbands=cfg.out_bands)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, 80) -> sub-band signal (B, T * prod(rates), bands)."""
        return self.trunk(mel)

    def synthesize(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, 80) -> full-band waveform (B, T * prod(rates) * bands)."""
        return self.pqmf.synthesis(self.trunk(mel))[..., 0]

    def inference(self, mel: torch.Tensor) -> torch.Tensor:
        """The waveform: `synthesize`, as the JAX package serves this family."""
        return self.synthesize(mel)
