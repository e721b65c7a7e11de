"""NHV, the Neural Homomorphic Vocoder, channels last.

Counterpart of `fastvocoder_tpu/models/nhv.py` (Liu, Chen & Yu,
Interspeech 2020).  Conditioning is one (B, T, 81) tensor: 80 mel channels
and f0 in Hz on channel 80 (0 = unvoiced; `dsp.f0.f0_to_condition`).

  * Sources: an impulse train fired where the cumulative phase of the f0
    contour, linearly interpolated to sample rate, crosses an integer
    (`impulse_train`), and Gaussian noise.
  * `FilterEstimator`: convs over the mel predict per frame two complex
    cepstra (harmonic and noise filters).
  * The LTV filter (`ltv_filter`): the source framed, windowed (symmetric
    Hann), rFFT'd, multiplied by exp(rFFT(cepstrum)) and overlap-added back.
  * A trainable FIR `fir` (taps, 1, 1), delta-initialised, shapes the sum.

The JAX package runs all of it as XLA (convs, FFTs, pads and adds), no
Pallas kernel, and so does the port: cuDNN convs and cuFFT on the card.
With `compute_dtype=torch.bfloat16` only the filter estimator's convs run in
bf16; its cepstra, the sources, the FFTs and the filter stay float32
(`fastvocoder_tpu/models/nhv.py:67,95,119`).

Where the port differs from the JAX package by design:

  * `impulse_train` accumulates the phase in exact integer arithmetic, so
    its impulses do not depend on the order of a summation: the card's and
    the CPU's trains are the same.  The JAX package accumulates in float32,
    whose rounding moves an impulse by a sample where its phase lies within
    that rounding of an integer (about 3.6 % of the impulses of a 585-frame
    utterance at 220 Hz).
  * The noise: torch cannot draw JAX's threefry numbers.  At inference it is
    `0.3 * randn` from a `torch.Generator` on the conditioning's device,
    seeded 0 on every call, deterministic per call and device as JAX's
    `PRNGKey(0)` is, with other values.  The trainer draws its own
    (`train.trainer.Trainer.noise`).  `forward(cond, sources=...)` takes
    both sources from the caller, which is how the tests hold the filter
    path against the JAX package exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fastvocoder_tpu_torch.hparams import NHVConfig
from fastvocoder_tpu_torch.models.layers import Conv1d
from fastvocoder_tpu_torch.ops.fused_resstack import leaky_relu
from fastvocoder_tpu_torch.ops.overlap_add import overlap_and_add

# f0 is carried in fixed point, in units of 2**-18 Hz: exact for every
# float32 f0 of 32 Hz and above, and int64 sums of a phase in these units
# hold utterances of up to about 80 minutes at 600 Hz
F0_SCALE = 2 ** 18
NOISE_SCALE = 0.3


def impulse_train(f0: torch.Tensor, hop: int, sample_rate: int) -> torch.Tensor:
    """f0 (B, T) in Hz -> impulse train (B, T * hop), float32.

    The frame contour is interpolated linearly to sample rate (sample j of
    frame t: f0[t] (1 - j / hop) + f0[t + 1] j / hop, the last frame held),
    its phase f0 / sample_rate accumulated, and an impulse fires wherever
    the phase's integer part steps up.  The phase is summed as integers:
    2 hop sample_rate F0_SCALE times the phase is a sum of the integers
    q[t] (2 hop - 2 j) + q[t + 1] 2 j, q = round(f0 F0_SCALE), which any
    order of summation gives exactly, on any device."""
    B, T = f0.shape
    dev = f0.device
    q = torch.round(f0.detach().double() * F0_SCALE).long()
    nxt = torch.clamp(torch.arange(T, device=dev) + 1, max=T - 1)
    j = 2 * torch.arange(hop, device=dev)
    inc = q[:, :, None] * (2 * hop - j) + q[:, nxt, None] * j  # (B, T, hop)
    phase = torch.cumsum(inc.reshape(B, T * hop), dim=1)
    wraps = torch.div(phase, 2 * hop * sample_rate * F0_SCALE, rounding_mode="floor")
    fired = torch.cat([wraps[:, :1] > 0, wraps[:, 1:] > wraps[:, :-1]], dim=1)
    return fired.float()


def ltv_filter(source: torch.Tensor, ccep: torch.Tensor, hop: int, win: int,
               nfft: int) -> torch.Tensor:
    """Linear time-varying filtering of source (B, n) by per-frame complex
    cepstra ccep (B, T, Q): frames of `win` samples every `hop` (the source
    padded by win / 2), a symmetric Hann window, rFFT to `nfft` bins, times
    H = exp(rFFT(ccep)) with the real part of log H clamped to [-30, 8],
    irFFT, overlap-add, and the n samples aligned with the source."""
    n = source.shape[1]
    T = ccep.shape[1]
    pad = win // 2
    frames = F.pad(source, (pad, pad + win)).unfold(1, win, hop)[:, :T]  # (B, T, win)
    window = torch.hann_window(win, periodic=False, dtype=frames.dtype, device=frames.device)
    spec = torch.fft.rfft(frames * window, n=nfft)
    log_h = torch.fft.rfft(ccep, n=nfft)
    h = torch.exp(torch.complex(torch.clamp(log_h.real, -30.0, 8.0), log_h.imag))
    y = torch.fft.irfft(spec * h, n=nfft)  # (B, T, nfft)
    return overlap_and_add(y, hop)[:, pad: pad + n]


class FilterEstimator(nn.Module):
    """mel (B, T, n_mels) -> complex cepstra (B, T, 2 ccep_size): the
    harmonic filter's, then the noise filter's.  `n_layers` convs of K with
    zero padding and leaky(0.2), then a 1x1 conv `conv_out`, scaled by 0.1
    (near unity gain at init)."""

    def __init__(self, in_channels: int, channels: int = 256, n_layers: int = 3,
                 kernel_size: int = 3, ccep_size: int = 222, weight_norm: bool = False,
                 compute_dtype=None):
        super().__init__()
        self.convs = []
        cin = in_channels
        for i in range(n_layers):
            conv = Conv1d(cin, channels, kernel_size, padding=(kernel_size - 1) // 2,
                          weight_norm=weight_norm, compute_dtype=compute_dtype)
            self.add_module(f"conv_{i}", conv)
            self.convs.append(conv)
            cin = channels
        self.conv_out = Conv1d(cin, 2 * ccep_size, 1, weight_norm=weight_norm,
                               compute_dtype=compute_dtype)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        h = mel
        for conv in self.convs:
            h = leaky_relu(conv(h))
        return 0.1 * self.conv_out(h).float()


class NHVGenerator(nn.Module):
    """cond (B, T, in_channels + 1) = [mel | f0 Hz] -> waveform (B, T * hop).
    Submodules and parameters are named as in the JAX package
    (`filter_estimator/conv_<i>`, `conv_out`, the root `fir`)."""

    def __init__(self, cfg: NHVConfig, weight_norm: bool = False, compute_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.filter_estimator = FilterEstimator(cfg.in_channels, cfg.channels, cfg.n_layers,
                                                cfg.kernel_size, cfg.ccep_size, weight_norm,
                                                compute_dtype)
        delta = torch.zeros(cfg.fir_taps, 1, 1)
        delta[cfg.fir_taps // 2] = 1.0
        self.fir = nn.Parameter(delta)

    def sources(self, f0: torch.Tensor, noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(harmonic, noise) for f0 (B, T): the port's `impulse_train`, and
        `noise` or, without it, the inference draw (0.3 randn from a
        generator on f0's device seeded 0)."""
        harmonic = impulse_train(f0, self.cfg.hop_size, self.cfg.sample_rate)
        if noise is None:
            g = torch.Generator(device=f0.device).manual_seed(0)
            noise = NOISE_SCALE * torch.randn(harmonic.shape, generator=g, device=f0.device)
        return harmonic, noise

    def forward(self, cond: torch.Tensor, *,
                sources: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        cfg = self.cfg
        if cond.shape[-1] != cfg.in_channels + 1:
            raise ValueError(
                f"NHV conditioning must be (B, T, {cfg.in_channels + 1}) = mel + f0 channel "
                f"(dsp.f0.f0_to_condition); got {tuple(cond.shape)}")
        mel, f0 = cond[..., : cfg.in_channels], cond[..., cfg.in_channels]
        ccep = self.filter_estimator(mel)
        harmonic, noise = sources if sources is not None else self.sources(f0)
        args = (cfg.hop_size, cfg.win_length, cfg.fft_size)
        wav = (ltv_filter(harmonic, ccep[..., : cfg.ccep_size], *args)
               + ltv_filter(noise, ccep[..., cfg.ccep_size:], *args))
        k = cfg.fir_taps
        out = F.conv1d(F.pad(wav[:, None], (k // 2, (k - 1) // 2)), self.fir.reshape(1, 1, k))
        return out[:, 0]

    def inference(self, cond: torch.Tensor) -> torch.Tensor:
        """The waveform with the inference sources, as the JAX package
        serves NHV."""
        return self(cond)
