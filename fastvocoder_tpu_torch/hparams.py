"""Global hyperparameters + per-model YAML config loading.

The port's own copy of `fastvocoder_tpu/hparams.py` (the port imports
nothing of the JAX package): immutable dataclasses holding the reference's
defaults (reference hparams.py:1-54), and YAML files read with the
reference's keys verbatim (including a tolerant read of the ``lamda_stft``
typo key, reference conf/*/*.yaml).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence

import yaml

MODEL_NAMES = ("melgan", "hifigan", "multiband-hifigan", "basis-melgan", "nhv")


@dataclass(frozen=True)
class Hparams:
    """Audio + training schedule constants (reference hparams.py:1-54)."""

    # Mel / DSP
    num_mels: int = 80
    num_freq: int = 1025          # n_fft = (num_freq - 1) * 2 = 2048
    frame_length_ms: float = 50   # win_length = 1200 @ 24 kHz
    frame_shift_ms: float = 10    # hop = 240 @ 24 kHz
    fmin: float = 40.0
    hop_size: int = 240
    sample_rate: int = 24000
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    preemphasize: bool = True
    preemphasis: float = 0.97
    rescale_out: float = 0.4
    signal_normalization: bool = True
    griffin_lim_iters: int = 60
    power: float = 1.5

    # Train sizes
    test_size: int = 0            # truncate dataset for smoke tests
    train_size: int = 9000
    valid_size: int = 500
    eval_size: int = 100

    # Schedule
    epochs: int = 100000          # "need stop by your hands"
    batch_size: int = 32
    batch_expand_size: int = 8
    discriminator_train_start_steps: int = 100000
    n_warm_up_step: int = 0

    use_feature_map_loss: bool = True

    learning_rate: float = 1e-4
    learning_rate_discriminator: float = 5e-5
    grad_clip_thresh: float = 1.0

    log_step: int = 5
    clear_time: int = 20

    save_step: int = 5000
    valid_step: int = 500
    valid_num: int = 100

    checkpoint_path: str = "checkpoint"
    logger_path: str = "logger"
    tensorboard_path: str = "tensorboard"

    fixed_length: int = 140       # training crop length in mel frames

    lambda_adv: float = 1.0
    lambda_fm: float = 1.0
    lambda_stft: float = 5.0

    def __post_init__(self):
        # hop_size is the integer constant everything frame-aligned reads
        # (crops, f0, NHV, validation); frame_shift_ms drives DSP extraction.
        # They encode the same quantity — refuse silent desync.
        derived = int(self.frame_shift_ms / 1000 * self.sample_rate)
        if derived != self.hop_size:
            raise ValueError(
                f"hop_size={self.hop_size} inconsistent with "
                f"frame_shift_ms={self.frame_shift_ms} @ {self.sample_rate} Hz "
                f"(= {derived}); change both together"
            )

    @property
    def n_fft(self) -> int:
        return (self.num_freq - 1) * 2

    @property
    def win_length(self) -> int:
        return int(self.frame_length_ms / 1000 * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.frame_shift_ms / 1000 * self.sample_rate)

    def replace(self, **kw) -> "Hparams":
        return dataclasses.replace(self, **kw)


HP = Hparams()  # module-level defaults, used where the reference reads `hp.*`


# ---------------------------------------------------------------------------
# Per-model architecture configs (reference conf/*/*.yaml keys, verbatim)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MelGANConfig:
    in_channels: int = 80
    out_channels: int = 1
    kernel_size: int = 7
    channels: Sequence[int] = (512, 256, 128, 64, 32)
    upsample_scales: Sequence[int] = (10, 6, 2, 2)
    stack_kernel_size: int = 3
    stacks: int = 3
    use_weight_norm: bool = True
    use_causal_conv: bool = False
    bias: bool = True


@dataclass(frozen=True)
class HiFiGANConfig:
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    upsample_rates: Sequence[int] = (8, 5, 3, 2)
    upsample_initial_channel: int = 256
    resblock_type: str = "1"
    upsample_kernel_sizes: Sequence[int] = (16, 10, 6, 4)
    resblock_dilation_sizes: Sequence[Sequence[int]] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    transposedconv: bool = True
    bias: bool = True
    out_bands: int = 1  # 4 for multiband-hifigan


@dataclass(frozen=True)
class BasisMelGANConfig:
    L: int = 30
    in_channels: int = 80
    out_channels: int = 256
    kernel_size: int = 7
    channels: Sequence[int] = (256, 256, 256)
    upsample_scales: Sequence[int] = (4, 4)
    stack_kernel_size: int = 3
    stacks: int = 3
    use_weight_norm: bool = True
    use_causal_conv: bool = False
    transposedconv: bool = True
    bias: bool = True


@dataclass(frozen=True)
class NHVConfig:
    """Neural Homomorphic Vocoder (models/nhv.py — the reference's empty
    TODO, reference model/generator/nhv.py).  Conditioning is mel + f0
    packed as in_channels + 1 input channels (dsp/f0.py)."""

    in_channels: int = 80          # mel channels; cond adds +1 f0 channel
    channels: int = 256            # filter-estimator CNN width
    n_layers: int = 3
    kernel_size: int = 3
    ccep_size: int = 222           # complex-cepstrum length per filter
    fir_taps: int = 129            # final trainable FIR
    fft_size: int = 1024           # LTV filtering frame FFT
    win_length: int = 480          # 2 * hop
    hop_size: int = 240
    sample_rate: int = 24000


@dataclass(frozen=True)
class DiscriminatorConfig:
    """Composite-discriminator sizes (the reference hard-codes these:
    model/discriminator/msd.py:117-202, mfd.py:146-175).  The defaults are
    the reference's architecture; tests use small widths."""

    # MSD: MelGAN multi-scale (reference msd.py)
    msd_scales: int = 3
    msd_channels: int = 16
    msd_max_channels: int = 1024
    msd_downsample_scales: Sequence[int] = (4, 4, 4, 4)
    # MFD: multi-resolution STFT (reference mfd.py)
    mfd_fft_sizes: Sequence[int] = (2048, 1024, 512)
    mfd_hop_sizes: Sequence[int] = (240, 120, 50)
    mfd_win_lengths: Sequence[int] = (1200, 600, 240)
    mfd_channels: int = 64
    mfd_max_channels: int = 1024
    mfd_downsample_scales: Sequence[int] = (4, 4)
    # MPD: optional, unwired in the reference (discriminator.py:16); not
    # ported yet (ROADMAP queue A)
    use_mpd: bool = False
    mpd_periods: Sequence[int] = (2, 3, 5, 7, 11)
    mpd_channels: Sequence[int] = (32, 128, 512, 1024)


DISC = DiscriminatorConfig()

# Small widths for the CPU tests: the same layer structure (grouped strided
# convs, in-graph STFT) at a fraction of the cost.
TINY_DISC = DiscriminatorConfig(
    msd_channels=4,
    msd_max_channels=32,
    msd_downsample_scales=(4, 4),
    mfd_fft_sizes=(256,),
    mfd_hop_sizes=(64,),
    mfd_win_lengths=(128,),
    mfd_channels=8,
    mfd_max_channels=32,
    mfd_downsample_scales=(4,),
    mpd_channels=(4, 8, 8, 8),
)


@dataclass(frozen=True)
class ModelConfig:
    """Parsed per-model YAML plus the shared loss flags."""

    model_name: str
    arch: Any  # one of the dataclasses above
    lambda_stft: float = 5.0
    multiband: bool = False
    use_feature_map_loss: bool = True
    # enable HiFiGAN's multi-period discriminator in the composite
    # (the reference implements MPD but leaves it unwired,
    # reference model/discriminator/discriminator.py:11,16)
    use_mpd: bool = False
    raw: dict = field(default_factory=dict, repr=False)


def _tuplify(x):
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


def load_model_config(model_name: str, config_path: str) -> ModelConfig:
    """Load a reference-format YAML model config.

    Mirrors the factory switch duplicated across the reference drivers
    (bin/train.py:269-313, bin/synthesize.py:25-68) but returns typed config
    instead of constructing a model.
    """
    if model_name not in MODEL_NAMES:
        raise ValueError(f"unknown model_name {model_name!r}; want {MODEL_NAMES}")
    with open(config_path) as f:
        raw = yaml.safe_load(f)

    # tolerant read of the reference's 'lamda_stft' typo key
    lambda_stft = raw.get("lambda_stft", raw.get("lamda_stft", HP.lambda_stft))
    multiband = bool(raw.get("multiband", False))
    use_fm = bool(raw.get("use_feature_map_loss", True))
    use_mpd = bool(raw.get("use_mpd", False))

    if model_name == "melgan":
        arch = MelGANConfig(
            in_channels=raw["in_channels"],
            out_channels=raw["out_channels"],
            kernel_size=raw["kernel_size"],
            channels=_tuplify(raw["channels"]),
            upsample_scales=_tuplify(raw["upsample_scales"]),
            stack_kernel_size=raw["stack_kernel_size"],
            stacks=raw["stacks"],
            use_weight_norm=raw["use_weight_norm"],
            use_causal_conv=raw["use_causal_conv"],
            bias=bool(raw.get("bias", True)),
        )
    elif model_name in ("hifigan", "multiband-hifigan"):
        arch = HiFiGANConfig(
            resblock_kernel_sizes=_tuplify(raw["resblock_kernel_sizes"]),
            upsample_rates=_tuplify(raw["upsample_rates"]),
            upsample_initial_channel=raw["upsample_initial_channel"],
            resblock_type=str(raw["resblock_type"]),
            upsample_kernel_sizes=_tuplify(raw["upsample_kernel_sizes"]),
            resblock_dilation_sizes=_tuplify(raw["resblock_dilation_sizes"]),
            transposedconv=bool(raw["transposedconv"]),
            bias=bool(raw.get("bias", True)),
            out_bands=4 if model_name == "multiband-hifigan" else 1,
        )
    elif model_name == "nhv":
        arch = NHVConfig(
            in_channels=int(raw.get("in_channels", 80)),
            channels=int(raw.get("channels", 256)),
            n_layers=int(raw.get("n_layers", 3)),
            kernel_size=int(raw.get("kernel_size", 3)),
            ccep_size=int(raw.get("ccep_size", 222)),
            fir_taps=int(raw.get("fir_taps", 129)),
            fft_size=int(raw.get("fft_size", 1024)),
            win_length=int(raw.get("win_length", 480)),
            hop_size=int(raw.get("hop_size", 240)),
            sample_rate=int(raw.get("sample_rate", 24000)),
        )
    else:  # basis-melgan
        arch = BasisMelGANConfig(
            L=raw["L"],
            in_channels=raw["in_channels"],
            out_channels=raw["out_channels"],
            kernel_size=raw["kernel_size"],
            channels=_tuplify(raw["channels"]),
            upsample_scales=_tuplify(raw["upsample_scales"]),
            stack_kernel_size=raw["stack_kernel_size"],
            stacks=raw["stacks"],
            use_weight_norm=raw["use_weight_norm"],
            use_causal_conv=raw["use_causal_conv"],
            transposedconv=bool(raw.get("transposedconv", True)),
            bias=bool(raw.get("bias", True)),
        )

    return ModelConfig(
        model_name=model_name,
        arch=arch,
        lambda_stft=float(lambda_stft),
        multiband=multiband,
        use_feature_map_loss=use_fm,
        use_mpd=use_mpd,
        raw=raw,
    )
