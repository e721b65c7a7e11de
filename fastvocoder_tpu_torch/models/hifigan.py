"""HiFiGAN generator, channels last (B, T, C).

Counterpart of `fastvocoder_tpu/models/hifigan.py` (reference
model/generator/hifigan.py:13-129): conv_pre (K = 7, zero padding 3) ->
per upsample stage: leaky(0.1), `up_<i>` (a transposed conv, or a
nearest-neighbour upsample and conv), and the MRF, the mean of the stage's
resblocks -> leaky(0.01) -> conv_post (K = 7) -> tanh.  The width halves at
every stage: upsample_initial_channel // 2**(i + 1).

On CUDA, ResBlock1 MRF stages run the MRF kernel (`ops/fused_mrf.py`,
forward and backward), and in the fused form (`weight_norm=False`) the last
stage runs the tail kernel (`ops/fused_tail.py`) with the output head
whenever the JAX package would fuse it: a transposed conv with stride 2 and
ResBlock1 blocks.  The training form (`weight_norm=True`) runs the last
stage like the others, its MRF through the MRF kernel: the tail kernel is
inference only, in the JAX package too.  A width the kernels do not take
raises there.

With `compute_dtype=torch.bfloat16` the generator computes in bf16 as the
JAX package's does (`fastvocoder_tpu/models/hifigan.py:146-155,208,248`):
library convs in bf16, the MRF and tail kernels' bf16 forms (the input cast
to bf16 before each), a float32 waveform out; parameters stay float32.

Submodules are named as in the JAX package (`conv_pre`, `up_<i>`,
`resblock_<i>_<j>`, `conv_post`), so a parameter's path there is its
`state_dict` key here.
"""

from __future__ import annotations

import torch
from torch import nn

from fastvocoder_tpu_torch.hparams import HiFiGANConfig
from fastvocoder_tpu_torch.models.layers import (
    Conv1d,
    ConvTranspose1d,
    ResBlock1,
    ResBlock2,
    UpsampleLayer,
    apply_mrf,
)
from fastvocoder_tpu_torch.ops._build import refuse_autograd
from fastvocoder_tpu_torch.ops.fused_mrf import LRELU_SLOPE
from fastvocoder_tpu_torch.ops.fused_resstack import leaky_relu
from fastvocoder_tpu_torch.ops.fused_tail import HEAD_SLOPE, TailTable, fused_hifigan_tail
from fastvocoder_tpu_torch.ops.precision import check_compute_dtype


def _tensors(ops):
    """The tensors of `tail_operands()`, in order."""
    k_up, b_up, _, _, blocks, k_post, b_post = ops
    return [k_up, b_up, *(t for pairs in blocks for p in pairs for t in p
                          if isinstance(t, torch.Tensor)), k_post, b_post]


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig, in_channels: int = 80, weight_norm: bool = False,
                 compute_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.weight_norm = weight_norm
        self.compute_dtype = check_compute_dtype(compute_dtype)
        kw = dict(bias=cfg.bias, weight_norm=weight_norm, compute_dtype=compute_dtype)
        ch = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(in_channels, ch, 7, padding=3, **kw)
        resblock = ResBlock1 if cfg.resblock_type == "1" else ResBlock2
        self.ups, self.mrfs = [], []
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            cin, ch = ch, cfg.upsample_initial_channel // 2 ** (i + 1)
            if cfg.transposedconv:
                up = ConvTranspose1d(cin, ch, k, stride=u, padding=u // 2 + u % 2,
                                     output_padding=u % 2, **kw)
            else:
                up = UpsampleLayer(cin, ch, upsample_rate=u, kernel_size=k, **kw)
            self.add_module(f"up_{i}", up)
            self.ups.append(up)
            blocks = []
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                             cfg.resblock_dilation_sizes)):
                block = resblock(ch, kernel_size=rk, dilations=rd, **kw)
                self.add_module(f"resblock_{i}_{j}", block)
                blocks.append(block)
            self.mrfs.append(blocks)
        self.conv_post = Conv1d(ch, cfg.out_bands, 7, padding=3, **kw)
        # the JAX package's tail gate (models/hifigan.py::_use_fused_tail),
        # widths aside: those the kernel does not take raise
        self.tail_fusable = (not weight_norm and cfg.transposedconv
                             and cfg.upsample_rates[-1] == 2 and cfg.resblock_type == "1")

    def tail_operands(self):
        """The last stage and the head in the form `ops.fused_tail` takes."""
        up = self.ups[-1]
        k_up, b_up = up.tap_major()
        k_post, b_post = self.conv_post.tap_major()
        return (k_up, b_up, up.stride, up.padding,
                [b.mrf_operands() for b in self.mrfs[-1]], k_post, b_post)

    def tail_table(self, device: torch.device, dtype: torch.dtype = torch.float32) -> TailTable:
        """The tail's `TailTable` on `device` for the kernel's form of
        `dtype`, kept on the model until one of the tail's operands is
        rebuilt (a weight written or moved: the convs' caches key on each
        parameter's storage and version) or another form asks."""
        ops = self.tail_operands()
        key = (device, dtype, *(id(t) for t in _tensors(ops)))
        if key != getattr(self, "_tail_key", None):
            self._tail_table = TailTable(*ops, device, dtype)
            self._tail_key = key
        return self._tail_table

    def trunk(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, in) -> (B, T * prod(rates), out_bands), after tanh."""
        x = self.conv_pre(mel)
        last = len(self.ups) - 1
        for i, (up, blocks) in enumerate(zip(self.ups, self.mrfs)):
            if i == last and x.is_cuda and self.tail_fusable:
                refuse_autograd("fused_tail", self.parameters())
                if self.compute_dtype is not None:  # the kernel's bf16 form
                    x = x.to(self.compute_dtype)
                table = self.tail_table(x.device, x.dtype)
                return fused_hifigan_tail(x.contiguous(), *table.keep, table=table)
            x = leaky_relu(x, LRELU_SLOPE)
            x = up(x)
            x = apply_mrf(x, blocks)
        x = leaky_relu(x, HEAD_SLOPE)  # the reference's default slope (hifigan.py:104)
        return torch.tanh(self.conv_post(x))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T, in) -> waveform (B, T * prod(rates)) for one band, else the
        bands (B, T * prod(rates), out_bands); float32 in every compute
        type."""
        x = self.trunk(mel).float()
        return x[..., 0] if self.cfg.out_bands == 1 else x

    def inference(self, mel: torch.Tensor) -> torch.Tensor:
        """The waveform: the plain call, as the JAX package serves HiFiGAN."""
        return self(mel)
