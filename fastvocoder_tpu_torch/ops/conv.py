"""1-D convolution primitives, channels last (B, T, C) in and out.

Counterpart of `fastvocoder_tpu/ops/conv.py`.  Weights are in PyTorch's
layout: `(Cout, Cin // groups, K)` for a convolution, `(Cin, Cout, K)` for a
transposed one.  The convolutions themselves are `F.conv1d` and
`F.conv_transpose1d` on a (B, C, T) view; the results are made contiguous
again in (B, T, C), the layout the port's kernels take.  A CUDA float32
conv of 4 input channels a group (the discriminators' downsample convs) goes
to the kernels of `ops/grouped_conv.py` instead, which read and write
(B, T, C) themselves (`grouped_conv.kernel_takes` says which).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from fastvocoder_tpu_torch.ops.grouped_conv import grouped_conv1d, kernel_takes

Pad = Union[int, Tuple[int, int]]


def _pair(pad: Pad) -> Tuple[int, int]:
    return (pad, pad) if isinstance(pad, int) else (int(pad[0]), int(pad[1]))


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    padding: Pad = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """`torch.nn.functional.conv1d` on x (B, T, Cin) -> (B, T', Cout);
    zero `padding` may be asymmetric."""
    left, right = _pair(padding)
    if kernel_takes(x.device.type, x.dtype, x.shape[-1], weight.shape[0], groups,
                    weight.shape[-1], stride, dilation, left, right):
        return grouped_conv1d(x.contiguous(), weight.contiguous(), bias, stride, left)
    xt = x.transpose(1, 2)
    if left != right:
        xt = F.pad(xt, (left, right))
        left = 0
    y = F.conv1d(xt, weight, bias, stride=stride, padding=left,
                 dilation=dilation, groups=groups)
    return y.transpose(1, 2).contiguous()


def conv_transpose1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    padding: int = 0,
    output_padding: int = 0,
) -> torch.Tensor:
    """`torch.nn.functional.conv_transpose1d` on x (B, T, Cin) ->
    (B, (T-1)*stride - 2*padding + K + output_padding, Cout)."""
    y = F.conv_transpose1d(x.transpose(1, 2), weight, bias, stride=stride,
                           padding=padding, output_padding=output_padding)
    return y.transpose(1, 2).contiguous()


def avg_pool1d(x: torch.Tensor, kernel_size: int, stride: int, padding: int = 0,
               count_include_pad: bool = True) -> torch.Tensor:
    """`torch.nn.AvgPool1d` on the time axis of (B, T, C)."""
    y = F.avg_pool1d(x.transpose(1, 2), kernel_size, stride, padding,
                     count_include_pad=count_include_pad)
    return y.transpose(1, 2).contiguous()


def reflect_index(T: int, pad: Pad, device=None) -> torch.Tensor:
    """Source rows of a reflect-padded length-T sequence: index i of the
    padded sequence reads row reflect(i - left).  Pads of any size repeat
    the reflection, as `numpy.pad(mode="reflect")` does (and as the JAX
    package's `jnp.pad` does); torch's own reflect pad refuses pads >= T."""
    left, right = _pair(pad)
    i = torch.arange(-left, T + right, device=device)
    if T == 1:
        return torch.zeros_like(i)
    period = 2 * (T - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= T, period - i, i)


def reflect_pad1d(x: torch.Tensor, pad: Pad) -> torch.Tensor:
    """`torch.nn.ReflectionPad1d` on the time axis of (B, T, C)."""
    return x.index_select(1, reflect_index(x.shape[1], pad, device=x.device))
