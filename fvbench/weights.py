"""The weights of a cell, made from its seed on the device.

Both sides get the same values: the program's modules by `load_state_dict`,
the reference as a dict.  Names are the published checkpoints' (the
program's `state_dict` keys and the reference's `Params` keys).  Every
value of a network comes from one `torch.rand` draw of a `torch.Generator`
on the device, seeded seed * 4 + `STREAM`, the stream that the network's
reference module declares (the generator's and the discriminator's of a
configuration differ), cut into leaves: a conv's weight and bias
U(-b, b) with b = 1 / sqrt(fan_in) (torch's conv init; fan_in = the
product of shape[1:], for a transposed conv too, as torch counts it),
Basis-MelGAN's basis U(-b, b) with b = 1 / sqrt(C).  The training form
adds each conv's gain at the norm of its weight over every axis but the
first (`g`, a transposed conv's `gt`), so that the effective weight starts
at the weight, as the program's own init does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from fvbench.reference.nn import Params


def stream_of(module) -> int:
    """The seed offset of a reference module's draw, as it declares it."""
    stream = getattr(module, "STREAM", None)
    if not isinstance(stream, int):
        raise AttributeError(f"reference module {module.__name__} declares no integer STREAM: "
                             f"each reference network's draw needs a seed stream of its own")
    return stream


def _layout(module, cfg: dict, weight_norm: bool):
    """[(name, shape, fan_in or None for a gain)] in draw order."""
    transposed = module.TRANSPOSED
    out = []
    for name, shape in module.param_shapes(cfg).items():
        if name.endswith(".basis"):
            out.append((name, shape, shape[1]))
            continue
        fan_in = math.prod(shape[1:])
        is_t = transposed is not None and transposed.search(name) is not None
        out.append((name + ".weight", shape, fan_in))
        out.append((name + ".bias", (shape[1] if is_t else shape[0],), fan_in))
        if weight_norm:
            out.append((name + (".gt" if is_t else ".g"), (shape[0],), None))
    return out


def make_params(module, cfg: dict, seed: Optional[int], device="cuda",
                weight_norm: bool = True, grad: bool = False) -> Params:
    """The leaves of the network that reference `module` lays out
    (`param_shapes(cfg)`, `TRANSPOSED`, `STREAM`) for configuration `cfg`,
    from `seed` (None: uninitialised, as on the meta device), as float32
    tensors on `device`."""
    stream = stream_of(module)
    layout = _layout(module, cfg, weight_norm)
    drawn = [(n, s, f) for n, s, f in layout if f is not None]
    total = sum(torch.Size(s).numel() for _, s, _ in drawn)
    if seed is None:
        flat = torch.empty(total, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(int(seed) * 4 + stream)
        flat = torch.rand(total, generator=gen, device=device)
    P: Params = {}
    at = 0
    with torch.no_grad():
        for name, shape, fan_in in drawn:
            n = torch.Size(shape).numel()
            P[name] = flat[at:at + n].view(shape).mul_(2).sub_(1).mul_(fan_in ** -0.5)
            at += n
        for name, shape, fan_in in layout:
            if fan_in is None:
                w = P[name.rsplit(".", 1)[0] + ".weight"]
                P[name] = torch.sqrt(torch.sum(w * w, dim=tuple(range(1, w.dim()))))
    P = {n: P[n].clone() for n, _, _ in layout}  # own storage a leaf, in layout order
    if grad:
        for t in P.values():
            t.requires_grad_(True)
    return P


def meta_params(module, cfg: dict, weight_norm: bool, grad: bool = False) -> Params:
    """The leaves' names and shapes, on the meta device."""
    return make_params(module, cfg, None, device="meta", weight_norm=weight_norm, grad=grad)
