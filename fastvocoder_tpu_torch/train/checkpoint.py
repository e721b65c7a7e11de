"""Save and load the port's training state in the reference's checkpoint
layout, and find a run's newest checkpoint.

The port's copy of `fastvocoder_tpu/train/checkpoint.py`'s key maps and
file layout (the port imports nothing of the JAX package).  The reference
saves `{'model', 'optimizer', 'discriminator', 'discriminator_optimizer'}`
with `torch.save` (reference bin/train.py:235-247); the JAX package writes
`model` and `discriminator` under the reference's torch key names (weight
norm as `weight_v` / `weight_g`, torch layouts), NHV (which the reference
never had) as a flat `a/b/kernel` dict of its JAX tree, plus `step` and its
optax states under `optimizer` and `discriminator_optimizer`.

`save_checkpoint` writes `model`, `discriminator` (with the MFD's Hann
windows as the reference's buffers) and `step` exactly as the JAX package
does, and beside them `format` (`REFERENCE_FORMAT`), `model_name` and the
two Adam states under keys of its own, `generator_adam` and
`discriminator_adam`: torch Adam's `exp_avg` and `exp_avg_sq` keyed by
reference parameter name, in the reference's layout, the optimiser's
`step` (every parameter takes each step) and its update count.  The JAX
package's `load_checkpoint` hands `optimizer` / `discriminator_optimizer` to optax, so
these keys stay clear of them: it reads a port checkpoint's weights and
starts a fresh optimiser.

`load_checkpoint` reads that format, the port's earlier `TRAIN_FORMAT`
payloads, and a checkpoint the JAX package's trainer wrote: `model`,
`discriminator`, `step`, and optax's `ScaleByAdamState(count, mu, nu)`
(inside `(EmptyState, (ScaleByAdamState, ...))`, or a `PartitionState` of
`MaskedState`s with `MaskedNode` leaves for Basis-MelGAN's frozen basis)
mapped per parameter into torch Adam's `step`, `exp_avg` and `exp_avg_sq`.
Moments take their parameters' layout changes.  The file is read by the
restricted unpickler of `checkpoint.torch_load`, without JAX or optax.

`AsyncCheckpointWriter` writes on a worker thread; `submit` snapshots the
state on the device first, before the next step is queued.

`save_published` writes the published `{model, pattern}` file as the JAX
package's does; `generator_state` reads the training-form generator of any
of these files.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import TYPE_CHECKING, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from fastvocoder_tpu_torch.checkpoint import (
    REFERENCE_FORMAT,
    TRAIN_FORMAT,
    OptaxRecord,
    jax_tree_from_state_dict,
    read_checkpoint,
    state_dict_from_jax,
)
from fastvocoder_tpu_torch.dsp.stft import hann_window
from fastvocoder_tpu_torch.hparams import (
    BasisMelGANConfig,
    DiscriminatorConfig,
    HiFiGANConfig,
    MelGANConfig,
    ModelConfig,
)

if TYPE_CHECKING:
    from fastvocoder_tpu_torch.train.trainer import TrainState

FlaxPath = Tuple[str, ...]
Tree = dict


@dataclasses.dataclass(frozen=True)
class MapEntry:
    torch_prefix: str       # e.g. "melgan.1" (keys: .weight_v / .weight_g / .bias)
    flax_path: FlaxPath     # e.g. ("conv_pre",)
    kind: str               # "conv" | "convT" | "conv2d" | "basis"
    bias: bool = True
    weight_norm: bool = True


# ---------------------------------------------------------------------------
# Key maps (construction order == the reference's torch registration order)
# ---------------------------------------------------------------------------


def _melgan_stack_entries(prefix: str, flax_prefix: FlaxPath, causal: bool, bias: bool,
                          wn: bool) -> List[MapEntry]:
    """ResidualStack keys (reference modules.py:350-370): non-causal stack =
    Sequential(act, pad, conv, act, conv1x1) -> stack.2 / stack.4; causal =
    Sequential(act, CausalConv1d, act, conv1x1) -> stack.1.conv / stack.3."""
    if not causal:
        dil, one, dil_path = f"{prefix}.stack.2", f"{prefix}.stack.4", flax_prefix + ("conv_dilated",)
    else:
        dil, one = f"{prefix}.stack.1.conv", f"{prefix}.stack.3"
        dil_path = flax_prefix + ("conv_dilated", "conv")
    return [
        MapEntry(dil, dil_path, "conv", bias, wn),
        MapEntry(one, flax_prefix + ("conv_1x1",), "conv", bias, wn),
        MapEntry(f"{prefix}.skip_layer", flax_prefix + ("skip",), "conv", bias, wn),
    ]


def _melgan_trunk_entries(seq_name: str, scales: Sequence[int], stacks: int, causal: bool,
                          bias: bool, wn: bool, transposedconv: bool = True,
                          with_last_layer: bool = True) -> List[MapEntry]:
    entries = [MapEntry(f"{seq_name}.1", ("conv_pre",), "conv", bias, wn)]
    per_scale = 2 + stacks
    for i, _ in enumerate(scales):
        base = 2 + i * per_scale
        if transposedconv:
            entries.append(MapEntry(f"{seq_name}.{base + 1}", (f"up_{i}",), "convT", bias, wn))
        else:
            entries.append(MapEntry(f"{seq_name}.{base + 1}.conv", (f"up_{i}", "conv"), "conv",
                                    bias, wn))
        for j in range(stacks):
            entries += _melgan_stack_entries(f"{seq_name}.{base + 2 + j}", (f"stack_{i}_{j}",),
                                             causal, bias, wn)
    if with_last_layer:
        last = 2 + len(scales) * per_scale
        entries.append(MapEntry(f"{seq_name}.{last}.conv", ("conv_post", "conv"), "conv", bias, wn))
    return entries


def _hifigan_entries(arch: HiFiGANConfig, flax_prefix: FlaxPath = ()) -> List[MapEntry]:
    bias = arch.bias
    entries = [MapEntry("conv_pre", flax_prefix + ("conv_pre",), "conv", bias)]
    nk = len(arch.resblock_kernel_sizes)
    for i in range(len(arch.upsample_rates)):
        if arch.transposedconv:
            entries.append(MapEntry(f"ups.{i}", flax_prefix + (f"up_{i}",), "convT", bias))
        else:
            entries.append(MapEntry(f"ups.{i}.conv", flax_prefix + (f"up_{i}", "conv"), "conv",
                                    bias))
    for i in range(len(arch.upsample_rates)):
        for j in range(nk):
            r = i * nk + j
            rb = flax_prefix + (f"resblock_{i}_{j}",)
            ndil = len(arch.resblock_dilation_sizes[j])
            if arch.resblock_type == "1":
                for conv in ("1", "2"):
                    entries += [MapEntry(f"resblocks.{r}.convs{conv}.{m}", rb + (f"conv{conv}_{m}",),
                                         "conv", bias) for m in range(ndil)]
            else:
                entries += [MapEntry(f"resblocks.{r}.convs.{m}", rb + (f"conv_{m}",), "conv", bias)
                            for m in range(ndil)]
    entries.append(MapEntry("conv_post", flax_prefix + ("conv_post",), "conv", bias))
    return entries


def generator_key_map(cfg: ModelConfig) -> List[MapEntry]:
    """The reference's torch keys of `cfg`'s generator (NHV has none: its
    checkpoints are flat, `has_torch_layout`)."""
    arch = cfg.arch
    if cfg.model_name == "melgan":
        assert isinstance(arch, MelGANConfig)
        return _melgan_trunk_entries("melgan", arch.upsample_scales, arch.stacks,
                                     arch.use_causal_conv, arch.bias, arch.use_weight_norm)
    if cfg.model_name == "basis-melgan":
        assert isinstance(arch, BasisMelGANConfig)
        entries = _melgan_trunk_entries("melgan", arch.upsample_scales, arch.stacks,
                                        arch.use_causal_conv, arch.bias, arch.use_weight_norm,
                                        transposedconv=arch.transposedconv, with_last_layer=False)
        entries.append(MapEntry("basis_signal.layer", ("basis_signal",), "basis", bias=False,
                                weight_norm=False))
        return entries
    if cfg.model_name == "hifigan":
        return _hifigan_entries(arch)
    if cfg.model_name == "multiband-hifigan":
        return _hifigan_entries(arch, flax_prefix=("trunk",))
    raise ValueError(cfg.model_name)


def _scale_entries(torch_prefix: str, flax_prefix: FlaxPath, n_down: int) -> List[MapEntry]:
    """One MSD scale (reference msd.py:54-100) or MFD resolution (mfd.py:77-123):
    layers.0 = Seq(pad, conv, act); layers.1..n_down = downsamples Seq(conv,
    act); then Seq(conv, act); then the output conv."""
    return ([MapEntry(f"{torch_prefix}.layers.0.1", flax_prefix + ("conv_first",), "conv")]
            + [MapEntry(f"{torch_prefix}.layers.{1 + i}.0", flax_prefix + (f"conv_down_{i}",),
                        "conv") for i in range(n_down)]
            + [MapEntry(f"{torch_prefix}.layers.{1 + n_down}.0", flax_prefix + ("conv_head",),
                        "conv"),
               MapEntry(f"{torch_prefix}.layers.{2 + n_down}", flax_prefix + ("conv_out",), "conv")])


def discriminator_key_map(disc_cfg: DiscriminatorConfig, use_mpd: bool = False) -> List[MapEntry]:
    """The reference's torch keys of the composite discriminator: MSD, MFD
    and, with `use_mpd` or `disc_cfg.use_mpd`, the MPD."""
    entries: List[MapEntry] = []
    for s in range(disc_cfg.msd_scales):
        entries += _scale_entries(f"msd.discriminators.{s}", ("msd", f"disc_{s}"),
                                  len(disc_cfg.msd_downsample_scales))
    for i in range(len(disc_cfg.mfd_fft_sizes)):
        entries += _scale_entries(f"mfd.stft_discriminator.{i}", ("mfd", f"disc_{i}"),
                                  len(disc_cfg.mfd_downsample_scales))
    if use_mpd or disc_cfg.use_mpd:
        for i in range(len(disc_cfg.mpd_periods)):
            p, f = f"mpd.discriminators.{i}", ("mpd", f"disc_{i}")
            # the strided stack and the stride-1 head: len(channels) + 1 convs
            entries += [MapEntry(f"{p}.convs.{c}", f + (f"conv_{c}",), "conv2d")
                        for c in range(len(disc_cfg.mpd_channels) + 1)]
            entries.append(MapEntry(f"{p}.conv_post", f + ("conv_post",), "conv2d"))
    return entries


def discriminator_buffers() -> Dict[str, torch.Tensor]:
    """The reference's MFD registers Hann windows as buffers (mfd.py:68);
    written, as the JAX package writes them, so that saved dicts load
    strictly in the reference."""
    return {f"mfd.stft_discriminator.{i}.window": hann_window(w)
            for i, w in enumerate((1200, 600, 240))}


def has_torch_layout(model_name: str) -> bool:
    return model_name != "nhv"


# ---------------------------------------------------------------------------
# Conversion: the reference's torch keys <-> JAX-layout trees <-> the port
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _node(tree: Tree, path: FlaxPath) -> Optional[dict]:
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            return None
        tree = tree[p]
    return tree


def _set(tree: Tree, path: FlaxPath, leaf: str, value: np.ndarray) -> None:
    for p in path:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def torch_to_flax(state: Mapping, key_map: Sequence[MapEntry], partial: bool = False) -> Tree:
    """Reference torch keys -> a nested JAX-layout tree of numpy arrays
    (kernels (K, Cin, Cout) or (kh, kw, Cin, Cout), gains 1-D).  With
    `partial`, entries absent from `state` are skipped (an optimiser's
    moments: no frozen basis)."""
    params: Tree = {}
    for e in key_map:
        if e.kind == "basis":
            key = f"{e.torch_prefix}.weight"
            if key in state or not partial:
                _set(params, e.flax_path, "basis", np.ascontiguousarray(_np(state[key])))
            continue
        v_key = f"{e.torch_prefix}.weight_v" if e.weight_norm else f"{e.torch_prefix}.weight"
        if partial and v_key not in state:
            continue
        v = _np(state[v_key])
        axes = {"conv": (2, 1, 0), "convT": (2, 0, 1), "conv2d": (2, 3, 1, 0)}[e.kind]
        _set(params, e.flax_path, "kernel", np.ascontiguousarray(np.transpose(v, axes)))
        if e.weight_norm:
            _set(params, e.flax_path, "gt" if e.kind == "convT" else "g",
                 _np(state[f"{e.torch_prefix}.weight_g"]).reshape(-1))
        if e.bias:
            _set(params, e.flax_path, "bias", _np(state[f"{e.torch_prefix}.bias"]))
    return params


def flax_to_torch(params: Tree, key_map: Sequence[MapEntry],
                  partial: bool = False) -> Dict[str, torch.Tensor]:
    """A nested JAX-layout tree -> reference torch keys (CPU tensors).  With
    `partial`, entries absent from the tree are skipped."""
    out: Dict[str, torch.Tensor] = {}
    for e in key_map:
        node = _node(params, e.flax_path)
        if node is None and partial:
            continue
        if node is None:
            raise KeyError(f"no {'/'.join(e.flax_path)} for {e.torch_prefix}")
        if e.kind == "basis":
            out[f"{e.torch_prefix}.weight"] = torch.from_numpy(np.array(node["basis"]))
            continue
        k = np.asarray(node["kernel"])
        axes, gain, gshape = {"conv": ((2, 1, 0), "g", (-1, 1, 1)),
                              "convT": ((1, 2, 0), "gt", (-1, 1, 1)),
                              "conv2d": ((3, 2, 0, 1), "g", (-1, 1, 1, 1))}[e.kind]
        v = torch.from_numpy(np.ascontiguousarray(np.transpose(k, axes)))
        if e.weight_norm and gain in node:
            out[f"{e.torch_prefix}.weight_v"] = v
            out[f"{e.torch_prefix}.weight_g"] = torch.from_numpy(
                np.array(node[gain]).reshape(gshape))
        else:
            out[f"{e.torch_prefix}.weight"] = v
        if e.bias:
            out[f"{e.torch_prefix}.bias"] = torch.from_numpy(np.array(node["bias"]))
    return out


def _nest(flat: Mapping[str, np.ndarray]) -> Tree:
    tree: Tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        _set(tree, tuple(parents), leaf, v)
    return tree


def generator_tree(model: Mapping, cfg: ModelConfig) -> Tree:
    """A reference-layout `model` entry -> the generator's JAX-layout tree
    (nested, or NHV's flat `a/b/kernel` one)."""
    if has_torch_layout(cfg.model_name):
        return torch_to_flax(model, generator_key_map(cfg))
    return {k: _np(v) for k, v in model.items()}


def reference_from_port(state: Mapping[str, torch.Tensor], entries: Optional[Sequence[MapEntry]],
                        partial: bool = False) -> Dict[str, torch.Tensor]:
    """A port `state_dict` in the training form (or anything keyed alike:
    an optimiser's moments) -> the reference's keys and layouts; with
    `entries` None, NHV's flat `a/b/kernel` layout."""
    flat = jax_tree_from_state_dict(state)
    if entries is None:  # in the order of a JAX tree's leaves: sorted by path
        return {k: torch.from_numpy(np.array(flat[k]))
                for k in sorted(flat, key=lambda k: k.split("/"))}
    return flax_to_torch(_nest(flat), entries, partial=partial)


def port_from_reference(ref: Mapping, entries: Optional[Sequence[MapEntry]],
                        partial: bool = False) -> Dict[str, torch.Tensor]:
    """The inverse of `reference_from_port`: the training form's keys."""
    if entries is None:
        return state_dict_from_jax({k: _np(v) for k, v in ref.items()}, fuse=False)
    return state_dict_from_jax(torch_to_flax(ref, entries, partial=partial), fuse=False)


def _key_maps(state: "TrainState", model_name: str):
    cfg = ModelConfig(model_name, state.generator.cfg)
    gen = generator_key_map(cfg) if has_torch_layout(model_name) else None
    disc = state.discriminator
    return gen, discriminator_key_map(disc.cfg, use_mpd=disc.mpd is not None)


# ---------------------------------------------------------------------------
# Optimiser state
# ---------------------------------------------------------------------------


def _adam_by_name(opt: torch.optim.Adam, module: torch.nn.Module) -> Dict[str, dict]:
    """`opt`'s per-parameter state by the parameter's name in `module`
    (clones: a snapshot)."""
    names = {p: n for n, p in module.named_parameters()}
    return {names[p]: {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in st.items()}
            for p, st in opt.state.items() if st}


def _adam_payload(by_name: Mapping[str, dict], entries, updates: int) -> dict:
    """Moments keyed by reference name in the reference's layout; every
    parameter of an optimiser has taken the same steps, so one `step`."""
    step = next(iter(by_name.values()))["step"] if by_name else torch.tensor(0.0)
    out = {"updates": int(updates), "step": step.detach().cpu()}
    for f in ("exp_avg", "exp_avg_sq"):
        out[f] = reference_from_port({n: st[f] for n, st in by_name.items()}, entries,
                                     partial=True)
    return out


def _set_adam(opt: torch.optim.Adam, module: torch.nn.Module, step: torch.Tensor,
              exp_avg: Mapping, exp_avg_sq: Mapping) -> None:
    """Fill `opt`'s state for `module`'s parameters from moments keyed by
    port name, every parameter at `step` (a 0-d tensor)."""
    params = {id(p) for g in opt.param_groups for p in g["params"]}
    opt.state.clear()
    for name, p in module.named_parameters():
        if id(p) not in params:
            continue
        if name not in exp_avg:
            raise ValueError(f"the optimiser state holds no moments of {name}")
        opt.state[p] = {
            "step": step.clone(),
            "exp_avg": exp_avg[name].to(p.device, p.dtype).reshape(p.shape).clone(),
            "exp_avg_sq": exp_avg_sq[name].to(p.device, p.dtype).reshape(p.shape).clone(),
        }


def _load_adam(opt, module, saved: dict, entries) -> None:
    if not saved["exp_avg"]:
        opt.state.clear()
        return
    moments = [port_from_reference(saved[f], entries, partial=True)
               for f in ("exp_avg", "exp_avg_sq")]
    _set_adam(opt, module, saved["step"], *moments)


def _find_record(obj, name: str):
    """The first `OptaxRecord` called `name` in an optax state."""
    if isinstance(obj, OptaxRecord) and obj.optax_name == name:
        return obj
    children = obj.values() if isinstance(obj, Mapping) else (
        obj if isinstance(obj, (tuple, list)) else ())
    for c in children:
        found = _find_record(c, name)
        if found is not None:
            return found
    return None


def _flax_leaves(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """The arrays of a nested moment tree by `a/b/c` path; optax's
    `MaskedNode`s (a frozen parameter) are left out."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flax_leaves(v, key))
        elif not isinstance(v, OptaxRecord):
            out[key] = np.asarray(v, np.float32)
    return out


def _load_optax_adam(opt, module, optax_state) -> int:
    """Map the JAX package's optax Adam state into `opt` -> its count."""
    adam = _find_record(optax_state, "ScaleByAdamState")
    if adam is None:
        raise ValueError("the optimiser state holds no ScaleByAdamState")
    count, mu, nu = adam
    count = int(np.asarray(count))
    if count == 0:
        opt.state.clear()
        return 0
    moments = [state_dict_from_jax(_flax_leaves(m), fuse=False) for m in (mu, nu)]
    _set_adam(opt, module, torch.tensor(float(count)), *moments)
    return count


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


def latest_checkpoint(run_dir: str) -> Optional[str]:
    """The checkpoint_<step>.pth.tar of the highest step under `run_dir`,
    searched recursively (a run directory or its checkpoint/ root)."""
    best, best_step = None, -1
    for root, _, files in os.walk(run_dir):
        for f in files:
            if f.startswith("checkpoint_") and f.endswith(".pth.tar"):
                try:
                    step = int(f[len("checkpoint_"):-len(".pth.tar")])
                except ValueError:
                    continue
                if step > best_step:
                    best, best_step = os.path.join(root, f), step
    return best


def _payload(model_name: str, maps, gen: Mapping, disc: Mapping, gen_adam: Mapping,
             disc_adam: Mapping, step: int, gen_updates: int, disc_updates: int) -> dict:
    gen_map, disc_map = maps
    discriminator = reference_from_port(disc, disc_map)
    discriminator.update(discriminator_buffers())
    return {
        "model": reference_from_port(gen, gen_map),
        "discriminator": discriminator,
        "step": int(step),
        "format": REFERENCE_FORMAT,
        "model_name": model_name,
        "generator_adam": _adam_payload(gen_adam, gen_map, gen_updates),
        "discriminator_adam": _adam_payload(disc_adam, disc_map, disc_updates),
    }


def _snapshot(state: "TrainState", model_name: str) -> tuple:
    """`_payload`'s arguments, every tensor cloned on its device."""
    clone = lambda m: {k: v.clone() for k, v in m.state_dict().items()}
    return (model_name, _key_maps(state, model_name), clone(state.generator),
            clone(state.discriminator), _adam_by_name(state.gen_opt, state.generator),
            _adam_by_name(state.disc_opt, state.discriminator), state.step, state.gen_updates,
            state.disc_updates)


def write_payload(path: str, payload: dict) -> None:
    """`torch.save` through a temporary file, so a reader never sees half a
    checkpoint."""
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: "TrainState", model_name: str) -> None:
    """Write `state` to `path` in the reference layout (module docstring)."""
    write_payload(path, _payload(*_snapshot(state, model_name)))


def load_checkpoint(path: str, state: "TrainState", model_name: str) -> "TrainState":
    """Load `path` into `state`'s modules and optimisers, in place: a
    checkpoint of this package (either format) or of the JAX package's
    trainer (its Adam states included).  Refuses another model's file."""
    kind, payload = read_checkpoint(path)
    if kind == "release":
        raise ValueError(f"{path} is a release checkpoint: it holds no training state")
    saved_model = payload.get("model_name")
    if saved_model is not None and saved_model != model_name:
        raise ValueError(f"{path} holds a {saved_model!r} run, not {model_name!r}")
    if kind == "train":
        state.generator.load_state_dict(payload["generator"])
        state.discriminator.load_state_dict(payload["discriminator"])
        state.gen_opt.load_state_dict(payload["optimizer"])
        state.disc_opt.load_state_dict(payload["discriminator_optimizer"])
        state.step = int(payload["step"])
        state.gen_updates = int(payload["gen_updates"])
        state.disc_updates = int(payload["disc_updates"])
        return state
    gen_map, disc_map = _key_maps(state, model_name)
    try:
        gen = port_from_reference(payload["model"], gen_map)
        disc = port_from_reference(payload["discriminator"], disc_map)
    except KeyError as e:
        raise ValueError(f"{path} does not hold this {model_name!r} configuration's "
                         f"generator and discriminator: no {e}") from e
    state.generator.load_state_dict(gen)
    state.discriminator.load_state_dict(disc)
    state.step = int(payload.get("step", 0))
    if "generator_adam" in payload:  # this package's own
        _load_adam(state.gen_opt, state.generator, payload["generator_adam"], gen_map)
        _load_adam(state.disc_opt, state.discriminator, payload["discriminator_adam"], disc_map)
        state.gen_updates = payload["generator_adam"]["updates"]
        state.disc_updates = payload["discriminator_adam"]["updates"]
    else:  # the JAX package's: optax states, if it saved them
        state.gen_updates = state.disc_updates = 0
        if "optimizer" in payload:
            state.gen_updates = _load_optax_adam(state.gen_opt, state.generator,
                                                 payload["optimizer"])
        if "discriminator_optimizer" in payload:
            state.disc_updates = _load_optax_adam(state.disc_opt, state.discriminator,
                                                  payload["discriminator_optimizer"])
    return state


def generator_state(path: str, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The generator of a training checkpoint (either of this package's
    formats, or the JAX package's) or of a published file, as the training
    form's `state_dict` (`build_generator(cfg, weight_norm=True)`).
    Refuses a release checkpoint (its weights are fused) and another
    model's file."""
    kind, payload = read_checkpoint(path)
    if kind == "release":
        raise ValueError(f"{path} is a release checkpoint: it holds no training-form generator")
    saved_model = payload.get("model_name")
    if saved_model is not None and saved_model != cfg.model_name:
        raise ValueError(f"{path} holds a {saved_model!r} model, not {cfg.model_name!r}")
    if kind == "train":
        return dict(payload["generator"])
    entries = generator_key_map(cfg) if has_torch_layout(cfg.model_name) else None
    try:
        return port_from_reference(payload["model"], entries)
    except KeyError as e:
        raise ValueError(f"{path} does not hold this {cfg.model_name!r} configuration's "
                         f"generator: no {e}") from e


def save_published(path: str, cfg: ModelConfig, generator_state: Mapping[str, torch.Tensor],
                   pattern: np.ndarray) -> None:
    """The published artifact `{'model', 'pattern'}` (reference
    bin/publish.py:71-74), as the JAX package's `save_published` writes it:
    the training-form generator state under the reference's keys and
    layouts (NHV: its flat layout), and the zero-mel `pattern` as a numpy
    array (empty but for Basis-MelGAN)."""
    entries = generator_key_map(cfg) if has_torch_layout(cfg.model_name) else None
    write_payload(path, {"model": reference_from_port(generator_state, entries),
                         "pattern": np.asarray(pattern)})


class AsyncCheckpointWriter:
    """Checkpoint saves on a worker thread, in submission order.

    Adam and the parameters update in place, so a snapshot taken after the
    next `opt.step()` has been queued would be torn (torch's form of the
    donated-buffer race of the JAX package's writer).  `submit` therefore
    clones every tensor of the state on its device, on the caller's stream,
    before it returns, that is before the next step is queued; the worker
    waits for the clones, converts and writes them.  `wait()` blocks until
    every save is on disk and re-raises the first failure."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._errors: List[BaseException] = []
        self._t = threading.Thread(target=self._worker, daemon=True, name="checkpoint_writer")
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:  # close()
                self._q.task_done()
                return
            path, args, ready = item
            try:
                if ready is not None:
                    ready.synchronize()
                write_payload(path, _payload(*args))
            except Exception as e:  # surfaced by wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def submit(self, path: str, state: "TrainState", model_name: str) -> None:
        args = _snapshot(state, model_name)
        ready = None
        if next(state.generator.parameters()).is_cuda:
            ready = torch.cuda.Event()
            ready.record()
        self._q.put((path, args, ready))

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        """End the worker after the saves already submitted."""
        self._q.put(None)
        self._t.join()
