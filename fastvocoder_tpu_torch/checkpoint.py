"""Carry weights from the JAX package's parameter trees into the port.

`state_dict_from_jax` maps a JAX parameter tree, nested or flat with `/`
keys as in `docs/checkpoints/*.npz`, onto the port's `state_dict`:

  * a node's path becomes its key (`stack_0_0/conv_dilated` ->
    `stack_0_0.conv_dilated`), the port's modules being named alike;
  * by default weight norm is fused in float32, as the JAX package's
    `train/checkpoint.py::fuse_weight_norm` does: `g` scales each output
    channel over (K, Cin), `gt` (transposed convs) each input channel over
    (K, Cout).  Trees already fused are taken as they are.  With
    `fuse=False` the gains are kept (`<node>.g`, `<node>.gt`) beside the
    direction (`<node>.weight`): the state of the training form
    (`build_generator(cfg, weight_norm=True)`, `build_discriminator`);
  * kernels (K, Cin, Cout) become torch weights: (Cout, Cin, K) for a
    convolution, (Cin, Cout, K) for a transposed one.  A transposed conv is
    a node with `gt`, or, in a fused tree, an upsampler node `up_<i>`;
  * 2-D kernels (kh, kw, Cin, Cout) (the multi-period discriminator's
    `_WNConv2d`) become (Cout, Cin, kh, kw), their gain `g` normalising each
    output channel over (kh, kw, Cin);
  * a leaf of the tree's root that is a parameter of its own (`ROOT_LEAVES`:
    NHV's trainable FIR `fir`, (taps, 1, 1)) keeps its name and layout;
  * a BatchNorm node (`LastLinear`'s `bn_1`, `bn_2`): its `scale` and
    `bias` become `weight` and `bias`, and given the tree's `batch_stats`
    its `mean` and `var` become `running_mean` and `running_var`.

Any other leaf is refused by name.

`load_release_npz` reads a committed release checkpoint.  A training
checkpoint is a `torch.save` file in one of two layouts:

  * the reference's (`REFERENCE_FORMAT`): `model` and `discriminator` under
    the upstream torch key names, `step`, as the JAX package's trainer
    writes it and, since format `fastvocoder_tpu_torch.train/2`, the port's
    (`train/checkpoint.py`);
  * the port's earlier payload of format `TRAIN_FORMAT` (`train/1`), its
    modules' `state_dict`s in the training form.

`jax_tree_from_state_dict` carries a training-form state back into a flat
JAX-layout tree, so that `state_dict_from_jax` fuses it as it fuses a JAX
tree; `jax_batch_stats_from_state_dict` carries a BatchNorm's running
statistics back into the flat `batch_stats` tree.  `read_checkpoint` tells
the kinds of file apart by their contents.  A torch file is read with
`torch_load`, a restricted unpickler that needs neither JAX nor optax, the
JAX package's files included.
"""

from __future__ import annotations

import json
import pickle
import re
import types
import zipfile
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

Tree = Mapping[str, Union[np.ndarray, "Tree"]]

_UPSAMPLER = re.compile(r"up_\d+")

TRAIN_FORMAT = "fastvocoder_tpu_torch.train/1"  # the trainer's earlier payload
REFERENCE_FORMAT = "fastvocoder_tpu_torch.train/2"  # the trainer's, in the reference layout
ROOT_LEAVES = ("fir",)  # parameters at a tree's root, carried as they are


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _transposed(node: str, leaves: Mapping) -> bool:
    """Whether a kernel node is a transposed conv: it has a `gt` gain, or, in
    a fused tree, it is an upsampler `up_<i>`."""
    return "gt" in leaves or bool(_UPSAMPLER.fullmatch(node.split("/")[-1]))


def _fold_gain(k: np.ndarray, leaves: Mapping[str, np.ndarray]) -> np.ndarray:
    """The effective kernel of a weight-norm node: `g` scales each output
    channel (the last axis) over every other axis, `gt` (a transposed conv)
    each input channel (axis 1) over (K, Cout)."""
    if "g" in leaves:
        axes = tuple(range(k.ndim - 1))
        return k * (leaves["g"] / np.sqrt(np.sum(k**2, axis=axes, keepdims=True)))
    if "gt" in leaves:
        norm = np.sqrt(np.sum(k**2, axis=(0, 2), keepdims=True))
        return k * (leaves["gt"][None, :, None] / norm)
    return k


def _torch_layout(node: str, leaves: Mapping, k: np.ndarray) -> np.ndarray:
    if k.ndim == 4:  # (kh, kw, Cin, Cout) -> (Cout, Cin, kh, kw)
        return k.transpose(3, 2, 0, 1)
    return k.transpose(1, 2, 0) if _transposed(node, leaves) else k.transpose(2, 1, 0)


_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}  # Flax -> torch


def state_dict_from_jax(params: Tree, fuse: bool = True,
                        batch_stats: Optional[Tree] = None) -> Dict[str, torch.Tensor]:
    nodes: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in _flatten(params).items():
        node, _, leaf = key.rpartition("/")
        nodes.setdefault(node, {})[leaf] = value.astype(np.float32)
    stats: Dict[str, torch.Tensor] = {}
    for key, value in _flatten(batch_stats or {}).items():
        node, _, leaf = key.rpartition("/")
        if leaf not in _BATCH_STATS:
            raise ValueError(f"{node}: unexpected batch statistic {leaf!r}")
        stats[f"{node.replace('/', '.')}.{_BATCH_STATS[leaf]}"] = torch.from_numpy(
            value.astype(np.float32))

    out: Dict[str, torch.Tensor] = {}
    for node, leaves in nodes.items():
        if not node:
            unknown = set(leaves) - set(ROOT_LEAVES)
            if unknown:
                raise ValueError(f"unexpected parameters at the root {sorted(unknown)}")
            out.update((leaf, torch.from_numpy(v)) for leaf, v in leaves.items())
            continue
        name = node.replace("/", ".")
        unknown = set(leaves) - {"kernel", "g", "gt", "bias", "basis", "scale"}
        if unknown:
            raise ValueError(f"{node}: unexpected parameters {sorted(unknown)}")
        if "kernel" in leaves:
            k = leaves["kernel"]
            if fuse:
                k = _fold_gain(k, leaves)
            else:
                for gain in ("g", "gt"):
                    if gain in leaves:
                        out[f"{name}.{gain}"] = torch.from_numpy(leaves[gain])
            out[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(_torch_layout(node, leaves, k)))
        if "bias" in leaves:
            out[f"{name}.bias"] = torch.from_numpy(leaves["bias"])
        if "basis" in leaves:
            out[f"{name}.basis"] = torch.from_numpy(leaves["basis"])
        if "scale" in leaves:  # a BatchNorm
            out[f"{name}.weight"] = torch.from_numpy(leaves["scale"])
    out.update(stats)
    return out


def jax_tree_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The flat JAX-layout tree of a port `state_dict`: the inverse of
    `state_dict_from_jax(..., fuse=False)`.  Keys `<node>.<leaf>` become
    `<node>/<leaf>` (`weight` -> `kernel`), torch weights become kernels
    (K, Cin, Cout) or (kh, kw, Cin, Cout), gains and root leaves stay as
    they are; a BatchNorm's `weight` becomes its `scale`, and its running
    statistics are left to `jax_batch_stats_from_state_dict`."""
    out: Dict[str, np.ndarray] = {}
    for node, leaves in _nodes(state).items():
        batch_norm = "running_mean" in leaves
        for leaf, v in leaves.items():
            if batch_norm and leaf in _BATCH_STATS.values():
                continue
            if batch_norm and leaf == "weight":
                leaf = "scale"
            elif leaf == "weight":
                leaf = "kernel"
                if v.ndim == 4:
                    v = v.transpose(2, 3, 1, 0)
                else:
                    v = v.transpose(2, 0, 1) if _transposed(node, leaves) else v.transpose(2, 1, 0)
            out[f"{node}/{leaf}" if node else leaf] = np.ascontiguousarray(v)
    return out


def _nodes(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    nodes: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in state.items():
        node, _, leaf = key.rpartition(".")
        nodes.setdefault(node.replace(".", "/"), {})[leaf] = value.detach().cpu().numpy()
    return nodes


def jax_batch_stats_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The flat `batch_stats` tree of a port `state_dict`: each BatchNorm's
    `running_mean` and `running_var` as `<node>/mean` and `<node>/var`."""
    to_flax = {v: k for k, v in _BATCH_STATS.items()}
    return {f"{node}/{to_flax[leaf]}": np.ascontiguousarray(v)
            for node, leaves in _nodes(state).items() for leaf, v in leaves.items()
            if leaf in to_flax}


class OptaxRecord(tuple):
    """An optax state object (`ScaleByAdamState`, `EmptyState`,
    `MaskedState`, ...) read without optax: its fields in order, and its
    class's name in `optax_name`."""

    optax_name = ""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)

    def __setstate__(self, state):  # named tuples pickle no state
        pass


_RECORDS: Dict[str, type] = {}

# the globals a checkpoint file may name: torch's tensor rebuilds, numpy's
# array reconstruction (numpy 1 and 2), `_codecs.encode` and `bytes`
# (protocol 2's bytes; an empty array's data is `bytes()`: the published
# pattern of a family other than Basis-MelGAN) and OrderedDict; `optax.*`
# classes become `OptaxRecord`s
_ALLOWED = {
    ("torch._utils", "_rebuild_tensor"), ("torch._utils", "_rebuild_tensor_v2"),
    ("torch._utils", "_rebuild_parameter"), ("collections", "OrderedDict"),
    ("numpy", "ndarray"), ("numpy", "dtype"), ("_codecs", "encode"),
    ("__builtin__", "bytes"), ("builtins", "bytes"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "optax" or module.startswith("optax."):
            full = f"{module}.{name}"
            if full not in _RECORDS:
                _RECORDS[full] = type(name, (OptaxRecord,), {"optax_name": name})
            return _RECORDS[full]
        if (module, name) in _ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refused global {module}.{name}")


# what `torch.load(pickle_module=)` takes from a pickle module (zip files)
_restricted_pickle = types.ModuleType("fastvocoder_tpu_torch_restricted_pickle")
_restricted_pickle.Unpickler = _RestrictedUnpickler


def torch_load(path: str, map_location="cpu"):
    """`torch.load` of a training checkpoint through a restricted unpickler:
    tensors, numpy arrays, containers and plain values, optax state objects
    as `OptaxRecord`s; any other global raises `pickle.UnpicklingError`
    naming it.  Imports neither JAX nor optax."""
    return torch.load(path, map_location=map_location, pickle_module=_restricted_pickle,
                      weights_only=False)


def _formats_message(path: str, why: str) -> str:
    return (f"{path} {why}: a checkpoint is a release checkpoint (.npz with `meta` and "
            f"`param:` arrays, as tools/export_release_checkpoint.py writes), a training "
            f"checkpoint in the reference layout (`model` and `discriminator` under the "
            f"upstream torch key names: format {REFERENCE_FORMAT!r} of this package's "
            f"bin/train.py, or the JAX package's bin/train.py) or this package's earlier "
            f"training payload (format {TRAIN_FORMAT!r})")


def read_checkpoint(path: str, map_location="cpu") -> Tuple[str, Optional[dict]]:
    """-> (kind, payload): ("release", None) for a release checkpoint,
    ("reference", the torch payload) for the reference layout,
    ("train", the payload) for a `TRAIN_FORMAT` payload.  Any other file,
    whatever its name, raises ValueError naming every format."""
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
        if "meta.npy" in names:
            return "release", None
        if any(n.endswith("/data.pkl") for n in names):
            try:
                payload = torch_load(path, map_location)
            except pickle.UnpicklingError as e:
                raise ValueError(_formats_message(path, f"cannot be read ({e})")) from e
            if isinstance(payload, dict) and payload.get("format") == TRAIN_FORMAT:
                return "train", payload
            if isinstance(payload, dict) and isinstance(payload.get("model"), Mapping) \
                    and payload.get("format", REFERENCE_FORMAT) == REFERENCE_FORMAT:
                return "reference", payload
            raise ValueError(_formats_message(
                path, "is a torch file but not a checkpoint of this package's trainer"))
    raise ValueError(_formats_message(path, "is neither a release checkpoint nor a torch file"))


def checkpoint_format(path: str) -> str:
    """"release", "reference" or "train" (`read_checkpoint`)."""
    return read_checkpoint(path)[0]


def load_release_npz(path: str) -> dict:
    """A release checkpoint (`tools/export_release_checkpoint.py` format:
    f16 `param:<path>` arrays, a `pattern`, JSON `meta`) ->
    {model_name, config, state_dict, pattern}.  Arrays are cast to
    float32; `pattern` (the zero-mel response, 3,000 frames in the
    committed files) is None when empty."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        flat = {k[len("param:"):]: z[k] for k in z.files if k.startswith("param:")}
        pattern = z["pattern"].astype(np.float32)
    return {
        "model_name": meta["model_name"],
        "config": meta["config"],
        "state_dict": state_dict_from_jax(flat),
        "pattern": pattern if pattern.size else None,
    }
