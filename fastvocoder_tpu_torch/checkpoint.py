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
    a node with `gt`, or, in a fused tree, an upsampler node `up_<i>`.

`load_release_npz` reads a committed release checkpoint.  The port's own
trainer writes `torch.save` payloads of format `TRAIN_FORMAT`
(`train/checkpoint.py`), their state in the training form;
`jax_tree_from_state_dict` carries such a state back into a flat JAX-layout
tree, so that `state_dict_from_jax` fuses it as it fuses a JAX tree.
`checkpoint_format` tells the two kinds of file apart by their contents.
"""

from __future__ import annotations

import json
import re
import zipfile
from typing import Dict, Mapping, Union

import numpy as np
import torch

Tree = Mapping[str, Union[np.ndarray, "Tree"]]

_UPSAMPLER = re.compile(r"up_\d+")

TRAIN_FORMAT = "fastvocoder_tpu_torch.train/1"  # the trainer's checkpoints


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


def state_dict_from_jax(params: Tree, fuse: bool = True) -> Dict[str, torch.Tensor]:
    nodes: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in _flatten(params).items():
        node, _, leaf = key.rpartition("/")
        nodes.setdefault(node, {})[leaf] = value.astype(np.float32)

    out: Dict[str, torch.Tensor] = {}
    for node, leaves in nodes.items():
        name = node.replace("/", ".")
        unknown = set(leaves) - {"kernel", "g", "gt", "bias", "basis"}
        if unknown:
            raise ValueError(f"{node}: unexpected parameters {sorted(unknown)}")
        if "kernel" in leaves:
            k = leaves["kernel"]
            if not fuse:
                for gain in ("g", "gt"):
                    if gain in leaves:
                        out[f"{name}.{gain}"] = torch.from_numpy(leaves[gain])
            elif "g" in leaves:
                norm = np.sqrt(np.sum(k**2, axis=(0, 1), keepdims=True))
                k = k * (leaves["g"] / norm)
            elif "gt" in leaves:
                norm = np.sqrt(np.sum(k**2, axis=(0, 2), keepdims=True))
                k = k * (leaves["gt"][None, :, None] / norm)
            k = k.transpose(1, 2, 0) if _transposed(node, leaves) else k.transpose(2, 1, 0)
            out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(k))
        if "bias" in leaves:
            out[f"{name}.bias"] = torch.from_numpy(leaves["bias"])
        if "basis" in leaves:
            out[f"{name}.basis"] = torch.from_numpy(leaves["basis"])
    return out


def jax_tree_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The flat JAX-layout tree of a port `state_dict`: the inverse of
    `state_dict_from_jax(..., fuse=False)`.  Keys `<node>.<leaf>` become
    `<node>/<leaf>` (`weight` -> `kernel`), torch weights become kernels
    (K, Cin, Cout), gains stay as they are."""
    nodes: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in state.items():
        node, _, leaf = key.rpartition(".")
        nodes.setdefault(node.replace(".", "/"), {})[leaf] = value.detach().cpu().numpy()
    out: Dict[str, np.ndarray] = {}
    for node, leaves in nodes.items():
        for leaf, v in leaves.items():
            if leaf == "weight":
                leaf = "kernel"
                v = v.transpose(2, 0, 1) if _transposed(node, leaves) else v.transpose(2, 1, 0)
            out[f"{node}/{leaf}"] = np.ascontiguousarray(v)
    return out


def checkpoint_format(path: str) -> str:
    """"release" for a release checkpoint (a `.npz` with `meta`), "train"
    for a `torch.save` file (the trainer's payload, whose `format` the
    reader checks); raises ValueError for any other file, whatever its
    name."""
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
        if "meta.npy" in names:
            return "release"
        if any(n.endswith("/data.pkl") for n in names):
            return "train"
    raise ValueError(
        f"{path} is neither a release checkpoint (.npz with `meta` and `param:` arrays, as "
        f"tools/export_release_checkpoint.py writes) nor a training checkpoint of this "
        f"package (format {TRAIN_FORMAT!r}, written by bin/train.py)")


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
