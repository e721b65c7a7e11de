"""Build and load the port's CUDA kernels, and count their launches.

Every `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with `ctypes`.  Libraries go to
`build/fastvocoder_tpu_torch/` beside the package and are named by a hash of
their source, the local headers it includes (`#include "..."`, followed
recursively) and the flags, so an edited source or header rebuilds and an
unchanged one is reused.  The first call to `library()` compiles every stale
source at once, one `nvcc` process per file, all started together.

Nothing here runs at import time: the CPU tests import every module on a
machine that has no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "fastvocoder_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches per kernel name; each wrapper adds one where it launches
launch_counts: Counter = Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of fastvocoder_tpu_torch are built at first use"
    )


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_includes(src: Path) -> List[Path]:
    """The headers `src` includes with quotes, directly or through another
    such header, resolved beside the including file; sorted."""
    seen: Dict[Path, None] = {}
    todo = [src]
    while todo:
        including = todo.pop()
        for name in _LOCAL_INCLUDE.findall(including.read_bytes()):
            path = (including.parent / name.decode()).resolve()
            if path not in seen and path.exists():
                seen[path] = None
                todo.append(path)
    return sorted(seen)


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in local_includes(src):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every stale kernel source in parallel; -> {name: ptxas
    report} for the sources compiled by this call (empty when all were
    already built).  Raises with nvcc's output if any compile fails."""
    with _lock:
        return _build_all_locked()


def _build_all_locked() -> Dict[str, str]:
    stale = [s for s in sorted(CSRC.glob("*.cu")) if not _target(s).exists()]
    if not stale:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in stale:
        out = _target(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    reports, failed = {}, []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[src.stem] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src = CSRC / f"{name}.cu"
            if not src.exists():
                raise FileNotFoundError(src)
            _build_all_locked()
            lib = ctypes.CDLL(str(_target(src)))
            _libs[name] = lib
        return lib


def check_operand(op: str, name: str, t: torch.Tensor, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> None:
    """Raise unless `t` is a contiguous, 16-byte aligned tensor of `dtype`
    on `device`: what every kernel's C entry point assumes of its pointers."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{op}: {name} must be a contiguous {dtype} tensor on {device}, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"{op}: {name} must be 16-byte aligned")


def check_form(op: str, x: torch.Tensor, dtype: torch.dtype) -> None:
    """Raise unless x has the type of the kernel form `op` (its float32 form
    or its bf16 form): a form never casts its input to the other's type."""
    if x.dtype != dtype:
        raise ValueError(f"{op}: this form of the kernel takes {dtype} x, got {x.dtype}; "
                         "the other type has a form of its own")


def check_x(op: str, x: torch.Tensor, widths,
            dtype: torch.dtype = torch.float32) -> Tuple[int, int, int]:
    """-> (B, T, C) after checking that x is a (B, T, C) operand of `dtype`
    on a CUDA device with C in `widths`."""
    check_form(op, x, dtype)
    if not x.is_cuda:
        raise ValueError(f"{op}: x must be a CUDA tensor, got {x.device}")
    if x.dim() != 3:
        raise ValueError(f"{op}: want x (B, T, C), got {tuple(x.shape)}")
    if x.shape[2] not in widths:
        raise ValueError(f"{op}: C={x.shape[2]} not in {widths}")
    check_operand(op, "x", x, x.device, dtype)
    return tuple(x.shape)


def check_table(op: str, table, x: torch.Tensor) -> None:
    """Raise unless a kept operand table (`ChainTable`, `StageTable`,
    `TailTable`) was packed for x's type: a float32 table read by the bf16
    form, or the reverse, would be a silent wrong answer."""
    if table.dtype != x.dtype:
        raise ValueError(f"{op}: the table was packed for {table.dtype}, x is {x.dtype}")


TAIL_INFERENCE_ONLY = ("this CUDA kernel is inference only, in the JAX package too "
                       "(training runs the stage through its modules and the MRF kernel)")


def no_graph(route: str) -> str:
    """Why a kernel's bf16 wrapper refuses a graph: its gradient comes
    through `route`, the op's autograd path."""
    return f"this wrapper records no graph: differentiate through `{route}`"



def refuse_autograd(op: str, tensors: Iterable[torch.Tensor],
                    why: str = TAIL_INFERENCE_ONLY) -> None:
    """Raise if autograd would have to differentiate through a kernel
    wrapper that records no graph (the HiFiGAN tail, inference only; the
    bf16 forms' wrappers, whose gradients come through their ops' autograd
    paths): grad mode is on and one of `tensors` requires a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{op}: {why}: call it under torch.inference_mode() or torch.no_grad()"
        )


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error, else count
    the launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launch_counts[name] += 1
