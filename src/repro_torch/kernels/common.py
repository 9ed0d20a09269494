"""Shared kernel utilities: the device index policy, the one device->host
transfer, launch counters, and the build/loader of the CUDA sources.

Counterpart of ``repro.kernels.common``.  Kernels are CUDA C++ under
``repro_torch/csrc/``, compiled with ``nvcc`` for ``sm_90a`` into one
shared library per source with a plain C interface and loaded with
``ctypes``.  The build happens at first use, into ``repro_torch/_build/``
(one ``nvcc`` per source, all started together), named by a hash of the
source so an edited kernel rebuilds.

Every wrapper dispatches on where its tensors live: a CPU tensor takes
the kernel's plain PyTorch version (``ref.py``), a CUDA tensor launches
the kernel or raises.  There is no other switch.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

# Device index dtype: positions, counts and offsets of the device-resident
# pipeline.  The reference runs with x64 off, so its indices are int32 and
# its pipeline engages only while the exact cross-product bound of an
# extension stays below ``COUNT_LIMIT`` (the counting pass cannot wrap).
IDX = torch.int32
IDX_NP = np.int32
COUNT_LIMIT = (1 << 31) - 1

# Kernel launches by kernel name.  A wrapper adds one where it launches
# its CUDA kernel and nowhere else (the plain CPU version does not count).
LAUNCHES: Dict[str, int] = collections.Counter()

KERNEL_SOURCES = ("frontier_fill", "bitset_intersect", "uint_intersect")

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def host_get(tree):
    """THE device->host transfer of the engine's device-resident paths
    (counterpart of ``repro.kernels.common.host_get``): every closing
    sync and every cohort-kernel result comes back through this one call
    site.  Tensors become numpy arrays; tuples, lists and dicts are
    walked; anything else passes through."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, (tuple, list)):
        return type(tree)(host_get(x) for x in tree)
    if isinstance(tree, dict):
        return {k: host_get(v) for k, v in tree.items()}
    return tree


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((_CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return _BUILD / f"lib{name}-{digest[:12]}.so"


def build(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every listed source that has no up-to-date library yet,
    one ``nvcc`` per source, all started together.  Returns each
    source's ptxas report (registers, shared memory, spills) for the
    libraries built by this call; raises with the compiler's output if
    any build fails."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas=-v", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel source; builds every
    kernel source on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build()
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 device: torch.device, ndim: int = 1) -> None:
    """Raise unless ``t`` has the dtype, device, rank and contiguity a
    kernel takes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def kernel_device(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (take the plain version); raise for anything else."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")
