"""Build and bind the hand-written CUDA kernels of `csrc/`.

At first CUDA use, `nvcc` compiles every `csrc/*.cu` for Hopper (sm_90a)
into one shared library with a plain C interface, under `_build/` beside
this file, named by a hash of the sources and flags: a change to either
builds anew. `ctypes` loads it. Nothing here runs at import, so the CPU
tests import the package without `nvcc` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME): "
            "bcnn_tpu_torch cannot build its CUDA kernels"
        )
    return nvcc


def build() -> Path:
    """Compile csrc/*.cu into _build/ unless a library of the same
    sources and flags is there already; returns the library's path."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.glob("*.cu*")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    lib = BUILD_DIR / f"libbcnn_tpu_torch_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernels, loaded and bound (one load per process)."""
    if not torch.cuda.is_available():
        raise RuntimeError("bcnn_tpu_torch kernels need a CUDA device")
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bcnn_yolo_decode.argtypes = [
        p, p, p, p, p,          # x, boxes, obj, probs, anchors (host)
        i, i, i, i, i,          # n, num, classes, grid_h, grid_w
        f, f,                   # net_w, net_h
        p,                      # stream
    ]
    lib.bcnn_yolo_decode.restype = ctypes.c_int
    lib.bcnn_cuda_error_string.argtypes = [i]
    lib.bcnn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().bcnn_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
