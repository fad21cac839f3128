"""Build and bind the hand-written CUDA kernels of `csrc/`.

At first CUDA use, `nvcc` compiles every `csrc/*.cu` for Hopper (sm_90a),
one process per source, all started together (a `.cuh` header they
include counts among the sources hashed), and links them into one
shared library with a plain C interface, under `_build/` beside this
file, named by a hash of the sources and flags: a change to either
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def _run(cmds):
    """Run the commands in parallel; raise with the output of the first
    that fails."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    failed = None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")


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
    nvcc = _nvcc()
    tmp_dir = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    try:
        objs = [tmp_dir / f"{src.stem}.o" for src in sources]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
              for src, o in zip(sources, objs)])
        tmp = tmp_dir / lib.name
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
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
    lib.bcnn_row_shift.argtypes = [
        p, p, p,                # img, d, out
        i, i, i, i,             # n, rows, win, chans
        i, i, i, i,             # kmax, out_x0, out_w, in_x0
        f,                      # fill
        p,                      # stream
    ]
    lib.bcnn_row_shift.restype = ctypes.c_int
    lib.bcnn_col_shift.argtypes = [
        p, p, p,                # img, d, out
        i, i, i, i,             # n, win, cols, chans
        i, i, i, i,             # kmax, out_x0, out_w, in_x0
        f,                      # fill
        p,                      # stream
    ]
    lib.bcnn_col_shift.restype = ctypes.c_int
    lib.bcnn_depthwise.argtypes = [
        p, p, p, p,             # x, w, b, y
        i, i, i, i,             # n, c, h, w
        i, i, i, i,             # k, stride, pad, act
        i, i, i, i, i,          # plan: g, th, tiles_h, tiles, rows
        i, i, i, i,             # plan: strips, stages, stage_floats, grid
        p,                      # stream
    ]
    lib.bcnn_depthwise.restype = ctypes.c_int
    lib.bcnn_conv_int8.argtypes = [
        p, p, p, p, p, p, p, p,  # x, w, d, scale, bias, mean, inv, out
        i, i, i, i,             # n, c, h, w
        i, i, i, i,             # o, k, stride, pad
        i, i, i, f,             # bn, act, out_int8, s_out
        i, i, i, p, p,          # plan: cfg, splits, split_steps; ws, counters
        p,                      # stream
    ]
    lib.bcnn_conv_int8.restype = ctypes.c_int
    lib.bcnn_grouped_int8.argtypes = [
        p, p, p, p, p, p, p, p,  # x, w, d, scale, bias, mean, inv, out
        i, i, i, i,             # n, c, h, w
        i, i, i, i, i,          # o, k, stride, pad, groups
        i, i, i, f,             # bn, act, out_int8, s_out
        i, i, i, i, i,          # plan: branch, s, lanes, strips, rows
        p,                      # stream
    ]
    lib.bcnn_grouped_int8.restype = ctypes.c_int
    lib.bcnn_bn_act.argtypes = [
        p, p, p, p, p, p,       # x, y, mean, var, scale, bias
        ctypes.c_longlong, i, ctypes.c_longlong,  # n, c, hw
        i, i, i, i,             # bf16, folded, act, nhwc
        f, f,                   # eps, slope
        p,                      # stream
    ]
    lib.bcnn_bn_act.restype = ctypes.c_int
    lib.bcnn_cuda_error_string.argtypes = [i]
    lib.bcnn_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (the tile plans'
    target)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().bcnn_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
