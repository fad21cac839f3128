"""YOLO head decode: the CUDA kernel K1 (`csrc/yolo_decode.cu`) and its
plain PyTorch version.

`decode_fused` replaces the Pallas TPU kernel
`bcnn_tpu.ops.yolo_pallas.decode_fused`: one pass over the raw head that
writes decoded boxes, objectness and objectness-weighted class
probabilities, ready for `ops.yolo.device_decode_nms`. `decode_grid_ref`
is its plain version, the counterpart of `decode_grid_jnp`.

The wrapper runs the plain version only for a tensor on the CPU. For a
CUDA tensor it launches the kernel or raises; nothing falls back.
`decode_fused.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import kernels
from .yolo import _decode_grid, yolo_head

# the kernel passes the anchors of a head in its launch parameters
MAX_ANCHORS = 16


def decode_grid_ref(
    x: torch.Tensor, param: Dict, net_w: int, net_h: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: raw head (N, A*(5+K), H, W). Returns boxes (N, H*W*A, 4),
    obj (N, H*W*A) and probs (N, H*W*A, K), candidates in (location,
    anchor) order."""
    n, _, h, w = x.shape
    num, classes = param["num"], param["classes"]
    y = yolo_head(x, num, classes).reshape(n, num, 5 + classes, h, w)
    y = y.permute(0, 3, 4, 1, 2)  # (N, H, W, A, 5+K)
    bx, by, bw, bh = _decode_grid(
        y, param["anchors"], param["mask"], net_w, net_h
    )
    boxes = torch.stack([bx, by, bw, bh], dim=-1).reshape(n, -1, 4)
    obj = y[..., 4].reshape(n, -1)
    probs = (y[..., 4:5] * y[..., 5:]).reshape(n, -1, classes)
    return boxes, obj, probs


def decode_fused(
    x: torch.Tensor, param: Dict, net_w: int, net_h: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: the decode of `decode_grid_ref`, as one CUDA kernel for a
    CUDA tensor x (fp32, contiguous)."""
    if x.device.type == "cpu":
        return decode_grid_ref(x, param, net_w, net_h)
    if x.device.type != "cuda":
        raise ValueError(f"decode_fused: unsupported device {x.device}")
    num, classes = param["num"], param["classes"]
    if x.dtype != torch.float32:
        raise TypeError(f"decode_fused: needs float32, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] != num * (5 + classes):
        raise ValueError(
            f"decode_fused: head shape {tuple(x.shape)} is not "
            f"(N, {num * (5 + classes)}, H, W)"
        )
    if not x.is_contiguous():
        raise ValueError("decode_fused: x must be contiguous")
    if not 1 <= num <= MAX_ANCHORS:
        raise ValueError(f"decode_fused: {num} anchors, at most {MAX_ANCHORS}")
    n, _, h, w = x.shape
    m = h * w * num
    opts = dict(dtype=torch.float32, device=x.device)
    boxes = torch.empty((n, m, 4), **opts)
    obj = torch.empty((n, m), **opts)
    probs = torch.empty((n, m, classes), **opts)
    if obj.numel() == 0:
        return boxes, obj, probs
    anchors, mask = param["anchors"], param["mask"]
    awh = (ctypes.c_float * (2 * num))(
        *[float(anchors[2 * mi + j]) for mi in mask for j in (0, 1)]
    )
    lib = kernels.library()
    with torch.cuda.device(x.device):
        rc = lib.bcnn_yolo_decode(
            x.data_ptr(), boxes.data_ptr(), obj.data_ptr(), probs.data_ptr(),
            ctypes.cast(awh, ctypes.c_void_p), n, num, classes, h, w,
            float(net_w), float(net_h),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(rc, "decode_fused")
    decode_fused.launches += 1
    return boxes, obj, probs


decode_fused.launches = 0
