"""YOLO head decode: the CUDA kernel K1 (`csrc/yolo_decode.cu`) and its
plain PyTorch version.

`decode_fused` replaces the Pallas TPU kernel
`bcnn_tpu.ops.yolo_pallas.decode_fused`: one pass over the raw head that
writes decoded boxes, objectness and objectness-weighted class
probabilities, ready for `ops.yolo.device_decode_nms`. `decode_grid_ref`
is its plain version, the counterpart of `decode_grid_jnp`.

The wrapper calls the op `bcnn_tpu_torch::yolo_decode` (`ops.library`;
the head's anchors go in as (w, h) pairs): its CPU implementation is
the plain version; its CUDA implementation, `decode_cuda`, launches the
kernel or raises; nothing falls back. `library.launches("yolo_decode")`
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .. import kernels
from . import library
from .yolo import _decode_grid, unscaled, yolo_head

# the kernel passes the anchors of a head in its launch parameters
MAX_ANCHORS = 16


def decode_grid_ref(
    x: torch.Tensor, param: Dict, net_w: int, net_h: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: raw head (N, A*(5+K), H, W). Returns boxes (N, H*W*A, 4),
    obj (N, H*W*A) and probs (N, H*W*A, K), candidates in (location,
    anchor) order."""
    unscaled(param, "the decode-everything decode")
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
    CUDA tensor x (fp32, contiguous), through the op
    `bcnn_tpu_torch::yolo_decode` on either device. The op takes the
    head's anchors as (w, h) pairs in mask order."""
    library.check_devices("decode_fused", x)
    unscaled(param, "K1")
    anchors, mask = param["anchors"], param["mask"]
    awh = [float(anchors[2 * mi + j]) for mi in mask for j in (0, 1)]
    return _K1(x, awh, param["classes"], float(net_w), float(net_h))


def _anchor_param(anchors, classes):
    num = len(anchors) // 2
    return dict(num=num, classes=classes, anchors=list(anchors),
                mask=list(range(num)))


def _decode_cpu(x, anchors, classes, net_w, net_h):
    return tuple(t.contiguous() for t in decode_grid_ref(
        x, _anchor_param(anchors, classes), net_w, net_h))


def decode_cuda(x, anchors, classes, net_w, net_h):
    """The op's CUDA implementation, K1's launcher: checks what the
    kernel takes (raises otherwise), allocates the outputs, launches and
    checks the launch."""
    if x.device.type != "cuda":
        raise ValueError(f"decode_fused: unsupported device {x.device}")
    num = len(anchors) // 2
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
    boxes, obj, probs = _decode_fake(x, anchors, classes, net_w, net_h)
    if obj.numel() == 0:
        return boxes, obj, probs
    n, _, h, w = x.shape
    awh = (ctypes.c_float * (2 * num))(*anchors)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        rc = lib.bcnn_yolo_decode(
            x.data_ptr(), boxes.data_ptr(), obj.data_ptr(), probs.data_ptr(),
            ctypes.cast(awh, ctypes.c_void_p), n, num, classes, h, w,
            float(net_w), float(net_h),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(rc, "decode_fused")
    return boxes, obj, probs


def _decode_fake(x, anchors, classes, net_w, net_h):
    """The three outputs, empty: boxes (N, M, 4), obj (N, M), probs (N,
    M, K), M = H W A, contiguous in x's dtype."""
    n, _, h, w = x.shape
    m = h * w * (len(anchors) // 2)
    return (x.new_empty((n, m, 4)), x.new_empty((n, m)),
            x.new_empty((n, m, classes)))


_K1 = library.register(
    "yolo_decode",
    "(Tensor x, float[] anchors, int classes, float net_w, float net_h) "
    "-> (Tensor, Tensor, Tensor)",
    cpu=_decode_cpu,
    cuda=decode_cuda,
    fake=_decode_fake,
)
