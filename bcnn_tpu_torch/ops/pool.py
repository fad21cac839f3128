"""Max pooling, as `bcnn_tpu.ops.pool.maxpool` computes it
(bcnn_maxpool_layer.c:145-192), and global average pooling.

The window for output (i, j) starts at (i*stride, j*stride), never at a
negative offset, and positions past the bottom or right edge read
-FLT_MAX. So the input is padded with -inf on the high side only, by
exactly what the builder's output size needs, and then pooled with no
padding. `F.max_pool2d(padding=...)` pads both sides and would shift the
windows; `lid12` of YOLOv3-tiny (size 2, stride 1, SAME) needs exactly
this one-sided pad.

An int8 tensor (the int8 activation flow) pads with the int8 minimum, as
the JAX package does (bcnn_tpu/ops/pool.py:108-118), and is pooled as an
exact bf16 copy (every int8 value is exact there) cast back:
`F.max_pool2d` has no int8 kernel on CUDA (torch 2.11 on an H100).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def maxpool(
    x: torch.Tensor, size: int, stride: int, out_h: int, out_w: int
) -> torch.Tensor:
    """x: NCHW -> (N, C, out_h, out_w)."""
    h, w = x.shape[2], x.shape[3]
    pad_h = max(0, (out_h - 1) * stride + size - h)
    pad_w = max(0, (out_w - 1) * stride + size - w)
    if pad_h or pad_w:
        fill = float("-inf") if x.is_floating_point() else torch.iinfo(
            x.dtype).min
        x = F.pad(x, (0, pad_w, 0, pad_h), value=fill)
    if x.dtype == torch.int8:
        return F.max_pool2d(x.to(torch.bfloat16), size, stride).to(torch.int8)
    return F.max_pool2d(x, size, stride)


def global_avgpool(x: torch.Tensor) -> torch.Tensor:
    """x: NCHW -> (N, C, 1, 1), the mean over H and W
    (bcnn_avgpool_layer.c:82-100)."""
    return x.mean(dim=(2, 3), keepdim=True)
