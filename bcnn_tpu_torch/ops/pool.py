"""Max pooling, as `bcnn_tpu.ops.pool.maxpool` computes it
(bcnn_maxpool_layer.c:145-192), and global average pooling.

The window for output (i, j) starts at (i*stride, j*stride), never at a
negative offset, and positions past the bottom or right edge read
-FLT_MAX. So the input is padded with -inf on the high side only, by
exactly what the builder's output size needs, and then pooled with no
padding. `F.max_pool2d(padding=...)` pads both sides and would shift the
windows; `lid12` of YOLOv3-tiny (size 2, stride 1, SAME) needs exactly
this one-sided pad.

A Darknet cfg's pool (`graph.add_maxpool_layer(darknet_padding=)`)
starts its windows `offset` = padding / 2 before i*stride: the input is
padded with -inf by `offset` on the low side too.

An int8 tensor (the int8 activation flow) pads with the int8 minimum, as
the JAX package does (bcnn_tpu/ops/pool.py:108-118), and is pooled as an
exact bf16 copy (every int8 value is exact there) cast back:
`F.max_pool2d` has no int8 kernel on CUDA (torch 2.11 on an H100).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def maxpool(
    x: torch.Tensor, size: int, stride: int, out_h: int, out_w: int,
    offset: int = 0,
) -> torch.Tensor:
    """x: NCHW -> (N, C, out_h, out_w); output (i, j)'s window starts at
    (i*stride - offset, j*stride - offset)."""
    h, w = x.shape[2], x.shape[3]
    int8 = x.dtype == torch.int8
    if int8:
        x = x.to(torch.bfloat16)
    pad_h = max(0, (out_h - 1) * stride + size - h - offset)
    pad_w = max(0, (out_w - 1) * stride + size - w - offset)
    if offset or pad_h or pad_w:
        fill = torch.iinfo(torch.int8).min if int8 else float("-inf")
        x = F.pad(x, (offset, pad_w, offset, pad_h), value=fill)
    y = F.max_pool2d(x, size, stride)
    return y.to(torch.int8) if int8 else y


def global_avgpool(x: torch.Tensor) -> torch.Tensor:
    """x: NCHW -> (N, C, 1, 1), the mean over H and W
    (bcnn_avgpool_layer.c:82-100)."""
    return x.mean(dim=(2, 3), keepdim=True)
