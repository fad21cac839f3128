"""Max pooling, as `bcnn_tpu.ops.pool.maxpool` computes it
(bcnn_maxpool_layer.c:145-192).

The window for output (i, j) starts at (i*stride, j*stride), never at a
negative offset, and positions past the bottom or right edge read
-FLT_MAX. So the input is padded with -inf on the high side only, by
exactly what the builder's output size needs, and then pooled with no
padding. `F.max_pool2d(padding=...)` pads both sides and would shift the
windows; `lid12` of YOLOv3-tiny (size 2, stride 1, SAME) needs exactly
this one-sided pad.
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
        x = F.pad(x, (0, pad_w, 0, pad_h), value=float("-inf"))
    return F.max_pool2d(x, size, stride)
