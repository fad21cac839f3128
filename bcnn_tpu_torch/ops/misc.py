"""Channel concat, the eltwise add with its stride broadcast and the
nearest-neighbour upsample, as `bcnn_tpu.ops.misc` computes them
(bcnn_concat_layer.c, bcnn_eltwise_layer.c:111-135,
bcnn_upsample_layer.c:86-110), on NCHW tensors. Each keeps an int8 (or
int32) tensor of the int8 flow, held channels-last, channels-last
without a copy of its own."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def concat_channels(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concat on the channel axis, dim 1 of NCHW."""
    return torch.cat(list(xs), dim=1)


def eltwise_add(
    x0: torch.Tensor,
    x1: torch.Tensor,
    stride: Tuple[int, int],
    min_dim: Tuple[int, int, int],
) -> torch.Tensor:
    """Add with stride broadcast (bcnn_eltwise_layer.c:111-135 and
    bcnn_axpy_strided, bcnn_mat.c:159-178):

      dst = copy(x0)
      dst[b, c, j*s0, i*s0] += x1[b, c, j*s1, i*s1]
        for c < min_c, j < min_h, i < min_w

    over the whole batch, the semantics `bcnn_tpu` chose: the
    reference's equal-stride fast path adds batch item 0 only
    (bcnn_eltwise_layer.c:119-121), an indexing bug. Equal shapes are a
    plain add. The result takes x0's memory format (`clone` and an
    elementwise add keep it)."""
    min_c, min_h, min_w = min_dim
    s0, s1 = stride
    if s0 == 1 and s1 == 1 and x0.shape == x1.shape:
        return x0 + x1
    out = x0.clone()
    out[:, :min_c, : min_h * s0 : s0, : min_w * s0 : s0] += x1[
        :, :min_c, : min_h * s1 : s1, : min_w * s1 : s1
    ]
    return out


def upsample_nn(x: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest-neighbour upsample by `size` on H and W. An int8 x (the
    int8 flow) is expanded on its NHWC view, one pass that writes
    channels-last, whatever its strides say at H = W = 1;
    `repeat_interleave` would write NCHW, as the float paths keep."""
    if x.dtype == torch.int8 and x.dim() == 4:
        nhwc = x.permute(0, 2, 3, 1)
        n, h, w, c = nhwc.shape
        y = nhwc[:, :, None, :, None, :].expand(n, h, size, w, size, c)
        # written out, not a view: at H = W = 1 the reshape of the
        # expansion alone would be one with zero strides
        return y.contiguous().view(n, h * size, w * size, c).permute(
            0, 3, 1, 2)
    return x.repeat_interleave(size, dim=2).repeat_interleave(size, dim=3)
