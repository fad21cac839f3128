"""Channel concat and nearest-neighbour upsample, as
`bcnn_tpu.ops.misc` computes them (bcnn_concat_layer.c,
bcnn_upsample_layer.c:86-110), on NCHW tensors. Both give an int8
tensor (the int8 flow, held channels-last) channels-last without a copy
of their own."""

from __future__ import annotations

from typing import Sequence

import torch


def concat_channels(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concat on the channel axis, dim 1 of NCHW."""
    return torch.cat(list(xs), dim=1)


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
