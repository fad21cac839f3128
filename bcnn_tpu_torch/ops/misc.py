"""Channel concat and nearest-neighbour upsample, as
`bcnn_tpu.ops.misc` computes them (bcnn_concat_layer.c,
bcnn_upsample_layer.c:86-110), on NCHW tensors."""

from __future__ import annotations

from typing import Sequence

import torch


def concat_channels(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concat on the channel axis, dim 1 of NCHW."""
    return torch.cat(list(xs), dim=1)


def upsample_nn(x: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest-neighbour upsample by `size` on H and W."""
    return x.repeat_interleave(size, dim=2).repeat_interleave(size, dim=3)
