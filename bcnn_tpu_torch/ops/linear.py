"""Fully-connected layer, as `bcnn_tpu.ops.linear.full_connected`
computes it (bcnn_fc_layer.c:144-226).

The weight is (in, out), its rows in the NCHW flatten order of the
input, which is the port's own activation layout: the input is flattened
as it lies, with no transpose. The product is a plain matmul, which the
JAX package leaves to XLA; in fp32 it must not run in TF32
(`torch.backends.cuda.matmul.allow_tf32`, False by default).
"""

from __future__ import annotations

import torch


def full_connected(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """x: (N,C,H,W) or (N,F); w: (F,out); returns (N,out,1,1)."""
    n = x.shape[0]
    y = torch.matmul(x.reshape(n, -1), w) + b
    return y.reshape(n, -1, 1, 1)
