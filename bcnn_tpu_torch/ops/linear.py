"""Fully-connected layer, as `bcnn_tpu.ops.linear.full_connected`
computes it (bcnn_fc_layer.c:144-226).

The weight is (in, out), its rows in the NCHW flatten order of the
input, which is the port's own activation layout: the input is flattened
as it lies, with no transpose. The product is a plain matmul, which the
JAX package leaves to XLA; in fp32 it must not run in TF32
(`torch.backends.cuda.matmul.allow_tf32`, False by default).

With compute_dtype (bf16), x and w are rounded to it and the product is
taken in fp32 from there (`bcnn_tpu/ops/linear.py:16-33`: bf16 inputs,
an fp32 result): products of bf16 values are exact in fp32.
"""

from __future__ import annotations

import torch


def full_connected(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, compute_dtype=None
) -> torch.Tensor:
    """x: (N,C,H,W) or (N,F); w: (F,out); returns (N,out,1,1) fp32."""
    n = x.shape[0]
    x = x.reshape(n, -1)
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32)) + b
    return y.reshape(n, -1, 1, 1)
