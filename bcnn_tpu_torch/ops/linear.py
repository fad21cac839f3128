"""Fully-connected layer, as `bcnn_tpu.ops.linear.full_connected`
computes it (bcnn_fc_layer.c:144-226).

The weight is (in, out), its rows in the NCHW flatten order of the
input, which is the port's own activation layout: the input is flattened
as it lies, with no transpose. The product is a plain matmul, which the
JAX package leaves to XLA; in fp32 it must not run in TF32
(`torch.backends.cuda.matmul.allow_tf32`, False by default).

With compute_dtype (bf16), x and w are rounded to it and the product is
taken in fp32 from there (`bcnn_tpu/ops/linear.py:16-33`: bf16 inputs,
an fp32 result): products of bf16 values are exact in fp32. Where
autograd records it (TRAIN), the backward is JAX's autodiff of that
product: each gradient is the fp32 product of the fp32 cotangent with
the other bf16 operand, rounded to bf16 (the transpose of the cast),
then cast back to its input's dtype.
"""

from __future__ import annotations

import torch


class _LinearMixed(torch.autograd.Function):
    """x16 @ w16 summed in fp32, with JAX's bf16 roundings in the
    backward."""

    @staticmethod
    def forward(ctx, x, w, cd):
        x16, w16 = x.to(cd), w.to(cd)
        ctx.save_for_backward(x16, w16)
        ctx.dtypes = (x.dtype, w.dtype)
        return torch.matmul(x16.to(torch.float32), w16.to(torch.float32))

    @staticmethod
    def backward(ctx, g):
        x16, w16 = ctx.saved_tensors
        xdt, wdt = ctx.dtypes
        cd = x16.dtype
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g @ w16.to(torch.float32).T).to(cd).to(xdt)
        if ctx.needs_input_grad[1]:
            gw = (x16.to(torch.float32).T @ g).to(cd).to(wdt)
        return gx, gw, None


def full_connected(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, compute_dtype=None
) -> torch.Tensor:
    """x: (N,C,H,W) or (N,F); w: (F,out); returns (N,out,1,1) fp32."""
    n = x.shape[0]
    x = x.reshape(n, -1)
    if compute_dtype is not None:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            y = _LinearMixed.apply(x, w, compute_dtype)
            return (y + b).reshape(n, -1, 1, 1)
        x = x.to(compute_dtype).to(torch.float32)
        w = w.to(compute_dtype).to(torch.float32)
    y = torch.matmul(x.to(w.dtype), w) + b
    return y.reshape(n, -1, 1, 1)
