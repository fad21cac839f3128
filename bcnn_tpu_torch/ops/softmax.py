"""Softmax with the reference's pass-through gradient, as
`bcnn_tpu.ops.softmax.softmax_passthrough_grad` computes it.

The forward is a softmax over the channels (dim 1 of NCHW) at each
position, a vector softmax when h*w == 1 (bcnn_softmax_layer.c:88-160).
The backward copies the output gradient to the input
(bcnn_softmax_layer.c:161-175), with no Jacobian.
"""

from __future__ import annotations

import torch


class _SoftmaxPassthrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.softmax(x, dim=1)

    @staticmethod
    def backward(ctx, g):
        return g


softmax_passthrough_grad = _SoftmaxPassthrough.apply
