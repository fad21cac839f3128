"""fp32 convolution, the counterpart of `bcnn_tpu.ops.conv.conv2d` on its
fp32 path (`lax.conv_general_dilated` at Precision.HIGHEST), in both
directions.

The JAX package leaves the conv to XLA, outside any Pallas kernel, so the
port leaves it to cuDNN. cuDNN runs fp32 convs in TF32 by default (about
three decimal digits). The forward turns TF32 off around its call, and
so must the backward: autograd would run it later, outside that context,
in TF32. So the conv is an `autograd.Function` whose backward calls
`aten.convolution_backward` under the same flags.

Layouts: activations NCHW, weights OIHW. Output size (h + 2p - k)/s + 1,
as the builder computes it (bcnn_conv_layer.c:126-135).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _no_tf32():
    cudnn = torch.backends.cudnn
    return cudnn.flags(
        enabled=cudnn.enabled,
        benchmark=cudnn.benchmark,
        deterministic=cudnn.deterministic,
        allow_tf32=False,
    )


class _Conv2dFp32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, pad, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, pad, groups)
        with _no_tf32():
            return F.conv2d(x, w, None, stride, pad, 1, groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, pad, groups = ctx.conf
        with _no_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [stride] * 2, [pad] * 2, [1, 1], False,
                [0, 0], groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False],
            )
        return gx, gw, None, None, None


def conv2d(
    x: torch.Tensor, w: torch.Tensor, stride: int, pad: int, groups: int = 1
) -> torch.Tensor:
    """x: (N,C,H,W), w: (O,C//groups,k,k) -> (N,O,H',W'), in fp32 in the
    forward and, where autograd records it, in the backward."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv2dFp32.apply(x, w, stride, pad, groups)
    with _no_tf32():
        return F.conv2d(x, w, None, stride, pad, 1, groups)


def depthwise_conv2d(
    x: torch.Tensor, w: torch.Tensor, stride: int, pad: int
) -> torch.Tensor:
    """Depthwise conv (bcnn_depthwise_conv_layer.c:165-294), one filter per
    input channel: x (N,C,H,W), w (C,1,k,k), groups = C. The plain
    version of K3 (`ops.depthwise.depthwise_fused`)."""
    return conv2d(x, w, stride, pad, groups=x.shape[1])
