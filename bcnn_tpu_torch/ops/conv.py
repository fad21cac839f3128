"""Convolution, the counterpart of `bcnn_tpu.ops.conv.conv2d`: fp32 (its
`lax.conv_general_dilated` at Precision.HIGHEST) in both directions, and
bf16 (`bcnn_tpu/ops/conv.py:140-222`) in every mode.

The JAX package leaves the conv to XLA, outside any Pallas kernel, so the
port leaves it to cuDNN. cuDNN runs fp32 convs in TF32 by default (about
three decimal digits). The forward turns TF32 off around its call, and
so must the backward: autograd would run it later, outside that context,
in TF32. So the conv is an `autograd.Function` whose backward calls
`aten.convolution_backward` under the same flags.

Layouts: activations NCHW, weights OIHW. Output size (h + 2p - k)/s + 1,
as the builder computes it (bcnn_conv_layer.c:126-135).

bf16 (compute_dtype set), two cases:
  - out_dtype set too (bench.py's act_dtype path): cuDNN's bf16 conv, a
    bf16 output from an fp32 sum, as XLA lowers this conv;
  - out_dtype unset: bf16 inputs, fp32 sum and output. A bf16 cuDNN call
    cannot give fp32, so x and w are rounded to bf16, cast back, and
    convolved in fp32 with TF32 allowed: a bf16 value has 8 significant
    bits and fits TF32's 11, so every product is exact either way and
    the result is that of the fp32 conv of the rounded inputs. Where
    autograd records it (TRAIN), this forward is `_Conv2dMixed`, the
    port of `_conv2d_mixed` and its custom VJP: it keeps the bf16 x and
    w for the backward, casts the cotangent to bf16, runs both
    transposed convs in bf16 and casts dx to x's dtype and dw to w's,
    so fp32 master params get fp32 gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _tf32(allow: bool):
    cudnn = torch.backends.cudnn
    return cudnn.flags(
        enabled=cudnn.enabled,
        benchmark=cudnn.benchmark,
        deterministic=cudnn.deterministic,
        allow_tf32=allow,
    )


class _Conv2dFp32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, pad, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, pad, groups)
        with _tf32(False):
            return F.conv2d(x, w, None, stride, pad, 1, groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, pad, groups = ctx.conf
        with _tf32(False):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [stride] * 2, [pad] * 2, [1, 1], False,
                [0, 0], groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False],
            )
        return gx, gw, None, None, None


class _Conv2dMixed(torch.autograd.Function):
    """bf16 conv inputs, fp32 sum and output; the backward in bf16
    (`bcnn_tpu/ops/conv.py:155-189`)."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, groups, cd):
        x16, w16 = x.to(cd), w.to(cd)
        ctx.save_for_backward(x16, w16)
        ctx.conf = (stride, pad, groups, x.dtype, w.dtype)
        with _tf32(True):
            return F.conv2d(x16.to(torch.float32), w16.to(torch.float32),
                            None, stride, pad, 1, groups)

    @staticmethod
    def backward(ctx, gy):
        x16, w16 = ctx.saved_tensors
        stride, pad, groups, xdt, wdt = ctx.conf
        gx, gw, _ = torch.ops.aten.convolution_backward(
            gy.to(x16.dtype), x16, w16, None, [stride] * 2, [pad] * 2,
            [1, 1], False, [0, 0], groups,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False],
        )
        return (None if gx is None else gx.to(xdt),
                None if gw is None else gw.to(wdt), None, None, None, None)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int,
    pad: int,
    groups: int = 1,
    compute_dtype=None,
    out_dtype=None,
) -> torch.Tensor:
    """x: (N,C,H,W), w: (O,C//groups,k,k) -> (N,O,H',W'), in fp32 in the
    forward and, where autograd records it, in the backward; with
    compute_dtype, in bf16 both ways (see the module's docstring;
    out_dtype is an inference setting). An x stored in bf16 without
    compute_dtype is cast up to fp32."""
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if compute_dtype is not None:
        if grad:
            return _Conv2dMixed.apply(x, w, stride, pad, groups,
                                      compute_dtype)
        xc, wc = x.to(compute_dtype), w.to(compute_dtype)
        if out_dtype is not None:
            return F.conv2d(xc, wc, None, stride, pad, 1, groups).to(out_dtype)
        with _tf32(True):
            return F.conv2d(xc.to(torch.float32), wc.to(torch.float32), None,
                            stride, pad, 1, groups)
    x = x.to(torch.float32)
    if grad:
        return _Conv2dFp32.apply(x, w, stride, pad, groups)
    with _tf32(False):
        return F.conv2d(x, w, None, stride, pad, 1, groups)


def depthwise_conv2d(
    x: torch.Tensor, w: torch.Tensor, stride: int, pad: int
) -> torch.Tensor:
    """Depthwise conv (bcnn_depthwise_conv_layer.c:165-294), one filter per
    input channel: x (N,C,H,W), w (C,1,k,k), groups = C. The plain
    version of K3 (`ops.depthwise.depthwise_fused`)."""
    return conv2d(x, w, stride, pad, groups=x.shape[1])
