"""Convolution and the deconv, the counterparts of
`bcnn_tpu.ops.conv.conv2d` and `conv2d_transpose`: fp32 (its
`lax.conv_general_dilated` at Precision.HIGHEST) in both directions, and
bf16 (`bcnn_tpu/ops/conv.py:140-222`, `:324-373`) in every mode; and the
reference's padded-deconv quirk, `conv2d_transpose_ref_quirk`.

The JAX package leaves the conv to XLA, outside any Pallas kernel, so the
port leaves it to cuDNN. cuDNN runs fp32 convs in TF32 by default (about
three decimal digits). The forward turns TF32 off around its call, and
so must the backward: autograd would run it later, outside that context,
in TF32. So the conv is an `autograd.Function` whose backward calls
`aten.convolution_backward` under the same flags.

Layouts: activations NCHW, weights OIHW. Output size (h + 2p - k)/s + 1,
as the builder computes it (bcnn_conv_layer.c:126-135). With
`channels_last` (the executor's bf16 inference layout,
`compile.channels_last_layout`), the bf16 casts of x and of the weight
write channels-last, each in its one pass: cuDNN's Hopper bf16 convs are
NHWC kernels, and handed NCHW tensors they transpose in and out. Its
output is then channels-last too.

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
    so fp32 master params get fp32 gradients. The deconv takes the same
    two paths, transposed (`conv_transpose2d`, and the backward with
    `transposed=True`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..profiling import span


def _tf32(allow: bool):
    cudnn = torch.backends.cudnn
    return cudnn.flags(
        enabled=cudnn.enabled,
        benchmark=cudnn.benchmark,
        deterministic=cudnn.deterministic,
        allow_tf32=allow,
    )


def _conv(x, w, stride, pad, groups, transposed):
    if transposed:
        return F.conv_transpose2d(x, w, None, stride, pad)
    return F.conv2d(x, w, None, stride, pad, 1, groups)


def _conv_backward(gy, x, w, conf, needs):
    stride, pad, groups, transposed = conf
    gx, gw, _ = torch.ops.aten.convolution_backward(
        gy, x, w, None, [stride] * 2, [pad] * 2, [1, 1], transposed,
        [0, 0], groups, [needs[0], needs[1], False],
    )
    return gx, gw


class _Conv2dFp32(torch.autograd.Function):
    """The conv, or with `transposed` the deconv, with TF32 off both
    ways."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, groups, transposed):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, pad, groups, transposed)
        with _tf32(False):
            return _conv(x, w, stride, pad, groups, transposed)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with _tf32(False):
            gx, gw = _conv_backward(gy, x, w, ctx.conf,
                                    ctx.needs_input_grad)
        return gx, gw, None, None, None, None


class _Conv2dMixed(torch.autograd.Function):
    """bf16 conv (or deconv) inputs, fp32 sum and output; the backward in
    bf16 (`bcnn_tpu/ops/conv.py:155-189`, and `_convt_mixed` :348-373)."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, groups, transposed, cd):
        x16, w16 = x.to(cd), w.to(cd)
        ctx.save_for_backward(x16, w16)
        ctx.conf = (stride, pad, groups, transposed)
        ctx.dtypes = (x.dtype, w.dtype)
        with _tf32(True):
            return _conv(x16.to(torch.float32), w16.to(torch.float32),
                         stride, pad, groups, transposed)

    @staticmethod
    def backward(ctx, gy):
        x16, w16 = ctx.saved_tensors
        xdt, wdt = ctx.dtypes
        gx, gw = _conv_backward(gy.to(x16.dtype), x16, w16, ctx.conf,
                                ctx.needs_input_grad)
        return (None if gx is None else gx.to(xdt),
                None if gw is None else gw.to(wdt),
                None, None, None, None, None)


def _conv_any(x, w, stride, pad, groups, transposed, compute_dtype,
              out_dtype, channels_last=False):
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if compute_dtype is not None:
        if grad:
            return _Conv2dMixed.apply(x, w, stride, pad, groups, transposed,
                                      compute_dtype)
        fmt = (torch.channels_last if channels_last
               else torch.preserve_format)
        xc = x.to(compute_dtype, memory_format=fmt)
        with span("bcnn.build.weight_cast"):
            wc = w.to(compute_dtype, memory_format=fmt)
        if out_dtype is not None:
            return _conv(xc, wc, stride, pad, groups, transposed).to(
                out_dtype)
        with _tf32(True):
            return _conv(xc.to(torch.float32), wc.to(torch.float32), stride,
                         pad, groups, transposed)
    x = x.to(w.dtype)
    if grad:
        return _Conv2dFp32.apply(x, w, stride, pad, groups, transposed)
    with _tf32(False):
        return _conv(x, w, stride, pad, groups, transposed)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int,
    pad: int,
    groups: int = 1,
    compute_dtype=None,
    out_dtype=None,
    channels_last: bool = False,
) -> torch.Tensor:
    """x: (N,C,H,W), w: (O,C//groups,k,k) -> (N,O,H',W'), in fp32 in the
    forward and, where autograd records it, in the backward; with
    compute_dtype, in bf16 both ways (see the module's docstring;
    out_dtype and channels_last are inference settings). Without
    compute_dtype, x is cast to w's dtype: a bf16 x stored between layers
    meets its fp32 weight in fp32, and a float64 net (tools/f3_float64.py)
    stays in float64."""
    return _conv_any(x, w, stride, pad, groups, False, compute_dtype,
                     out_dtype, channels_last)


def depthwise_conv2d(
    x: torch.Tensor, w: torch.Tensor, stride: int, pad: int
) -> torch.Tensor:
    """Depthwise conv (bcnn_depthwise_conv_layer.c:165-294), one filter per
    input channel: x (N,C,H,W), w (C,1,k,k), groups = C. The plain
    version of K3 (`ops.depthwise.depthwise_fused`)."""
    return conv2d(x, w, stride, pad, groups=x.shape[1])


def conv2d_transpose(
    x: torch.Tensor,
    w: torch.Tensor,
    stride: int,
    pad: int,
    compute_dtype=None,
) -> torch.Tensor:
    """The deconv of `bcnn_tpu.ops.conv.conv2d_transpose`
    (bcnn_deconv_layer.c:149-180): the transpose of a forward conv with
    the same stride and pad, output s*(h-1) + k - 2p. x (N,C,H,W), w
    (C, O, k, k) (the layer's blob order, `conv_transpose2d`'s) -> (N, O,
    H', W'). fp32 with TF32 off both ways; with compute_dtype, bf16
    inputs and an fp32 sum and output, the backward in bf16, as
    `_convt_mixed` (`bcnn_tpu/ops/conv.py:348-373`)."""
    return _conv_any(x, w, stride, pad, 1, True, compute_dtype, None)


def conv2d_transpose_ref_quirk(
    x: torch.Tensor, w: torch.Tensor, stride: int, pad: int
) -> torch.Tensor:
    """The reference's forward padded deconv, quirk included, as
    `bcnn_tpu.ops.conv.conv2d_transpose_ref_quirk` replicates it
    (bcnn_deconv_layer.c:149-180): the output is sized with the pad
    (s*(h-1) + k - 2p) but col2im runs with pad 0 and walks its input
    sequentially, so the f-th float it consumes is C.ravel()[f], C = W^T X
    laid out (co*k*k, h*w) row-major: the first co*k*k*oh*ow entries,
    oh = (dh - k)/s + 1, each added at (kr + orow*s, kc + ocol*s). At pad
    0 this is the true transpose conv. Autograd differentiates this
    forward (the reference's own backward reads stale memory at pad > 0).
    In fp32: TF32 is off for the product (`matmul.allow_tf32`, off by
    default)."""
    num, k = w.shape[1], w.shape[2]
    n, _, h, wid = x.shape
    dh = stride * (h - 1) + k - 2 * pad
    dw = stride * (wid - 1) + k - 2 * pad
    oh = (dh - k) // stride + 1
    ow = (dw - k) // stride + 1
    if oh <= 0 or ow <= 0:
        raise ValueError("degenerate padded deconv geometry")
    # C[(co,kr,kc),(y,x)] = sum_ci w[ci,co,kr,kc] * x[ci,y,x]
    cols = torch.einsum("nchw,corq->norqhw", x.to(w.dtype), w).reshape(
        n, num * k * k * h * wid)
    f = torch.arange(num * k * k * oh * ow, device=x.device)
    q, t = f // (oh * ow), f % (oh * ow)
    co, kr, kc = q // (k * k), (q // k) % k, q % k
    ir = kr + (t // ow) * stride
    ic = kc + (t % ow) * stride
    tgt = (co * dh + ir) * dw + ic  # NCHW flat target
    out = torch.zeros((n, num * dh * dw), dtype=cols.dtype, device=x.device)
    out = out.index_add(1, tgt, cols[:, : num * k * k * oh * ow])
    return out.reshape(n, num, dh, dw)
