"""int8 convolution with its fused epilogue: the CUDA kernel K4
(`csrc/conv_int8.cu`) and its plain PyTorch version.

K4 computes what `bcnn_tpu` runs through XLA for a quantized conv node:
`bcnn_tpu/ops/quant.py:302` `conv2d_int8`, then the BN/bias and
activation of `_apply_conv_epilogue` and the requantize of
`_maybe_emit_int8` (`bcnn_tpu/compile.py:438-468`). PyTorch has no int8
convolution on CUDA, so the port writes its own; the JAX package has no
Pallas kernel here.

    acc = sum over c, r, s of x * w           (int32, exact)
    y   = fp32(acc) * d,  d = fp32(sx) * w_scale
    y   = ((y - mean) * inv) * scale + bias   (BN as it stands: mean, inv)
        | y * scale + bias                    (BN folded: scale only)
        | y + bias                            (no BN)
    y   = NONE | RELU | LRELU
    out = int8(clip(rint(y / s_out), -127, 127)) when s_out is given,
          else fp32 y

`conv_int8_fused_ref` is the plain version: the sum as `F.conv2d` in
float64 on the int8 values (every partial sum is an integer below 2^53,
so it is exact in any order; cuDNN is kept out of it, so no transform
algorithm rounds), then the epilogue as separate torch ops in that
order. K4 rounds each step as those ops do and is bit-equal to it.

The wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back.
`conv_int8_fused.launches` counts the kernel's launches.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels
from ..types import Activation

# the kernel's tile: output pixels and output channels a block, the
# reduction depth of one step (one mma.m16n8k32), threads a block, the
# bytes of a shared-memory row (32 + 16 of padding);
# tests/test_torch_conv_int8_plan.py emulates the kernel with them
TILE_M, TILE_N, TILE_K, THREADS, ROW_BYTES = 128, 64, 32, 256, 48

# the activations K4 fuses, and their codes in csrc/conv_int8.cu
FUSED_ACT = {Activation.NONE: 0, Activation.RELU: 1, Activation.LRELU: 2}


def _vec(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def conv2d_int32(
    x: torch.Tensor, w: torch.Tensor, stride: int, pad: int, groups: int = 1
) -> torch.Tensor:
    """The exact int32 sum of an int8 conv: x (N,C,H,W), w (O,C/g,k,k)."""
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x.double(), w.double(), None, stride, pad, 1, groups)
    return acc.to(torch.int32)


def conv_int8_fused_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    d: torch.Tensor,
    bias: torch.Tensor,
    stride: int,
    pad: int,
    act: Activation = Activation.NONE,
    scale: Optional[torch.Tensor] = None,
    mean: Optional[torch.Tensor] = None,
    inv: Optional[torch.Tensor] = None,
    s_out: Optional[float] = None,
) -> torch.Tensor:
    """The plain version of K4 (see the module's docstring): the exact
    sum, then each epilogue step a separate torch op, in K4's order."""
    act = Activation(act)
    y = conv2d_int32(x, w, stride, pad).to(torch.float32) * _vec(d)
    if mean is not None:
        y = (y - _vec(mean)) * _vec(inv)
        y = y * _vec(scale) + _vec(bias)
    elif scale is not None:
        y = y * _vec(scale) + _vec(bias)
    else:
        y = y + _vec(bias)
    if act == Activation.LRELU:
        y = torch.where(y > 0, y, 0.1 * y)
    elif act == Activation.RELU:
        y = torch.where(y < 0, torch.zeros_like(y), y)
    elif act != Activation.NONE:
        raise ValueError(f"conv_int8_fused: activation {act!r} is not fused")
    if s_out is None:
        return y
    s = torch.tensor(s_out, dtype=torch.float32, device=y.device)
    return torch.clamp(torch.round(y / s), -127, 127).to(torch.int8)


def conv_int8_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    d: torch.Tensor,
    bias: torch.Tensor,
    stride: int,
    pad: int,
    act: Activation = Activation.NONE,
    scale: Optional[torch.Tensor] = None,
    mean: Optional[torch.Tensor] = None,
    inv: Optional[torch.Tensor] = None,
    s_out: Optional[float] = None,
) -> torch.Tensor:
    """K4: `conv_int8_fused_ref` as one CUDA kernel for CUDA tensors. x
    int8 (N,C,H,W), w int8 (O,C,k,k), groups 1; d, bias and the BN
    vectors fp32 (O,); returns int8 when s_out is given, else fp32."""
    act = Activation(act)
    if mean is not None and (inv is None or scale is None):
        raise ValueError("conv_int8_fused: BN needs mean, inv and scale")
    vecs = [v for v in (d, bias, scale, mean, inv) if v is not None]
    ts = [x, w, *vecs]
    if all(t.device.type == "cpu" for t in ts):
        return conv_int8_fused_ref(x, w, d, bias, stride, pad, act, scale,
                                   mean, inv, s_out)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(
            "conv_int8_fused: unsupported devices "
            + ", ".join(str(t.device) for t in ts)
        )
    if x.dtype != torch.int8 or w.dtype != torch.int8 or any(
        v.dtype != torch.float32 for v in vecs
    ):
        raise TypeError(
            f"conv_int8_fused: needs int8 x and w and float32 vectors, got "
            f"{x.dtype}, {w.dtype}, " + ", ".join(str(v.dtype) for v in vecs)
        )
    if act not in FUSED_ACT:
        raise ValueError(f"conv_int8_fused: activation {act!r} is not fused")
    if (
        x.dim() != 4 or w.dim() != 4 or w.shape[1] != x.shape[1]
        or w.shape[2] != w.shape[3]
        or any(tuple(v.shape) != (w.shape[0],) for v in vecs)
    ):
        raise ValueError(
            f"conv_int8_fused: x {tuple(x.shape)} is not (N, C, H, W), w "
            f"{tuple(w.shape)} not (O, C, k, k) or a vector not (O,)"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("conv_int8_fused: every tensor must be contiguous")
    if stride < 1 or pad < 0:
        raise ValueError(f"conv_int8_fused: stride {stride}, pad {pad}")
    if s_out is not None and not s_out > 0:
        raise ValueError(f"conv_int8_fused: s_out {s_out}")
    n, c, h, wd = x.shape
    o, _, k, _ = w.shape
    oh = max(0, (h + 2 * pad - k) // stride + 1)
    ow = max(0, (wd + 2 * pad - k) // stride + 1)
    out = torch.empty(
        (n, o, oh, ow),
        dtype=torch.float32 if s_out is None else torch.int8,
        device=x.device,
    )
    if out.numel():
        bn = 0 if scale is None else 1 if mean is None else 2
        ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
        lib = kernels.library()
        with torch.cuda.device(x.device):
            rc = lib.bcnn_conv_int8(
                x.data_ptr(), w.data_ptr(), d.data_ptr(), ptr(scale),
                bias.data_ptr(), ptr(mean), ptr(inv), out.data_ptr(),
                n, c, h, wd, o, k, stride, pad, bn, FUSED_ACT[act],
                int(s_out is not None),
                0.0 if s_out is None else float(s_out),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        kernels.check(rc, "conv_int8_fused")
        conv_int8_fused.launches += 1
    return out


conv_int8_fused.launches = 0
