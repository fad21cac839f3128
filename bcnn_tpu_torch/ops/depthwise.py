"""Depthwise conv + bias + activation in one pass: the CUDA kernel K3
(`csrc/depthwise.cu`) and its plain PyTorch version.

`depthwise_fused` replaces the Pallas TPU kernel
`bcnn_tpu.ops.dw_pallas.depthwise_fused`, on NCHW tensors with (C, 1, k,
k) weights. Unlike the JAX package, which keeps that kernel out of its
executor, the port runs every depthwise layer through it on the card.
`depthwise_fused_ref` is its plain version: `ops.conv.depthwise_conv2d`
(the grouped conv), then + b, then `apply_activation`, as
`bcnn_tpu.compile._depthwise_conv2d` computes the layer.

The wrapper runs the plain version only when every tensor is on the CPU.
For CUDA tensors it launches the kernel or raises; nothing falls back.
It takes fp32 only. An activation the kernel does not fuse (TANH,
SOFTPLUS, ...) runs the kernel with NONE and then `apply_activation`.
The kernel has no backward yet, so it refuses tensors that autograd
records. `depthwise_fused.launches` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..types import Activation
from .activations import apply_activation
from .conv import depthwise_conv2d

# the kernel's activation codes (csrc/depthwise.cu)
_FUSED = {
    Activation.NONE: 0,
    Activation.RELU: 1,
    Activation.LRELU: 2,
    Activation.CLAMP: 3,
}


def depthwise_fused_ref(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
    pad: int, act: Activation = Activation.NONE,
) -> torch.Tensor:
    """x (N,C,H,W), w (C,1,k,k), b (C,) -> (N,C,OH,OW)."""
    y = depthwise_conv2d(x, w, stride, pad) + b.reshape(1, -1, 1, 1)
    return apply_activation(y, act)


def depthwise_fused(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
    pad: int, act: Activation = Activation.NONE,
) -> torch.Tensor:
    """K3: `depthwise_fused_ref` as one CUDA kernel for CUDA tensors (fp32,
    contiguous)."""
    act = Activation(act)
    ts = (x, w, b)
    if all(t.device.type == "cpu" for t in ts):
        return depthwise_fused_ref(x, w, b, stride, pad, act)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(
            "depthwise_fused: unsupported devices "
            f"{x.device}, {w.device}, {b.device}"
        )
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(
            f"depthwise_fused: needs float32, got {x.dtype}, {w.dtype}, "
            f"{b.dtype}"
        )
    if (
        x.dim() != 4 or w.dim() != 4
        or tuple(w.shape[:2]) != (x.shape[1], 1) or w.shape[2] != w.shape[3]
        or tuple(b.shape) != (x.shape[1],)
    ):
        raise ValueError(
            f"depthwise_fused: x {tuple(x.shape)} is not (N, C, H, W), w "
            f"{tuple(w.shape)} not (C, 1, k, k) or b {tuple(b.shape)} not "
            "(C,)"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("depthwise_fused: x, w and b must be contiguous")
    if stride < 1 or pad < 0:
        raise ValueError(f"depthwise_fused: stride {stride}, pad {pad}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "depthwise_fused: the CUDA kernel has no backward yet"
        )
    n, c, h, wd = x.shape
    k = w.shape[2]
    oh = max(0, (h + 2 * pad - k) // stride + 1)
    ow = max(0, (wd + 2 * pad - k) // stride + 1)
    y = torch.empty((n, c, oh, ow), dtype=torch.float32, device=x.device)
    if y.numel():
        lib = kernels.library()
        with torch.cuda.device(x.device):
            rc = lib.bcnn_depthwise(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, c,
                h, wd, k, stride, pad, _FUSED.get(act, 0),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        kernels.check(rc, "depthwise_fused")
        depthwise_fused.launches += 1
    return y if act in _FUSED else apply_activation(y, act)


depthwise_fused.launches = 0
