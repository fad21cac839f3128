"""int8 grouped and depthwise convolution with its fused epilogue: the
CUDA kernel K5 (`csrc/grouped_int8.cu`) and its plain PyTorch version.

K5 computes what `bcnn_tpu` runs through XLA for a quantized depthwise
layer (`bcnn_tpu/compile.py:470-496`) or a quantized CONV2D with
num_groups > 1 (`:438-468`): `bcnn_tpu/ops/quant.py:302` `conv2d_int8`
with groups, then the bias or BN, the activation and the requantize.
PyTorch has no int8 convolution on CUDA, and the JAX package has no
Pallas kernel here. The computation is K4's (`ops.conv_int8`) with
groups: the exact int32 sum over each group's input channels and the k x
k taps, then `int8_epilogue_ref`'s steps, in its order and rounding.
`grouped_int8_fused_ref` is the plain version: `conv2d_int32` with
groups (float64, exact), then that epilogue.

Layouts: x int8 channels-last (NHWC in memory), as the int8 flow holds
it; w (O, C/G, k, k) held (k, k, C/G, O) in memory (`grouped_weight`),
so that the weights of 4 consecutive output channels at one tap are one
char4. The quant dicts hold depthwise and grouped weights so from the
start. An int8 output is written channels-last, an fp32 one
NCHW-contiguous, as K4 writes them.

The wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises, also on an x that is not
channels-last or a w not in K5's layout. `plan_grouped_int8` chooses
the launch geometry here, where the CPU tests reach it
(`tests/test_torch_grouped_int8_plan.py` emulates the kernel with it).
`grouped_int8_fused.launches` counts the kernel's launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..types import Activation
from .conv_int8 import FUSED_ACT, conv2d_int32, int8_epilogue_ref, out_size

# csrc/grouped_int8.cu: threads a block at most, quads (4 output
# channels) a block at most, bytes of staged weights at most, pixels a
# thread walks at most
THREADS, MAX_QUADS, SMEM_STAGED, PIX = 256, 64, 48 * 1024, 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class GroupedPlan(NamedTuple):
    """The launch geometry of one K5 launch."""

    quads: int     # quads of output channels a block (a power of two)
    rows: int      # pixels a block at a time: threads = quads * rows
    pix: int       # pixels a thread, rows apart
    tiles_m: int   # blocks along the pixels
    tiles_q: int   # blocks along the output channels
    staged: bool   # the block's weights in shared memory
    vec: bool      # char4 loads of x and w (depthwise, C % 4 == 0)

    @property
    def threads(self) -> int:
        return self.quads * self.rows

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_q


def plan_grouped_int8(n: int, c: int, h: int, w: int, o: int, k: int,
                      stride: int, pad: int, groups: int,
                      sms: int = 132) -> GroupedPlan:
    """K5's plan for x (n, c, h, w), o output channels in `groups`
    groups, a k x k window: as many quads a block as the layer has, up
    to 64 (rounded up to a power of two), halved until the block's
    weights fit in 48 KB of shared memory (else not staged, at the
    widest); 256 threads a block; 8 pixels a thread, halved while the
    grid has fewer than two blocks an SM."""
    oh, ow = out_size(h, w, k, stride, pad)
    m = n * oh * ow
    if (m < 1 or o < 1 or c < 1 or groups < 1 or c % groups
            or o % groups):
        raise ValueError(
            f"plan_grouped_int8: no output for {(n, c, h, w)} -> {o} in "
            f"{groups} groups, k {k}, stride {stride}, pad {pad}")
    cg = c // groups
    nq = _cdiv(o, 4)
    widest = min(MAX_QUADS, 1 << (nq - 1).bit_length())
    quads = widest
    while quads > 1 and k * k * cg * 4 * quads > SMEM_STAGED:
        quads //= 2
    staged = k * k * cg * 4 * quads <= SMEM_STAGED
    if not staged:
        quads = widest
    rows = THREADS // quads
    tiles_q = _cdiv(nq, quads)
    pix = PIX
    while pix > 1 and _cdiv(m, rows * pix) * tiles_q < 2 * sms:
        pix //= 2
    return GroupedPlan(quads, rows, pix, _cdiv(m, rows * pix), tiles_q,
                       staged, cg == 1 and o == c and c % 4 == 0)


def grouped_weight(w: torch.Tensor) -> torch.Tensor:
    """w (O, C/G, k, k) held (k, k, C/G, O) in memory, K5's layout; w
    itself where it is so already."""
    if is_grouped_weight(w):
        return w
    return w.permute(2, 3, 1, 0).contiguous().permute(3, 2, 0, 1)


def is_grouped_weight(w: torch.Tensor) -> bool:
    return w.dim() == 4 and w.permute(2, 3, 1, 0).is_contiguous()


def grouped_int8_fused_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    d: torch.Tensor,
    bias: torch.Tensor,
    stride: int,
    pad: int,
    groups: int,
    act: Activation = Activation.NONE,
    scale: Optional[torch.Tensor] = None,
    mean: Optional[torch.Tensor] = None,
    inv: Optional[torch.Tensor] = None,
    s_out: Optional[float] = None,
) -> torch.Tensor:
    """The plain version of K5: the exact grouped sum, then K4's
    epilogue, each step a separate torch op."""
    return int8_epilogue_ref(conv2d_int32(x, w, stride, pad, groups), d,
                             bias, act, scale, mean, inv, s_out)


def grouped_int8_fused(
    x: torch.Tensor,
    w: torch.Tensor,
    d: torch.Tensor,
    bias: torch.Tensor,
    stride: int,
    pad: int,
    groups: int,
    act: Activation = Activation.NONE,
    scale: Optional[torch.Tensor] = None,
    mean: Optional[torch.Tensor] = None,
    inv: Optional[torch.Tensor] = None,
    s_out: Optional[float] = None,
) -> torch.Tensor:
    """K5: `grouped_int8_fused_ref` as one CUDA kernel for CUDA tensors.
    x int8 (N,C,H,W), w int8 (O,C/groups,k,k), on the card x
    channels-last and w in `grouped_weight`'s layout; d, bias and the BN
    vectors fp32 (O,). Returns int8 channels-last when s_out is given,
    else fp32 NCHW-contiguous, on either device."""
    act = Activation(act)
    if mean is not None and (inv is None or scale is None):
        raise ValueError("grouped_int8_fused: BN needs mean, inv and scale")
    vecs = [v for v in (d, bias, scale, mean, inv) if v is not None]
    ts = [x, w, *vecs]
    fmt = torch.contiguous_format if s_out is None else torch.channels_last
    if all(t.device.type == "cpu" for t in ts):
        return grouped_int8_fused_ref(
            x, w, d, bias, stride, pad, groups, act, scale, mean, inv,
            s_out).contiguous(memory_format=fmt)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(
            "grouped_int8_fused: unsupported devices "
            + ", ".join(str(t.device) for t in ts)
        )
    if x.dtype != torch.int8 or w.dtype != torch.int8 or any(
        v.dtype != torch.float32 for v in vecs
    ):
        raise TypeError(
            f"grouped_int8_fused: needs int8 x and w and float32 vectors, "
            f"got {x.dtype}, {w.dtype}, "
            + ", ".join(str(v.dtype) for v in vecs)
        )
    if act not in FUSED_ACT:
        raise ValueError(
            f"grouped_int8_fused: activation {act!r} is not fused")
    if (
        x.dim() != 4 or w.dim() != 4 or groups < 1
        or x.shape[1] % groups or w.shape[0] % groups
        or w.shape[1] * groups != x.shape[1] or w.shape[2] != w.shape[3]
        or any(tuple(v.shape) != (w.shape[0],) for v in vecs)
    ):
        raise ValueError(
            f"grouped_int8_fused: x {tuple(x.shape)} is not (N, C, H, W), "
            f"w {tuple(w.shape)} not (O, C/{groups}, k, k) or a vector "
            "not (O,)"
        )
    if not (x.is_contiguous(memory_format=torch.channels_last)
            and is_grouped_weight(w)
            and all(v.is_contiguous() for v in vecs)):
        raise ValueError(
            "grouped_int8_fused: on the card x must be channels-last "
            "contiguous (NHWC), w held (k, k, C/G, O) (grouped_weight) and "
            f"the vectors contiguous; got x strides {x.stride()}, w "
            f"strides {w.stride()}"
        )
    if stride < 1 or pad < 0:
        raise ValueError(f"grouped_int8_fused: stride {stride}, pad {pad}")
    if s_out is not None and not s_out > 0:
        raise ValueError(f"grouped_int8_fused: s_out {s_out}")
    n, c, h, wd = x.shape
    o, _, k, _ = w.shape
    oh, ow = out_size(h, wd, k, stride, pad)
    out = torch.empty(
        (n, o, oh, ow),
        dtype=torch.float32 if s_out is None else torch.int8,
        device=x.device, memory_format=fmt,
    )
    if out.numel():
        plan = plan_grouped_int8(n, c, h, wd, o, k, stride, pad, groups,
                                 kernels.sm_count(x.device))
        bn = 0 if scale is None else 1 if mean is None else 2
        ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
        lib = kernels.library()
        with torch.cuda.device(x.device):
            rc = lib.bcnn_grouped_int8(
                x.data_ptr(), w.data_ptr(), d.data_ptr(), ptr(scale),
                bias.data_ptr(), ptr(mean), ptr(inv), out.data_ptr(),
                n, c, h, wd, o, k, stride, pad, groups, bn, FUSED_ACT[act],
                int(s_out is not None),
                0.0 if s_out is None else float(s_out),
                plan.quads, plan.rows, plan.pix, int(plan.staged),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        kernels.check(rc, "grouped_int8_fused")
        grouped_int8_fused.launches += 1
    return out


grouped_int8_fused.launches = 0
