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
it; w (O, C/G, k, k) held (k, k, O, C/G) in memory (`grouped_weight`):
a group's input channels are contiguous for each tap and output
channel, so the grouped branches read 16 (or 4) of them with one load
and reduce them with `__dp4a`; for depthwise (C/G = 1) it is the memory
of (k, k, 1, O), 16 consecutive channels' weights at one tap one 16-byte
load. The quant dicts hold depthwise and grouped weights so from the
start. An int8 output is written channels-last, an fp32 one
NCHW-contiguous, as K4 writes them.

The kernel (its source note says more): the grid walks (image, output
row, strip of `s` pixels) with no division a pixel; a depthwise 3x3
layer with C % 16 == 0 runs on 16-channel lanes in strips of 2 pixels,
its block staging the weights once in shared memory, each thread
loading its strip's x columns once a kernel row and summing a row's 3
taps of a channel with one `__dp4a` on a word of 4 columns made by byte
transposes in registers; grouped convs with C/G % 16 (or 4) == 0 and
O/G % 4 == 0 run `__dp4a` over the group's channels, 4 output channels a
lane; everything else a byte branch. The requantize multiplies by 1/s
and decides exactly (without dividing) only within 2^-15 of a
half-integer (`requant_bits_ref` is its numpy twin), so every code
equals rint(y / s)'s.

The wrapper calls the op `bcnn_tpu_torch::grouped_int8` (`ops.library`):
its CPU implementation is the plain version; its CUDA implementation,
`grouped_int8_cuda`, launches the kernel or raises, also on an x that is
not channels-last or a w not in K5's layout. `plan_grouped_int8` chooses
the branch and the launch geometry here, where the CPU tests reach it
(`tests/test_torch_grouped_int8_plan.py` emulates the kernel's words and
byte operations with it). `library.launches("grouped_int8")` counts the
kernel's launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..types import Activation
from . import library
from .conv_int8 import (FUSED_ACT, check_epilogue, conv2d_int32,
                        int8_conv_fake, int8_conv_flops, int8_epilogue_ref,
                        out_format, out_size)

# csrc/grouped_int8.cu's branches: depthwise 3x3 on 16-channel lanes,
# grouped __dp4a on 16 or 4 of a group's channels at a time, bytes
DW, G16, G4, BYTES = 0, 1, 2, 3
BRANCH_NAMES = ("dw", "g16", "g4", "bytes")
# threads a block at most; per branch the pixels a strip, the lanes a
# block at most and the threads a block aimed at (chosen by
# `tools/k5_compare.py --sweep` on the card)
THREADS, DW_LANES = 256, 64
STRIP = {DW: 2, G16: 4, G4: 4, BYTES: 1}
LANES = {DW: 8, G16: 2, G4: 2, BYTES: 64}
AIM = {DW: 256, G16: 128, G4: 128, BYTES: 256}
INT32_MAX = 2**31 - 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class GroupedPlan(NamedTuple):
    """The launch geometry of one K5 launch: block (lanes, strips, rows),
    grid (n * strip_tiles, row_tiles, lane_tiles)."""

    branch: int       # DW, G16, G4 or BYTES
    s: int            # output pixels a strip (a thread)
    lanes: int        # lanes a block: 16 channels (DW) or 4 output ones
    strips: int       # strips a block along a row
    rows: int         # output rows a block
    strip_tiles: int  # blocks along a row
    row_tiles: int    # blocks down the rows
    lane_tiles: int   # blocks across the lanes
    lanes_all: int    # lanes of the layer

    @property
    def threads(self) -> int:
        return self.lanes * self.strips * self.rows

    def blocks(self, n: int) -> int:
        return n * self.strip_tiles * self.row_tiles * self.lane_tiles

    def describe(self) -> str:
        return (f"{BRANCH_NAMES[self.branch]}, strips of {self.s}, block "
                f"{self.lanes}x{self.strips}x{self.rows}")


def k5_branch(c: int, o: int, k: int, stride: int, groups: int,
              align: int = 16, shortcut: bool = True) -> int:
    """The branch K5 runs for a shape whose addresses are all multiples
    of `align`; `shortcut`: fp32 out, or 1 / s_out normal (`shortcut_on`)
    (csrc/grouped_int8.cu:bcnn_grouped_int8_branch)."""
    cg, og = c // groups, o // groups
    if (cg == 1 and og == 1 and c % 16 == 0 and k == 3 and stride in (1, 2)
            and align >= 16 and shortcut):
        return DW
    if og % 4 == 0 and cg % 16 == 0 and align >= 16:
        return G16
    if og % 4 == 0 and cg % 4 == 0 and align >= 4:
        return G4
    return BYTES


def plan_grouped_int8(n: int, c: int, h: int, w: int, o: int, k: int,
                      stride: int, pad: int, groups: int,
                      align: int = 16, shortcut: bool = True,
                      s: Optional[int] = None,
                      lanes: Optional[int] = None,
                      aim: Optional[int] = None) -> GroupedPlan:
    """K5's plan for x (n, c, h, w), o output channels in `groups`
    groups, a k x k window, addresses multiples of `align`, `shortcut`
    as `k5_branch` takes it: the branch,
    then (unless given) STRIP's pixels a strip, as many lanes a block as
    the layer has up to LANES, as many strips of a row as make AIM
    threads, and as many rows as fill the rest; the grid is as large as
    the layer."""
    oh, ow = out_size(h, w, k, stride, pad)
    m = n * oh * ow
    if (m < 1 or o < 1 or c < 1 or groups < 1 or c % groups
            or o % groups):
        raise ValueError(
            f"plan_grouped_int8: no output for {(n, c, h, w)} -> {o} in "
            f"{groups} groups, k {k}, stride {stride}, pad {pad}")
    if (n * h * w * c > INT32_MAX or m * o > INT32_MAX
            or k * k * o * (c // groups) > INT32_MAX):
        raise ValueError(
            f"plan_grouped_int8: {(n, c, h, w)} -> {o} needs offsets past "
            "2^31, which K5 does not take")
    branch = k5_branch(c, o, k, stride, groups, align, shortcut)
    lanes_all = c // 16 if branch == DW else _cdiv(o, 4)
    s = STRIP[branch] if s is None else s
    lanes = min(lanes_all, LANES[branch] if lanes is None else lanes)
    if branch == DW:
        lanes = min(lanes, DW_LANES)  # the block's weights in 24 KB
    aim = AIM[branch] if aim is None else aim
    strips = min(_cdiv(ow, s), max(1, aim // lanes))
    rows = min(oh, max(1, aim // (lanes * strips)))
    return GroupedPlan(branch, s, lanes, strips, rows,
                       _cdiv(_cdiv(ow, s), strips), _cdiv(oh, rows),
                       _cdiv(lanes_all, lanes), lanes_all)


def shortcut_on(s_out: Optional[float]) -> bool:
    """Whether K5 may requantize by 1 / s_out (fp32 out, or 1 / s_out a
    normal float32), as its launcher decides."""
    if s_out is None:
        return True
    with np.errstate(over="ignore", divide="ignore"):
        inv = np.float32(1) / np.float32(s_out)
    return bool(np.isfinite(inv) and abs(inv) >= np.finfo(np.float32).tiny)


def alignment(*ts: Optional[torch.Tensor]) -> int:
    """The largest power of two up to 16 dividing every tensor's address
    (csrc/grouped_int8.cu:alignment)."""
    bits = 16
    for t in ts:
        if t is not None:
            bits |= t.data_ptr()
    return bits & -bits


def requant_bits_ref(y: np.ndarray,
                     s: float) -> tuple[np.ndarray, np.ndarray]:
    """int8_epilogue.cuh's requant_bits in numpy, step for step: the int8
    codes it writes for fp32 values y and scale s (1 / s normal), and
    which of them took the exact decision at a half-integer."""
    y = np.asarray(y, np.float32)
    s32 = np.float32(s)
    inv = np.float32(1) / s32
    rnd = np.float32(12582912.0)  # 1.5 * 2^23
    with np.errstate(over="ignore", invalid="ignore"):
        t = y * inv
        t = np.where(np.isnan(t), np.float32(-127),
                     np.clip(t, np.float32(-127), np.float32(127)))
        nm = t + rnd
        e = t - (nm - rnd)
        near = ~(np.abs(e) < np.float32(0.5 - 2.0**-15))
        h = np.floor(t) + np.float32(0.5)
        hd = h.astype(np.float64)
        up = hd + 0.5 * (np.nextafter(h, np.float32(np.inf)).astype(
            np.float64) - hd)
        dn = hd - 0.5 * (hd - np.nextafter(h, np.float32(-np.inf)).astype(
            np.float64))
        yd, sd = y.astype(np.float64), float(s32)
        q = h - np.float32(0.5)
        odd = q.astype(np.int64) & 1 == 1
        q = np.where((yd - up * sd > 0) | (~(yd - dn * sd < 0) & odd),
                     h + np.float32(0.5), q)
        exact = (np.clip(q, -127, 127) + rnd).view(np.int32) & 0xFF
    code = np.where(near, exact, nm.view(np.int32) & 0xFF)
    return ((code + 128) % 256 - 128).astype(np.int8), near


def grouped_weight(w: torch.Tensor) -> torch.Tensor:
    """w (O, C/G, k, k) held (k, k, O, C/G) in memory, K5's layout (a
    group's input channels contiguous for each tap and output channel;
    for depthwise, C/G = 1, the memory of (k, k, 1, O)), with the strides
    of that layout also on dims of size 1 (so that every quant dict holds
    the same tensor); w itself where it is so already."""
    o, cg, k, _ = w.shape
    strides = (cg, 1, k * o * cg, o * cg)
    if w.stride() == strides:
        return w
    return torch.empty_strided(w.shape, strides, dtype=w.dtype,
                               device=w.device).copy_(w)


def is_grouped_weight(w: torch.Tensor) -> bool:
    return w.dim() == 4 and w.permute(2, 3, 0, 1).is_contiguous()


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
    """K5: `grouped_int8_fused_ref` as one CUDA kernel for CUDA tensors,
    through the op `bcnn_tpu_torch::grouped_int8` on either device. x
    int8 (N,C,H,W), w int8 (O,C/groups,k,k), on the card x channels-last
    and w in `grouped_weight`'s layout; d, bias and the BN vectors fp32
    (O,). Returns int8 channels-last when s_out is given, else fp32
    NCHW-contiguous, on either device."""
    act = check_epilogue("grouped_int8_fused", act, scale, mean, inv)
    library.check_devices("grouped_int8_fused", x, w, d, bias, scale,
                          mean, inv)
    return _K5(x, w, d, bias, stride, pad, groups, int(act), scale, mean,
               inv, None if s_out is None else float(s_out))


def _grouped_int8_cpu(x, w, d, bias, stride, pad, groups, act, scale=None,
                      mean=None, inv=None, s_out=None):
    return grouped_int8_fused_ref(
        x, w, d, bias, stride, pad, groups, act, scale, mean, inv,
        s_out).contiguous(memory_format=out_format(s_out))


def grouped_int8_cuda(x, w, d, bias, stride, pad, groups, act, scale=None,
                      mean=None, inv=None, s_out=None):
    """The op's CUDA implementation, K5's launcher: checks what the
    kernel takes (raises otherwise), plans, allocates the output,
    launches (`launch`)."""
    act = Activation(act)
    vecs = [v for v in (d, bias, scale, mean, inv) if v is not None]
    ts = [x, w, *vecs]
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
            "contiguous (NHWC), w held (k, k, O, C/G) (grouped_weight) and "
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
        device=x.device, memory_format=out_format(s_out),
    )
    if out.numel():
        plan = plan_grouped_int8(
            n, c, h, wd, o, k, stride, pad, groups,
            alignment(x, w, d, bias, scale, mean, inv, out),
            shortcut_on(s_out))
        launch(plan, x, w, d, bias, stride, pad, groups, act, scale, mean,
               inv, s_out, out)
    return out


def launch(plan: GroupedPlan, x, w, d, bias, stride, pad, groups, act,
           scale, mean, inv, s_out, out, lib=None) -> None:
    """K5 on `plan` into `out`, arguments as `grouped_int8_fused` checked
    them (also `tools/k5_compare.py`'s sweep, where `lib` may be another
    build); raises if the launcher refuses the plan or the launch fails.
    Counts nothing."""
    n, c, h, wd = x.shape
    o, _, k, _ = w.shape
    bn = 0 if scale is None else 1 if mean is None else 2
    ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
    lib = lib or kernels.library()
    with torch.cuda.device(x.device):
        rc = lib.bcnn_grouped_int8(
            x.data_ptr(), w.data_ptr(), d.data_ptr(), ptr(scale),
            bias.data_ptr(), ptr(mean), ptr(inv), out.data_ptr(),
            n, c, h, wd, o, k, stride, pad, groups, bn, FUSED_ACT[act],
            int(s_out is not None), 0.0 if s_out is None else float(s_out),
            plan.branch, plan.s, plan.lanes, plan.strips, plan.rows,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(rc, "grouped_int8_fused")


_K5 = library.register(
    "grouped_int8",
    "(Tensor x, Tensor w, Tensor d, Tensor bias, int stride, int pad, "
    "int groups, int act, Tensor? scale=None, Tensor? mean=None, "
    "Tensor? inv=None, float? s_out=None) -> Tensor",
    cpu=_grouped_int8_cpu,
    cuda=grouped_int8_cuda,
    fake=lambda x, w, d, bias, stride, pad, groups, act, scale=None,
    mean=None, inv=None, s_out=None: int8_conv_fake(x, w, stride, pad,
                                                    s_out),
    flops=int8_conv_flops,
)
