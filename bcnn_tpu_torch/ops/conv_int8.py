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

Layouts: the int8 program holds its int8 activations channels-last
(logical NCHW, NHWC in memory), and K4 takes x so and w (O, C, k, k)
channels-last, i.e. (O, k, k, C) in memory, k in (r, s, c) order (the
quant dicts hold their weights so; `channels_last_weight` repacks
another). It
writes an int8 output channels-last and an fp32 output (the linear
heads) NCHW-contiguous, as the heads' readers take them.

The wrapper calls the op `bcnn_tpu_torch::conv_int8` (`ops.library`),
one graph node whatever the device: its CPU implementation is the plain
version, returning the same layouts; its CUDA implementation,
`conv_int8_cuda`, launches the kernel or raises, also on an x or w that
is not channels-last; nothing falls back and nothing is copied. `plan_conv_int8` chooses the kernel's tile
and its split of K here, where the CPU tests reach it; the kernel checks
the plan. `library.launches("conv_int8")` counts the kernel's launches: one
a call, split or not (a split launch first zeroes its tiles' counters
with one `cudaMemsetAsync` on the same stream, which is not counted).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import kernels
from ..profiling import span
from ..types import Activation
from . import library

# the kernel's tile shapes (csrc/conv_int8.cu kCfgs): output pixels and
# output channels a block, warps along each; the reduction depth of one
# mma.m16n8k32, the k values of a stage (two of them) and the stages of
# a block's ring; tests/test_torch_conv_int8_plan.py emulates the kernel
# with them
CONFIGS = ((128, 64, 4, 2), (64, 64, 2, 2), (128, 32, 4, 1), (128, 16, 4, 1))
TILE_K, STAGE_K, STAGES = 32, 64, 4
# The plan's rules, from timing every tile shape and split at the 13
# YOLOv3-tiny convs on an H100 (tools/k4_compare.py --sweep, PERF.md):
# 128 x 32 tiles where K is deep, 128 x 64 where they make two blocks an
# SM, else 64 x 64; K split only where it is deeper still and the tiles
# make fewer than two blocks an SM (a split costs a partial round trip
# and a counter reset that the short-K layers do not earn back).
DEEP_K, SPLIT_K = 1024, 2048
SMEM_BLOCK = 232448  # shared memory a block may take, bytes (227 KB)

# the activations K4 fuses, and their codes in csrc/conv_int8.cu
FUSED_ACT = {Activation.NONE: 0, Activation.RELU: 1, Activation.LRELU: 2}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class ConvPlan(NamedTuple):
    """The tiles and the split of K of one K4 launch."""

    cfg: int          # index into CONFIGS
    bm: int           # output pixels a tile
    bn: int           # output channels a tile
    threads: int      # threads a block
    tiles_m: int
    tiles_n: int
    splits: int       # blocks a tile, each a run of K
    split_steps: int  # stages of STAGE_K k values a run
    steps: int        # stages in all

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n * self.splits

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: the ring, or the staged
        output tile that reuses it (fp32 transposed, rows of bm + 4
        floats; int8, rows of `int8_stage_row(bn)` bytes)."""
        ring = STAGES * (self.bm + self.bn) * STAGE_K
        return max(ring, self.bn * (self.bm + 4) * 4,
                   self.bm * int8_stage_row(self.bn))

    @property
    def workspace_ints(self) -> int:
        """int32 partial sums of a split launch (0 without a split)."""
        if self.splits == 1:
            return 0
        return self.tiles_m * self.tiles_n * self.splits * self.bm * self.bn


def int8_stage_row(bn: int) -> int:
    """Bytes of a pixel's row in the staged int8 output tile: bn and 16
    or 32 more, an odd number of 16-byte units, so that the epilogue's
    2-byte writes of a warp land on 32 banks."""
    return bn + (32 if (bn // 16) % 2 else 16)


def out_size(h: int, w: int, k: int, stride: int, pad: int):
    return (max(0, (h + 2 * pad - k) // stride + 1),
            max(0, (w + 2 * pad - k) // stride + 1))


def plan_conv_int8(n: int, c: int, h: int, w: int, o: int, k: int,
                   stride: int, pad: int, sms: int = 132) -> ConvPlan:
    """K4's plan for x (n, c, h, w), o output channels, a k x k window:
    for O <= 16 or <= 32 the tile of that width; else 128 x 32 where K =
    C k k is at least DEEP_K, 128 x 64 where that makes two blocks an
    SM, else 64 x 64; then, where K is at least SPLIT_K and the tiles
    make fewer than two blocks an SM (the deepest 13x13 layers), K split
    into the fewest runs of whole stages that reach two, as even as
    whole stages go, every run non-empty."""
    oh, ow = out_size(h, w, k, stride, pad)
    m = n * oh * ow
    if m < 1 or o < 1 or c < 1:
        raise ValueError(f"plan_conv_int8: no output for {(n, c, h, w)} "
                         f"-> {o}, k {k}, stride {stride}, pad {pad}")
    kdim = c * k * k
    steps = _cdiv(kdim, STAGE_K)
    if o <= 16:
        cfg = 3
    elif o <= 32 or kdim >= DEEP_K:
        cfg = 2
    else:
        cfg = 0 if _cdiv(m, 128) * _cdiv(o, 64) >= 2 * sms else 1
    bm, bn, wm, wn = CONFIGS[cfg]
    tiles_m, tiles_n = _cdiv(m, bm), _cdiv(o, bn)
    target = 2 * sms if kdim >= SPLIT_K else 1
    for want in range(1, steps + 1):
        split_steps = _cdiv(steps, want)  # runs as even as whole stages go
        splits = _cdiv(steps, split_steps)
        if tiles_m * tiles_n * splits >= target:
            break
    return ConvPlan(cfg, bm, bn, 32 * wm * wn, tiles_m, tiles_n, splits,
                    split_steps, steps)


def channels_last_weight(w: torch.Tensor) -> torch.Tensor:
    """w (O, C, k, k) held channels-last, (O, k, k, C) in memory: K4's
    (r, s, c) order of k; w itself where it is so already. The quant
    dicts hold their conv weights so from the start; this repack is for
    weights made elsewhere."""
    return w.contiguous(memory_format=torch.channels_last)


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
    return int8_epilogue_ref(conv2d_int32(x, w, stride, pad), d, bias, act,
                             scale, mean, inv, s_out)


def int8_epilogue_ref(
    acc: torch.Tensor,
    d: torch.Tensor,
    bias: torch.Tensor,
    act: Activation = Activation.NONE,
    scale: Optional[torch.Tensor] = None,
    mean: Optional[torch.Tensor] = None,
    inv: Optional[torch.Tensor] = None,
    s_out: Optional[float] = None,
) -> torch.Tensor:
    """The epilogue of K4 and K5 on an int32 sum (N, O, H, W), each step
    a separate torch op: the dequant, BN or bias, the activation, the
    requantize."""
    act = Activation(act)
    y = acc.to(torch.float32) * _vec(d)
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


def out_format(s_out):
    """K4's and K5's output layout: int8 channels-last, fp32 NCHW."""
    return torch.contiguous_format if s_out is None else torch.channels_last


def check_epilogue(what: str, act, scale, mean, inv) -> Activation:
    """The epilogue arguments both kernels take: a fused activation, and
    BN as mean, inv and scale together."""
    act = Activation(act)
    if mean is not None and (inv is None or scale is None):
        raise ValueError(f"{what}: BN needs mean, inv and scale")
    if act not in FUSED_ACT:
        raise ValueError(f"{what}: activation {act!r} is not fused")
    return act


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
    """K4: `conv_int8_fused_ref` as one CUDA kernel for CUDA tensors,
    through the op `bcnn_tpu_torch::conv_int8` on either device. x int8
    (N,C,H,W) and w int8 (O,C,k,k), groups 1, on the card both
    channels-last in memory (x NHWC, w (O,k,k,C)); d, bias and the BN
    vectors fp32 (O,). Returns int8 channels-last when s_out is given,
    else fp32 NCHW-contiguous, on either device."""
    act = check_epilogue("conv_int8_fused", act, scale, mean, inv)
    library.check_devices("conv_int8_fused", x, w, d, bias, scale, mean,
                          inv)
    return _K4(x, w, d, bias, stride, pad, int(act), scale, mean, inv,
               None if s_out is None else float(s_out))


def _conv_int8_cpu(x, w, d, bias, stride, pad, act, scale=None,
                   mean=None, inv=None, s_out=None):
    return conv_int8_fused_ref(x, w, d, bias, stride, pad, act, scale, mean,
                               inv, s_out).contiguous(memory_format=out_format(
                                   s_out))


def conv_int8_cuda(x, w, d, bias, stride, pad, act, scale=None,
                   mean=None, inv=None, s_out=None):
    """The op's CUDA implementation, K4's launcher: checks what the
    kernel takes (raises otherwise), plans, allocates the output and a
    split's workspace, launches and checks the launch."""
    act = Activation(act)
    vecs = [v for v in (d, bias, scale, mean, inv) if v is not None]
    ts = [x, w, *vecs]
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
    cl = torch.channels_last
    if not (x.is_contiguous(memory_format=cl)
            and w.is_contiguous(memory_format=cl)
            and all(v.is_contiguous() for v in vecs)):
        raise ValueError(
            "conv_int8_fused: on the card x and w must be channels-last "
            "contiguous (x NHWC, w (O, k, k, C) in memory: "
            "channels_last_weight) and the vectors contiguous; got x "
            f"strides {x.stride()}, w strides {w.stride()}"
        )
    if stride < 1 or pad < 0:
        raise ValueError(f"conv_int8_fused: stride {stride}, pad {pad}")
    if s_out is not None and not s_out > 0:
        raise ValueError(f"conv_int8_fused: s_out {s_out}")
    n, c, h, wd = x.shape
    o, _, k, _ = w.shape
    oh, ow = out_size(h, wd, k, stride, pad)
    out = torch.empty(
        (n, o, oh, ow),
        dtype=torch.float32 if s_out is None else torch.int8,
        device=x.device, memory_format=out_format(s_out),
    )
    if out.numel():
        with span("bcnn.build.k4_plan"):
            plan = plan_conv_int8(n, c, h, wd, o, k, stride, pad,
                                  kernels.sm_count(x.device))
        ws = counters = None
        if plan.splits > 1:
            ws = torch.empty(plan.workspace_ints, dtype=torch.int32,
                             device=x.device)
            counters = torch.empty(plan.tiles_m * plan.tiles_n,
                                   dtype=torch.int32, device=x.device)
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
                plan.cfg, plan.splits, plan.split_steps, ptr(ws),
                ptr(counters),
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        kernels.check(rc, "conv_int8_fused")
    return out


def int8_conv_fake(x, w, stride, pad, s_out):
    """The output K4 or K5 writes for x (N, C, H, W) and w (O, ., k, k):
    its shape, dtype and layout, empty."""
    oh, ow = out_size(x.shape[2], x.shape[3], w.shape[2], stride, pad)
    return torch.empty(
        (x.shape[0], w.shape[0], oh, ow),
        dtype=torch.float32 if s_out is None else torch.int8,
        device=x.device, memory_format=out_format(s_out))


def int8_conv_flops(x_shape, w_shape, *args, out_shape=None, **kwargs):
    """Operations of K4 or K5 (a multiply and an add a tap), as
    `torch.utils.flop_counter` counts a convolution."""
    return 2 * _numel(out_shape) * w_shape[1] * w_shape[2] * w_shape[3]


def _numel(shape) -> int:
    n = 1
    for v in shape:
        n *= int(v)
    return n


_K4 = library.register(
    "conv_int8",
    "(Tensor x, Tensor w, Tensor d, Tensor bias, int stride, int pad, "
    "int act, Tensor? scale=None, Tensor? mean=None, Tensor? inv=None, "
    "float? s_out=None) -> Tensor",
    cpu=_conv_int8_cpu,
    cuda=conv_int8_cuda,
    fake=lambda x, w, d, bias, stride, pad, act, scale=None, mean=None,
    inv=None, s_out=None: int8_conv_fake(x, w, stride, pad, s_out),
    flops=int8_conv_flops,
)
