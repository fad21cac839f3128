"""Depthwise conv + bias + activation in one pass: the CUDA kernel K3
(`csrc/depthwise.cu`) and its plain PyTorch version.

`depthwise_fused` replaces the Pallas TPU kernel
`bcnn_tpu.ops.dw_pallas.depthwise_fused`, on NCHW tensors with (C, 1, k,
k) weights. Unlike the JAX package, which keeps that kernel out of its
executor, the port runs every depthwise layer through it on the card.
`depthwise_fused_ref` is its plain version: `ops.conv.depthwise_conv2d`
(the grouped conv), then + b, then `apply_activation`, as
`bcnn_tpu.compile._depthwise_conv2d` computes the layer.

The wrapper calls the op `bcnn_tpu_torch::depthwise` (`ops.library`):
its CPU implementation is the plain version (and its gradient there the
plain version's); its CUDA implementation, `depthwise_cuda`, launches
the kernel or raises; nothing falls back. The kernel takes fp32 only.
An activation the kernel does not fuse (TANH, SOFTPLUS, ...) runs the op
with NONE and then `apply_activation`. The kernel has no backward yet,
so on the card the wrapper refuses tensors that autograd records.
`library.launches("depthwise")` counts the kernel's launches.

`plan_tiles` chooses the kernel's tiles here, where the CPU tests reach
it: g whole planes, or a band of output rows of one plane, a tile; the
ring depth, the stage size and the persistent grid. The kernel checks
the plan and refuses one that does not cover every output once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import kernels
from ..types import Activation
from . import library
from .activations import apply_activation
from .conv import depthwise_conv2d

# the kernel's activation codes (csrc/depthwise.cu)
_FUSED = {
    Activation.NONE: 0,
    Activation.RELU: 1,
    Activation.LRELU: 2,
    Activation.CLAMP: 3,
}


# The ring, the stage budget and the two costs were set by timing every
# candidate plan at MobileNet-v1's shapes on an H100 (PERF.md): a ring
# of 2 stages of up to 26 KB came out ahead of deeper rings of smaller
# stages, and the model then picks a plan within 5% of the fastest.
THREADS = 256         # threads a block (csrc/depthwise.cu kThreads)
ROWS = 7              # outputs a thread at k 3, stride 1 or 2 (kRows)
BLOCKS_PER_SM = 3     # resident blocks an SM (kBlocksPerSm)
STAGES = 2            # staged tiles in a block's ring
STAGE_FLOATS = 6656   # floats a staged tile may take (26 KB)
SMEM_SM = 233472      # shared memory of an SM, bytes (228 KB)
SMEM_BLOCK = 232448   # shared memory a block may take, bytes (227 KB)
TILE_COST = 1024      # a tile's fixed cost, in floats moved
PASS_COST = 1536      # a block's pass over its threads' outputs, in floats


class TilePlan(NamedTuple):
    """The tiles of one K3 launch (see csrc/depthwise.cu)."""

    g: int             # planes a tile (1 for a band)
    th: int            # output rows a tile
    tiles_h: int       # bands a plane (1: whole planes)
    tiles: int         # tiles in all
    rows: int          # outputs a thread computes, down a column
    strips: int        # strips of `rows` outputs a band
    stages: int        # staged tiles in a block's ring
    stage_floats: int  # floats of one staged tile, with 16-byte slack
    grid: int          # persistent blocks

    @property
    def smem_bytes(self) -> int:
        return 4 * self.stages * self.stage_floats


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan_tiles(n: int, c: int, h: int, w: int, k: int, stride: int,
               pad: int, sms: int = 132) -> TilePlan:
    """The tile plan for x (n, c, h, w), a k x k window, `stride`, `pad`,
    on a card of `sms` SMs.

    A tile's input is one contiguous range of x: g whole planes when a
    plane fits a stage, else the input rows of a band of output rows of
    one plane, with their halo. Among the tiles that fit STAGE_FLOATS,
    it takes the one with the least (rounds of the grid) x (a tile's
    time), a tile's time being the larger of its copies (floats read
    and written + TILE_COST) and its compute (PASS_COST for each pass of
    the block's threads over its outputs), which the ring overlaps. Only
    a plane too wide for any band of one strip at that size gets a
    larger stage, as large as shared memory allows."""
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    planes = n * c
    if oh < 1 or ow < 1 or planes < 1:
        raise ValueError(f"plan_tiles: no output for {(n, c, h, w)} k{k} "
                         f"s{stride} p{pad}")
    rows = ROWS if k == 3 and stride in (1, 2) else 1

    def floats(length):  # a stage for `length` floats from any 4-byte start
        return _cdiv(length + 3, 4) * 4

    for budget in (STAGE_FLOATS, SMEM_BLOCK // (4 * STAGES) // 4 * 4):
        cands = []  # (g, th, tiles_h, floats staged)
        for g in range(1, min(planes, budget // max(1, h * w)) + 1):
            if floats(g * h * w) <= budget:
                cands.append((g, oh, 1, g * h * w))
        ths = range(rows, oh, rows) if oh > rows else ()
        for th in list(ths) or range(1, oh):
            length = min(h, (th - 1) * stride + k) * w
            if floats(length) <= budget:
                cands.append((1, th, _cdiv(oh, th), length))
        if cands:
            break
    else:
        raise ValueError(f"plan_tiles: a {w}-wide plane with a {k} x {k} "
                         "window does not fit shared memory")

    def plan(g, th, tiles_h, length):
        stage = floats(length)
        fit = SMEM_SM // (4 * STAGES * stage + 1024)
        tiles = _cdiv(planes, g) * tiles_h
        grid = min(tiles, sms * max(1, min(BLOCKS_PER_SM, fit)))
        return TilePlan(g, th, tiles_h, tiles, rows, _cdiv(th, rows),
                        STAGES, stage, grid)

    def cost(cand):
        p = plan(*cand)
        g, th, _, length = cand
        passes = _cdiv(g * p.strips * ow, THREADS)
        tile = max(length + g * th * ow + TILE_COST, PASS_COST * passes)
        return _cdiv(p.tiles, p.grid) * tile, p.tiles

    return plan(*min(cands, key=cost))


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
    contiguous), through the op `bcnn_tpu_torch::depthwise` on either
    device; an activation the kernel does not fuse runs after the op."""
    act = Activation(act)
    library.check_devices("depthwise_fused", x, w, b)
    if (x.device.type == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, w, b))):
        raise NotImplementedError(
            "depthwise_fused: the CUDA kernel has no backward yet"
        )
    y = _K3(x, w, b, stride, pad, int(act) if act in _FUSED else 0)
    return y if act in _FUSED else apply_activation(y, act)


def _depthwise_cpu(x, w, b, stride, pad, act):
    return depthwise_fused_ref(x, w, b, stride, pad, act).contiguous()


def depthwise_cuda(x, w, b, stride, pad, act):
    """The op's CUDA implementation, K3's launcher (`act` a fused one):
    checks what the kernel takes (raises otherwise), plans, allocates
    the output, launches and checks the launch."""
    act = Activation(act)
    ts = (x, w, b)
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
    if act not in _FUSED:
        raise ValueError(f"depthwise_fused: activation {act!r} is not fused")
    n, c, h, wd = x.shape
    k = w.shape[2]
    y = torch.empty((n, c) + _out_hw(h, wd, k, stride, pad),
                    dtype=torch.float32, device=x.device)
    if y.numel():
        lib = kernels.library()
        plan = plan_tiles(n, c, h, wd, k, stride, pad,
                          kernels.sm_count(x.device))
        with torch.cuda.device(x.device):
            rc = lib.bcnn_depthwise(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), n, c,
                h, wd, k, stride, pad, _FUSED[act], *plan,
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        kernels.check(rc, "depthwise_fused")
    return y


def _out_hw(h, w, k, stride, pad):
    return (max(0, (h + 2 * pad - k) // stride + 1),
            max(0, (w + 2 * pad - k) // stride + 1))


def _depthwise_fake(x, w, b, stride, pad, act):
    return x.new_empty((x.shape[0], x.shape[1])
                       + _out_hw(x.shape[2], x.shape[3], w.shape[2], stride,
                                 pad))


def _depthwise_flops(x_shape, w_shape, *args, out_shape=None, **kwargs):
    """A multiply and an add a tap of each output, as
    `torch.utils.flop_counter` counts a convolution."""
    n, c, oh, ow = out_shape
    return 2 * n * c * oh * ow * w_shape[2] * w_shape[3]


def _setup_backward(ctx, inputs, output):
    x, w, b, stride, pad, act = inputs
    ctx.save_for_backward(x, w, b)
    ctx.conf = (stride, pad, act)


def _backward(ctx, gy):
    """The plain version's gradient, on the CPU; the kernel has none."""
    x, w, b = ctx.saved_tensors
    if gy.device.type != "cpu":
        raise NotImplementedError(
            "depthwise_fused: the CUDA kernel has no backward yet")
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip((x, w, b), ctx.needs_input_grad)]
        y = depthwise_fused_ref(*leaves, *ctx.conf)
        want = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(y, want, gy))
    return tuple(next(got) if t.requires_grad else None
                 for t in leaves) + (None, None, None)


_K3 = library.register(
    "depthwise",
    "(Tensor x, Tensor w, Tensor b, int stride, int pad, int act) -> Tensor",
    cpu=_depthwise_cpu,
    cuda=depthwise_cuda,
    fake=_depthwise_fake,
    flops=_depthwise_flops,
)
torch.library.register_autograd(
    f"{library.NAMESPACE}::depthwise", _backward,
    setup_context=_setup_backward, lib=library._LIB)
