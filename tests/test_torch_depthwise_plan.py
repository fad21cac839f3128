"""K3's tile plan (`ops/depthwise.plan_tiles`) and the kernel's indexing,
on the CPU. The CUDA kernel (csrc/depthwise.cu) cannot run here, so
this file mirrors what it does with each plan: the checks its C entry
point makes, the contiguous range each tile stages (rounded down to a
16-byte boundary), each thread's walk over a tile's outputs, and the
sum of each output from the staged floats with the row and column
predicates, in the kernel's order (taps row by row, each a fused
multiply-add, emulated exactly in float64, then the bias). The
emulation must equal the plain version within 1e-5 of the largest
output (the plain version sums in another order). A halo or an
alignment fault shows up here before the card. Imports no JAX."""

import numpy as np
import pytest
import torch

from bcnn_tpu_torch.ops import depthwise as dw
from bcnn_tpu_torch.ops.activations import apply_activation
from bcnn_tpu_torch.ops.depthwise import depthwise_fused_ref, plan_tiles
from bcnn_tpu_torch.types import Activation

torch.set_num_threads(1)

# the nine depthwise layers of MobileNet-v1 at batch 64, 224 px: k 3,
# pad 1, (n, c, h, w, stride)
MOBILENET = [
    (64, 32, 112, 112, 1), (64, 64, 112, 112, 2), (64, 128, 56, 56, 1),
    (64, 128, 56, 56, 2), (64, 256, 28, 28, 1), (64, 256, 28, 28, 2),
    (64, 512, 14, 14, 1), (64, 512, 14, 14, 2), (64, 1024, 7, 7, 1),
]
# (n, c, h, w, k, stride, pad)
RAGGED = [
    (3, 5, 15, 7, 3, 1, 1),      # W = 7, plane starts off 16-byte bounds
    (2, 6, 15, 13, 3, 1, 1),     # W = 13
    (1, 3, 40, 300, 3, 2, 1),    # W = 300: bands of a wide plane
    (5, 7, 7, 7, 3, 1, 1),       # 35 planes: N*C not a multiple of g
    (2, 6, 15, 13, 5, 3, 0),     # k 5, stride 3, pad 0
    (2, 4, 17, 11, 7, 2, 3),     # k 7, stride 2
    (1, 2, 23, 19, 7, 3, 2),     # k 7, stride 3
    (2, 3, 16, 16, 3, 2, 0),     # pad 0 at stride 2
    (1, 2, 200, 40, 3, 1, 1),    # bands: the last one's halo ends the plane
    (1, 1, 9, 5, 3, 1, 4),       # pad > k: bands of padding only
]


def dims(n, c, h, w, k, stride, pad):
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    return dict(planes=n * c, chans=c, h=h, w=w, oh=oh, ow=ow, k=k,
                stride=stride, pad=pad)


def c_side_accepts(p, d):
    """The checks of bcnn_depthwise (csrc/depthwise.cu) on a plan."""
    fast = d["k"] == 3 and d["stride"] in (1, 2)
    band_rows = (p.th - 1) * d["stride"] + d["k"]
    max_len = (p.g * d["h"] * d["w"] if p.tiles_h == 1
               else min(band_rows, d["h"]) * d["w"])
    return (
        (p.rows == 7 and fast or p.rows == 1) and p.g >= 1
        and 1 <= p.th <= d["oh"] and p.tiles_h == -(-d["oh"] // p.th)
        and (p.g == 1 or p.tiles_h == 1)
        and p.tiles == -(-d["planes"] // p.g) * p.tiles_h
        and p.strips == -(-p.th // p.rows) and 2 <= p.stages <= 4
        and p.stage_floats % 4 == 0 and 1 <= p.grid <= p.tiles
        and p.stage_floats >= (max_len + 6) // 4 * 4
        and p.smem_bytes <= dw.SMEM_BLOCK
    )


def span_of(p, d, t):
    """csrc/depthwise.cu span_of: (p0, g_n, oy0, th_n, lo, hi, start,
    len) of tile t."""
    band, p0 = t % p.tiles_h, (t // p.tiles_h) * p.g
    g_n = min(p.g, d["planes"] - p0)
    oy0 = band * p.th
    th_n = min(p.th, d["oh"] - oy0)
    h, s, pad, k = d["h"], d["stride"], d["pad"], d["k"]
    if p.tiles_h == 1:
        lo, hi = 0, h
    else:
        lo = min(max(oy0 * s - pad, 0), h)
        hi = min(max((oy0 + th_n - 1) * s - pad + k, lo), h)
    start = (p0 * h + lo) * d["w"]
    return p0, g_n, oy0, th_n, lo, hi, start, ((g_n - 1) * h + hi - lo) * d[
        "w"]


def stage(p, d, xf, t, base):
    """Tile t's stage, copied as stage_tile does for x lying `base`
    floats past a 16-byte boundary; returns (buf, head). Asserts that
    every 16-byte copy stays inside x, that 4-byte copies happen only at
    x's ends, and that the stage fits its buffer."""
    _, _, _, _, _, _, start, length = span_of(p, d, t)
    xn = xf.numel()
    head = (base + start) % 4
    chunks = (head + length + 3) // 4
    assert 4 * chunks <= p.stage_floats
    buf = torch.full((p.stage_floats,), float("nan"), dtype=torch.float64)
    for j in range(chunks):
        a = start - head + 4 * j  # index in x of the chunk's first float
        if 0 <= a and a + 4 <= xn:
            buf[4 * j:4 * j + 4] = xf[a:a + 4]
        else:
            assert a < 0 or a + 4 > xn
            assert j == 0 or j == chunks - 1
            for e in range(4):
                buf[4 * j + e] = xf[a + e] if 0 <= a + e < xn else 0.0
    return buf, head


def walk(p, d, p0, g_n):
    """Every thread's items (gi, strip, ox, channel) of a tile, by the
    kernel's counters."""
    ow, per_plane, chans = d["ow"], p.strips * d["ow"], d["chans"]
    T = dw.THREADS
    step = (T % ow, T // ow % p.strips, T // per_plane)
    out = []
    for tid in range(T):
        gi, strip, ox = tid // per_plane, tid % per_plane // ow, tid % ow
        c = (p0 + gi) % chans
        while gi < g_n:
            out.append((gi, strip, ox, c))
            ox, strip, gi = ox + step[0], strip + step[1], gi + step[2]
            c += step[2] % chans
            if ox >= ow:
                ox, strip = ox - ow, strip + 1
            if strip >= p.strips:
                strip, gi, c = strip - p.strips, gi + 1, c + 1
            if c >= chans:
                c -= chans
    return out


def fma32(a, b, c):
    """fmaf: one rounding of a * b + c to float32 (a * b is exact in
    float64)."""
    return (a * b + c).float().double()


def emulate(x, wt, b, stride, pad, act, p, base=0):
    """The kernel's output for plan p, built tile by tile from the staged
    floats alone; asserts each output is written once."""
    n, c, h, w = x.shape
    k = wt.shape[2]
    d = dims(n, c, h, w, k, stride, pad)
    xf = x.reshape(-1).double()
    wf = wt.reshape(c, k, k).double()
    y = torch.zeros(d["planes"], d["oh"], d["ow"], dtype=torch.float64)
    written = torch.zeros(y.shape, dtype=torch.int32)
    R = p.rows
    for t in range(p.tiles):
        p0, g_n, oy0, th_n, lo, hi, _, _ = span_of(p, d, t)
        buf, head = stage(p, d, xf, t, base)
        items = walk(p, d, p0, g_n)
        assert len(items) == len(set(items)) == g_n * p.strips * d["ow"]
        gi, strip, ox, ch = (torch.tensor(v) for v in zip(*items))
        assert torch.equal(ch, (p0 + gi) % c)
        acc = torch.zeros(len(items), R, dtype=torch.float64)
        for ti in range(R):
            iy0 = (oy0 + strip * R + ti) * stride - pad
            for r in range(k):
                iy = iy0 + r
                row_ok = (iy >= lo) & (iy < hi)
                for q in range(k):
                    ix = ox * stride - pad + q
                    ok = row_ok & (ix >= 0) & (ix < w)
                    off = head + (gi * h + iy - lo) * w + ix
                    assert bool(((off >= 0) & (off < p.stage_floats))[ok]
                                .all())
                    v = torch.where(ok, buf[torch.where(ok, off, 0)], 0.0)
                    acc[:, ti] = fma32(v, wf[ch, r, q], acc[:, ti])
        for ti in range(R):
            oy = oy0 + strip * R + ti
            keep = oy < oy0 + th_n
            out = (acc[:, ti] + b.double()[ch]).float().double()
            y[(p0 + gi)[keep], oy[keep], ox[keep]] = out[keep]
            written[(p0 + gi)[keep], oy[keep], ox[keep]] += 1
    assert bool((written == 1).all())
    y = y.float().reshape(n, c, d["oh"], d["ow"])
    return apply_activation(y, act)


@pytest.mark.parametrize(
    "n,c,h,w,k,stride,pad",
    [(n, c, h, w, 3, s, 1) for n, c, h, w, s in MOBILENET] + RAGGED,
)
def test_plan_covers_every_output_once_in_shared_memory(n, c, h, w, k,
                                                        stride, pad):
    p = plan_tiles(n, c, h, w, k, stride, pad)
    d = dims(n, c, h, w, k, stride, pad)
    assert c_side_accepts(p, d)
    covered = np.zeros((d["planes"], d["oh"]), np.int32)
    xn = d["planes"] * h * w
    for t in range(p.tiles):
        p0, g_n, oy0, th_n, lo, hi, start, length = span_of(p, d, t)
        assert th_n >= 1 and g_n >= 1
        covered[p0:p0 + g_n, oy0:oy0 + th_n] += 1
        # the input rows every output of the tile reads lie in [lo, hi)
        need_lo = max(0, oy0 * stride - pad)
        need_hi = min(h, (oy0 + th_n - 1) * stride - pad + k)
        assert need_hi <= need_lo or lo <= need_lo and need_hi <= hi
        # rounded down to 16 bytes, the range starts and ends inside x
        # (x itself starts on a 16-byte boundary)
        assert 0 <= start - start % 4 and start + length <= xn
        assert (start % 4 + length + 3) // 4 * 4 <= p.stage_floats
    assert (covered == 1).all()
    assert p.smem_bytes <= dw.SMEM_BLOCK
    if p.grid == dw.BLOCKS_PER_SM * 132:  # persistent: blocks resident
        assert (p.smem_bytes + 1024) * dw.BLOCKS_PER_SM <= dw.SMEM_SM


def inputs(n, c, h, w, k, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, c, h, w, generator=gen)
    wt = torch.randn(c, 1, k, k, generator=gen) * (2 / k**2) ** 0.5
    b = torch.rand(c, generator=gen) - 0.5
    return x, wt, b


@pytest.mark.parametrize(
    "n,c,h,w,k,stride,pad,act,sms,base",
    [
        # MobileNet's shapes at batch 1 and few channels
        (1, 3, 112, 112, 3, 1, 1, Activation.RELU, 132, 0),
        (1, 2, 112, 112, 3, 2, 1, Activation.RELU, 132, 0),
        (1, 3, 56, 56, 3, 1, 1, Activation.RELU, 132, 0),
        (1, 9, 28, 28, 3, 2, 1, Activation.RELU, 132, 0),
        (2, 30, 14, 14, 3, 1, 1, Activation.RELU, 132, 0),
        (1, 100, 7, 7, 3, 1, 1, Activation.RELU, 132, 0),
        # ragged, x off a 16-byte boundary, few blocks for many tiles
        (3, 5, 15, 7, 3, 1, 1, Activation.LRELU, 1, 1),
        (1, 3, 40, 300, 3, 2, 1, Activation.CLAMP, 2, 2),
        (2, 6, 15, 13, 5, 3, 0, Activation.NONE, 132, 3),
        (2, 4, 17, 11, 7, 2, 3, Activation.CLAMP, 132, 0),
        (1, 2, 23, 19, 7, 3, 2, Activation.LRELU, 132, 1),
        (2, 3, 16, 16, 3, 2, 0, Activation.RELU, 132, 2),
        (1, 2, 200, 40, 3, 1, 1, Activation.NONE, 3, 0),
        (1, 1, 9, 5, 3, 1, 4, Activation.LRELU, 132, 0),
    ],
)
def test_kernel_indexing_matches_plain_version(n, c, h, w, k, stride, pad,
                                               act, sms, base):
    x, wt, b = inputs(n, c, h, w, k, n * c + h + w + k)
    p = plan_tiles(n, c, h, w, k, stride, pad, sms)
    got = emulate(x, wt, b, stride, pad, act, p, base)
    want = depthwise_fused_ref(x, wt, b, stride, pad, act)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_plan_grid_is_persistent_and_refuses_planes_too_wide():
    p = plan_tiles(64, 32, 112, 112, 3, 1, 1, 132)
    assert p.tiles > p.grid == 132 * dw.BLOCKS_PER_SM
    assert p.stages == dw.STAGES and p.smem_bytes > 48 * 1024
    assert plan_tiles(1, 1, 5, 5, 3, 1, 1, 132).grid == 1
    # a plane wider than a stage of STAGE_FLOATS: one-row bands, a ring
    # of 2 larger stages
    p = plan_tiles(1, 1, 5, 8000, 3, 1, 1)
    assert (p.th, p.stages) == (1, 2)
    assert c_side_accepts(p, dims(1, 1, 5, 8000, 3, 1, 1))
    with pytest.raises(ValueError):
        plan_tiles(1, 1, 5, 100_000, 3, 1, 1)
    with pytest.raises(ValueError):
        plan_tiles(1, 1, 2, 2, 5, 1, 0)
