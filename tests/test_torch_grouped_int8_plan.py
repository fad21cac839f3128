"""K5's plan and indexing (`csrc/grouped_int8.cu`, `ops/grouped_int8.py`)
emulated on the CPU, bit-equal to its plain version.

The emulation walks the kernel's grid as the kernel does: each block
stages its columns of the weight from K5's (k, k, C/G, O) memory into
its shared-memory rows of 4 * quads bytes (zeros past O), each thread
takes its quad of output channels and walks its pixels `rows` apart,
reads x from NHWC memory at the input channel of each output channel's
group, skips the taps outside the image, and writes each output at the
kernel's index: int8 channels-last (m * O + o), fp32 NCHW ((n * O + o) *
plane + pixel). Every output must be written exactly once; the sums then
go through `int8_epilogue_ref` (the kernel's epilogue is
`int8_epilogue.cuh`, held to it on the card by tests/test_torch_cuda.py
and chip_smoke.py). Shapes: MobileNet-v1's depthwise layers at batch 1
and small planes, ragged C % 4 != 0 and O % 4 != 0, stride 2, grouped
convs with and without BN, every fused activation, and a group too deep
for the weights to be staged."""

import numpy as np
import pytest
import torch

from bcnn_tpu_torch.ops.conv_int8 import int8_epilogue_ref, out_size
from bcnn_tpu_torch.ops.grouped_int8 import (
    MAX_QUADS, SMEM_STAGED, THREADS, grouped_int8_fused,
    grouped_int8_fused_ref, grouped_weight, is_grouped_weight,
    plan_grouped_int8)
from bcnn_tpu_torch.types import Activation

torch.set_num_threads(1)

A = Activation
# (n, c, h, w, o, k, stride, pad, groups, act, bn)
CASES = [
    (1, 32, 12, 12, 32, 3, 1, 1, 32, A.RELU, False),     # MobileNet dw1
    (1, 64, 12, 12, 64, 3, 2, 1, 64, A.RELU, False),     # dw2, stride 2
    (2, 6, 7, 9, 6, 3, 1, 1, 6, A.LRELU, False),         # C % 4 != 0
    (2, 5, 9, 7, 5, 5, 2, 0, 5, A.NONE, False),          # k 5, ragged
    (1, 8, 9, 9, 12, 3, 1, 1, 4, A.LRELU, True),         # 4 groups, BN
    (2, 8, 6, 6, 8, 1, 1, 0, 2, A.RELU, True),           # 1x1, 2 groups
    (1, 9, 7, 7, 6, 3, 2, 1, 3, A.NONE, False),          # O % 4 != 0
    (1, 16, 5, 5, 32, 3, 1, 1, 16, A.LRELU, False),      # multiplier 2
    (1, 1400, 3, 3, 4, 3, 1, 1, 1, A.RELU, False),       # unstaged
]


def emulate(x, w, stride, pad, groups, plan):
    """The int32 sums K5 computes, placed where it writes them, and how
    often each output was written (int8 index m * O + o)."""
    n, c, h, wd = x.shape
    o, cg, k, _ = w.shape
    og = o // groups
    oh, ow = out_size(h, wd, k, stride, pad)
    plane, m_all = oh * ow, n * oh * ow
    xm = x.permute(0, 2, 3, 1).contiguous().reshape(-1).long().numpy()
    # K5's (k, k, cg, O) memory: row (tap * cg + j), column o
    wm = w.permute(2, 3, 1, 0).contiguous().reshape(-1).long().numpy()
    taps = k * k * cg
    span = 4 * plan.quads
    acc = np.zeros(m_all * o, np.int64)
    writes = np.zeros(m_all * o, np.int64)
    # every (bx, tp, it) pixel of the grid
    bx, tp, it = np.meshgrid(np.arange(plan.tiles_m), np.arange(plan.rows),
                             np.arange(plan.pix), indexing="ij")
    m = (bx * plan.rows * plan.pix + it * plan.rows + tp).ravel()
    m = m[m < m_all]
    ni, rem = m // plane, m % plane
    oy, ox = rem // ow, rem % ow
    for by in range(plan.tiles_q):
        o_blk = by * span
        i = np.arange(taps * span)
        row, col = i // span, i % span
        oo = o_blk + col
        sw = np.where(oo < o, wm[row * o + np.minimum(oo, o - 1)], 0)
        if not plan.staged:  # read from memory: the same values
            assert (sw[oo < o] == wm[row * o + oo][oo < o]).all()
        for tq in range(plan.quads):
            oq = o_blk + 4 * tq
            if oq >= o:
                continue
            for e in range(4):
                oc = oq + e
                if oc >= o:
                    continue
                cb = (oc // og) * cg
                a = np.zeros(m.size, np.int64)
                for r in range(k):
                    iy = oy * stride - pad + r
                    for s in range(k):
                        ix = ox * stride - pad + s
                        ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
                        base = ((ni * h + iy) * wd + ix) * c
                        tap = r * k + s
                        rows_j = tap * cg + np.arange(cg)
                        wv = sw[rows_j * span + 4 * tq + e]
                        xv = xm[np.where(ok, base, 0)[:, None] + cb
                                + np.arange(cg)[None, :]]
                        a += np.where(ok, (xv * wv[None, :]).sum(1), 0)
                acc[m * o + oc] = a
                writes[m * o + oc] += 1
    return acc, writes, (ni, rem)


def cases():
    return [pytest.param(*cs, id="-".join(map(str, cs[:9])) + f"-{cs[9].name}"
                         + ("-bn" if cs[10] else "")) for cs in CASES]


@pytest.mark.parametrize("n,c,h,w,o,k,stride,pad,groups,act,bn", cases())
def test_emulated_kernel_equals_plain_version(n, c, h, w, o, k, stride, pad,
                                              groups, act, bn):
    rng = np.random.RandomState(c + o + k)
    x = torch.from_numpy(rng.randint(-127, 128, (n, c, h, w)).astype(
        np.int8)).contiguous(memory_format=torch.channels_last)
    wt = grouped_weight(torch.from_numpy(rng.randint(
        -127, 128, (o, c // groups, k, k)).astype(np.int8)))
    vec = lambda lo, hi: torch.from_numpy(  # noqa: E731
        rng.uniform(lo, hi, o).astype(np.float32))
    d, bias = vec(1e-4, 3e-4), vec(-0.2, 0.2)
    kw = {}
    if bn:
        var = vec(0.5, 1.5)
        kw = dict(scale=vec(0.8, 1.2), mean=vec(-0.1, 0.1),
                  inv=torch.ones_like(var) / torch.sqrt(var + 1e-5))
    plan = plan_grouped_int8(n, c, h, w, o, k, stride, pad, groups)
    acc, writes, (ni, rem) = emulate(x, wt, stride, pad, groups, plan)
    assert (writes == 1).all()  # every output once
    oh, ow = out_size(h, w, k, stride, pad)
    acc_t = torch.from_numpy(acc.reshape(n, oh, ow, o)).permute(
        0, 3, 1, 2).to(torch.int32)
    for s_out in (None, 0.05):
        want = grouped_int8_fused_ref(x, wt, d, bias, stride, pad, groups,
                                      act, s_out=s_out, **kw)
        got = int8_epilogue_ref(acc_t, d, bias, act, s_out=s_out, **kw)
        assert torch.equal(got, want)
        # the wrapper's CPU path: the same values, the kernel's layouts
        out = grouped_int8_fused(x, wt, d, bias, stride, pad, groups, act,
                                 s_out=s_out, **kw)
        assert torch.equal(out, want)
        fmt = torch.contiguous_format if s_out is None else \
            torch.channels_last
        assert out.is_contiguous(memory_format=fmt)
    # the fp32 output's NCHW index of each pixel the grid walked
    nchw = (ni * o) * (oh * ow) + rem
    assert len(set(nchw.tolist())) == n * oh * ow


@pytest.mark.parametrize("n,c,h,w,o,k,stride,pad,groups,act,bn", cases())
def test_plan_is_one_the_kernel_takes(n, c, h, w, o, k, stride, pad, groups,
                                      act, bn):
    plan = plan_grouped_int8(n, c, h, w, o, k, stride, pad, groups)
    q = plan.quads
    assert 1 <= q <= MAX_QUADS and q & (q - 1) == 0
    assert plan.threads <= THREADS and plan.pix >= 1
    oh, ow = out_size(h, w, k, stride, pad)
    assert plan.tiles_m * plan.rows * plan.pix >= n * oh * ow
    assert (plan.tiles_m - 1) * plan.rows * plan.pix < n * oh * ow
    assert plan.tiles_q * 4 * q >= o > (plan.tiles_q - 1) * 4 * q
    taps = k * k * (c // groups)
    assert plan.staged == (taps * 4 * q <= SMEM_STAGED)
    assert plan.vec == (c == groups == o and c % 4 == 0)
    # fewer pixels a thread only where twice as many left the grid under
    # two blocks an SM
    m = n * oh * ow
    if plan.pix < 8:
        twice = -(-m // (plan.rows * plan.pix * 2))
        assert twice * plan.tiles_q < 2 * 132


def test_mobilenet_shapes_are_staged_and_vectorized():
    """MobileNet-v1's nine depthwise shapes at batch 64, 224 px: char4
    loads, weights staged, 256 threads, enough blocks for 132 SMs."""
    shapes = [(32, 112, 1), (64, 112, 2), (128, 56, 1), (128, 56, 2),
              (256, 28, 1), (256, 28, 2), (512, 14, 1), (512, 14, 2),
              (1024, 7, 1)]
    for c, hw, stride in shapes:
        plan = plan_grouped_int8(64, c, hw, hw, c, 3, stride, 1, c)
        assert plan.vec and plan.staged and plan.threads == THREADS
        assert plan.quads == min(MAX_QUADS, c // 4)
        assert plan.blocks >= 2 * 132


def test_weight_layout():
    w = torch.arange(2 * 3 * 3 * 3, dtype=torch.int8).reshape(2, 3, 3, 3)
    g = grouped_weight(w)
    assert torch.equal(g, w) and is_grouped_weight(g)
    assert not is_grouped_weight(w)
    assert grouped_weight(g) is g
    # (k, k, C/G, O) memory: O fastest
    assert g.stride() == (1, 2, 3 * 3 * 2, 3 * 2)


def test_wrapper_refuses_bad_arguments():
    x = torch.zeros(1, 4, 5, 5, dtype=torch.int8)
    w = torch.zeros(4, 1, 3, 3, dtype=torch.int8)
    v = torch.zeros(4)
    with pytest.raises(ValueError, match="not fused"):
        grouped_int8_fused(x, w, v, v, 1, 1, 4, A.LOGISTIC)
    with pytest.raises(ValueError, match="BN needs"):
        grouped_int8_fused(x, w, v, v, 1, 1, 4, A.RELU, mean=v)
    with pytest.raises(ValueError, match="no output"):
        plan_grouped_int8(1, 4, 5, 5, 4, 3, 1, 1, 3)
