"""K4 (`bcnn_tpu_torch/csrc/conv_int8.cu`) emulated on the CPU: its block
grid, the im2col gather of the x tile (a thread's output pixel, its 16 k
values stepped through (c, r, s), zero outside the image, past K and
past M), the w tile (8 bytes a thread, zero past K and O), the 48-byte
shared-memory rows, the mma.m16n8k32 fragments of each lane as the PTX
ISA lays them out, and the epilogue's map from accumulator to output and
its order of fp32 steps; bit-equal to `conv_int8_fused_ref`. Change it
with any change to the kernel's indexing."""

import numpy as np
import pytest
import torch

from bcnn_tpu_torch.ops.conv_int8 import (ROW_BYTES, THREADS, TILE_K, TILE_M,
                                          TILE_N, conv_int8_fused_ref)
from bcnn_tpu_torch.types import Activation

torch.set_num_threads(1)


def load_tiles(x, w, geo, m0, o0, step):
    """Shared-memory x and w tiles of one block at one k step, as the
    block's THREADS threads fill them."""
    n, c, h, wd, o, k, stride, pad, oh, ow = geo
    kdim, m_all = c * k * k, n * oh * ow
    tid = np.arange(THREADS)
    sa = np.zeros((TILE_M, ROW_BYTES), np.int64)
    a_row, a_half = tid % TILE_M, tid // TILE_M
    am = m0 + a_row
    ok = am < m_all
    img = am // (oh * ow)
    pq = am - img * oh * ow
    oy = pq // ow
    ih0, iw0 = oy * stride - pad, (pq - oy * ow) * stride - pad
    kk = step * TILE_K + a_half * 16
    ci = kk // (k * k)
    rem = kk - ci * k * k
    r = rem // k
    s = rem - r * k
    xf = x.reshape(-1)
    for j in range(16):  # 4 words of 4 bytes
        ih, iw = ih0 + r, iw0 + s
        valid = ok & (kk < kdim) & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < wd)
        idx = ((img * c + ci) * h + ih) * wd + iw
        sa[a_row, a_half * 16 + j] = np.where(
            valid, xf[np.where(valid, idx, 0)], 0)
        kk = kk + 1
        s = s + 1
        wrap = s == k
        s[wrap] = 0
        r[wrap] += 1
        wrap = r == k
        r[wrap] = 0
        ci[wrap] += 1
    sb = np.zeros((TILE_N, ROW_BYTES), np.int64)
    b_row, b_q = tid // 4, tid % 4
    bo = o0 + b_row
    wf = w.reshape(-1)
    for j in range(8):
        kb = step * TILE_K + b_q * 8 + j
        valid = (bo < o) & (kb < kdim)
        sb[b_row, b_q * 8 + j] = np.where(
            valid, wf[np.where(valid, bo * kdim + kb, 0)], 0)
    return sa, sb


def mma_m16n8k32(a, b0, b1):
    """D (32 lanes, 4) of one mma.m16n8k32 s8: a (32 lanes, 4 regs, 4
    bytes), b0/b1 (32 lanes, 4 bytes), in the PTX fragment layouts: A
    reg 0 row g, cols 4t..4t+3; reg 1 row g+8; regs 2, 3 the same +16
    cols; B reg 0 col g, rows 4t..; reg 1 rows +16; D c0/c1 row g, cols
    2t, 2t+1; c2/c3 row g+8."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for j in range(4):
        A[g, 4 * t + j] = a[:, 0, j]
        A[g + 8, 4 * t + j] = a[:, 1, j]
        A[g, 16 + 4 * t + j] = a[:, 2, j]
        A[g + 8, 16 + 4 * t + j] = a[:, 3, j]
        B[4 * t + j, g] = b0[:, j]
        B[16 + 4 * t + j, g] = b1[:, j]
    D = A @ B
    return np.stack([D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
                     D[g + 8, 2 * t + 1]], axis=1)


def emulate(x, w, d, bias, stride, pad, act, scale, mean, inv, s_out):
    x, w = x.numpy().astype(np.int64), w.numpy().astype(np.int64)
    n, c, h, wd = x.shape
    o, _, k, _ = w.shape
    oh, ow = (h + 2 * pad - k) // stride + 1, (wd + 2 * pad - k) // stride + 1
    geo = (n, c, h, wd, o, k, stride, pad, oh, ow)
    m_all, kdim = n * oh * ow, c * k * k
    steps = -(-kdim // TILE_K)
    f32 = np.float32
    vec = {kname: (None if v is None else v.numpy())
           for kname, v in (("d", d), ("bias", bias), ("scale", scale),
                            ("mean", mean), ("inv", inv))}
    out = np.full((n, o, oh, ow), np.nan if s_out is None else 99,
                  np.float32 if s_out is None else np.int64)
    flat = out.reshape(-1)
    written = np.zeros(flat.size, np.int64)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for bx in range(-(-m_all // TILE_M)):
        for by in range(-(-o // TILE_N)):
            m0, o0 = bx * TILE_M, by * TILE_N
            acc = np.zeros((8, 2, 4, 32, 4), np.int64)  # warp, mi, ni, lane
            for step in range(steps):
                sa, sb = load_tiles(x, w, geo, m0, o0, step)
                for warp in range(8):
                    wm, wn = warp % 4, warp // 4
                    for mi in range(2):
                        rows = wm * 32 + mi * 16 + g
                        a = np.stack([
                            sa[rows[:, None], 4 * t[:, None] + np.arange(4)],
                            sa[rows[:, None] + 8,
                               4 * t[:, None] + np.arange(4)],
                            sa[rows[:, None],
                               16 + 4 * t[:, None] + np.arange(4)],
                            sa[rows[:, None] + 8,
                               16 + 4 * t[:, None] + np.arange(4)],
                        ], axis=1)
                        for ni in range(4):
                            cols = wn * 32 + ni * 8 + g
                            b0 = sb[cols[:, None], 4 * t[:, None] + np.arange(4)]
                            b1 = sb[cols[:, None],
                                    16 + 4 * t[:, None] + np.arange(4)]
                            acc[warp, mi, ni] += mma_m16n8k32(a, b0, b1)
            for warp in range(8):
                wm, wn = warp % 4, warp // 4
                for mi in range(2):
                    for half in range(2):
                        m = m0 + wm * 32 + mi * 16 + g + 8 * half
                        img = m // (oh * ow)
                        base = img * o * oh * ow + (m - img * oh * ow)
                        for ni in range(4):
                            for j in range(2):
                                oc = o0 + wn * 32 + ni * 8 + t * 2 + j
                                keep = (m < m_all) & (oc < o)
                                oc_, base_ = oc[keep], base[keep]
                                a = acc[warp, mi, ni, keep, 2 * half + j]
                                y = f32(a.astype(np.float32)) * vec["d"][oc_]
                                if mean is not None:
                                    y = (y - vec["mean"][oc_]) * vec["inv"][oc_]
                                    y = y * vec["scale"][oc_] + vec["bias"][oc_]
                                elif scale is not None:
                                    y = y * vec["scale"][oc_] + vec["bias"][oc_]
                                else:
                                    y = y + vec["bias"][oc_]
                                if act == Activation.LRELU:
                                    y = np.where(y > 0, y, f32(0.1) * y)
                                elif act == Activation.RELU:
                                    y = np.where(y < 0, f32(0), y)
                                idx = base_ + oc_ * oh * ow
                                if s_out is not None:
                                    q = np.rint(y / f32(s_out))
                                    y = np.clip(q, -127, 127).astype(np.int64)
                                flat[idx] = y
                                np.add.at(written, idx, 1)
    assert (written == 1).all()  # every output once
    return out


CASES = [  # n, c, h, w, o, k, stride, pad, bn, act, int8 out
    (2, 3, 9, 9, 16, 3, 1, 1, "unfolded", "LRELU", True),  # K = 27
    (1, 8, 13, 13, 70, 3, 2, 1, "folded", "RELU", False),  # s2, O ragged
    (1, 16, 5, 7, 255, 1, 1, 0, None, "NONE", False),  # a head: O = 255
    (3, 5, 11, 6, 9, 3, 2, 0, None, "LRELU", True),  # pad 0, K = 45
    (1, 7, 6, 5, 12, 3, 1, 1, "unfolded", "NONE", True),  # K = 63, not 8k
    (2, 40, 4, 4, 33, 3, 1, 1, "unfolded", "LRELU", False),  # 12 k steps
    (2, 16, 8, 8, 64, 1, 1, 0, "folded", "LRELU", True),  # M = 128, one tile
]


@pytest.mark.parametrize("case", CASES)
def test_k4_emulation_is_bit_equal_to_the_plain_version(case):
    n, c, h, wd, o, k, stride, pad, bn, act, int8_out = case
    gen = torch.Generator().manual_seed(n * 1000 + c * 10 + o)
    x = torch.randint(-127, 128, (n, c, h, wd), generator=gen,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (o, c, k, k), generator=gen,
                      dtype=torch.int8)
    w[0] = 127  # a row of extremes
    x[0, 0] = -127
    d = torch.rand(o, generator=gen) * 1e-3 + 1e-4
    bias = torch.randn(o, generator=gen)
    scale = torch.rand(o, generator=gen) + 0.5 if bn else None
    mean = inv = None
    if bn == "unfolded":
        mean = torch.randn(o, generator=gen) * 0.2
        inv = torch.ones(o) / torch.sqrt(torch.rand(o, generator=gen) + 0.5)
    s_out = 0.173 if int8_out else None
    args = (x, w, d, bias, stride, pad, Activation[act], scale, mean, inv,
            s_out)
    want = conv_int8_fused_ref(*args).numpy()
    got = emulate(*args)
    if int8_out:
        assert want.dtype == np.int8 and np.abs(want).max() == 127
        np.testing.assert_array_equal(got, want.astype(np.int64))
    else:
        np.testing.assert_array_equal(got, want)


def test_tile_constants_fit_the_kernel():
    """8 warps of 32 x 32 cover the 128 x 64 tile; two stages of x and w
    rows fit 48 KB of static shared memory; a row's 16 bytes of padding
    keep the fragment reads of a warp on 32 banks."""
    assert THREADS == 8 * 32 and TILE_M == 4 * 32 and TILE_N == 2 * 32
    assert TILE_K == 32 and THREADS == TILE_M * 2 == TILE_N * 4
    assert 2 * (TILE_M + TILE_N) * ROW_BYTES <= 48 * 1024
    g, t = np.arange(32) // 4, np.arange(32) % 4
    banks = ((g * ROW_BYTES + 4 * t) // 4) % 32
    assert len(set(banks.tolist())) == 32
