"""K4 (`bcnn_tpu_torch/csrc/conv_int8.cu`) emulated on the CPU: the plan
(`plan_conv_int8`), the block grid with its split of K, the x tile's
16-byte copies from NHWC memory with their zero-fill (outside the image,
past K, past M) and the (r, s, c) k position stepped by 64 a stage, the
byte gather for a C that is not a multiple of 16 (the first conv's C =
3 has its own loader, a pixel's 27 bytes a thread) with its stepped
address, the w tile from the (O, k, k, C) repack,
the swizzled 64-byte stage rows, two m16n8k32 steps a stage, the
ldmatrix.x4 fragments of each lane and mma.m16n8k32 as the PTX
ISA lays them out, the split-K partials summed by the tile's last block
in a shuffled order, and the epilogue's staged stores (int8 NHWC
in 16-byte runs, fp32 NCHW columns), every output written once; bit-equal
to `conv_int8_fused_ref` on the NCHW tensors. Also the shared-memory
banks of every access and the plan at YOLOv3-tiny's 13 shapes. Change
it with any change to the kernel's indexing."""

import numpy as np
import pytest
import torch

from bcnn_tpu_torch.models import yolov3, yolov3_tiny
from bcnn_tpu_torch.ops.conv_int8 import (
    CONFIGS, SMEM_BLOCK, SPLIT_K, STAGE_K, STAGES, TILE_K, ConvPlan,
    channels_last_weight, conv_int8_fused, conv_int8_fused_ref,
    int8_stage_row, out_size, plan_conv_int8)
from bcnn_tpu_torch.types import Activation

torch.set_num_threads(1)

LANE = np.arange(32)
G, T4 = LANE // 4, LANE % 4
CHUNKS = STAGE_K // 16  # 16-byte chunks of a stage row


def swz(row, chunk):
    """Byte offset of 16-byte chunk `chunk` of stage row `row`."""
    return row * STAGE_K + ((chunk ^ ((row >> 1) & 3)) << 4)


def kpos(kk, c, k):
    tap = kk // c
    r = tap // k
    return r, tap - r * k, kk - tap * c


class Block:
    """One block of a launch: its threads' loader state, its ring."""

    def __init__(self, xf, wf, geo, plan, vec, bx, by, bz):
        self.xf, self.wf, self.geo, self.plan, self.vec = xf, wf, geo, plan, vec
        n, c, h, wd, o, k, stride, pad, oh, ow = geo
        bm, bn, threads = plan.bm, plan.bn, plan.threads
        self.m0, self.o0 = bx * bm, by * bn
        self.t_begin = bz * plan.split_steps
        self.t_count = min(plan.steps - self.t_begin, plan.split_steps)
        tid = np.arange(threads)
        self.chunk = tid % CHUNKS
        rows_a = CHUNKS * bm // threads
        self.rows = [tid // CHUNKS + i * (threads // CHUNKS)
                     for i in range(rows_a)]
        self.a = []
        for rows in self.rows:
            am = self.m0 + rows
            ok = am < n * oh * ow
            img = am // (oh * ow)
            pq = am - img * oh * ow
            oy = pq // ow
            ih = np.where(ok, oy * stride - pad, -(1 << 30))
            iw = np.where(ok, (pq - oy * ow) * stride - pad, 0)
            base = np.where(ok, ((img * h + ih) * wd + iw) * c, 0)
            self.a.append((ih, iw, base))
        self.kp = list(kpos(self.t_begin * STAGE_K + 16 * self.chunk, c, k))
        self.smem = np.zeros(STAGES * (bm + bn) * STAGE_K, np.int64)
        self.writes = []  # (thread ids, byte offsets) of each 16-byte store

    def issue(self, t, slot):
        n, c, h, wd, o, k, stride, pad, oh, ow = self.geo
        bm, bn, threads = self.plan.bm, self.plan.bn, self.plan.threads
        sa = slot * (bm + bn) * STAGE_K
        sb = sa + bm * STAGE_K
        tid = np.arange(threads)
        kdim = c * k * k
        j16 = np.arange(16)
        if self.vec:  # rows tid / 4 + i * threads / 4, chunk tid % 4
            r, s, ci = self.kp
            for rows, (ih, iw, base) in zip(self.rows, self.a):
                dst = sa + swz(rows, self.chunk)
                ok = ((r < k) & (ih + r >= 0) & (ih + r < h) & (iw + s >= 0)
                      & (iw + s < wd))
                src = base + (r * wd + s) * c + ci
                self.smem[dst[:, None] + j16] = np.where(
                    ok[:, None], self.xf[np.where(ok, src, 0)[:, None] + j16],
                    0)
                self.writes.append((tid, dst))
        elif c == 3 and k == 3:  # a thread a pixel: 27 bytes, then zeros
            rows = tid[tid < bm]
            am = self.m0 + rows
            okm = am < n * oh * ow
            img = am // (oh * ow)
            pq = am - img * oh * ow
            oy = pq // ow
            ih, iw = oy * stride - pad, (pq - oy * ow) * stride - pad
            px = ((img * h + ih) * wd + iw) * 3
            vals = np.zeros((len(rows), 4 * 16), np.int64)
            for r in range(3):
                for sx in range(3):
                    ok = (okm & (ih + r >= 0) & (ih + r < h) & (iw + sx >= 0)
                          & (iw + sx < wd))
                    for ci in range(3):
                        src = px + r * wd * 3 + sx * 3 + ci
                        vals[:, (r * 3 + sx) * 3 + ci] = np.where(
                            ok, self.xf[np.where(ok, src, 0)], 0)
            for chunk in range(CHUNKS):
                dst = sa + swz(rows, chunk)
                self.smem[dst[:, None] + j16] = vals[:, 16 * chunk:
                                                     16 * chunk + 16]
                self.writes.append((rows, dst))
        else:  # row tid % bm, chunks tid / bm + i * threads / bm
            rows = tid % bm
            am = self.m0 + rows
            okm = am < n * oh * ow
            img = am // (oh * ow)
            pq = am - img * oh * ow
            oy = pq // ow
            ih = np.where(okm, oy * stride - pad, -(1 << 30))
            iw = np.where(okm, (pq - oy * ow) * stride - pad, 0)
            base = np.where(okm, ((img * h + ih) * wd + iw) * c, 0)
            for cq in range(0, CHUNKS, threads // bm):
                chunk = tid // bm + cq
                k0 = t * STAGE_K + 16 * chunk
                vals = np.zeros((threads, 16), np.int64)
                # the address steps along k, and by (W - k) C at r
                r, s, ci = kpos(k0, c, k)
                off = base + (r * wd + s) * c + ci
                for j in range(16):
                    ok = ((k0 + j < kdim) & (ih + r >= 0) & (ih + r < h)
                          & (iw + s >= 0) & (iw + s < wd))
                    vals[:, j] = np.where(ok, self.xf[np.where(ok, off, 0)],
                                          0)
                    off = off + 1
                    ci = ci + 1
                    wrap = ci == c
                    ci = np.where(wrap, 0, ci)
                    s = s + wrap
                    wrap = s == k
                    s = np.where(wrap, 0, s)
                    r = r + wrap
                    off = off + wrap * (wd - k) * c
                dst = sa + swz(rows, chunk)
                self.smem[dst[:, None] + j16] = vals
                self.writes.append((tid, dst))
        if self.vec:  # the chunk's k position, 64 further
            r, s, ci = self.kp
            ci = ci + STAGE_K
            while (ci >= c).any():
                wrap = ci >= c
                ci = np.where(wrap, ci - c, ci)
                s = s + wrap
                wrap2 = s == k
                s = np.where(wrap2, 0, s)
                r = r + wrap2
            self.kp = [r, s, ci]
        q = np.arange(CHUNKS * bn)
        oc = self.o0 + q // CHUNKS
        kk = t * STAGE_K + 16 * (q % CHUNKS)
        idx = oc[:, None] * kdim + kk[:, None] + j16
        ok = (oc[:, None] < o) & (kk[:, None] + j16 < kdim)
        if self.vec:  # whole chunks: K is a multiple of 16
            assert (ok == ok[:, :1]).all()
        dst = sb + swz(q // CHUNKS, q % CHUNKS)
        self.smem[dst[:, None] + j16] = np.where(ok, self.wf[
            np.where(ok, idx, 0)], 0)
        for first in range(0, CHUNKS * bn, threads):
            sel = slice(first, min(CHUNKS * bn, first + threads))
            self.writes.append((q[sel] - first, dst[sel]))


def ldmatrix_x4(smem, addr):
    """ldmatrix.x4 (b16, not transposed): lanes 8j..8j+7 give the row
    addresses of matrix j; lane l receives, in register j, bytes 4 (l %
    4) .. +3 of row l / 4 of matrix j. addr (32,) -> (32 lanes, 4 regs,
    4 bytes)."""
    regs = np.zeros((32, 4, 4), np.int64)
    for j in range(4):
        rows = addr[8 * j + G]
        regs[:, j, :] = smem[rows[:, None] + 4 * T4[:, None] + np.arange(4)]
    return regs


def mma_m16n8k32(a, b0, b1):
    """D (32 lanes, 4) of one mma.m16n8k32 s8: a (32 lanes, 4 regs, 4
    bytes), b0/b1 (32 lanes, 4 bytes), in the PTX fragment layouts: A
    reg 0 row g, cols 4t..4t+3; reg 1 row g+8; regs 2, 3 the same +16
    cols; B reg 0 col g, rows 4t..; reg 1 rows +16; D c0/c1 row g, cols
    2t, 2t+1; c2/c3 row g+8."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for j in range(4):
        A[G, 4 * T4 + j] = a[:, 0, j]
        A[G + 8, 4 * T4 + j] = a[:, 1, j]
        A[G, 16 + 4 * T4 + j] = a[:, 2, j]
        A[G + 8, 16 + 4 * T4 + j] = a[:, 3, j]
        B[4 * T4 + j, G] = b0[:, j]
        B[16 + 4 * T4 + j, G] = b1[:, j]
    D = A @ B
    return np.stack([D[G, 2 * T4], D[G, 2 * T4 + 1], D[G + 8, 2 * T4],
                     D[G + 8, 2 * T4 + 1]], axis=1)


def a_lane_addr(plan, wm, mi, ks):
    """The row address each lane gives ldmatrix.x4 for the A fragment of
    m16n8k32 step ks of a stage."""
    tm = plan.bm // CONFIGS[plan.cfg][2]
    return swz(wm * tm + mi * 16 + (LANE & 15), 2 * ks + (LANE >> 4))


def b_lane_addr(plan, wn, nj, ks):
    """... and for the B fragments of column blocks 2 nj and 2 nj + 1."""
    tn = plan.bn // CONFIGS[plan.cfg][3]
    return swz(wn * tn + nj * 16 + ((LANE >> 4) << 3) + (LANE & 7),
               2 * ks + ((LANE >> 3) & 1))


def run_block(blk):
    """The block's main loop: the ring's issue order and the warps'
    fragments and products. Returns acc (warps, MI, NI, 32, 4)."""
    plan = blk.plan
    bm, bn = plan.bm, plan.bn
    _, _, wm_n, wn_n = CONFIGS[plan.cfg]
    mi_n, ni_n = bm // wm_n // 16, bn // wn_n // 8
    acc = np.zeros((wm_n * wn_n, mi_n, ni_n, 32, 4), np.int64)
    issued = []
    for s in range(STAGES - 1):
        if s < blk.t_count:
            blk.issue(blk.t_begin + s, s)
            issued.append(s)
    for i in range(blk.t_count):
        assert i in issued  # its group committed STAGES - 2 groups ago
        nx = i + STAGES - 1
        if nx < blk.t_count:
            assert nx % STAGES == (i - 1) % STAGES  # the slot step i-1 read
            blk.issue(blk.t_begin + nx, nx % STAGES)
            issued.append(nx)
        sa = (i % STAGES) * (bm + bn) * STAGE_K
        sb = sa + bm * STAGE_K
        for ks in range(STAGE_K // TILE_K):
            for warp in range(wm_n * wn_n):
                wm, wn = warp % wm_n, warp // wm_n
                af = [ldmatrix_x4(blk.smem,
                                  sa + a_lane_addr(plan, wm, mi, ks))
                      for mi in range(mi_n)]
                bf = []
                for nj in range(ni_n // 2):
                    r = ldmatrix_x4(blk.smem,
                                    sb + b_lane_addr(plan, wn, nj, ks))
                    bf += [(r[:, 0], r[:, 1]), (r[:, 2], r[:, 3])]
                for mi in range(mi_n):
                    for ni in range(ni_n):
                        acc[warp, mi, ni] += mma_m16n8k32(af[mi], *bf[ni])
    return acc


def requant(y, s_out):
    """K4's requantize: rint(fl(y / s)), clamped to +-127."""
    y = np.asarray(y, np.float32)
    return np.clip(np.rint(y / np.float32(s_out)), -127, 127).astype(
        np.int64)


def epilogue_fp32(acc, oc, vec, mean, scale, act):
    f32 = np.float32
    y = f32(acc.astype(np.float32)) * vec["d"][oc]
    if mean is not None:
        y = (y - vec["mean"][oc]) * vec["inv"][oc]
        y = y * vec["scale"][oc] + vec["bias"][oc]
    elif scale is not None:
        y = y * vec["scale"][oc] + vec["bias"][oc]
    else:
        y = y + vec["bias"][oc]
    if act == Activation.LRELU:
        y = np.where(y > 0, y, f32(0.1) * y)
    elif act == Activation.RELU:
        y = np.where(y < 0, f32(0), y)
    return y


def emulate(x, w, d, bias, stride, pad, act, scale, mean, inv, s_out,
            plan=None, seed=0):
    """K4 on x int8 (N,C,H,W) and w int8 (O,C,k,k), from their
    channels-last memory; returns the output as NCHW values."""
    n, c, h, wd = x.shape
    o, _, k, _ = w.shape
    oh, ow = out_size(h, wd, k, stride, pad)
    geo = (n, c, h, wd, o, k, stride, pad, oh, ow)
    if plan is None:
        plan = plan_conv_int8(n, c, h, wd, o, k, stride, pad)
    m_all = n * oh * ow
    # the bytes the kernel reads: NHWC x and the (O, k, k, C) repack
    xc = x.contiguous(memory_format=torch.channels_last)
    wc = channels_last_weight(w)
    xf = xc.permute(0, 2, 3, 1).reshape(-1).numpy().astype(np.int64)
    wf = wc.permute(0, 2, 3, 1).reshape(-1).numpy().astype(np.int64)
    assert xf.size == x.numel() and wf.size == w.numel()
    vec = c % 16 == 0
    vecs = {key: (None if v is None else v.numpy())
            for key, v in (("d", d), ("bias", bias), ("scale", scale),
                           ("mean", mean), ("inv", inv))}
    bm, bn, threads = plan.bm, plan.bn, plan.threads
    _, _, wm_n, wn_n = CONFIGS[plan.cfg]
    mi_n, ni_n = bm // wm_n // 16, bn // wn_n // 8
    int8_out = s_out is not None
    out = np.full(m_all * o, 99 if int8_out else np.nan,
                  np.int64 if int8_out else np.float32)
    written = np.zeros(m_all * o, np.int64)
    rng = np.random.default_rng(seed)
    o_vec = o % 16 == 0
    st_row = int8_stage_row(bn)
    for bx in range(plan.tiles_m):
        for by in range(plan.tiles_n):
            # every split of the tile; then the last to count itself in
            # adds the others' partials from the workspace
            ws = np.zeros((plan.splits, mi_n * ni_n, threads, 4), np.int64)
            accs = []
            for bz in range(plan.splits):
                blk = Block(xf, wf, geo, plan, vec, bx, by, bz)
                assert blk.t_count >= 1
                acc = run_block(blk)
                accs.append(acc)
                for warp in range(wm_n * wn_n):
                    for mi in range(mi_n):
                        for ni in range(ni_n):
                            ws[bz, mi * ni_n + ni,
                               warp * 32 + LANE] = acc[warp, mi, ni]
            last = int(rng.integers(plan.splits))
            acc = accs[last].copy()
            for z in rng.permutation(plan.splits):
                if z == last:
                    continue
                for warp in range(wm_n * wn_n):
                    for mi in range(mi_n):
                        for ni in range(ni_n):
                            acc[warp, mi, ni] += ws[z, mi * ni_n + ni,
                                                    warp * 32 + LANE]
            m0, o0 = bx * bm, by * bn
            st = np.zeros(bm * st_row if int8_out else bn * (bm + 4),
                          np.int64 if int8_out else np.float32)
            for warp in range(wm_n * wn_n):
                wm, wn = warp % wm_n, warp // wm_n
                for mi in range(mi_n):
                    for half in range(2):
                        row = wm * (bm // wm_n) + mi * 16 + G + 8 * half
                        for ni in range(ni_n):
                            for j in range(2):
                                col = wn * (bn // wn_n) + ni * 8 + 2 * T4 + j
                                keep = o0 + col < o
                                y = epilogue_fp32(
                                    acc[warp, mi, ni, keep, 2 * half + j],
                                    o0 + col[keep], vecs, mean, scale, act)
                                if int8_out:
                                    st[row[keep] * st_row + col[keep]] = \
                                        requant(y, s_out)
                                else:
                                    st[col[keep] * (bm + 4) + row[keep]] = y
            if int8_out:  # 16 channels of a pixel a thread, NHWC
                for q in range(bm * (bn // 16)):
                    row, oc = q // (bn // 16), o0 + 16 * (q % (bn // 16))
                    m = m0 + row
                    if m >= m_all:
                        continue
                    if o_vec and oc + 16 <= o:  # one 16-byte store
                        assert (m * o + oc) % 16 == 0
                    width = max(0, min(16, o - oc))  # else byte stores
                    idx = m * o + oc + np.arange(width)
                    out[idx] = st[row * st_row + (oc - o0) + np.arange(width)]
                    written[idx] += 1
            else:  # a channel's pixels, consecutive threads, NCHW
                q = np.arange(bm * bn)
                col, row = q // bm, q % bm
                oc, m = o0 + col, m0 + row
                keep = (oc < o) & (m < m_all)
                img = m // (oh * ow)
                idx = (img * o + oc) * oh * ow + (m - img * oh * ow)
                out[idx[keep]] = st[col[keep] * (bm + 4) + row[keep]]
                np.add.at(written, idx[keep], 1)
    assert (written == 1).all()  # every output once
    if int8_out:
        return out.reshape(n, oh, ow, o).transpose(0, 3, 1, 2)
    return out.reshape(n, o, oh, ow)


def make_case(case):
    n, c, h, wd, o, k, stride, pad, bn, act, int8_out = case
    gen = torch.Generator().manual_seed(n * 1000 + c * 10 + o)
    x = torch.randint(-127, 128, (n, c, h, wd), generator=gen,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (o, c, k, k), generator=gen,
                      dtype=torch.int8)
    w[0] = 127  # a row of extremes
    x[0, 0] = -127
    d = (torch.rand(o, generator=gen) * 1e-3 + 1e-4) * (27 / (c * k * k)) ** 0.5
    bias = torch.randn(o, generator=gen)
    scale = torch.rand(o, generator=gen) + 0.5 if bn else None
    mean = inv = None
    if bn == "unfolded":
        mean = torch.randn(o, generator=gen) * 0.2
        inv = torch.ones(o) / torch.sqrt(torch.rand(o, generator=gen) + 0.5)
    s_out = 0.173 if int8_out else None
    return (x, w, d, bias, stride, pad, Activation[act], scale, mean, inv,
            s_out)


def check(args, plan=None, seed=0):
    want = conv_int8_fused_ref(*args).numpy()
    got = emulate(*args, plan=plan, seed=seed)
    if args[-1] is not None:
        assert want.dtype == np.int8 and np.abs(want).max() == 127
        np.testing.assert_array_equal(got, want.astype(np.int64))
    else:
        np.testing.assert_array_equal(got, want)


CASES = [  # n, c, h, w, o, k, stride, pad, bn, act, int8 out
    # byte gather (C % 16 != 0) or one tile
    (2, 3, 9, 9, 16, 3, 1, 1, "unfolded", "LRELU", True),  # K = 27
    (1, 8, 13, 13, 70, 3, 2, 1, "folded", "RELU", False),  # s2, O ragged
    (1, 16, 5, 7, 255, 1, 1, 0, None, "NONE", False),  # a head: O = 255
    (3, 5, 11, 6, 9, 3, 2, 0, None, "LRELU", True),  # pad 0, K = 45
    (1, 7, 6, 5, 12, 3, 1, 1, "unfolded", "NONE", True),  # K = 63, not 8k
    (2, 40, 4, 4, 33, 3, 1, 1, "unfolded", "LRELU", False),  # 12 k steps
    (2, 16, 8, 8, 64, 1, 1, 0, "folded", "LRELU", True),  # M = 128, one tile
    # 16-byte copies: C a multiple of 16
    (1, 16, 9, 10, 32, 3, 1, 1, "unfolded", "LRELU", True),  # two taps a step
    (2, 48, 5, 5, 40, 3, 2, 1, "folded", "RELU", True),  # K % 32 = 16
    (1, 32, 7, 9, 96, 3, 1, 1, None, "NONE", False),  # fp32 NCHW staging
    (1, 3, 12, 11, 16, 3, 1, 1, "unfolded", "LRELU", True),  # lid1's loader
    # Darknet-53's kinds (full YOLOv3, BN folded at load)
    (1, 32, 9, 9, 64, 3, 2, 1, "folded", "LRELU", True),  # s2, K = 288
    (2, 32, 6, 7, 64, 3, 1, 1, "folded", "LRELU", True),  # K = 288: 4.5 stages
    (1, 64, 7, 8, 128, 3, 2, 1, "folded", "LRELU", True),  # s2, C = 64
    (1, 128, 5, 6, 64, 1, 1, 0, "folded", "LRELU", True),  # 1x1 squeeze
    (1, 256, 5, 5, 255, 1, 1, 0, None, "NONE", False),  # the 52x52 head's
]


@pytest.mark.parametrize("case", CASES)
def test_k4_emulation_is_bit_equal_to_the_plain_version(case):
    check(make_case(case))


def forced_plan(case, cfg, splits):
    n, c, h, wd, o, k, stride, pad = case[:8]
    oh, ow = out_size(h, wd, k, stride, pad)
    bm, bn, wm, wn = CONFIGS[cfg]
    steps = -(-c * k * k // STAGE_K)
    ss = -(-steps // splits)
    return ConvPlan(cfg, bm, bn, 32 * wm * wn, -(-n * oh * ow // bm),
                    -(-o // bn), -(-steps // ss), ss, steps)


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
@pytest.mark.parametrize("splits,case", [
    (1, (1, 32, 6, 7, 70, 3, 1, 1, "unfolded", "LRELU", True)),
    (3, (1, 32, 6, 7, 70, 3, 1, 1, "folded", "NONE", False)),
    (3, (2, 7, 5, 5, 24, 5, 1, 2, None, "LRELU", True)),  # gather, split
])
def test_k4_emulation_every_tile_shape_and_split(cfg, splits, case):
    """Every tile shape the kernel has, with and without a split of K
    (the last block of a tile chosen at random, the others' partials
    summed in a shuffled order), on the 16-byte and the byte loader."""
    args = make_case(case)
    plan = forced_plan(case, cfg, splits)
    assert plan.splits == splits
    check(args, plan, seed=cfg * 10 + splits)


def yolo_shapes():
    """The 13 convs of YOLOv3-tiny 416 at batch 8: (n, c, h, w, o, k,
    stride, pad)."""
    net = yolov3_tiny(8, 416, 416, 80)
    out = []
    for node in net.nodes:
        if node.type.name == "CONV2D":
            s, d, p = net.tensors[node.src[0]], net.tensors[node.dst[0]], \
                node.param
            out.append((s.n, s.c, s.h, s.w, d.c, p["size"], p["stride"],
                        p["pad"]))
    return out


YOLO_SHAPES = yolo_shapes()


def test_yolo_has_thirteen_convs():
    assert len(YOLO_SHAPES) == 13


def assert_plan_covers(shape):
    n, c, h, w, o, k, stride, pad = shape
    plan = plan_conv_int8(*shape, sms=132)
    bm, bn, wm, wn = CONFIGS[plan.cfg]
    assert (plan.bm, plan.bn, plan.threads) == (bm, bn, 32 * wm * wn)
    oh, ow = out_size(h, w, k, stride, pad)
    assert plan.tiles_m * bm >= n * oh * ow > (plan.tiles_m - 1) * bm
    assert plan.tiles_n * bn >= o > (plan.tiles_n - 1) * bn
    assert plan.steps == -(-c * k * k // STAGE_K)
    assert (plan.splits - 1) * plan.split_steps < plan.steps \
        <= plan.splits * plan.split_steps
    if plan.blocks < 132:  # short K: every split measured slower
        assert c * k * k < SPLIT_K and plan.splits == 1
    assert plan.smem_bytes <= SMEM_BLOCK
    assert plan.tiles_n <= 65535 and plan.splits <= 65535
    if plan.splits > 1:  # split only where the tiles leave SMs idle
        assert plan.tiles_m * plan.tiles_n < 2 * 132
    return plan


@pytest.mark.parametrize("shape", YOLO_SHAPES,
                         ids=[f"c{s[1]}_h{s[2]}_o{s[4]}_k{s[5]}"
                              for s in YOLO_SHAPES])
def test_plan_fills_the_card_at_yolo_shapes(shape):
    """At each of the 13 shapes: at least one block an SM of the H100's
    132, except where K is short of SPLIT_K and the plan keeps the whole
    K in one block (lid14, lid16 and lid19: there every split of K timed
    slower on the card than the idle SMs cost, PERF.md); every K stage in
    exactly one run, no run empty, and the block's shared memory within
    the 227 KB a block may take."""
    assert_plan_covers(shape)


def darknet53_shapes():
    """{shape: count} of full YOLOv3's 75 convs at 416 px, batch 8."""
    net = yolov3(8, 416, 416, 80)
    out = {}
    for node in net.nodes:
        if node.type.name == "CONV2D":
            s, d, p = net.tensors[node.src[0]], net.tensors[node.dst[0]], \
                node.param
            key = (s.n, s.c, s.h, s.w, d.c, p["size"], p["stride"], p["pad"])
            out[key] = out.get(key, 0) + 1
    return out


DARKNET53 = darknet53_shapes()


def test_darknet53_has_75_convs_in_23_shapes():
    assert (sum(DARKNET53.values()), len(DARKNET53)) == (75, 23)
    assert sum(s[6] == 2 for s in DARKNET53) == 5  # the downsamples
    assert max(s[1] * s[5] ** 2 for s in DARKNET53) == 4608


@pytest.mark.parametrize("shape", list(DARKNET53),
                         ids=[f"c{s[1]}_h{s[2]}_o{s[4]}_k{s[5]}_s{s[6]}"
                              for s in DARKNET53])
def test_plan_covers_the_darknet53_shapes(shape):
    """The same rules hold at the 23 shapes of full YOLOv3's 75 convs:
    none is split (each K is short of SPLIT_K or makes 352 blocks or
    more), and the stride-2 convs, C = 32 ... 512, use 16-byte copies."""
    plan = assert_plan_covers(shape)
    assert plan.splits == 1
    if shape[6] == 2:
        assert shape[1] % 16 == 0


def test_k4_emulation_splits_k_at_9216():
    """A 3x3 conv of 1024 channels (K = 9216, 144 stages) on a small
    plane: the plan for a 4-SM card splits K, each run's partials land
    in the workspace, the last block of a tile sums them."""
    case = (1, 1024, 3, 3, 40, 3, 1, 1, "folded", "LRELU", True)
    plan = plan_conv_int8(*case[:8], sms=4)
    assert plan.steps == 144 and plan.splits > 1 and plan.workspace_ints
    check(make_case(case), plan, seed=3)


def test_plan_splits_the_13x13_layers():
    """The six 13x13 convs: 128 x 32 tiles where K is deep, K split in
    two on the 3x3 convs of 512 outputs (176 tiles, K = 2,304); 64 x 64
    tiles, K whole, on the 1x1 convs of K 256 and 512."""
    got = {(s[1], s[4]): plan_conv_int8(*s, sms=132)
           for s in YOLO_SHAPES if s[2] == 13}
    assert {key: (p.bm, p.bn, p.splits, p.split_steps)
            for key, p in got.items()} == {
        (256, 512): (128, 32, 2, 18), (512, 1024): (128, 32, 1, 72),
        (1024, 256): (128, 32, 1, 16), (512, 255): (64, 64, 1, 8),
        (256, 128): (64, 64, 1, 4)}


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
def test_shared_memory_banks(cfg):
    """Every shared-memory access of the main loop is free of bank
    conflicts: each ldmatrix phase (8 rows of 16 bytes), each quarter
    warp's 16-byte cp.async writes and byte-gather stores, and the
    epilogue's 1-byte int8 and 4-byte fp32 staging writes of a warp."""
    bm, bn, wm_n, wn_n = CONFIGS[cfg]
    plan = forced_plan((1, 32, 16, 16, bn, 3, 1, 1), cfg, 1)

    def groups_distinct(addr16):  # 8 accesses of 16 bytes: 32 banks
        return len({(a // 16) % 8 for a in addr16}) == 8

    for ks in range(STAGE_K // TILE_K):
        for wm in range(wm_n):
            for mi in range(bm // wm_n // 16):
                addr = a_lane_addr(plan, wm, mi, ks)
                for j in range(4):
                    assert groups_distinct(addr[8 * j:8 * j + 8])
        for wn in range(wn_n):
            for nj in range(bn // wn_n // 16):
                addr = b_lane_addr(plan, wn, nj, ks)
                for j in range(4):
                    assert groups_distinct(addr[8 * j:8 * j + 8])
    x = torch.zeros(1, 32, 16, 16, dtype=torch.int8)
    w = torch.zeros(bn, 32, 3, 3, dtype=torch.int8)
    blk = Block(x.numpy().reshape(-1).astype(np.int64),
                w.numpy().reshape(-1).astype(np.int64),
                (1, 32, 16, 16, bn, 3, 1, 1, 16, 16), plan, True, 0, 0, 0)
    blk.issue(0, 0)
    gather = Block(np.zeros(3 * 256, np.int64), np.zeros(bn * 27, np.int64),
                   (1, 3, 16, 16, bn, 3, 1, 1, 16, 16),
                   forced_plan((1, 3, 16, 16, bn, 3, 1, 1), cfg, 1), False,
                   0, 0, 0)
    gather.issue(0, 0)
    for tid, dst in blk.writes + gather.writes:
        for first in range(0, len(tid), 8):  # a quarter warp a phase
            assert groups_distinct(dst[first:first + 8])
    st_row = int8_stage_row(bn)
    for wm in range(wm_n):
        for wn in range(wn_n):
            for mi in range(bm // wm_n // 16):
                for ni in range(bn // wn_n // 8):
                    row = wm * (bm // wm_n) + mi * 16 + G
                    for j in range(2):
                        col = wn * (bn // wn_n) + ni * 8 + 2 * T4 + j
                        words = (row * st_row + col) // 4
                        # lanes on one bank write the same word, or none
                        assert len(set(words.tolist())) == len(
                            {int(v) % 32 for v in set(words.tolist())})
                        addr = col * (bm + 4) + row
                        assert len(set((addr % 32).tolist())) == 32


def test_wrapper_on_the_cpu_returns_the_kernels_layouts():
    """On the CPU the wrapper runs the plain version, on any layout, and
    returns what the kernel writes: int8 channels-last, fp32 NCHW."""
    args = list(make_case((2, 16, 7, 7, 24, 3, 1, 1, "unfolded", "LRELU",
                           True)))
    x, w = args[0], args[1]
    want = conv_int8_fused_ref(*args)
    args[0] = x.contiguous(memory_format=torch.channels_last)
    args[1] = channels_last_weight(w)
    got = conv_int8_fused(*args[:6], act=args[6], scale=args[7],
                          mean=args[8], inv=args[9], s_out=args[10])
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    f32 = conv_int8_fused(*args[:6], act=args[6], scale=args[7],
                          mean=args[8], inv=args[9])
    assert f32.dtype == torch.float32 and f32.is_contiguous()
    assert torch.equal(f32, conv_int8_fused_ref(*args[:10]))
