"""K5's plan and indexing (`csrc/grouped_int8.cu`, `ops/grouped_int8.py`)
emulated on the CPU, bit-equal to its plain version.

The emulation walks the kernel's grid as the kernel does: block (lanes,
strips, rows), grid (n * strip_tiles, row_tiles, lane_tiles), each thread
one strip of `s` output pixels along a row for its lane's channels. Per
branch it repeats the kernel's words and byte operations in numpy:
- dw: 16-channel lanes, strips of 2; the block's prologue puts each
  lane's taps of each kernel row and quad of channels in shared memory
  as [w0, w1, w2, 0] and [0, w0, w1, w2] (4 x 4 byte transposes by
  `__byte_perm` with the kernel's selectors); per kernel row the
  strip's stride + 3 x columns loaded as 16-byte words (zeros outside
  the image), transposed into words of 4 columns a channel, and
  `__dp4a` of such a word with the staged taps;
- g16 / g4: 4 output channels of one group a lane, `__dp4a` over 16 or 4
  of the group's input channels, read from the (k, k, O, C/G) weight;
- bytes: 4 output channels a lane, byte products.
Each output is written at the kernel's index (int8 channels-last m * O +
o) and must be written exactly once; the sums must equal the exact int32
conv, and the int8 output, through `int8_epilogue_ref`'s steps and
`requant_bits_ref` (the kernel's requantize shortcut, step for step),
must equal `grouped_int8_fused_ref`'s. The shortcut is also held to
rint(y / s) at constructed ties and on a million seeded values.
"""

import numpy as np
import pytest
import torch

from bcnn_tpu_torch.ops.conv_int8 import (conv2d_int32, int8_epilogue_ref,
                                          out_size)
from bcnn_tpu_torch.ops.grouped_int8 import (
    BYTES, DW, DW_LANES, G4, G16, THREADS, grouped_int8_fused,
    grouped_int8_fused_ref,
    grouped_weight, is_grouped_weight, k5_branch, plan_grouped_int8,
    requant_bits_ref, shortcut_on)
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
    (1, 1400, 3, 3, 4, 3, 1, 1, 1, A.RELU, False),       # one deep group
    (1, 32, 14, 14, 32, 3, 1, 1, 32, A.RELU, False),     # ragged strip end
    (2, 48, 13, 11, 48, 3, 2, 1, 48, A.LRELU, False),    # stride 2, odd
    (1, 24, 8, 8, 24, 3, 1, 1, 24, A.NONE, False),       # C = 16 j + 8
    (2, 16, 9, 9, 16, 3, 1, 1, 4, A.RELU, True),         # cg = 4
    (1, 128, 10, 10, 64, 3, 1, 1, 2, A.LRELU, True),     # cg = 64
    (1, 1024, 7, 7, 1024, 3, 1, 1, 1024, A.RELU, False),  # dw13, batch 1
    (1, 32, 5, 3, 32, 3, 1, 1, 32, A.NONE, False),       # a row under s
    (3, 16, 6, 6, 16, 3, 2, 0, 16, A.LRELU, False),      # stride 2, pad 0
]
BRANCH = [DW, DW, BYTES, BYTES, BYTES, G4, BYTES, BYTES, G4, DW, DW, BYTES,
          G4, G16, DW, DW, DW]


# ------------------------------------------------ the kernel's operations #

def byte_perm(a, b, sel):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (nibble i of sel) of the 8 bytes b:a."""
    v = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
    out = np.zeros(np.broadcast(a, b).shape, np.uint64)
    for i in range(4):
        nib = (sel >> (4 * i)) & 7
        out |= ((v >> np.uint64(8 * nib)) & np.uint64(0xFF)) << np.uint64(
            8 * i)
    return out.astype(np.uint32)


def transpose4(a, b, c, d):
    """csrc/grouped_int8.cu:transpose4, its selectors as written there."""
    t0, t1 = byte_perm(a, b, 0x6240), byte_perm(a, b, 0x7351)
    t2, t3 = byte_perm(c, d, 0x6240), byte_perm(c, d, 0x7351)
    return [byte_perm(t0, t2, 0x5410), byte_perm(t1, t3, 0x5410),
            byte_perm(t0, t2, 0x7632), byte_perm(t1, t3, 0x7632)]


def sbytes(v):
    return [((v >> np.uint32(8 * i)) & np.uint32(0xFF)).astype(
        np.int64) - 256 * (((v >> np.uint32(8 * i + 7)) & np.uint32(1))
                           .astype(np.int64)) for i in range(4)]


def dp4a(a, b, c):
    return c + sum(x * y for x, y in zip(sbytes(a), sbytes(b)))


def words(mem, off, ok, nwords):
    """Little-endian 32-bit words of uint8 memory at byte offsets `off`
    (zeros where not ok), as a 16- or 4-byte load gives them."""
    off = np.where(ok, off, 0)
    out = []
    for u in range(nwords):
        w = np.zeros(off.shape, np.uint32)
        for i in range(4):
            w |= mem[off + 4 * u + i].astype(np.uint32) << np.uint32(8 * i)
        out.append(np.where(ok, w, np.uint32(0)).astype(np.uint32))
    return out


# ---------------------------------------------------------- the emulation #

def threads(plan, n, oh, ow):
    """(n, oy, ox0, lane) of every thread that has work, as the kernel
    derives them from blockIdx and threadIdx."""
    bx, by, bz, tx, ty, tz = np.meshgrid(
        np.arange(n * plan.strip_tiles), np.arange(plan.row_tiles),
        np.arange(plan.lane_tiles), np.arange(plan.lanes),
        np.arange(plan.strips), np.arange(plan.rows), indexing="ij")
    bx, by, bz, tx, ty, tz = (v.ravel() for v in (bx, by, bz, tx, ty, tz))
    ni = bx // plan.strip_tiles
    strip = (bx - ni * plan.strip_tiles) * plan.strips + ty
    oy = by * plan.rows + tz
    lane = bz * plan.lanes + tx
    ox0 = strip * plan.s
    keep = (ox0 < ow) & (oy < oh) & (lane < plan.lanes_all)
    return ni[keep], oy[keep], ox0[keep], lane[keep]


def dw_weights(wm, c, plan):
    """csrc/grouped_int8.cu:dw_weights for every lane tile (blockIdx.z):
    its block's shared words, 4 uint32 each as int64 (-1: not written),
    A = [w0, w1, w2, 0] and B = [0, w0, w1, w2] of each lane, kernel row
    and quad at ((r * 4 + q) * 2 + ab) * lanes + l."""
    lanes = plan.lanes
    sab = np.full((plan.lane_tiles, DW_LANES * 24, 4), -1, np.int64)
    t = np.arange(3 * lanes)  # the prologue's work items
    r, l = t // lanes, t % lanes
    for bz in range(plan.lane_tiles):
        lane = bz * lanes + l
        ok = lane < plan.lanes_all
        zero = np.zeros(t.shape, np.uint32)
        wt = [words(wm, (r * 3 + s) * c + 16 * lane, ok, 4) for s in range(3)]
        for q in range(4):
            a = transpose4(wt[0][q], wt[1][q], wt[2][q], zero)
            for ab in (0, 1):
                idx = ((r * 4 + q) * 2 + ab) * lanes + l
                for e in range(4):
                    v = a[e].astype(np.int64)
                    if ab:
                        v = (v << 8) & 0xFFFFFFFF
                    sab[bz, idx[ok], e] = v[ok]
    return sab


def emulate(x, w, stride, pad, groups, plan):
    """The int32 sums K5 computes, placed where it writes them (int8
    index m * O + o), and how often each output was written."""
    n, c, h, wd = x.shape
    o, cg, k, _ = w.shape
    og = o // groups
    oh, ow = out_size(h, wd, k, stride, pad)
    xm = x.permute(0, 2, 3, 1).contiguous().reshape(-1).numpy().view(
        np.uint8)
    # K5's (k, k, O, cg) memory
    wm = w.permute(2, 3, 0, 1).contiguous().reshape(-1).numpy().view(
        np.uint8)
    ni, oy, ox0, lane = threads(plan, n, oh, ow)
    acc = np.zeros(n * oh * ow * o, np.int64)
    writes = np.zeros(n * oh * ow * o, np.int64)
    s = plan.s

    def put(j, chans, sums):
        ox = ox0 + j
        ok = ox < ow
        m = (ni * oh + oy) * ow + ox
        for ch, v in zip(chans, sums):
            good = ok & (ch < o)
            idx = (m * o + ch)[good]
            acc[idx] = v[good]
            np.add.at(writes, idx, 1)

    if plan.branch == DW:
        sab = dw_weights(wm, c, plan)
        ll = lane - (lane // plan.lanes) * plan.lanes  # threadIdx.x
        bz = lane // plan.lanes

        def stage(r, q, ab):
            """sab[((r * 4 + q) * 2 + ab) * lanes + l] of each thread's
            block, as 4 words; every word read must have been written."""
            got = sab[bz, ((r * 4 + q) * 2 + ab) * plan.lanes + ll]
            assert (got >= 0).all()
            return [got[:, e].astype(np.uint32) for e in range(4)]

        cols = stride + 3  # s = 2: (s - 1) * stride + 3
        sums = np.zeros((2, 16, ni.size), np.int64)
        c16 = 16 * lane
        ix0 = ox0 * stride - pad
        zero = np.zeros(ni.shape, np.uint32)
        for r in range(3):
            iy = oy * stride - pad + r
            rok = (iy >= 0) & (iy < h)
            xrow = (ni * h + iy) * wd * c + c16
            xc = []
            for cc in range(cols):
                ix = ix0 + cc
                ok = rok & (ix >= 0) & (ix < wd)
                xc.append(words(xm, xrow + ix * c, ok, 4))
            for q in range(4):
                a = stage(r, q, 0)
                col = lambda cc: xc[cc][q] if cc < cols else zero  # noqa
                # a row outside the image reads zeros and adds nothing
                t0 = transpose4(*(col(i) for i in range(4)))
                if stride == 1:  # the same columns, the taps a byte on
                    pairs = ((t0, a), (t0, stage(r, q, 1)))
                else:  # columns 2.. for the next output
                    pairs = ((t0, a),
                             (transpose4(*(col(2 + i) for i in range(4))), a))
                for j, (xw, ww) in enumerate(pairs):
                    for e in range(4):
                        sums[j, 4 * q + e] = dp4a(xw[e], ww[e],
                                                  sums[j, 4 * q + e])
        for j in range(2):
            put(j, [c16 + i for i in range(16)], sums[j])
    elif plan.branch in (G16, G4):
        vb = 16 if plan.branch == G16 else 4
        o0 = 4 * lane
        cb = (o0 // og) * cg
        sums = np.zeros((s, 4, ni.size), np.int64)
        for r in range(k):
            iy = oy * stride - pad + r
            rok = (iy >= 0) & (iy < h)
            xrow = (ni * h + iy) * wd * c + cb
            for t in range(k):
                wp = ((r * k + t) * o + o0) * cg
                for j0 in range(0, cg, vb):
                    xv = []
                    for j in range(s):
                        ix = ox0 * stride - pad + t + j * stride
                        ok = rok & (ix >= 0) & (ix < wd)
                        xv.append(words(xm, xrow + ix * c + j0, ok, vb // 4))
                    wv = [words(wm, wp + e * cg + j0, rok, vb // 4)
                          for e in range(4)]
                    for u in range(vb // 4):
                        for j in range(s):
                            for e in range(4):
                                sums[j, e] = np.where(
                                    rok, dp4a(xv[j][u], wv[e][u], sums[j, e]),
                                    sums[j, e])
        for j in range(s):
            put(j, [o0 + e for e in range(4)], sums[j])
    else:
        xs = xm.view(np.int8).astype(np.int64)
        ws = wm.view(np.int8).astype(np.int64)
        o0 = 4 * lane
        for j in range(s):
            ox = ox0 + j
            sums = []
            for e in range(4):
                oc = np.minimum(o0 + e, o - 1)
                cb = (oc // og) * cg
                v = np.zeros(ni.size, np.int64)
                for r in range(k):
                    iy = oy * stride - pad + r
                    for t in range(k):
                        ix = ox * stride - pad + t
                        ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
                        xp = np.where(ok, ((ni * h + iy) * wd + ix) * c, 0)
                        wp = ((r * k + t) * o + oc) * cg
                        jj = np.arange(cg)[None, :]
                        v += np.where(ok, (xs[xp[:, None] + cb[:, None] + jj]
                                           * ws[wp[:, None] + jj]).sum(1), 0)
                sums.append(v)
            put(j, [o0 + e for e in range(4)], sums)
    return acc, writes


def make_case(n, c, h, w, o, k, groups, bn):
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
    return x, wt, d, bias, kw


def check_emulation(n, c, h, w, o, k, stride, pad, groups, act, bn, plan):
    x, wt, d, bias, kw = make_case(n, c, h, w, o, k, groups, bn)
    acc, writes = emulate(x, wt, stride, pad, groups, plan)
    assert (writes == 1).all()  # every output once
    oh, ow = out_size(h, w, k, stride, pad)
    acc_t = torch.from_numpy(acc.reshape(n, oh, ow, o)).permute(
        0, 3, 1, 2).to(torch.int32)
    assert torch.equal(acc_t, conv2d_int32(x, wt, stride, pad, groups))
    y = int8_epilogue_ref(acc_t, d, bias, act, **kw)
    want = grouped_int8_fused_ref(x, wt, d, bias, stride, pad, groups, act,
                                  **kw)
    assert torch.equal(y, want)
    s_out = 0.05
    q, _ = requant_bits_ref(y.numpy(), s_out)
    want = grouped_int8_fused_ref(x, wt, d, bias, stride, pad, groups, act,
                                  s_out=s_out, **kw)
    assert torch.equal(torch.from_numpy(q), want)
    return x, wt, d, bias, kw


def cases():
    return [pytest.param(*cs, id="-".join(map(str, cs[:9])) + f"-{cs[9].name}"
                         + ("-bn" if cs[10] else "")) for cs in CASES]


@pytest.mark.parametrize("n,c,h,w,o,k,stride,pad,groups,act,bn", cases())
def test_emulated_kernel_equals_plain_version(n, c, h, w, o, k, stride, pad,
                                              groups, act, bn):
    plan = plan_grouped_int8(n, c, h, w, o, k, stride, pad, groups)
    x, wt, d, bias, kw = check_emulation(n, c, h, w, o, k, stride, pad,
                                         groups, act, bn, plan)
    for s_out in (None, 0.05):
        want = grouped_int8_fused_ref(x, wt, d, bias, stride, pad, groups,
                                      act, s_out=s_out, **kw)
        # the wrapper's CPU path: the same values, the kernel's layouts
        out = grouped_int8_fused(x, wt, d, bias, stride, pad, groups, act,
                                 s_out=s_out, **kw)
        assert torch.equal(out, want)
        fmt = torch.contiguous_format if s_out is None else \
            torch.channels_last
        assert out.is_contiguous(memory_format=fmt)


# the other strips and blocks the sweep tries, on a shape of each branch
VARIANTS = [(i, s, lanes, aim) for i in (0, 1, 9, 10, 14, 16)
            for s, lanes, aim in ((2, 1, 64), (2, 4, 128), (2, 2, 32),
                                  (2, 64, 256))] + [
    (i, s, lanes, aim) for i in (12, 13)
    for s, lanes, aim in ((2, 1, 64), (2, 4, 128), (4, 2, 32),
                          (4, 64, 256))]


@pytest.mark.parametrize("i,s,lanes,aim", VARIANTS)
def test_emulated_strip_and_block_variants(i, s, lanes, aim):
    n, c, h, w, o, k, stride, pad, groups, act, bn = CASES[i]
    plan = plan_grouped_int8(n, c, h, w, o, k, stride, pad, groups, s=s,
                             lanes=lanes, aim=aim)
    assert plan.branch == BRANCH[i] != BYTES
    check_emulation(n, c, h, w, o, k, stride, pad, groups, act, bn, plan)


def launcher_takes(plan, n, c, h, w, o, k, stride, pad, groups, align=16,
                   shortcut=True):
    """csrc/grouped_int8.cu:bcnn_grouped_int8's checks of a plan."""
    oh, ow = out_size(h, w, k, stride, pad)
    lanes_all = c // 16 if plan.branch == DW else -(-o // 4)
    return (
        plan.branch == k5_branch(c, o, k, stride, groups, align, shortcut)
        and plan.s in {DW: (2,), BYTES: (1, 2, 4)}.get(plan.branch, (2, 4))
        and min(plan.lanes, plan.strips, plan.rows) >= 1
        and plan.threads <= THREADS
        and (plan.branch != DW or plan.lanes <= DW_LANES)
        and plan.lanes_all == lanes_all
        and plan.strip_tiles == -(-(-(-ow // plan.s)) // plan.strips)
        and plan.row_tiles == -(-oh // plan.rows) <= 65535
        and plan.lane_tiles == -(-lanes_all // plan.lanes) <= 65535
        and n * plan.strip_tiles < 2**31
        and n * h * w * c < 2**31 and n * oh * ow * o < 2**31)


@pytest.mark.parametrize("n,c,h,w,o,k,stride,pad,groups,act,bn", cases())
def test_plan_is_one_the_kernel_takes(n, c, h, w, o, k, stride, pad, groups,
                                      act, bn):
    plan = plan_grouped_int8(n, c, h, w, o, k, stride, pad, groups)
    assert plan.branch == BRANCH[CASES.index(
        (n, c, h, w, o, k, stride, pad, groups, act, bn))]
    assert launcher_takes(plan, n, c, h, w, o, k, stride, pad, groups)
    # a misaligned tensor runs a branch that needs less
    for align in (1, 2, 4, 8):
        p = plan_grouped_int8(n, c, h, w, o, k, stride, pad, groups,
                              align=align)
        assert p.branch in ((G4,) if align >= 4 and plan.branch != BYTES
                            and (c // groups) % 4 == 0 else (BYTES,))
        assert launcher_takes(p, n, c, h, w, o, k, stride, pad, groups,
                              align)


def test_depthwise_branch_needs_the_requantize_shortcut():
    """A 1 / s_out that is not a normal float32 turns the shortcut off,
    and the depthwise branch (which never divides) with it."""
    assert shortcut_on(None) and shortcut_on(2 / 127) and shortcut_on(1e30)
    assert not shortcut_on(1e-39) and not shortcut_on(2.0**127)
    plan = plan_grouped_int8(1, 32, 12, 12, 32, 3, 1, 1, 32,
                             shortcut=False)
    assert plan.branch == BYTES
    assert launcher_takes(plan, 1, 32, 12, 12, 32, 3, 1, 1, 32,
                          shortcut=False)


def test_mobilenet_shapes_are_staged_and_vectorized():
    """MobileNet-v1's nine depthwise shapes at batch 64, 224 px: the
    depthwise branch (16-byte lanes, the strip's columns staged in
    registers), blocks the launcher takes, and enough of them for 132
    SMs."""
    shapes = [(32, 112, 1), (64, 112, 2), (128, 56, 1), (128, 56, 2),
              (256, 28, 1), (256, 28, 2), (512, 14, 1), (512, 14, 2),
              (1024, 7, 1)]
    for c, hw, stride in shapes:
        plan = plan_grouped_int8(64, c, hw, hw, c, 3, stride, 1, c)
        assert plan.branch == DW and plan.lanes_all == c // 16
        assert launcher_takes(plan, 64, c, hw, hw, c, 3, stride, 1, c)
        assert plan.threads >= 128 and plan.blocks(64) >= 132


def test_weight_layout():
    w = torch.arange(2 * 3 * 3 * 3, dtype=torch.int8).reshape(2, 3, 3, 3)
    g = grouped_weight(w)
    assert torch.equal(g, w) and is_grouped_weight(g)
    assert not is_grouped_weight(w)
    assert grouped_weight(g) is g
    # (k, k, O, C/G) memory: a group's input channels fastest
    assert g.stride() == (3, 1, 3 * 2 * 3, 2 * 3)
    # depthwise (C/G = 1): the memory of (k, k, 1, O), as before
    dw = torch.arange(4 * 9, dtype=torch.int8).reshape(4, 1, 3, 3)
    assert torch.equal(
        grouped_weight(dw).permute(2, 3, 0, 1).reshape(-1),
        dw.permute(2, 3, 1, 0).reshape(-1))


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
    with pytest.raises(ValueError, match="2\\^31"):
        plan_grouped_int8(1024, 1024, 64, 64, 1024, 3, 1, 1, 1024)


# ------------------------------------------ the requantize's shortcut #

def true_codes(y, s):
    s32 = np.float32(s)
    return np.clip(np.rint(y.astype(np.float32) / s32), -127, 127).astype(
        np.int8)


SCALES = [2 / 127, 0.05, 1 / 3, 7.3e-3, 0.1, 1.0, 3.7, 1e-6, 4096.0]


@pytest.mark.parametrize("s", SCALES)
def test_requant_shortcut_equals_true_division_at_ties(s):
    """y = (q + 0.5) s and the floats next to it, q across the codes
    and past them: the shortcut's code is rint(y / s)'s, and at the ties
    it took the true division."""
    s32 = np.float32(s)
    q = np.arange(-131, 131, dtype=np.float32)
    ties = (q + np.float32(0.5)) * s32
    ys = [ties]
    up, down = ties.copy(), ties.copy()
    for _ in range(6):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        ys += [up, down]
    y = np.concatenate(ys + [q * s32, -ties])
    got, near = requant_bits_ref(y, s)
    assert np.array_equal(got, true_codes(y, s))
    exact = ties / s32 == q + np.float32(0.5)
    inside = np.abs(q + np.float32(0.5)) < 127
    assert near[:ties.size][exact & inside].all()


def test_requant_shortcut_on_a_million_values():
    rng = np.random.RandomState(13)
    for s in (2 / 127, 0.0371, 1.9):
        y = (rng.standard_normal(10**6) * 40 * s).astype(np.float32)
        got, near = requant_bits_ref(y, s)
        assert np.array_equal(got, true_codes(y, s))
        assert near.mean() < 1e-3  # the true division is rare
