"""K2's indexing (csrc/row_shift.cu), on the CPU. The CUDA kernel cannot
run here, so this file mirrors what it does, in float32 with the
kernel's operation order, and holds the result to the plain versions bit
for bit:
  - row mode: each tile's source range staged from the 16-byte boundary
    at or below it (img at each of the four offsets from a boundary;
    4-byte copies only at img's ends), the two tap windows read as
    aligned float4s from the stage and shifted by the row's offset, the
    fill as a select on the row index, the float4 stores with their
    scalar head and tail (out at each of the four offsets), rows longer
    than a tile in pieces;
  - column mode: each thread's W floats (W = 2 where rows allow float2),
    its segment of outputs down the columns with the lower tap carried,
    and floats that straddle a step of the shift loaded one by one.
Every output must be written exactly once. Imports no JAX."""

import math

import pytest
import torch

from bcnn_tpu_torch.ops.row_shift import col_shift_ref, row_shift_ref

torch.set_num_threads(1)

F32 = torch.float32
# csrc/row_shift.cu
ROW_THREADS, PIECE = 128, 4096
COL_THREADS, SEG = 128, 4

# (n, rows, win, C, kmax, out_x0, out_w, in_x0)
CASES = [
    (2, 5, 20, 3, 4, 0, 20, 0),        # same frame in and out
    (2, 4, 30, 3, 6, -6, 42, -1),      # pass 1: fill read at both ends
    (1, 3, 12, 2, 5, -20, 8, 0),       # output entirely in the fill
    (2, 3, 16, 1, 3, 2, 10, 0),        # window inside the row, C = 1
    (1, 3, 11, 7, 4, 1, 9, 2),         # C = 7
    (1, 2, 500, 3, 5, -2, 1400, 0),    # 4,200 outputs a row: two pieces
    (3, 6, 14, 3, 6, 0, 12, -6),       # pass 3 of a small chain
]


def shift_of(d, kmax):
    """(k0, v0, v1, w0, w1) as csrc/row_shift.cu shift_of, in float32."""
    d = torch.tensor(d, dtype=F32)
    k0 = int(torch.floor(d)) + kmax
    one = torch.tensor(1.0, dtype=F32)

    def w(k):
        return torch.clamp(one - torch.abs(d - torch.tensor(k - kmax,
                                                            dtype=F32)),
                           min=0.0)
    return (k0, 0 <= k0 <= 2 * kmax, 0 <= k0 + 1 <= 2 * kmax, w(k0),
            w(k0 + 1))


def combine(sh, a, b):
    """w0*a + w1*b with the taps outside the sweep left out, each
    product and the sum rounded to float32 (torch rounds each op)."""
    _, v0, v1, w0, w1 = sh
    acc = torch.zeros_like(a)
    if v0:
        acc = w0 * a
    if v1:
        acc = acc + w1 * b
    return acc


def row_inputs(n, rows, win, c, kmax, seed):
    gen = torch.Generator().manual_seed(seed)
    img = 255 * torch.rand(n, rows, win, c, generator=gen)
    d = (2 * torch.rand(n, rows, generator=gen) - 1) * (kmax - 1)
    d.view(-1)[0] = 2.0  # integer shifts, one negative
    d.view(-1)[-1] = -3.0 if kmax > 3 else 0.0
    return img, d


def emulate_row(img, d, kmax, out_x0, out_w, in_x0, fill, base, obase):
    """Row mode, tile by tile, from the staged floats alone; img lies
    `base` floats and out `obase` floats past a 16-byte boundary."""
    n, rows, win, C = img.shape
    win_c, out_c = win * C, out_w * C
    flat = img.reshape(-1)
    total = flat.numel()
    col0 = out_x0 - kmax - in_x0
    piece = min(out_c, PIECE)
    pieces = -(-out_c // piece)
    stage_floats = 4 * -(-(piece + C + 3) // 4)
    out = torch.full((n * rows * out_c,), float("nan"), dtype=F32)
    written = torch.zeros(out.shape, dtype=torch.int32)
    fill = torch.tensor(fill, dtype=F32)
    for t in range(n * rows * pieces):
        row, p = divmod(t, pieces)
        e0 = p * piece
        ln = min(piece, out_c - e0)
        sh = shift_of(float(d.reshape(-1)[row]), kmax)
        s = (col0 + sh[0]) * C + e0
        lo = max(s, 0)
        hi = max(min(s + ln + C, win_c), lo)
        src = row * win_c + lo  # index in img of the range's first float
        head = (base + src) % 4
        # stage_tile: never-staged floats stay NaN, so a read of one that
        # the fill select keeps would show
        buf = torch.full((stage_floats,), float("nan"), dtype=F32)
        if hi > lo:
            chunks = (head + hi - lo + 3) // 4
            assert 4 * chunks <= stage_floats
            for j in range(chunks):
                a = src - head + 4 * j
                assert (base + a) % 4 == 0  # cp.async's 16-byte alignment
                if 0 <= a and a + 4 <= total:
                    buf[4 * j:4 * j + 4] = flat[a:a + 4]
                else:  # 4-byte copies: only at img's ends
                    assert a < 0 or a + 4 > total
                    for e in range(4):
                        buf[4 * j + e] = (flat[a + e] if 0 <= a + e < total
                                          else 0.0)
        # compute_tile
        mb = head - lo + s
        dst0 = row * out_c + e0
        oh = min((4 - (obase + dst0) % 4) % 4, ln)
        nvec = (ln - oh) // 4
        tail0 = oh + 4 * nvec
        qmax = stage_floats // 4 - 1
        last = stage_floats - 1

        def in_row(v, i):  # i: row indices; v: the values read for them
            return torch.where((i >= 0) & (i < win_c), v, fill)

        def window4(m, j):
            """Float j of window4(buf4, m, qmax), for a tensor of m: of
            the two aligned chunks q, q+1 (each clamped to the stage),
            float (m & 3) + j."""
            k = (m & 3) + j
            chunk = torch.clamp((m >> 2) + k // 4, 0, qmax)
            return buf[4 * chunk + k % 4]

        for e in list(range(oh)) + list(range(tail0, ln)):
            i = torch.tensor([s + e])
            v0 = buf[min(max(mb + e, 0), last)]
            v1 = buf[min(max(mb + e + C, 0), last)]
            out[dst0 + e] = combine(sh, in_row(v0, i), in_row(v1, i + C))[0]
            written[dst0 + e] += 1
        e = oh + 4 * torch.arange(nvec)
        assert bool(((obase + dst0 + e) % 4 == 0).all())  # aligned float4
        for j in range(4):
            i = s + e + j
            out[dst0 + e + j] = combine(
                sh, in_row(window4(mb + e, j), i),
                in_row(window4(mb + e + C, j), i + C))
            written[dst0 + e + j] += 1
    assert bool((written == 1).all())
    return out.reshape(n, rows, out_w, C)


@pytest.mark.parametrize("base", [0, 1, 2, 3])
@pytest.mark.parametrize("case", CASES)
def test_row_mode_staging_matches_plain_version(case, base):
    n, rows, win, c, kmax, out_x0, out_w, in_x0 = case
    img, d = row_inputs(n, rows, win, c, kmax, rows * win + kmax)
    want = row_shift_ref(img, d, kmax, out_x0, out_w, in_x0, 128.0)
    for obase in {0, (base + 2) % 4}:
        got = emulate_row(img, d, kmax, out_x0, out_w, in_x0, 128.0, base,
                          obase)
        assert torch.equal(got, want)


def emulate_col(img, d, kmax, out_x0, out_w, in_x0, fill, W):
    """Column mode, thread by thread over the segments, vectorised over
    the W floats' lanes; img (N, win, R, C)."""
    n, win, R, C = img.shape
    rc = R * C
    assert rc % W == 0
    flat = img.reshape(n, win, rc)
    col0 = out_x0 - kmax - in_x0
    out = torch.full((n, out_w, rc), float("nan"), dtype=F32)
    written = torch.zeros(out.shape, dtype=torch.int32)
    fill = torch.tensor(fill, dtype=F32)
    per_image = rc // W
    straddles = 0
    for seg in range(-(-out_w // SEG)):
        i0 = seg * SEG
        count = min(SEG, out_w - i0)
        for g in range(n * per_image):
            ni = g // per_image
            x = W * (g - ni * per_image)
            sh = [shift_of(float(d[ni, (x + w) // C]), kmax)
                  for w in range(W)]
            j0 = [col0 + s[0] + i0 for s in sh]
            same = all(j == j0[0] for j in j0)
            straddles += not same
            v = torch.full((SEG + 1, W), float(fill), dtype=F32)
            for t in range(count + 1):
                if same:  # one W-float load, 8-byte aligned for W = 2
                    assert W == 1 or (ni * win * rc + x) % 2 == 0
                    if 0 <= j0[0] + t < win:
                        v[t] = flat[ni, j0[0] + t, x:x + W]
                else:
                    for w in range(W):
                        if 0 <= j0[w] + t < win:
                            v[t, w] = flat[ni, j0[w] + t, x + w]
            for t in range(count):
                for w in range(W):
                    out[ni, i0 + t, x + w] = combine(sh[w], v[t, w],
                                                     v[t + 1, w])
                    written[ni, i0 + t, x + w] += 1
    assert bool((written == 1).all())
    return out.reshape(n, out_w, R, C), straddles


@pytest.mark.parametrize("case", CASES[:5] + [(2, 9, 30, 2, 6, -6, 26, -1)])
def test_column_mode_walk_matches_plain_version(case):
    n, rows, win, c, kmax, out_x0, out_w, in_x0 = case
    img, d = row_inputs(n, rows, win, c, kmax, rows + win + kmax)
    img = img.transpose(1, 2).contiguous()  # (n, win, rows, c): columns
    want = col_shift_ref(img, d, kmax, out_x0, out_w, in_x0, 128.0)
    assert torch.equal(want, row_shift_ref(
        img.transpose(1, 2), d, kmax, out_x0, out_w, in_x0,
        128.0).transpose(1, 2))
    widths = [1, 2] if rows * c % 2 == 0 else [1]
    for W in widths:
        got, straddles = emulate_col(img, d, kmax, out_x0, out_w, in_x0,
                                     128.0, W)
        assert torch.equal(got, want)
        if W == 2 and c % 2:
            assert straddles  # pairs across two columns' shifts


def test_shear_chain_shapes_take_float2_and_fit_the_grid():
    """At 416 px, rotation 10: pass 2's rows of 438 x 3 floats take the
    float2 path; a row-mode tile fits the shared memory of a block with
    room for 16 of them an SM; the column grid fits 65535 segments."""
    rc = 438 * 3
    assert rc % 2 == 0
    for out_c, c in ((438 * 3, 3), (416 * 3, 3)):
        piece = min(out_c, PIECE)
        stage = 4 * -(-(piece + c + 3) // 4)
        assert 4 * stage * 16 <= 228 * 1024
    assert math.ceil(416 / SEG) <= 65535
