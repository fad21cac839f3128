"""K6's launch plan and walk (csrc/bn_act.cu), on the CPU. The CUDA
kernel cannot run here, so this file mirrors what it does: the
launcher's runs of whole images (under 2^31 values each), each run's
scalar head, whole 16-byte vectors and scalar tail (all scalars where x
and y are not equally aligned) and its grid; the multiply-high divider
it takes for (i / HW) % C; each vector's channel, taken once where the
vector lies in one plane and value by value where it straddles planes;
and its arithmetic, one fp32 op a step rounded to x's dtype (MISH: the
BN's rounded value taken through torch's mish in fp32, rounded once). The
channels-last form likewise: its plan (16-byte vectors of whole channel
groups where C is a multiple of the vector, x and y are aligned and the
shared table of constants fits, else one value a thread), each vector's
channels (v % (C / V)) and each value's (i % C) by the dividers. The
emulation must write every value exactly once and equal `bn_act_ref`
bit for bit. Imports no JAX."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bcnn_tpu_torch.ops.activations import LRELU_SLOPE
from bcnn_tpu_torch.ops.bn_act import bn_act_ref
from bcnn_tpu_torch.ops.norm import EPS
from bcnn_tpu_torch.types import Activation

torch.set_num_threads(1)

F32 = torch.float32
# csrc/bn_act.cu
THREADS = 256
INT_MAX = 2**31 - 1
SMS = 132  # H100 SXM


def divider(d):
    """make_divider: (m, s) with floor(n / d) = (umulhi(n, m) + n) >> s."""
    s = 0
    while s < 32 and (1 << s) < d:
        s += 1
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    assert 0 < m < 2**32
    return m, s


def div(n, ms):
    """Divider::div on uint32 n (numpy uint64 arrays or ints); the sum
    stays under 2^32."""
    m, s = ms
    n = np.asarray(n, dtype=np.uint64)
    t = (n * np.uint64(m)) >> np.uint64(32)
    assert np.all(t + n < np.uint64(2**32))
    return (t + n) >> np.uint64(s)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 13, 169, 255, 676, 1024,
                               173056, 2**20 + 1, 2**30, 2**31 - 1])
def test_divider_is_integer_division(d):
    ms = divider(d)
    rng = np.random.RandomState(d % 1000)
    n = np.concatenate([
        np.arange(0, min(3 * d + 3, 5000), dtype=np.uint64),
        np.array([d - 1, d, d + 1, 2 * d - 1, 2 * d, INT_MAX - 1, INT_MAX],
                 dtype=np.uint64) % np.uint64(2**31),
        rng.randint(0, 2**31, 20000).astype(np.uint64),
    ])
    assert np.array_equal(div(n, ms), n // np.uint64(d))


def plan(n, c, hw, esize, x_off, limit=INT_MAX, resident=5):
    """bcnn_bn_act's launches: [(first value, values, head, nvec,
    straddles, blocks)] for x starting x_off bytes past a 16-byte
    boundary and y on one; `limit` stands for INT_MAX (a smaller one
    makes several runs), `resident` for the blocks an SM holds."""
    image = c * hw
    assert image <= limit
    run = limit // image
    vec = 16 // esize
    out = []
    for i0 in range(0, n, run):
        first = i0 * image
        cnt = min(run, n - i0) * image
        ax, ay = (x_off + first * esize) % 16, (first * esize) % 16
        if ax != ay:
            head, nvec = cnt, 0
        else:
            head = min(((16 - ax) % 16) // esize, cnt)
            nvec = (cnt - head) // vec
        straddles = hw % vec != 0 or head != 0
        work = max(nvec, cnt - nvec * vec)
        blocks = max(1, min(-(-work // THREADS), SMS * resident))
        out.append((first, cnt, head, nvec, straddles, blocks))
    return out


def block_runs(nvec, blocks):
    """Each block's run of vectors [lo, hi): equal to within one."""
    runs = [(nvec * b // blocks, nvec * (b + 1) // blocks)
            for b in range(blocks)]
    sizes = [hi - lo for lo, hi in runs]
    assert max(sizes) - min(sizes) <= 1
    return runs


def channel(i, hw, c):
    """(r, ch) of values i by the kernel's dividers."""
    by_hw, by_c = divider(hw), divider(c)
    i = np.asarray(i, dtype=np.uint64)
    plane = div(i, by_hw)
    r = (i - plane * np.uint64(hw)).astype(np.int64)
    return r, (plane - div(plane, by_c) * np.uint64(c)).astype(np.int64)


def walk(cnt, head, nvec, straddles, blocks, hw, c, vec):
    """(value index, channel, in a vector?) of every value a launch
    writes, in the kernel's way: each block's run of vectors, each
    vector's channel by the dividers, its values past the plane's end
    (split) in the next channel, or, for planes shorter than a vector,
    value by value; the scalars by the dividers one by one."""
    idx, chan, vecs = [], [], []
    for lo, hi in block_runs(nvec, blocks):
        i = head + np.arange(lo, hi, dtype=np.int64) * vec
        r, ch = channel(i, hw, c)
        nxt = np.where(ch + 1 == c, 0, ch + 1)
        if hw >= vec:
            split = np.where(straddles & (r + vec > hw), hw - r, vec)
            assert straddles or np.all(r + vec <= hw)
            for j in range(vec):
                idx.append(i + j)
                chan.append(np.where(j < split, ch, nxt))
        else:  # walked: the next channel at each plane's end
            for j in range(vec):
                wrap = r == hw
                r = np.where(wrap, 0, r)
                ch = np.where(wrap, np.where(ch + 1 == c, 0, ch + 1), ch)
                idx.append(i + j)
                chan.append(ch.copy())
                r = r + 1
        vecs += [hw >= vec] * (vec * (hi - lo))
    body_end = head + nvec * vec
    e = np.concatenate([np.arange(head), np.arange(body_end, cnt)])
    idx.append(e.astype(np.int64))
    chan.append(channel(e, hw, c)[1])
    vecs += [False] * len(e)
    idx = np.concatenate(idx) if idx else np.zeros(0, np.int64)
    return idx, np.concatenate(chan), np.array(vecs, dtype=bool)


def r(t, dtype):
    """Round fp32 values to dtype and back (__float2bfloat16_rn)."""
    return t.to(dtype).to(F32)


def rn_bf16(v):
    """float64 values rounded once to bf16 (to nearest, ties to even, with
    bf16's subnormals and overflow), as a bf16x2 op rounds its exact
    result; float64 holds the exact products and sums met here."""
    v = v.numpy()
    with np.errstate(invalid="ignore", over="ignore"):
        _, e = np.frexp(v)
        q = np.ldexp(1.0, np.maximum(e, -125) - 8)  # bf16's spacing
        out = np.rint(v / q) * q
        out = np.where(np.abs(out) >= 2.0**128, np.sign(v) * np.inf, out)
    out = np.where(np.isfinite(v), out, v)
    return torch.from_numpy(out)


def kernel_values(xf, ch, vecs, dtype, folded, act, pairs):
    """The kernel's arithmetic on fp32 values xf whose channels are ch:
    one fp32 op a step rounded to dtype, or, for bf16 `pairs` (the
    vectors' bf16x2 ops), the exact result rounded once."""
    s, b, m, v = vecs
    # the launcher's eps and slope: in dtype, as the plain version's
    eps, slope = (float(torch.tensor(c, dtype=dtype))
                  for c in (EPS, LRELU_SLOPE))
    k = {"s": r(s[ch], dtype), "b": r(b[ch], dtype)}
    if pairs:
        f64 = torch.float64
        t, ks, kb = xf.to(f64), k["s"].to(f64), k["b"].to(f64)
        op = lambda a: rn_bf16(a)  # noqa: E731
    else:
        t, ks, kb = xf, k["s"], k["b"]
        op = lambda a: r(a, dtype)  # noqa: E731
    if folded:
        t = op(op(t * ks) + kb)
    else:
        mm = r(m[ch], dtype).to(t.dtype)
        inv = r(torch.rsqrt(r(r(v[ch], dtype) + torch.tensor(eps, dtype=F32),
                              dtype)), dtype).to(t.dtype)
        t = op(t - mm)
        t = op(t * inv)
        t = op(t * ks)
        t = op(t + kb)
    if act == Activation.RELU:
        t = torch.where(torch.isnan(t), t, torch.clamp_min(t, 0.0))
    elif act == Activation.LRELU:
        t = torch.where(t > 0, t, op(torch.tensor(slope, dtype=t.dtype) * t))
    return t.to(F32)


# the activations the emulation takes after the walk, on the whole output
LAST = {Activation.MISH: F.mish, Activation.SWISH: F.silu}


def emulate(x, vecs, folded, act, x_off=0, limit=INT_MAX, resident=5):
    """K6's output, launch by launch, from the plan, the walk and the
    arithmetic; asserts every value is written once. MISH and SWISH
    are taken last, over the whole output at once: torch's CPU mish and
    silu round their vectorised body and their scalar tail apart, and
    the kernel's are the card's. So a MISH or SWISH case here checks
    the walk and the BN before it, not the kernel's Mish or Swish
    arithmetic (`x * tanhf(log1pf(expf(x)))`, `x / (1 + expf(-x))` in
    fp32): that is held bit for bit only on the card, by
    tests/test_torch_cuda.py::test_k6_mish_matches_plain_ops_at_every_yolov4_bn_shape,
    ::test_k6_swish_matches_silu_at_every_yolov7_bn_shape and
    chip_smoke.py's phase 3f at batch 64."""
    n, c, h, w = x.shape
    hw, esize = h * w, x.element_size()
    bf16 = x.dtype == torch.bfloat16
    flat = x.reshape(-1).to(F32)
    out = torch.full_like(flat, float("nan"))
    written = np.zeros(flat.numel(), dtype=np.int64)
    for first, cnt, head, nvec, straddles, blocks in plan(
            n, c, hw, esize, x_off, limit, resident):
        idx, ch, in_vec = walk(cnt, head, nvec, straddles, blocks, hw, c,
                               16 // esize)
        g = first + idx
        np.add.at(written, g, 1)
        for part, pairs in ((in_vec, bf16), (~in_vec, False)):
            gi = torch.from_numpy(g[part])
            out[gi] = kernel_values(
                flat[gi], torch.from_numpy(ch[part]), vecs, x.dtype,
                folded, Activation.NONE if act in LAST else act, pairs)
    assert np.all(written == 1)
    if act in LAST:  # in fp32 on the rounded BN, rounded once
        out = LAST[act](out)
    return out.to(x.dtype).view(x.shape)


def inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = 3 * torch.randn(shape, generator=g)
    x.view(-1)[:4] = torch.tensor([float("nan"), -0.0, float("inf"),
                                   -float("inf")])
    vecs = (torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g),
            torch.randn(c, generator=g), torch.rand(c, generator=g) * 2)
    return x.to(dtype), vecs


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


# (shape, x's offset from a 16-byte boundary in bytes, limit, blocks an
# SM holds)
CASES = [
    ((2, 3, 13, 13), 0, INT_MAX, 5),    # HW 169: vectors straddle planes
    ((1, 255, 26, 26), 0, INT_MAX, 5),  # HW 676 = 4 mod 8
    ((2, 1024, 13, 13), 0, INT_MAX, 1),  # runs of several rounds a block
    ((2, 64, 16, 16), 0, INT_MAX, 1),   # no vector straddles
    ((3, 7, 1, 1), 0, INT_MAX, 5),      # a plane of one value
    ((2, 1, 3, 1), 0, INT_MAX, 5),      # C 1, planes shorter than a vector
    ((2, 5, 2, 3), 0, INT_MAX, 5),
    ((2, 3, 13, 13), 4, INT_MAX, 5),    # x not aligned with y: all scalars
    ((5, 3, 5, 7), 0, 3 * 35 * 2, 5),   # runs of 2 images, the second and
                                        # third off a boundary: heads
    ((4, 16, 4, 4), 0, 16 * 16, 5),     # runs of one image, aligned
]


@pytest.mark.parametrize("act", [Activation.NONE, Activation.RELU,
                                 Activation.LRELU, Activation.MISH,
                                 Activation.SWISH])
@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, F32])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_emulated_kernel_equals_plain_version(case, dtype, folded, act):
    shape, off, limit, resident = CASES[case]
    x, vecs = inputs(shape, dtype, seed=case)
    got = emulate(x, vecs, folded, act, off, limit, resident)
    want = bn_act_ref(x, *vecs, folded, act)
    # a NaN's bits are the hardware's (the CPU's vector casts keep its
    # sign; the card's __float2bfloat16_rn gives one NaN): NaN for NaN
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(bits(got)[~nan], bits(want)[~nan])


def test_plan_at_yolov3_shapes():
    """Full YOLOv3 416's largest and smallest BN outputs at batch 64, bf16:
    one launch each, 16-byte vectors throughout, one wave of resident
    blocks; no vector straddles at 416 x 416, some do at 13 x 13; a batch
    past 2^31 values takes a second launch, off a 16-byte boundary by a
    whole number of values."""
    n = 64 * 32 * 416 * 416
    assert plan(64, 32, 416 * 416, 2, 0) == [(0, n, 0, n // 8, False,
                                              SMS * 5)]
    (small,) = plan(64, 1024, 169, 2, 0)
    assert small[2:5] == (0, 64 * 1024 * 169 // 8, True)
    two = plan(720, 3, 999 * 1001, 2, 0)
    assert len(two) == 2 and two[1][2] == 1 and two[1][4]


# -- the channels-last form (bn_act_kernel_nhwc) ----------------------- #

TABLE_BYTES = 48 * 1024  # kTableKb


def plan_nhwc(n, c, hw, esize, x_off, folded, limit=INT_MAX, resident=5):
    """bcnn_bn_act's launches for a channels-last x: [(first value,
    values, nvec, blocks)]; vectors (the whole run in them) where c is a
    multiple of the vector, x and y lie on 16-byte boundaries and the
    table of c channels' constants fits, else one value a thread."""
    image = c * hw
    assert image <= limit
    run = limit // image
    vec = 16 // esize
    table = (2 if folded else 4) * c * esize
    out = []
    for i0 in range(0, n, run):
        first = i0 * image
        cnt = min(run, n - i0) * image
        ax, ay = (x_off + first * esize) % 16, (first * esize) % 16
        ok = c % vec == 0 and table <= TABLE_BYTES and ax == ay == 0
        nvec = cnt // vec if ok else 0
        work = nvec or cnt
        blocks = max(1, min(-(-work // THREADS), SMS * resident))
        out.append((first, cnt, nvec, blocks))
    return out


def walk_nhwc(cnt, nvec, blocks, c, vec):
    """(value index, channel, in a vector?) of every value a channels-last
    launch writes: each block's run of vectors, vector v holding channels
    [vec * j, vec * j + vec), j = v % (c / vec) by the divider; or every
    value alone, its channel e % c by the divider."""
    if not nvec:
        e = np.arange(cnt, dtype=np.int64)
        ch = e - div(e, divider(c)).astype(np.int64) * c
        return e, ch, np.zeros(cnt, dtype=bool)
    assert nvec * vec == cnt  # no scalars: c is a multiple of vec
    cv = c // vec
    idx, chan = [], []
    for lo, hi in block_runs(nvec, blocks):
        v = np.arange(lo, hi, dtype=np.int64)
        j = v - div(v, divider(cv)).astype(np.int64) * cv
        for k in range(vec):
            idx.append(v * vec + k)
            chan.append(j * vec + k)
    return (np.concatenate(idx), np.concatenate(chan),
            np.ones(cnt, dtype=bool))


def emulate_nhwc(x, vecs, folded, act, x_off=0, limit=INT_MAX, resident=5):
    """K6's channels-last form on x (NCHW shape, any strides: its values
    are taken in NHWC order), launch by launch; MISH and SWISH last, as
    in `emulate`. Returns y with x's shape, channels-last."""
    n, c, h, w = x.shape
    hw, esize = h * w, x.element_size()
    bf16 = x.dtype == torch.bfloat16
    flat = x.permute(0, 2, 3, 1).reshape(-1).to(F32)
    out = torch.full_like(flat, float("nan"))
    written = np.zeros(flat.numel(), dtype=np.int64)
    for first, cnt, nvec, blocks in plan_nhwc(n, c, hw, esize, x_off,
                                              folded, limit, resident):
        idx, ch, in_vec = walk_nhwc(cnt, nvec, blocks, c, 16 // esize)
        g = first + idx
        np.add.at(written, g, 1)
        for part, pairs in ((in_vec, bf16), (~in_vec, False)):
            gi = torch.from_numpy(g[part])
            out[gi] = kernel_values(
                flat[gi], torch.from_numpy(ch[part]), vecs, x.dtype,
                folded, Activation.NONE if act in LAST else act, pairs)
    assert np.all(written == 1)
    if act in LAST:
        out = LAST[act](out)
    return out.to(x.dtype).view(n, h, w, c).permute(0, 3, 1, 2)


# (shape, x's offset from a 16-byte boundary in bytes, limit, blocks an
# SM holds)
CASES_NHWC = [
    ((2, 16, 13, 13), 0, INT_MAX, 5),     # C a multiple of 8: vectors
    ((2, 1024, 13, 13), 0, INT_MAX, 1),   # a 16 KB table at fp32, rounds
    ((3, 3, 5, 7), 0, INT_MAX, 5),        # C 3: one value a thread
    ((2, 12, 3, 3), 0, INT_MAX, 5),       # vectors in fp32, not in bf16
    ((1, 4096, 2, 2), 0, INT_MAX, 5),     # fp32 unfolded: past 48 KB
    ((2, 16, 13, 13), 4, INT_MAX, 5),     # x not aligned with y
    ((5, 8, 5, 7), 0, 8 * 35 * 2, 5),     # runs of 2 images, aligned
    ((3, 5, 3, 3), 0, 5 * 9, 5),          # runs of one image, C 5
]


@pytest.mark.parametrize("act", [Activation.NONE, Activation.RELU,
                                 Activation.LRELU, Activation.MISH,
                                 Activation.SWISH])
@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, F32])
@pytest.mark.parametrize("case", range(len(CASES_NHWC)))
def test_emulated_channels_last_form_equals_plain_version(case, dtype,
                                                          folded, act):
    shape, off, limit, resident = CASES_NHWC[case]
    x, vecs = inputs(shape, dtype, seed=100 + case)
    x = x.contiguous(memory_format=torch.channels_last)
    got = emulate_nhwc(x, vecs, folded, act, off, limit, resident)
    want = bn_act_ref(x, *vecs, folded, act)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(bits(got)[~nan], bits(want)[~nan])


def test_plan_nhwc_at_yolov4_shapes():
    """YOLOv4 608's largest BN output and its 1,024-channel one at batch
    64, bf16, BN unfolded: one launch each, all of it in 16-byte vectors
    (an 8 KB table at C 1,024); C 3 at any size goes one value a thread;
    a batch past 2^31 values takes a second launch, still on a 16-byte
    boundary where C is a multiple of 8."""
    n = 64 * 32 * 608 * 608
    assert plan_nhwc(64, 32, 608 * 608, 2, 0, False) == [
        (0, n, n // 8, SMS * 5)]
    (small,) = plan_nhwc(64, 1024, 19 * 19, 2, 0, False)
    assert small[2] == small[1] // 8
    assert plan_nhwc(2, 3, 169, 2, 0, False)[0][2] == 0
    two = plan_nhwc(2, 8, 16384 * 8193, 2, 0, False)
    assert len(two) == 2 and all(p[2] == p[1] // 8 for p in two)
