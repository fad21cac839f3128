"""K1's block plan and chunk-to-output map (csrc/yolo_decode.cu), on the
CPU. The CUDA kernel cannot run here, so this file mirrors what it does:
the choice of L (locations a block) and kc (classes staged at once), the
float32 reciprocal division it uses in place of integer division, each
thread's staged rows and location, the channel each staged row reads,
and where each block writes its boxes, objectness and probabilities
(the last as aligned float4s with a scalar head and tail, or, with the
classes in chunks, as scalars). A staged value is the plain version's
own elementwise result for that (image, channel, location), so the
emulation must equal `decode_grid_ref` bit for bit, every output written
exactly once. Imports no JAX."""

import pytest
import torch

from bcnn_tpu_torch.ops.yolo import yolo_head
from bcnn_tpu_torch.ops.yolo_decode import decode_grid_ref

torch.set_num_threads(1)

F32 = torch.float32
# csrc/yolo_decode.cu
THREADS, SMEM_FLOATS = 256, 12 * 1024
SMS = 132  # H100 SXM
ANCHORS = [10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319] + [
    float(v) for v in range(20, 40)]


def plan(n, num, classes, hw, sms=SMS):
    """(lg, kc): L = 2^lg locations a block, kc classes staged at once,
    as bcnn_yolo_decode chooses them."""
    rows = num * (5 + classes)
    lg = 4 if n * -(-hw // 16) >= 2 * sms else 3
    while lg > 0 and rows * ((1 << lg) + 1) > SMEM_FLOATS:
        lg -= 1
    p = (1 << lg) + 1
    kc = classes if rows * p <= SMEM_FLOATS else SMEM_FLOATS // (num * p) - 5
    return lg, kc


def div_small(v, d):
    """The kernel's floor(v / d): (v + 0.5) * (1/d) in float32, truncated;
    it must equal integer division."""
    vf = torch.as_tensor(v).to(F32)
    inv = torch.tensor(1.0, dtype=F32) / torch.tensor(float(d), dtype=F32)
    q = ((vf + 0.5) * inv).to(torch.int64)
    assert torch.equal(q, torch.as_tensor(v) // d)
    return q


def staged_values(x, p, net_w, net_h):
    """V (N, A, 5+K, H*W): what the kernel stores for each input, from
    the plain version's elementwise tensors (box coordinates finished,
    exps of tw/th taken as `_decode_grid` takes them)."""
    n, _, h, w = x.shape
    num, k = p["num"], p["classes"]
    y = yolo_head(x, num, k).reshape(n, num, 5 + k, h, w)
    yp = y.permute(0, 3, 4, 1, 2)  # (N, H, W, A, 5+K)
    aw = torch.tensor([p["anchors"][2 * m] for m in p["mask"]], dtype=F32)
    ah = torch.tensor([p["anchors"][2 * m + 1] for m in p["mask"]],
                      dtype=F32)
    col = torch.arange(w, dtype=F32).reshape(1, 1, w, 1)
    row = torch.arange(h, dtype=F32).reshape(1, h, 1, 1)
    v = yp.clone()
    v[..., 0] = (col + yp[..., 0]) / w
    v[..., 1] = (row + yp[..., 1]) / h
    v[..., 2] = torch.exp(yp[..., 2]) * aw / net_w
    v[..., 3] = torch.exp(yp[..., 3]) * ah / net_h
    return v.permute(0, 3, 4, 1, 2).reshape(n, num, 5 + k, h * w)


def emulate(x, p, net_w, net_h, sms=SMS, pbase=0):
    """The kernel's outputs, block by block from the staged floats alone;
    probs lies `pbase` floats past a 16-byte boundary."""
    n, _, h, w = x.shape
    A, K = p["num"], p["classes"]
    E, hw = 5 + K, h * w
    lg, kc = plan(n, A, K, hw, sms)
    L, P = 1 << lg, (1 << lg) + 1
    assert A * (5 + min(kc, K)) * P <= SMEM_FLOATS and L <= THREADS
    V = staged_values(x, p, net_w, net_h).reshape(n, A * E, hw)
    nan = float("nan")
    boxes = torch.full((n * hw * A, 4), nan, dtype=F32)
    obj = torch.full((n * hw * A,), nan, dtype=F32)
    probs = torch.full((n * hw * A * K,), nan, dtype=F32)
    w_box = torch.zeros(boxes.shape, dtype=torch.int32)
    w_obj = torch.zeros(obj.shape, dtype=torch.int32)
    w_prob = torch.zeros(probs.shape, dtype=torch.int32)
    tid = torch.arange(THREADS)
    lane, step = tid & (L - 1), THREADS >> lg
    chunks = -(-hw // L)
    for blk in range(n * chunks):
        nb, ci = divmod(blk, chunks)
        loc0 = ci * L
        lb = min(L, hw - loc0)
        m0 = (nb * hw + loc0) * A
        sm = torch.full((A * (5 + min(kc, K)) * P,), nan, dtype=F32)

        def stage(first, last, k0, kn):
            # thread t stages rows first + (t >> lg) + j*step at location
            # lane(t): every (row, location) once
            rows = [torch.arange(first + (t >> lg), last, step)
                    for t in range(THREADS)]
            cnt = torch.tensor([len(r) for r in rows])
            row = torch.cat(rows)
            loc = torch.repeat_interleave(lane, cnt)
            slot = row * P + loc
            assert slot.unique().numel() == slot.numel() == (last - first) * L
            box = row < A * 5
            a_box = row // 5
            r = torch.clamp(row - A * 5, min=0)
            a_cls = div_small(r, kn) if kn else r
            ch = torch.where(box, a_box * E + row - a_box * 5,
                             a_cls * E + 5 + k0 + r - a_cls * kn)
            live = loc < lb
            sm[slot[live]] = V[nb, ch[live], loc0 + loc[live]]
            sm[slot[~live]] = nan  # the kernel's dead lanes: never read

        def prob(cq, kk, kn):
            l = div_small(cq, A)
            a = cq - l * A
            return sm[(a * 5 + 4) * P + l] * sm[(A * 5 + a * kn + kk) * P + l]

        def write_probs(k0, kn):
            if kn < K:  # scalars, runs of kn floats K apart
                q = torch.arange(lb * A * kn)
                cq = div_small(q, kn)
                dst = (m0 + cq) * K + k0 + q - cq * kn
                probs[dst] = prob(cq, q - cq * kn, kn)
                w_prob[dst] += 1
                return
            ln = lb * A * K
            oh = min((4 - (pbase + m0 * K) % 4) % 4, ln)
            nvec = (ln - oh) // 4
            e_vec = oh + 4 * torch.arange(nvec)
            assert bool(((pbase + m0 * K + e_vec) % 4 == 0).all())
            e = torch.cat([torch.arange(oh), torch.arange(oh + 4 * nvec, ln),
                           (e_vec[:, None] + torch.arange(4)).reshape(-1)])
            cq = div_small(e, K)
            probs[m0 * K + e] = prob(cq, e - cq * K, K)
            w_prob[m0 * K + e] += 1

        kn = min(kc, K)
        stage(0, A * (5 + kn), 0, kn)
        q = torch.arange(lb * A)
        l = div_small(q, A)
        s = (q - l * A) * 5 * P + l
        boxes[m0 + q] = torch.stack([sm[s + c * P] for c in range(4)], -1)
        obj[m0 + q] = sm[s + 4 * P]
        w_box[m0 + q] += 1
        w_obj[m0 + q] += 1
        if kn > 0:
            write_probs(0, kn)
        k0 = kn
        while k0 < K:
            kn = min(kc, K - k0)
            stage(A * 5, A * (5 + kn), k0, kn)
            write_probs(k0, kn)
            k0 += kn
    for cnt in (w_box, w_obj, w_prob):
        assert bool((cnt == 1).all())
    return (boxes.reshape(n, hw * A, 4), obj.reshape(n, hw * A),
            probs.reshape(n, hw * A, K))


@pytest.mark.parametrize(
    "n,classes,h,w,mask,pbase",
    [(8, 80, 13, 13, [3, 4, 5], 0),        # the path's heads at batch 8
     (8, 80, 26, 26, [0, 1, 2], 0),
     (3, 7, 7, 11, [1, 3, 5], 1),          # K = 7: probs rows off 16 bytes
     (2, 80, 7, 11, [4], 2),               # 1 anchor, partial last chunk
     (1, 7, 5, 9, list(range(16)), 3),     # 16 anchors
     (5, 90, 3, 3, list(range(16)), 0),    # 16 anchors: L cut to 4
     (1, 1000, 1, 3, list(range(16)), 0),  # classes staged 379 at a time
     (300, 2, 4, 4, [0, 1, 2], 1)],        # 16 locations, a block an image
)
def test_block_map_matches_plain_version(n, classes, h, w, mask, pbase):
    gen = torch.Generator().manual_seed(n * h * w + classes)
    x = 4 * torch.randn(n, len(mask) * (5 + classes), h, w, generator=gen)
    p = dict(num=len(mask), classes=classes, mask=mask, anchors=ANCHORS)
    got = emulate(x, p, 416, 416, pbase=pbase)
    for g, r in zip(got, decode_grid_ref(x, p, 416, 416)):
        assert g.shape == r.shape and torch.equal(g, r)


def test_plan_at_the_path_shapes():
    """YOLOv3-tiny's heads at batch 8: well over 32 blocks each, every
    class in one stage within 48 KB."""
    for hw, blocks, L in ((169, 176, 8), (676, 344, 16)):
        lg, kc = plan(8, 3, 80, hw)
        assert (1 << lg, kc) == (L, 80)
        assert 8 * -(-hw // L) == blocks
        assert 3 * 85 * (L + 1) * 4 <= 48 * 1024
    assert plan(5, 16, 90, 9) == (2, 90)
    assert plan(1, 16, 1000, 3) == (0, 379)


def test_div_small_is_exact_below_2_22():
    v = torch.cat([torch.arange(0, 70000),
                   torch.randint(0, 2**22, (200000,),
                                 generator=torch.Generator().manual_seed(0))])
    for d in (1, 2, 3, 5, 7, 16, 80, 85, 240, 379, 1000, 6139):
        div_small(v, d)
