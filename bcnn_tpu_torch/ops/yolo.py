"""YOLOv3 detection head: activation, training deltas, box decode, the
host-side decode + NMS of `bcnn_yolo_get_detections` (numpy) and the
batched on-device decode + NMS of `bcnn_tpu.ops.yolo`.

Heads are NCHW, (N, A*(5+K), H, W), with channel c = a*(5+K) + e
(entry_index, bcnn_yolo.c:207-215). Candidates are flattened in
(location, anchor) order, m = (row*W + col)*A + a, the order
`bcnn_tpu` takes from its NHWC heads, so NMS sees the same rows in both
packages.

Top-k is a stable descending sort: on equal values it puts the lower
index first, as `lax.top_k` does; `torch.topk` does not promise that.
The greedy NMS keeps the reference's semantics (do_nms_obj,
bcnn_yolo.c:511-545): candidates in objectness order, each alive one
suppresses every later one whose IoU with it exceeds 0.45.

A head whose param holds Darknet's `scale_x_y` s (YOLOv4, YOLOv7; the
port's own) centres a box at x = (col + sigmoid(tx) * s - (s - 1) / 2)
/ W, and likewise y. One whose param holds Darknet's `new_coords`
(YOLOv7) takes the logistic of every channel, tw and th too, and sizes
a box without exp: w = 4 * sigmoid(tw)^2 * anchor_w / net_w, likewise
h. The top-k-first decode (`device_detect_topk`) and the host decode
(`decode_layer`) take both; the decode-everything paths (K1 and its
plain version) and the training deltas raise on either (`unscaled`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..profiling import span
from ..types import DETECTION_MAX_BOXES, Mode
from .activations import in_f32, sigmoid

NMS_THRESH = 0.45  # bcnn_yolo.c:626
NOOBJ_IOU_THRESH = 0.5  # bcnn_yolo.c:310


def unscaled(param: Dict, what: str) -> None:
    """Raises ValueError where a head's box centres are scaled
    (scale_x_y != 1) or its boxes take new_coords: `what` has no form
    that decodes them."""
    s = param.get("scale_x_y", 1.0)
    if s != 1.0:
        raise ValueError(f"{what} has no scale_x_y; this head's is {s} "
                         "(the top-k-first detection decodes it)")
    if param.get("new_coords"):
        raise ValueError(f"{what} has no new_coords (the top-k-first "
                         "detection decodes it)")


def yolo_head(x: torch.Tensor, num: int, classes: int) -> torch.Tensor:
    """x: (N, A*(5+K), H, W) raw conv output -> activated head output:
    logistic on (tx, ty) and on (obj, classes), tw/th raw
    (bcnn_yolo.c:226-249)."""
    n, c, h, w = x.shape
    y = x.reshape(n, num, 5 + classes, h, w)
    y = torch.cat(
        [sigmoid(y[:, :, 0:2]), y[:, :, 2:4], sigmoid(y[:, :, 4:])],
        dim=2,
    )
    return y.reshape(n, c, h, w)


def _box_iou(b1, b2):
    """IoU of (x, y, w, h) centre-format boxes, broadcasting (box_iou,
    bcnn_yolo.c:108-135); 0 where the union is not positive."""
    x1, y1, w1, h1 = b1
    x2, y2, w2, h2 = b2
    iw = torch.minimum(x1 + w1 / 2, x2 + w2 / 2) - torch.maximum(
        x1 - w1 / 2, x2 - w2 / 2
    )
    ih = torch.minimum(y1 + h1 / 2, y2 + h2 / 2) - torch.maximum(
        y1 - h1 / 2, y2 - h2 / 2
    )
    inter = torch.where((iw < 0) | (ih < 0), 0.0, iw * ih)
    union = w1 * h1 + w2 * h2 - inter
    return torch.where(union > 0, inter / union, 0.0)


def _decode_grid(y, anchors_wh, mask, net_w, net_h, row0=0, grid_h=None):
    """y: (N,H,W,A,5+K) activated -> boxes (x,y,w,h), each (N,H,W,A)
    (get_yolo_box, bcnn_yolo.c:137-145); y the rows row0 .. row0 + H of
    a grid of grid_h rows (None: H)."""
    _, h, w, _, _ = y.shape
    # fp32, or float64 for a float64 y (tools/f3_float64.py)
    opts = dict(dtype=torch.promote_types(y.dtype, torch.float32),
                device=y.device)
    col = torch.arange(w, **opts).reshape(1, 1, w, 1)
    row = torch.arange(row0, row0 + h, **opts).reshape(1, h, 1, 1)
    aw = torch.tensor([anchors_wh[2 * m] for m in mask], **opts)
    ah = torch.tensor([anchors_wh[2 * m + 1] for m in mask], **opts)
    bx = (col + y[..., 0]) / w
    by = (row + y[..., 1]) / (h if grid_h is None else grid_h)
    bw = in_f32(torch.exp, y[..., 2]) * aw / net_w
    bh = in_f32(torch.exp, y[..., 3]) * ah / net_h
    return bx, by, bw, bh


def yolo_train_deltas(
    y: torch.Tensor,
    label: torch.Tensor,
    param: Dict,
    net_w: int,
    net_h: int,
    with_stats: bool = False,
    rows: Optional[Tuple[int, int]] = None,
):
    """y: (N, A*(5+K), H, W) activated head; label (N, 50*5) flat
    [x, y, w, h, class] per truth. Returns delta in y's layout, with
    dL/d(pre-activation) == delta semantics (bcnn_yolo.c:250-414).

    The one-pass formulation of `bcnn_tpu.ops.yolo.yolo_train_deltas`,
    worked in the (N, H, W, A, 5+K) view so that slot
    pos = (cj*W + ci)*A + a is the JAX package's:
      - noobj: delta_obj = sigmoid_obj, zeroed where the best IoU against
        any truth exceeds 0.5 (:305-312);
      - each truth's best anchor by shape-only IoU over all `total`
        anchors (first max wins); if this layer's mask owns it, box deltas
        scaled by (2 - tw*th), obj delta (obj - 1) and class deltas
        (out - multi-hot of the classes of every owned truth on the same
        slot, delta_yolo_class :187-206);
      - later truths overwrite earlier ones on a slot: the winner is a
        scatter-max of the truth index, with one dummy slot for truths
        the layer does not own;
      - truths end at the first x == 0 (:286-289).

    rows=(row0, grid_h): y holds the grid rows row0 .. row0 + H of a
    head of grid_h rows (a height band of `parallel.model_axis`); the
    boxes decode at their rows of the whole grid, and only the truths
    whose cell lies in the band are assigned, so the bands' deltas are
    the whole head's, row for row.

    with_stats=True also returns the per-batch diagnostics the reference
    prints (bcnn_yolo.c:258-264, 404-414), as 0-d tensors: sums for Avg
    IOU, Class, Obj, No Obj, .5R and .75R, and the count of OWNED
    truths, a truth a later one overwrites included
    (`bcnn_tpu/ops/yolo.py:250-273`).
    """
    unscaled(param, "the YOLO training deltas")
    num, classes = param["num"], param["classes"]
    anchors, mask, total = param["anchors"], param["mask"], param["total"]
    e = 5 + classes
    n, _, h, w = y.shape
    row0, gh = (0, h) if rows is None else rows
    dev = y.device
    yr = y.reshape(n, num, e, h, w).permute(0, 3, 4, 1, 2)  # (N,H,W,A,E)
    T = DETECTION_MAX_BOXES
    label = label.reshape(n, T, 5)

    tx = label[..., 0]
    valid = torch.cumprod((tx != 0).to(torch.float32), dim=1)  # (N,T)

    # ---- noobj deltas ------------------------------------------------ #
    bx, by, bw, bh = _decode_grid(yr, anchors, mask, net_w, net_h,
                                  row0, gh)
    p = (bx[..., None], by[..., None], bw[..., None], bh[..., None])
    tb = tuple(label[:, None, None, None, :, i] for i in range(4))
    ious = _box_iou(p, tb) * valid[:, None, None, None, :]
    best_iou = torch.amax(ious, dim=-1)  # (N,H,W,A)
    delta_obj = torch.where(best_iou > NOOBJ_IOU_THRESH, 0.0, yr[..., 4])

    # ---- per-truth assignment, one pass ------------------------------ #
    opts = dict(dtype=torch.promote_types(y.dtype, torch.float32),
                device=dev)
    anchors_arr = torch.tensor(anchors, **opts).reshape(total, 2)
    mask_arr = torch.tensor(mask, dtype=torch.int64, device=dev)
    txx, tyy, tww, thh = (label[..., i] for i in range(4))  # (N,T)
    tcls = label[..., 4].to(torch.int64)
    pw = anchors_arr[:, 0] / net_w
    ph = anchors_arr[:, 1] / net_h
    zt = torch.zeros((1, 1, total), **opts)
    zn = torch.zeros((n, T, 1), **opts)
    iou_a = _box_iou(
        (zt, zt, pw[None, None], ph[None, None]),
        (zn, zn, tww[..., None], thh[..., None]),
    )  # (N,T,total)
    best_n = torch.argmax(iou_a, dim=-1)  # first max, (N,T)
    eq = mask_arr[None, None, :] == best_n[..., None]  # (N,T,A)
    owned = eq.any(dim=-1) & (valid > 0)
    mask_n = torch.argmax(eq.to(torch.int32), dim=-1)  # first match
    ci = torch.clamp((txx * w).to(torch.int64), 0, w - 1)
    cj = torch.clamp((tyy * gh).to(torch.int64), 0, gh - 1)
    if rows is not None:  # the band's truths; cj from here on local
        owned = owned & (cj >= row0) & (cj < row0 + h)
        cj = torch.clamp(cj - row0, 0, max(h - 1, 0))

    bidx = torch.arange(n, device=dev)[:, None]
    cur = yr[bidx, cj, ci, mask_n]  # (N,T,E)
    aw = anchors_arr[best_n, 0]
    ah = anchors_arr[best_n, 1]
    scale = 2.0 - tww * thh
    dx = -scale * ((txx * w - ci) - cur[..., 0])
    dy = -scale * ((tyy * gh - (cj + row0)) - cur[..., 1])
    dw = -scale * (torch.log(tww * net_w / aw) - cur[..., 2])
    dh = -scale * (torch.log(thh * net_h / ah) - cur[..., 3])
    dobj = cur[..., 4] - 1.0
    # one_hot with jax.nn.one_hot's semantics: an out-of-range class is
    # an all-zero row
    onehot = (
        tcls[..., None] == torch.arange(classes, device=dev)
    ).to(torch.float32)
    hwa = h * w * num
    pos = (cj * w + ci) * num + mask_n  # (N,T)
    pos = torch.where(owned, pos, hwa)
    same_slot = (pos[:, :, None] == pos[:, None, :]) & owned[:, None, :]
    multihot = torch.clamp(
        torch.einsum("ntu,nuk->ntk", same_slot.to(torch.float32), onehot),
        max=1.0,
    )
    dcls = cur[..., 5:] - multihot
    upd = torch.cat(
        [torch.stack([dx, dy, dw, dh, dobj], dim=-1), dcls], dim=-1
    )  # (N,T,E)

    # last writer wins: scatter-max the truth index into the slot map,
    # then scatter only the winning rows
    t_iota = torch.arange(T, device=dev).expand(n, T)
    winner = torch.full((n, hwa + 1), -1, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(1, pos, t_iota, "amax")
    won = torch.gather(winner, 1, pos) == t_iota  # dummy slot holds <= T-1
    won = won & owned
    has_winner = winner[:, :hwa] >= 0
    upd_w = torch.where(won[..., None], upd, 0.0)
    scat = torch.zeros((n, hwa + 1, e), **opts).scatter_add(
        1, pos[..., None].expand(-1, -1, e), upd_w
    )[:, :hwa]
    ch4 = torch.where(has_winner, scat[..., 4], delta_obj.reshape(n, hwa))
    delta = torch.cat([scat[..., :4], ch4[..., None], scat[..., 5:]], dim=-1)
    # (N, H*W*A, E) -> (N, A*E, H, W)
    delta = delta.reshape(n, h, w, num, e).permute(0, 3, 4, 1, 2).reshape(
        n, num * e, h, w
    )
    if not with_stats:
        return delta
    # per owned truth, as the reference's loop accumulates them (:321-398,
    # and the avg_anyobj sweep :313)
    px = (ci + cur[..., 0]) / w
    py = (cj + row0 + cur[..., 1]) / gh
    pw_t = torch.exp(cur[..., 2]) * aw / net_w
    ph_t = torch.exp(cur[..., 3]) * ah / net_h
    iou_t = _box_iou((px, py, pw_t, ph_t), (txx, tyy, tww, thh))
    ow = owned.to(torch.float32)
    # as jnp.take_along_axis reads a class index: a negative one counts
    # from the end, one out of range reads nan
    t = torch.where(tcls < 0, tcls + classes, tcls)
    oob = (t < 0) | (t >= classes)
    cat = torch.gather(cur[..., 5:], -1,
                       t.clamp(0, classes - 1)[..., None])[..., 0]
    cat = torch.where(oob, float("nan"), cat)
    stats = {
        "iou_sum": torch.sum(iou_t * ow),
        "recall50": torch.sum((iou_t > 0.5) * ow),
        "recall75": torch.sum((iou_t > 0.75) * ow),
        "obj_sum": torch.sum(cur[..., 4] * ow),
        "cat_sum": torch.sum(cat * ow),
        "count": torch.sum(ow),
        "anyobj_sum": torch.sum(yr[..., 4]),
        # the reference's static divisor w*h*num*batch (:411-412)
        "n_slots": torch.tensor(float(n * hwa), device=dev),
    }
    return delta, stats


def yolo_forward(
    x: torch.Tensor,
    label: Optional[torch.Tensor],
    param: Dict,
    mode: Mode,
    with_stats: bool = False,
    rows: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """Returns (activated output, aux): aux is None outside TRAIN or
    without a label, else (surrogate, cost) with surrogate
    sum(delta.detach() * x), whose gradient in x is delta, and the
    reported cost sum(delta^2) (bcnn_yolo.c:404-407); with_stats,
    (surrogate, cost, stats) with the cost among the stats. rows: a
    height band's place in its head (`yolo_train_deltas`)."""
    if param.get("new_coords"):  # the logistic of every channel
        y = sigmoid(x)
    else:
        y = yolo_head(x, param["num"], param["classes"])
    if mode != Mode.TRAIN or label is None:
        return y, None
    with torch.no_grad():
        out = yolo_train_deltas(
            y.detach(), label, param, param["net_w"], param["net_h"],
            with_stats=with_stats, rows=rows,
        )
    delta, stats = out if with_stats else (out, None)
    cost = torch.sum(torch.square(delta))
    if with_stats:
        return y, (torch.sum(delta * x), cost, dict(stats, cost=cost))
    return y, (torch.sum(delta * x), cost)


def format_yolo_stats(stats: Dict) -> str:
    """The reference's per-batch stderr line, byte for byte
    (bcnn_yolo.c:408-414): means over the owned-truth count (0/0 gives
    nan, as the C float division does), No Obj over every (cell, anchor)
    slot."""
    cnt = float(stats["count"])
    div = (lambda s: float(s) / cnt) if cnt else (lambda s: float("nan"))
    return (
        "Yolo Avg IOU: %f Class: %f Obj: %f No Obj: %f .5R: %f, "
        ".75R: %f num_boxes: %d cost: %f"
        % (
            div(stats["iou_sum"]),
            div(stats["cat_sum"]),
            div(stats["obj_sum"]),
            float(stats["anyobj_sum"]) / float(stats["n_slots"]),
            div(stats["recall50"]),
            div(stats["recall75"]),
            int(cnt),
            float(stats["cost"]),
        )
    )


# ------------------------------------------------------------------------ #
# host-side post-processing (bcnn_yolo_get_detections), numpy
# ------------------------------------------------------------------------ #


def correct_region_boxes(x, y, w_box, h_box, w, h, netw, neth, relative=1):
    """Letterbox undo (bcnn_yolo.c:470-496), with the reference's integer
    new_w / new_h."""
    if netw / w < neth / h:
        new_w = netw
        new_h = (h * netw) // w
    else:
        new_h = neth
        new_w = (w * neth) // h
    x = (x - (netw - new_w) / 2.0 / netw) / (new_w / netw)
    y = (y - (neth - new_h) / 2.0 / neth) / (new_h / neth)
    w_box = w_box * (netw / new_w)
    h_box = h_box * (neth / new_h)
    if not relative:
        x, w_box = x * w, w_box * w
        y, h_box = y * h, h_box * h
    return x, y, w_box, h_box


def decode_layer(
    y: np.ndarray, param: Dict, net_w: int, net_h: int, thresh: float
) -> List[dict]:
    """One YOLO layer's activated output for one image, y (H, W,
    A*(5+K)) (the NCHW head transposed), to the detections whose
    objectness exceeds thresh: the fill loop of bcnn_yolo_get_detections
    (bcnn_yolo.c:604-639), in (location, anchor) order; a head's
    scale_x_y and new_coords as Darknet's get_yolo_box takes them."""
    h, w, _ = y.shape
    num, classes = param["num"], param["classes"]
    s = param.get("scale_x_y", 1.0)
    new_coords = param.get("new_coords")
    yr = y.reshape(h, w, num, 5 + classes)
    dets = []
    for i in range(h * w):
        row, col = divmod(i, w)
        for a in range(num):
            obj = float(yr[row, col, a, 4])
            if obj <= thresh:
                continue
            m = param["mask"][a]
            bx = (col + float(yr[row, col, a, 0]) * s - (s - 1) / 2) / w
            by = (row + float(yr[row, col, a, 1]) * s - (s - 1) / 2) / h
            tw, th = yr[row, col, a, 2], yr[row, col, a, 3]
            # expf overflows to inf without a warning, as in C
            with np.errstate(over="ignore"):
                sw, sh = ((4 * float(tw) ** 2, 4 * float(th) ** 2)
                          if new_coords
                          else (float(np.exp(tw)), float(np.exp(th))))
            bw = sw * param["anchors"][2 * m] / net_w
            bh = sh * param["anchors"][2 * m + 1] / net_h
            probs = obj * np.asarray(yr[row, col, a, 5:])
            probs = np.where(probs > thresh, probs, 0.0)
            dets.append(dict(x=bx, y=by, w=bw, h=bh, objectness=obj,
                             num_classes=classes, prob=probs))
    return dets


def nms_obj(dets: List[dict], nms_thresh: float = NMS_THRESH) -> List[dict]:
    """Objectness-sorted greedy NMS (do_nms_obj, bcnn_yolo.c:511-545):
    a suppressed box keeps its slot, with objectness 0 and zero probs."""
    dets = sorted(dets, key=lambda d: -d["objectness"])
    for i in range(len(dets)):
        if dets[i]["objectness"] == 0:
            continue
        a = (dets[i]["x"], dets[i]["y"], dets[i]["w"], dets[i]["h"])
        for j in range(i + 1, len(dets)):
            if dets[j]["objectness"] == 0:
                continue
            b = (dets[j]["x"], dets[j]["y"], dets[j]["w"], dets[j]["h"])
            if float(_box_iou_np(a, b)) > nms_thresh:
                dets[j]["objectness"] = 0
                dets[j]["prob"] = np.zeros_like(dets[j]["prob"])
    return dets


def _box_iou_np(a, b):
    """IoU of two (x, y, w, h) centre-format boxes as Python floats."""
    iw = min(a[0] + a[2] / 2, b[0] + b[2] / 2) - max(
        a[0] - a[2] / 2, b[0] - b[2] / 2
    )
    ih = min(a[1] + a[3] / 2, b[1] + b[3] / 2) - max(
        a[1] - a[3] / 2, b[1] - b[3] / 2
    )
    if iw < 0 or ih < 0:
        return 0.0
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def _top_k(v: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along dim 1, ties broken towards the lower index."""
    vals, idx = torch.sort(v, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t: (N, M, E), idx: (N, k) -> (N, k, E)."""
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[2]))


def _greedy_nms_mask(
    bsel: torch.Tensor, valid: torch.Tensor, nms_thresh: float
) -> torch.Tensor:
    """Objectness-ordered greedy suppression over already-sorted boxes
    bsel (N, K, 4): the keep mask (N, K)."""
    x, y, w, h = bsel.unbind(-1)
    iou = _box_iou(
        (x[..., :, None], y[..., :, None], w[..., :, None], h[..., :, None]),
        (x[..., None, :], y[..., None, :], w[..., None, :], h[..., None, :]),
    )
    k = bsel.shape[1]
    with span("bcnn.build.nms_order"):
        later = torch.ones(k, k, dtype=torch.bool,
                           device=bsel.device).triu(1)
    suppress_pair = (iou > nms_thresh) & later  # i suppresses j > i
    alive = valid
    for i in range(k):
        alive = alive & ~(suppress_pair[:, i, :] & alive[:, i : i + 1])
    return alive & valid


def device_decode_nms(
    boxes: torch.Tensor,  # (N, M, 4) xywh relative
    obj: torch.Tensor,  # (N, M)
    cls_probs: torch.Tensor,  # (N, M, K) already multiplied by obj
    max_dets: int = 100,
    thresh: float = 0.5,
    nms_thresh: float = NMS_THRESH,
):
    """Top max_dets candidates by objectness, then greedy NMS. Returns
    (boxes (N,max_dets,4), scores (N,max_dets,K), objectness (N,max_dets));
    suppressed and padded slots have zero scores and objectness."""
    with span("bcnn.heads"):
        m = boxes.shape[1]
        with span("bcnn.select"):
            obj = torch.where(obj > thresh, obj, 0.0)
            if max_dets > m:  # pad with dead candidates
                pad = max_dets - m
                boxes = F.pad(boxes, (0, 0, 0, pad))
                obj = F.pad(obj, (0, pad))
                cls_probs = F.pad(cls_probs, (0, 0, 0, pad))
            topv, topi = _top_k(obj, max_dets)
            bsel = _gather_rows(boxes, topi)
            psel = _gather_rows(cls_probs, topi)
        with span("bcnn.nms"):
            keep = _greedy_nms_mask(bsel, topv > 0, nms_thresh)
        return bsel, psel * keep[..., None], topv * keep


def _candidate_table(meta, device) -> torch.Tensor:
    """(6, M) per-candidate col, row, grid w, grid h, anchor w, anchor h,
    in the (head, location, anchor) order of the flattened heads; where
    a head scales its box centres, (8, M) with each candidate's scale_x_y
    s and -(s - 1) / 2 below them."""
    with span("bcnn.build.candidates"):
        scaled = any(s != 1.0 for *_, s in meta)
        parts = []
        for h, w, num, anchors, mask, s in meta:
            loc = np.arange(h * w)
            aw = np.asarray([anchors[2 * mi] for mi in mask], np.float32)
            ah = np.asarray([anchors[2 * mi + 1] for mi in mask],
                            np.float32)
            m = h * w * num
            rows = [
                np.repeat(loc % w, num),
                np.repeat(loc // w, num),
                np.full(m, w),
                np.full(m, h),
                np.tile(aw, h * w),
                np.tile(ah, h * w),
            ]
            if scaled:
                rows += [np.full(m, s), np.full(m, -0.5 * (s - 1))]
            parts.append(np.stack(rows).astype(np.float32))
        return torch.as_tensor(np.concatenate(parts, axis=1),
                               device=device)


def device_detect_topk(
    heads: List[torch.Tensor],  # raw conv outputs (N, A*(5+K), Hi, Wi)
    head_params: List[Dict],
    net_w: int,
    net_h: int,
    max_dets: int = 100,
    thresh: float = 0.5,
    nms_thresh: float = NMS_THRESH,
):
    """Top-k-first batched detection: select max_dets candidates on the
    raw objectness logits (sigmoid is monotone), then decode and apply
    the class sigmoids to the selected rows only, so the (N, M, K)
    probability tensor is never made. The threshold test runs in sigmoid
    space, as the decode-everything path's `obj > thresh` does, for every
    fp32 rounding at the boundary and for ±inf logits; NaN logits compare
    False and are dropped. Rows are selected with a gather (the `take`
    formulation of `bcnn_tpu.ops.yolo.device_detect_topk`). The heads
    take new_coords all or none (a ValueError otherwise)."""
    with span("bcnn.heads"):
        n = heads[0].shape[0]
        classes = head_params[0]["classes"]
        e = 5 + classes
        new_coords = bool(head_params[0].get("new_coords"))
        if any(bool(p.get("new_coords")) != new_coords
               for p in head_params):
            raise ValueError("the heads mix new_coords and exp boxes")

        with span("bcnn.select"):
            flat_heads, offsets, sizes, meta = [], [], [], []
            off = 0
            for raw, prm in zip(heads, head_params):
                _, _, h, w = raw.shape
                num = prm["num"]
                fh = raw.reshape(n, num, e, h * w).permute(0, 3, 1, 2)
                flat_heads.append(fh.reshape(n, h * w * num, e))
                offsets.append(off)
                sizes.append(h * w * num)
                meta.append((h, w, num, prm["anchors"], prm["mask"],
                             prm.get("scale_x_y", 1.0)))
                off += h * w * num

            objl = torch.cat([fh[..., 4] for fh in flat_heads], dim=1)
            masked = torch.where(sigmoid(objl) > thresh, objl,
                                 float("-inf"))
            k = min(max_dets, masked.shape[1])
            topv_l, topi = _top_k(masked, k)
            valid = topv_l > float("-inf")

            sel = torch.zeros((n, k, e), dtype=flat_heads[0].dtype,
                              device=topi.device)
            for fh, o, m in zip(flat_heads, offsets, sizes):
                local = topi - o
                inr = (local >= 0) & (local < m)
                g = _gather_rows(fh, local.clamp(0, m - 1))
                sel = torch.where(inr[..., None], g, sel)

        with span("bcnn.decode"):
            table = _candidate_table(meta, topi.device)[:, topi]
            csel, rsel, gwsel, ghsel, awsel, ahsel = table[:6]
            sx, sy = sigmoid(sel[..., 0]), sigmoid(sel[..., 1])
            if len(table) > 6:  # scale_x_y: s * sigmoid - (s - 1) / 2
                ssel, osel = table[6:]
                sx, sy = sx * ssel + osel, sy * ssel + osel
            bx = (csel + sx) / gwsel
            by = (rsel + sy) / ghsel
            if new_coords:  # 4 * sigmoid(t)^2, no exp
                sw, sh = sigmoid(sel[..., 2]), sigmoid(sel[..., 3])
                sw, sh = 4 * sw * sw, 4 * sh * sh
            else:
                sw = in_f32(torch.exp, sel[..., 2])
                sh = in_f32(torch.exp, sel[..., 3])
            bw = sw * awsel / net_w
            bh = sh * ahsel / net_h
            bsel = torch.stack([bx, by, bw, bh], dim=-1)
            obj = sigmoid(sel[..., 4]) * valid
            psel = obj[..., None] * sigmoid(sel[..., 5 : 5 + classes])

        with span("bcnn.nms"):
            keep = _greedy_nms_mask(bsel, valid, nms_thresh)
        psel, obj = psel * keep[..., None], obj * keep
        if k < max_dets:  # pad to the requested width with suppressed slots
            pad = max_dets - k
            bsel = F.pad(bsel, (0, 0, 0, pad))
            psel = F.pad(psel, (0, 0, 0, pad))
            obj = F.pad(obj, (0, pad))
        return bsel, psel, obj
