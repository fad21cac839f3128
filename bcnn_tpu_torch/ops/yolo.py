"""YOLOv3 detection head in PREDICT: activation, box decode and the
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
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..types import Mode

NMS_THRESH = 0.45  # bcnn_yolo.c:626


def yolo_head(x: torch.Tensor, num: int, classes: int) -> torch.Tensor:
    """x: (N, A*(5+K), H, W) raw conv output -> activated head output:
    logistic on (tx, ty) and on (obj, classes), tw/th raw
    (bcnn_yolo.c:226-249)."""
    n, c, h, w = x.shape
    y = x.reshape(n, num, 5 + classes, h, w)
    y = torch.cat(
        [torch.sigmoid(y[:, :, 0:2]), y[:, :, 2:4], torch.sigmoid(y[:, :, 4:])],
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


def _decode_grid(y, anchors_wh, mask, net_w, net_h):
    """y: (N,H,W,A,5+K) activated -> boxes (x,y,w,h), each (N,H,W,A)
    (get_yolo_box, bcnn_yolo.c:137-145)."""
    _, h, w, _, _ = y.shape
    opts = dict(dtype=torch.float32, device=y.device)
    col = torch.arange(w, **opts).reshape(1, 1, w, 1)
    row = torch.arange(h, **opts).reshape(1, h, 1, 1)
    aw = torch.tensor([anchors_wh[2 * m] for m in mask], **opts)
    ah = torch.tensor([anchors_wh[2 * m + 1] for m in mask], **opts)
    bx = (col + y[..., 0]) / w
    by = (row + y[..., 1]) / h
    bw = torch.exp(y[..., 2]) * aw / net_w
    bh = torch.exp(y[..., 3]) * ah / net_h
    return bx, by, bw, bh


def yolo_forward(
    x: torch.Tensor, label: Optional[torch.Tensor], param: Dict, mode: Mode
) -> torch.Tensor:
    """The head's forward outside training: the activated output."""
    if mode == Mode.TRAIN and label is not None:
        raise NotImplementedError(
            "YOLO training deltas are not ported to bcnn_tpu_torch yet"
        )
    return yolo_head(x, param["num"], param["classes"])


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
    later = torch.ones(k, k, dtype=torch.bool, device=bsel.device).triu(1)
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
    m = boxes.shape[1]
    obj = torch.where(obj > thresh, obj, 0.0)
    if max_dets > m:  # pad with dead candidates
        pad = max_dets - m
        boxes = F.pad(boxes, (0, 0, 0, pad))
        obj = F.pad(obj, (0, pad))
        cls_probs = F.pad(cls_probs, (0, 0, 0, pad))
    topv, topi = _top_k(obj, max_dets)
    bsel = _gather_rows(boxes, topi)
    psel = _gather_rows(cls_probs, topi)
    keep = _greedy_nms_mask(bsel, topv > 0, nms_thresh)
    return bsel, psel * keep[..., None], topv * keep


def _candidate_table(meta, device) -> torch.Tensor:
    """(6, M) per-candidate col, row, grid w, grid h, anchor w, anchor h,
    in the (head, location, anchor) order of the flattened heads."""
    parts = []
    for h, w, num, anchors, mask in meta:
        loc = np.arange(h * w)
        aw = np.asarray([anchors[2 * mi] for mi in mask], np.float32)
        ah = np.asarray([anchors[2 * mi + 1] for mi in mask], np.float32)
        m = h * w * num
        parts.append(
            np.stack(
                [
                    np.repeat(loc % w, num),
                    np.repeat(loc // w, num),
                    np.full(m, w),
                    np.full(m, h),
                    np.tile(aw, h * w),
                    np.tile(ah, h * w),
                ]
            ).astype(np.float32)
        )
    return torch.as_tensor(np.concatenate(parts, axis=1), device=device)


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
    formulation of `bcnn_tpu.ops.yolo.device_detect_topk`)."""
    n = heads[0].shape[0]
    classes = head_params[0]["classes"]
    e = 5 + classes

    flat_heads, offsets, sizes, meta = [], [], [], []
    off = 0
    for raw, prm in zip(heads, head_params):
        _, _, h, w = raw.shape
        num = prm["num"]
        fh = raw.reshape(n, num, e, h * w).permute(0, 3, 1, 2)
        flat_heads.append(fh.reshape(n, h * w * num, e))
        offsets.append(off)
        sizes.append(h * w * num)
        meta.append((h, w, num, prm["anchors"], prm["mask"]))
        off += h * w * num

    objl = torch.cat([fh[..., 4] for fh in flat_heads], dim=1)
    masked = torch.where(torch.sigmoid(objl) > thresh, objl, float("-inf"))
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
    csel, rsel, gwsel, ghsel, awsel, ahsel = _candidate_table(
        meta, topi.device
    )[:, topi]

    bx = (csel + torch.sigmoid(sel[..., 0])) / gwsel
    by = (rsel + torch.sigmoid(sel[..., 1])) / ghsel
    bw = torch.exp(sel[..., 2]) * awsel / net_w
    bh = torch.exp(sel[..., 3]) * ahsel / net_h
    bsel = torch.stack([bx, by, bw, bh], dim=-1)
    obj = torch.sigmoid(sel[..., 4]) * valid
    psel = obj[..., None] * torch.sigmoid(sel[..., 5 : 5 + classes])

    keep = _greedy_nms_mask(bsel, valid, nms_thresh)
    psel, obj = psel * keep[..., None], obj * keep
    if k < max_dets:  # pad to the requested width with suppressed slots
        pad = max_dets - k
        bsel = F.pad(bsel, (0, 0, 0, pad))
        psel = F.pad(psel, (0, 0, 0, pad))
        obj = F.pad(obj, (0, pad))
    return bsel, psel, obj
