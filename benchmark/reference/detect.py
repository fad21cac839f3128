"""Plain YOLOv3 decode and detection, the reference for the served
detections.

Candidates are flattened in (head, row, column, anchor) order. A
candidate's box is Darknet's get_yolo_box (yolo_layer.c): x = (col +
sigmoid(tx)) / W, y = (row + sigmoid(ty)) / H, w = exp(tw) * anchor_w /
net_w, h likewise; its objectness sigmoid(to), its class scores
objectness * sigmoid(tc). A detection request keeps the `max_dets`
candidates of largest objectness above `thresh` and suppresses, in
objectness order, every later one whose IoU with a kept one exceeds
`nms_thresh` (do_nms_obj's greedy rule).
"""

from __future__ import annotations

from typing import Dict, List

import torch

NMS_THRESH = 0.45


def decode(raws: List[torch.Tensor], params: List[Dict], net_w: int,
           net_h: int):
    """Every candidate of a batch of heads, in float32: (boxes (N, M,
    4), objectness logits (N, M), class logits (N, M, K))."""
    boxes, objl, clsl = [], [], []
    for raw, p in zip(raws, params):
        n, _, h, w = raw.shape
        a, k = p["num"], p["classes"]
        t = raw.to(torch.float32).reshape(n, a, 5 + k, h, w).permute(
            0, 3, 4, 1, 2)  # (N, H, W, A, 5 + K)
        col = torch.arange(w, device=raw.device, dtype=torch.float32)
        row = torch.arange(h, device=raw.device, dtype=torch.float32)
        aw = torch.tensor([p["anchors"][2 * m] for m in p["mask"]],
                          device=raw.device)
        ah = torch.tensor([p["anchors"][2 * m + 1] for m in p["mask"]],
                          device=raw.device)
        bx = (col.reshape(1, 1, w, 1) + torch.sigmoid(t[..., 0])) / w
        by = (row.reshape(1, h, 1, 1) + torch.sigmoid(t[..., 1])) / h
        bw = torch.exp(t[..., 2]) * aw / net_w
        bh = torch.exp(t[..., 3]) * ah / net_h
        boxes.append(torch.stack([bx, by, bw, bh], -1).reshape(n, -1, 4))
        objl.append(t[..., 4].reshape(n, -1))
        clsl.append(t[..., 5:].reshape(n, -1, k))
    return torch.cat(boxes, 1), torch.cat(objl, 1), torch.cat(clsl, 1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of centre-format boxes a (..., P, 4) against b (..., Q, 4)."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    ah, bh = a[..., 2:] / 2, b[..., 2:] / 2
    lo = torch.maximum(a[..., :2] - ah, b[..., :2] - bh)
    hi = torch.minimum(a[..., :2] + ah, b[..., :2] + bh)
    wh = hi - lo
    inter = torch.where((wh < 0).any(-1), 0.0, wh[..., 0] * wh[..., 1])
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return torch.where(union > 0, inter / union, 0.0)


def rounder(dtype):
    """Rounds a float32 tensor to `dtype` and back (None: no rounding),
    saturating at the type's largest finite value, as the card's
    conversions to float8 do (`satfinite`)."""
    if dtype is None:
        return lambda t: t
    big = torch.finfo(dtype).max
    return lambda t: t.clamp(-big, big).to(dtype).to(torch.float32)


def detections(raws: List[torch.Tensor], params: List[Dict], net_w: int,
               net_h: int, max_dets: int, thresh: float, dtype=None):
    """A detection request's output, (boxes (N, K, 4), scores (N, K,
    classes), objectness (N, K)), suppressed rows with zero scores and
    objectness; every step rounded to `dtype` (None: float32)."""
    r = rounder(dtype)
    heads = [r(h.to(torch.float32)) for h in raws]
    boxes, objl, clsl = decode(heads, params, net_w, net_h)
    boxes = r(boxes)
    valid = r(torch.sigmoid(objl)) > thresh
    masked = torch.where(valid, objl, float("-inf"))
    k = min(max_dets, masked.shape[1])
    top, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    sel = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    cls = torch.gather(clsl, 1, idx[..., None].expand(-1, -1, clsl.shape[2]))
    pair = (iou(sel, sel) > NMS_THRESH) & torch.ones(
        k, k, dtype=torch.bool, device=sel.device).triu(1)
    alive = top > float("-inf")
    for i in range(k):
        alive = alive & ~(pair[:, i, :] & alive[:, i:i + 1])
    obj = r(torch.sigmoid(top.clamp(min=-1e30))) * alive
    scores = r(obj[..., None] * r(torch.sigmoid(cls)))
    return sel, scores, obj
