"""Detection quality: per-class AP and mAP over a stream of detections,
ported from `bcnn_tpu.metrics_det` (numpy on the host, as there).

The reference never measures detection quality (it prints training
diagnostics, bcnn_yolo.c:404-414, and dumps prediction images,
bcnn_cl.c:148-250); `bcnn_tpu` added the VOC/COCO-style evaluator over
the same detection rows, and the port keeps it.

Boxes are (x, y, w, h), centre format, relative to the net input: the
space of the detection loader's labels and of the decoded detections,
so IoU is taken where the model works.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

COCO_IOU_THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05).round(2))


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of (M,4) vs (G,4) center-format boxes -> (M,G)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    ax0, ax1 = a[:, 0] - a[:, 2] / 2, a[:, 0] + a[:, 2] / 2
    ay0, ay1 = a[:, 1] - a[:, 3] / 2, a[:, 1] + a[:, 3] / 2
    bx0, bx1 = b[:, 0] - b[:, 2] / 2, b[:, 0] + b[:, 2] / 2
    by0, by1 = b[:, 1] - b[:, 3] / 2, b[:, 1] + b[:, 3] / 2
    iw = np.minimum(ax1[:, None], bx1[None]) - np.maximum(
        ax0[:, None], bx0[None]
    )
    ih = np.minimum(ay1[:, None], by1[None]) - np.maximum(
        ay0[:, None], by0[None]
    )
    # untrained nets can emit inf/nan boxes (exp of large tw/th): the
    # arithmetic below must not spray warnings; non-finite IoU rows
    # compare False everywhere, i.e. never match
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
        union = (
            (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
        )
        return np.where(union > 0, inter / union, 0.0)


def average_precision(
    scores: np.ndarray, matched: np.ndarray, n_gt: int,
    interpolation: str = "all",
) -> float:
    """AP from a flat list of detections of ONE class across all images.

    scores: (D,) confidences; matched: (D,) bool true-positive flags
    (each GT matched at most once by the caller); n_gt: total ground
    truths of this class. interpolation: 'all' (VOC2010+/continuous) or
    '101' (COCO's 101-point grid)."""
    if n_gt == 0:
        return float("nan")  # class absent from the eval set: excluded
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = matched[order].astype(np.float64)
    fp = 1.0 - tp
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    # precision envelope (monotone non-increasing from the right)
    prec_env = np.maximum.accumulate(precision[::-1])[::-1]
    if interpolation == "101":
        grid = np.linspace(0.0, 1.0, 101)
        idx = np.searchsorted(recall, grid, side="left")
        p = np.where(idx < len(prec_env), prec_env[np.minimum(idx, len(prec_env) - 1)], 0.0)
        return float(p.mean())
    # all-point: integrate the envelope over recall steps
    r = np.concatenate([[0.0], recall])
    p = np.concatenate([[prec_env[0] if len(prec_env) else 0.0], prec_env])
    return float(np.sum((r[1:] - r[:-1]) * p[1:]))


def match_detections(
    dets: np.ndarray, gts: np.ndarray, iou_thresh: float
) -> np.ndarray:
    """Greedy one-image one-class matching: detections in score-desc
    order claim the highest-IoU unmatched GT with IoU >= thresh.
    dets: (M,5) [x,y,w,h,score]; gts: (G,4). Returns (M,) bool."""
    matched = np.zeros(len(dets), bool)
    if len(dets) == 0 or len(gts) == 0:
        return matched
    order = np.argsort(-dets[:, 4], kind="stable")
    iou = _iou_matrix(dets[:, :4], gts)
    taken = np.zeros(len(gts), bool)
    for d in order:
        g = int(np.argmax(np.where(taken, -1.0, iou[d])))
        if not taken[g] and iou[d, g] >= iou_thresh:
            taken[g] = True
            matched[d] = True
    return matched


def evaluate_detections(
    preds: Sequence[np.ndarray],
    gts: Sequence[np.ndarray],
    num_classes: int,
    iou_thresholds: Sequence[float] = COCO_IOU_THRESHOLDS,
    interpolation: str = "all",
) -> Dict:
    """preds: per image (M_i, 6) [x,y,w,h,score,class]; gts: per image
    (G_i, 5) [x,y,w,h,class]. Returns {'map50', 'map', 'ap': (T, C),
    'iou_thresholds', 'n_gt': (C,)}; classes with zero ground truths are
    nan in `ap` and excluded from the means."""
    assert len(preds) == len(gts)
    thr = list(iou_thresholds)
    n_gt = np.zeros(num_classes, np.int64)
    for g in gts:
        for c in range(num_classes):
            n_gt[c] += int((g[:, 4].astype(int) == c).sum()) if len(g) else 0
    ap = np.full((len(thr), num_classes), np.nan)
    for c in range(num_classes):
        per_img = [
            (
                p[p[:, 5].astype(int) == c][:, :5] if len(p) else
                np.zeros((0, 5)),
                g[g[:, 4].astype(int) == c][:, :4] if len(g) else
                np.zeros((0, 4)),
            )
            for p, g in zip(preds, gts)
        ]
        for ti, t in enumerate(thr):
            scores, matched = [], []
            for d, g in per_img:
                scores.append(d[:, 4])
                matched.append(match_detections(d, g, t))
            ap[ti, c] = average_precision(
                np.concatenate(scores) if scores else np.zeros(0),
                np.concatenate(matched) if matched else np.zeros(0, bool),
                int(n_gt[c]),
                interpolation,
            )
    with np.errstate(invalid="ignore"):
        per_thr = np.nanmean(ap, axis=1)
    i50 = min(range(len(thr)), key=lambda i: abs(thr[i] - 0.5))
    return {
        "map50": float(per_thr[i50]),
        "map": float(np.nanmean(per_thr)),
        "ap": ap,
        "iou_thresholds": thr,
        "n_gt": n_gt,
    }


def dets_to_rows(
    boxes: np.ndarray,
    scores: np.ndarray,
    score_floor: float = 0.0,
) -> np.ndarray:
    """One image's device-NMS output -> (M,6) eval rows. boxes (K,4),
    scores (K,C) = objectness * class prob with suppressed slots zeroed
    (ops/yolo.device_detect_topk). Every (box, class) pair above the
    floor becomes a detection, like the reference's per-class prob
    vector semantics."""
    k, c = scores.shape
    keep = scores > score_floor
    bi, ci = np.nonzero(keep)
    return np.concatenate(
        [boxes[bi], scores[bi, ci, None], ci[:, None].astype(np.float64)],
        axis=1,
    )


def map_eval(
    sess,
    num_images: Optional[int] = None,
    thresh: float = 0.005,
    max_dets: int = 100,
    iou_thresholds: Sequence[float] = COCO_IOU_THRESHOLDS,
    batches: Optional[int] = None,
) -> Dict:
    """Run the eval stream of sess.loader (the loader of
    Session.set_data_loader, a DetectionListLoader for a detection list,
    or any object whose next_batch() returns host (x, labels)) through
    Session.detect_on_batch and score mAP."""
    net = sess.net
    n_img = num_images
    if batches is None:
        if n_img is None:
            raise ValueError("pass num_images or batches")
        # evaluate EXACTLY n_img images: ceil to cover the tail, then
        # slice the final (stream-wrapped) batch down to the remainder
        batches = -(-n_img // net.batch_size)
    limit = n_img if n_img is not None else batches * net.batch_size
    preds: List[np.ndarray] = []
    gts: List[np.ndarray] = []
    classes = _num_classes(net)
    for _ in range(batches):
        if len(preds) >= limit:
            break
        x, y = sess.loader.next_batch()
        b, s, _o = sess.detect_on_batch(x, thresh=thresh, max_dets=max_dets)
        b, s = b.float().cpu().numpy(), s.float().cpu().numpy()
        take = min(net.batch_size, limit - len(preds))
        for i in range(take):
            preds.append(dets_to_rows(b[i], s[i]))
            lab = np.asarray(y[i]).reshape(-1, 5)
            # truths terminate at the first x == 0 (reference `break`)
            zero = np.nonzero(lab[:, 0] == 0)[0]
            lab = lab[: zero[0]] if len(zero) else lab
            gts.append(lab.astype(np.float64))
    return evaluate_detections(preds, gts, classes, iou_thresholds)


def _num_classes(net) -> int:
    from .types import LayerType

    for n in net.nodes:
        if n.type == LayerType.YOLOV3:
            return int(n.param["classes"])
    raise ValueError("net has no YOLO layers")


def format_map(res: Dict) -> str:
    return (
        f"mAP@0.5= {res['map50']:.4f} "
        f"mAP@[.5:.95]= {res['map']:.4f} "
        f"(gt boxes: {int(res['n_gt'].sum())})"
    )
