"""The comparison that decides `correct` for a serving cell.

After the window, a sample of the requests the window finished, drawn
from the seed, is judged against the plain reference (`reference/`):

- `heads`: the raw YOLO heads the program computes for the sampled
  requests' inputs, through the same session, batch and kernels as the
  timed calls (`Served.heads`), against the reference's heads computed
  from the same seeded weights and inputs at the cell's precision (int8:
  the reference's own calibration, weight codes and flow plan). The
  number is the worst head's relative error, ||p - r|| / ||r|| over the
  sample;
- `dets`: each detection the timed call returned (objectness > 0)
  against the candidate of the program's own heads, decoded by the
  reference, that lies nearest to it by the whole gap: the widest gap of
  its box (relative to max(1, |value|)), objectness and class scores;
- `select`: how many of the timed call's choices the reference's rule
  (objectness above the threshold, the `max_dets` largest objectness
  logits, greedy NMS at the reference's `NMS_THRESH` (0.45 in YOLOv3) in
  objectness order; its `detections`) does not allow on the same heads.
  Each image's kept detections must be candidates above the threshold
  and among the top `max_dets`; no two of them may overlap by more than
  the NMS limit; and every candidate surely above the threshold and
  surely among the top `max_dets` that was not kept must overlap, by
  more than the limit, a kept one of no smaller logit. With no margins
  that set is exactly greedy NMS's (by induction over the ranks). The
  cell's `margins` are the rounding of the program's decode: `sigmoid`,
  the absolute error of a logistic (the objectness against the
  threshold, a box's centre in grid cells), and `exp`, the relative
  error of a box's width and height. A choice that rounding could flip
  is excused, and so is whatever that flip changes below it.

`dets` and `select` follow the program from its own heads, so that a
rounding of a head cannot flip a candidate across the threshold or NMS;
`heads` checks those heads by themselves. The plain model and its rule
are the cell's reference (`harness.REFERENCE`), passed in as `ref`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

# pairs of a kept row and a candidate whose class scores are compared at
# once (a pair holds a row of class scores)
PAIRS = 1 << 16


def ref_heads(ref, layers, weights, x: torch.Tensor, precision: str,
              quant, block: int) -> List[torch.Tensor]:
    """The reference's heads of x, in blocks of `block` images."""
    parts = []
    for i in range(0, x.shape[0], block):
        xb = x[i:i + block]
        with torch.no_grad():
            hs = ref.forward(layers, weights, xb,
                             quant if precision == "int8" else None)
        parts.append([h.to(torch.float32) for h in hs])
    return [torch.cat(p) for p in zip(*parts)]


def worst(*v: float) -> float:
    """The largest of the readings; inf where one is not a number, so
    that a NaN fails its limit wherever it stands."""
    return math.inf if any(math.isnan(x) for x in v) else max(v)


def head_gap(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    return worst(*(float((p.to(r.device) - r).norm() / r.norm())
                   for p, r in zip(prog, ref)))


def match(b: torch.Tensor, o: torch.Tensor, s: torch.Tensor,
          rb: torch.Tensor, rp: torch.Tensor,
          rs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidate each kept row is, and its gap: of the candidates
    (boxes rb (M, 4), objectness rp (M,), class scores rs (M, K)), the
    one whose whole gap to the row (box b (R, 4), objectness o (R,),
    scores s (R, K)) is least, the whole gap being the widest of the
    box's (relative to max(1, |value|)), the objectness's and the class
    scores'. (gaps (R,), candidates (R,)).

    A whole gap is no less than the gap by box and objectness alone, so
    the scores are compared only for candidates whose gap by box and
    objectness is within the whole gap of the nearest by those; on a tie
    that nearest one stays."""
    d = ((b[:, None, :] - rb[None]).abs()
         / rb[None].abs().clamp(min=1.0)).amax(-1)
    d = torch.maximum(d, (o[:, None] - rp[None]).abs())
    dmin, c = d.min(1)
    g = torch.maximum(dmin, (s - rs[c]).abs().amax(-1))
    whole = torch.full_like(d, math.inf)
    rows, cand = (d <= g[:, None]).nonzero(as_tuple=True)
    for i in range(0, rows.numel(), PAIRS):
        r, j = rows[i:i + PAIRS], cand[i:i + PAIRS]
        whole[r, j] = torch.maximum(d[r, j], (s[r] - rs[j]).abs().amax(-1))
    least, near = whole.min(1)
    better = least < g
    return torch.where(better, least, g), torch.where(better, near, c)


def det_numbers(ref, served: Tuple[torch.Tensor, ...],
                heads: List[torch.Tensor], params: List[Dict], net_w: int,
                net_h: int, max_dets: int, thresh: float,
                margins: Dict[str, float]) -> Tuple[float, int]:
    """(`dets`, `select`) of one request: served (boxes, scores,
    objectness) as the timed call returned them, heads the program's for
    its input."""
    dev = heads[0].device
    rb, rol, rcl = ref.decode(heads, params, net_w, net_h)
    rp = torch.sigmoid(rol)
    # a cell of each candidate's grid, as a share of the image
    cell = torch.cat([torch.tensor([[1 / h.shape[3], 1 / h.shape[2]]],
                                   device=dev).expand(
        h.shape[2] * h.shape[3] * p["num"], 2)
        for h, p in zip(heads, params)])
    sb, sp, so = (t.to(dev, torch.float32) for t in served)
    gap, faults = 0.0, 0
    for i in range(sb.shape[0]):
        rows = so[i] > 0
        g, c = match(sb[i][rows], so[i][rows], sp[i][rows], rb[i], rp[i],
                     rp[i][:, None] * torch.sigmoid(rcl[i]))
        if g.numel():
            gap = worst(gap, float(g.max()))
        # how far each box may lie from the reference's: a sigmoid's
        # rounding times the grid cell in x and y, an exp's in w and h
        eps = torch.cat([margins["sigmoid"] * cell,
                         margins["exp"] * rb[i][:, 2:]], 1)
        faults += select_faults(c, rb[i], eps, rol[i], rp[i], max_dets,
                                thresh, margins["sigmoid"], ref.NMS_THRESH)
    return gap, faults


def _kth(v: torch.Tensor, k: int) -> float:
    """The k-th largest of v; -inf where v has fewer than k."""
    return float(v.topk(k).values[-1]) if v.numel() >= k else -math.inf


def iou_bounds(a: torch.Tensor, ea: torch.Tensor, b: torch.Tensor,
               eb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The least and the largest IoU of centre-format boxes a (P, 4)
    against b (Q, 4) when each box's centre and size may lie off by up
    to ea (P, 4), eb (Q, 4): (P, Q) each. With no error both are the
    IoU."""
    a, ea = a[:, None, :], ea[:, None, :]
    b, eb = b[None], eb[None]
    ha, hb = a[..., 2:] / 2, b[..., 2:] / 2
    lo = torch.maximum(a[..., :2] - ha, b[..., :2] - hb)
    hi = torch.minimum(a[..., :2] + ha, b[..., :2] + hb)
    # each edge moves by its centre's error and half its size's
    u = torch.maximum(ea[..., :2] + ea[..., 2:] / 2,
                      eb[..., :2] + eb[..., 2:] / 2)
    wh = hi - lo
    inter = [(wh + s * 2 * u).clamp(min=0).prod(-1) for s in (-1, 1)]
    area = [((a[..., 2:] + s * ea[..., 2:]).clamp(min=0).prod(-1),
             (b[..., 2:] + s * eb[..., 2:]).clamp(min=0).prod(-1))
            for s in (-1, 1)]
    least = inter[0] / (area[1][0] + area[1][1] - inter[0]).clamp(min=1e-30)
    union = area[0][0] + area[0][1] - inter[1]
    most = torch.where(union > inter[1], inter[1] / union.clamp(min=1e-30),
                       torch.ones_like(union))
    return least, most


def select_faults(kept: torch.Tensor, boxes: torch.Tensor, eps: torch.Tensor,
                  logits: torch.Tensor, probs: torch.Tensor, k: int,
                  thresh: float, mt: float, nms_thresh: float) -> int:
    """The choices of one image's kept candidates (indices `kept`) that
    greedy top-k NMS at IoU `nms_thresh` on (boxes, logits, probs) does
    not allow within the rounding of its inputs: objectness within mt,
    box coordinates within eps (see the module's docstring)."""
    maybe = probs > thresh - mt  # possibly above the threshold
    sure = probs > thresh + mt
    possible = maybe & (logits >= _kth(logits[sure], k))
    surely_in = sure & (logits > _kth(logits[maybe], k))
    faults = int((~possible[kept]).sum())
    if kept.numel():
        least, _ = iou_bounds(boxes[kept], eps[kept], boxes[kept], eps[kept])
        same = kept[:, None] == kept[None]
        faults += int(((least > nms_thresh) | same).triu(1).sum())
    missed = surely_in.clone()
    missed[kept] = False
    cand = missed.nonzero().flatten()
    if cand.numel():
        if not kept.numel():
            return faults + cand.numel()
        _, most = iou_bounds(boxes[cand], eps[cand], boxes[kept], eps[kept])
        ranks = logits[kept][None] >= logits[cand][:, None]
        faults += int((~((most > nms_thresh) & ranks).any(1)).sum())
    return faults


def sample(n_done: int, k: int, seed: int) -> List[int]:
    """k of the finished requests, drawn from the seed (the last one
    always among them)."""
    rng = np.random.default_rng(seed ^ 0xC4EC)
    pick = set(rng.choice(n_done, size=min(k, n_done), replace=False).tolist())
    pick.discard(n_done - 1)
    return sorted(pick)[:max(0, k - 1)] + [n_done - 1]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)
