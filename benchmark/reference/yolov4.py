"""The plain reference of the YOLOv4 configurations: AlexeyAB's Darknet
(github.com/AlexeyAB/darknet, `src/*_layer.c`, `src/activations.c`)
read from `cfg/yolov4.cfg`, under the names a configuration's reference
provides (`harness.REFERENCE`).

What YOLOv4 shares with YOLOv3 comes from `darknet` and `detect`: the
cfg's layers and shapes (`build`), the convs and their operations, the
seeded weights, and the integer scheme, re-exported as they are (no
cell of this configuration is int8: the scheme's forward has no Mish,
and `calibrate` raises on it). What differs is here:

- convolutional: as `darknet`, with `mish` too, Darknet's
  x * tanh(softplus(x)), softplus(x) = x above 20, exp(x) below -20 and
  log1p(exp(x)) between (activations.c, MISH_THRESHOLD 20);
- maxpool: Darknet's rule (maxpool_layer.c): `padding` (default size -
  1) pads the input, window (i, j) starts at (i, j) * stride -
  padding / 2, positions outside read -FLT_MAX (here -inf), the output
  is (w + padding - size) / stride + 1; odd windows are centred (SPP's
  5, 9 and 13; `darknet._maxpool` starts them at i * stride). `build`'s
  shapes, ceil(w / stride), are this rule's for the default padding,
  the only one yolov4.cfg has;
- yolo: each head's `scale_x_y` s (1 where the cfg has none); a box's
  centre is x = (col + sigmoid(tx) * s - (s - 1) / 2) / W, and likewise
  y (yolo_layer.c scales the logistic as x * s - 0.5 * (s - 1) before
  get_yolo_box); width, height, objectness and classes as `detect`.

Departures from Darknet: float32 with TF32 off (`darknet.no_tf32`),
or float64 for a float64 input; -inf for -FLT_MAX in the pools; the
detection rule is the one the program serves (`detect`'s objectness-
ordered greedy NMS at 0.45, bcnn's do_nms_obj), not the cfg's per-class
`greedynms`. `forward(..., dtype=)` rounds each layer's output and each
conv's weight to `dtype` (`detect.rounder`), a lower precision for the
control (`benchmark/control_fp8.py`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import darknet
from benchmark.reference.darknet import (  # noqa: F401
    BN_EPS, LEAKY, Layer, Quant, build, calibrate, conv_layers, conv_ops,
    make_weights, no_tf32, watch_tensors)
from benchmark.reference.detect import NMS_THRESH, iou, rounder  # noqa: F401

MISH_THRESHOLD = 20.0


def mish(y: torch.Tensor) -> torch.Tensor:
    """Darknet's mish: y * tanh(softplus(y)), its softplus cut at 20."""
    e = torch.exp(y)
    sp = torch.where(y > MISH_THRESHOLD, y,
                     torch.where(y < -MISH_THRESHOLD, e, torch.log1p(e)))
    return y * torch.tanh(sp)


def _epilogue(l: Layer, wt: Dict[str, torch.Tensor], y):
    v = lambda t: t.to(y.dtype).reshape(1, -1, 1, 1)  # noqa: E731
    if int(l.opts.get("batch_normalize", 0)):
        y = (y - v(wt["mean"])) / torch.sqrt(v(wt["var"]) + BN_EPS)
        y = y * v(wt["scale"]) + v(wt["shift"])
    else:
        y = y + v(wt["bias"])
    act = l.opts.get("activation", "linear")
    if act == "mish":
        return mish(y)
    if act == "leaky":
        return torch.where(y > 0, y, LEAKY * y)
    if act != "linear":
        raise ValueError(f"activation {act} is not in YOLOv4")
    return y


def _maxpool(x, l: Layer):
    size, s = int(l.opts["size"]), int(l.opts["stride"])
    padding = int(l.opts.get("padding", size - 1))
    lo = padding // 2
    h, w = x.shape[2], x.shape[3]
    oh = (h + padding - size) // s + 1
    ow = (w + padding - size) // s + 1
    ph = max(0, (oh - 1) * s + size - h - lo)
    pw = max(0, (ow - 1) * s + size - w - lo)
    x = F.pad(x, (lo, pw, lo, ph), value=float("-inf"))
    return F.max_pool2d(x, size, s)[:, :, :oh, :ow]


def forward(layers: List[Layer], weights: List[Dict[str, torch.Tensor]],
            x: torch.Tensor, quant: Optional[Quant] = None,
            dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """The raw input of each [yolo] layer, in cfg order (weights: one
    dict a conv, as `darknet.forward` takes them). dtype: every layer's
    output and every conv's weight rounded to it and back."""
    if quant is not None:
        raise ValueError("YOLOv4's reference has no integer forward")
    r = rounder(dtype)
    vals: Dict[int, torch.Tensor] = {-1: r(x)}
    ci = 0
    with no_tf32():
        for i, l in enumerate(layers):
            src = [vals[s] for s in l.srcs]
            if l.kind == "conv":
                wt = weights[ci]
                ci += 1
                y = F.conv2d(src[0], r(wt["w"]).to(x.dtype), None,
                             int(l.opts.get("stride", 1)), darknet._pad(l))
                y = _epilogue(l, wt, y)
            elif l.kind == "maxpool":
                y = _maxpool(src[0], l)
            elif l.kind == "shortcut":
                y = src[0] + src[1]
            elif l.kind == "route":
                y = torch.cat(src, dim=1) if len(src) > 1 else src[0]
            elif l.kind == "upsample":
                y = darknet._upsample(src[0], l)
            else:  # yolo
                y = src[0]
            vals[i] = r(y)
    return [vals[s] for s, _ in heads(layers)]


def heads(layers: List[Layer]):
    """`darknet.heads`, each head's params with its `scale_x_y`."""
    scales = [float(l.opts.get("scale_x_y", 1)) for l in layers
              if l.kind == "yolo"]
    return [(s, dict(p, scale_x_y=k))
            for (s, p), k in zip(darknet.heads(layers), scales)]


def decode(raws: List[torch.Tensor], params: List[Dict], net_w: int,
           net_h: int):
    """Every candidate of a batch of heads, in float32 (`detect.decode`'s
    order and outputs), the centres scaled by each head's scale_x_y."""
    boxes, objl, clsl = [], [], []
    for raw, p in zip(raws, params):
        n, _, h, w = raw.shape
        a, k, s = p["num"], p["classes"], p["scale_x_y"]
        t = raw.to(torch.float32).reshape(n, a, 5 + k, h, w).permute(
            0, 3, 4, 1, 2)  # (N, H, W, A, 5 + K)
        col = torch.arange(w, device=raw.device, dtype=torch.float32)
        row = torch.arange(h, device=raw.device, dtype=torch.float32)
        aw = torch.tensor([p["anchors"][2 * m] for m in p["mask"]],
                          device=raw.device)
        ah = torch.tensor([p["anchors"][2 * m + 1] for m in p["mask"]],
                          device=raw.device)
        off = -0.5 * (s - 1)
        bx = (col.reshape(1, 1, w, 1)
              + (torch.sigmoid(t[..., 0]) * s + off)) / w
        by = (row.reshape(1, h, 1, 1)
              + (torch.sigmoid(t[..., 1]) * s + off)) / h
        bw = torch.exp(t[..., 2]) * aw / net_w
        bh = torch.exp(t[..., 3]) * ah / net_h
        boxes.append(torch.stack([bx, by, bw, bh], -1).reshape(n, -1, 4))
        objl.append(t[..., 4].reshape(n, -1))
        clsl.append(t[..., 5:].reshape(n, -1, k))
    return torch.cat(boxes, 1), torch.cat(objl, 1), torch.cat(clsl, 1)


def detections(raws: List[torch.Tensor], params: List[Dict], net_w: int,
               net_h: int, max_dets: int, thresh: float, dtype=None):
    """`detect.detections` on this module's decode: (boxes (N, K, 4),
    scores (N, K, classes), objectness (N, K)), suppressed rows with zero
    scores and objectness; every step rounded to `dtype` (None:
    float32)."""
    r = rounder(dtype)
    hs = [r(h.to(torch.float32)) for h in raws]
    boxes, objl, clsl = decode(hs, params, net_w, net_h)
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
