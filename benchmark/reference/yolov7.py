"""The plain reference of the YOLOv7 configurations: the deploy net of
cfg/deploy/yolov7.yaml (github.com/WongKinYiu/yolov7, `models/common.py`,
`models/yolo.py`) as the Darknet dialect writes it (AlexeyAB's
`cfg/yolov7.cfg`), under the names a configuration's reference provides
(`harness.REFERENCE`).

What YOLOv7 shares with YOLOv3 and YOLOv4 comes from `darknet`,
`detect` and `yolov4` as it is: the cfg's layers and shapes (`build`),
the convs and their operations, the route, the upsample and Darknet's
centred max-pool (`yolov4._maxpool`: SPPCSPC's 5, 9 and 13 at stride 1;
the MP blocks' 2 at stride 2). No cell of this configuration is int8:
the integer scheme's forward has no swish, and `calibrate` raises on
it. What differs is here:

- convolutional: as `darknet`, with `swish`, x * logistic(x)
  (activations.c; PyTorch's SiLU); every conv but the heads is batch
  norm and swish;
- the seeded weights: `darknet`'s, with the batch norms' shifts raised
  by 1.5 and their statistics taken from seeded frames (`make_weights`);
- yolo: `scale_x_y` s = 2 and `new_coords` = 1 (yolo_layer.c's
  get_yolo_box with new_coords, IDetect's decode in models/yolo.py):
  with every channel's logistic taken, a box's centre is x = (col +
  sigmoid(tx) * s - (s - 1) / 2) / W, likewise y, and its width w = 4 *
  sigmoid(tw)^2 * anchor_w / net_w (no exp), likewise h; objectness and
  classes as `detect`.

Departures from yolov7. The first three leave the arithmetic as it is:
- RepConv in its deploy form, one 3x3 conv + BN + swish (the fused
  branches of reparameterization; the deploy yaml's own form);
- IDetect's ImplicitA and ImplicitM folded into the head convs' weights
  and biases (what `fuse()` does before export);
- the heads' logistic taken by the [yolo] head and not by its conv
  (Darknet applies `activation=logistic` in the conv and skips it in the
  layer): `forward` returns the head conv's linear output, which
  `decode` takes through the logistic. A `logistic` conv that no
  new_coords head follows raises.
The fourth is the serving rule: the detections are the ones the program
serves, `detect`'s objectness-ordered greedy NMS at 0.45 (bcnn's
do_nms_obj), as in the YOLOv3 and YOLOv4 cells, not yolov7's per-class
NMS. Otherwise as `yolov4`: float32 with TF32 off (`darknet.no_tf32`),
or float64 for a float64 input; `forward(..., dtype=)` rounds each
layer's output and each conv's weight to `dtype` (`detect.rounder`), a
lower precision for the control (`benchmark/control_fp8.py`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import darknet
from benchmark.reference.darknet import (  # noqa: F401
    BN_EPS, Layer, Quant, build, calibrate, conv_layers, conv_ops,
    no_tf32, watch_tensors)
from benchmark.reference.detect import NMS_THRESH, iou, rounder  # noqa: F401
from benchmark.reference.yolov4 import _maxpool


def swish(y: torch.Tensor) -> torch.Tensor:
    """Darknet's swish: y * logistic(y)."""
    return y * torch.sigmoid(y)


def _epilogue(l: Layer, wt: Dict[str, torch.Tensor], y, head: bool):
    """Batch norm or the bias, then the activation; `head`: a conv whose
    logistic its new_coords head takes."""
    v = lambda t: t.to(y.dtype).reshape(1, -1, 1, 1)  # noqa: E731
    if int(l.opts.get("batch_normalize", 0)):
        y = (y - v(wt["mean"])) / torch.sqrt(v(wt["var"]) + BN_EPS)
        y = y * v(wt["scale"]) + v(wt["shift"])
    else:
        y = y + v(wt["bias"])
    act = l.opts.get("activation", "linear")
    if act == "swish":
        return swish(y)
    if act == "logistic" and head:
        return y
    if act != "linear":
        raise ValueError(f"activation {act} is not in YOLOv7's convs")
    return y


# what the seeded batch norms add to `darknet`'s shifts, and the seeded
# frames their statistics are taken from (`make_weights`)
SHIFT = 1.5
FRAMES = 2


def make_weights(layers: List[Layer], seed: int,
                 device) -> List[Dict[str, torch.Tensor]]:
    """`darknet.make_weights` (He-normal convs; batch norm scale in [0.8,
    1.2); a head's bias in [-0.05, 0.05)) with each batch norm's shift
    in [-0.05, 0.05) + SHIFT, then each batch norm's statistics taken
    from its conv's output over FRAMES seeded frames (uniform in [0,
    1), at the layers' input size), conv by conv in cfg order, as a
    trained net's running statistics are: its mean the output's
    per-channel mean, its var the output's variance about those means
    over all its channels, one value a conv.

    Why, 89 convs deep with no residual add: a random var does not hold
    the activations' scale (they fall to the shifts' 0.03 at the He
    gain, grow past 10^3 at 1.15 times it, and near 1.1 fall or grow by
    seed); a var per channel divides by the channels that barely vary
    on the calibration frames and blows the last layers up on others;
    and about a mean of 0, where each swish sees N(0, 1), a layer
    multiplies a perturbation's variance by E[swish'(h)^2] / Var[swish(h)]
    = 1.21, so bf16's roundings grow to half the heads. At a mean of
    SHIFT the factor is 1.03."""
    weights = darknet.make_weights(layers, seed, device)
    for wt in weights:
        if "shift" in wt:
            wt["shift"] = wt["shift"] + SHIFT
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x7B4E)
    x = torch.rand((FRAMES, *layers[0].in_shape), generator=gen,
                   device=device)
    with torch.no_grad():
        forward(layers, weights, x, set_stats=True)
    return weights


def forward(layers: List[Layer], weights: List[Dict[str, torch.Tensor]],
            x: torch.Tensor, quant: Optional[Quant] = None,
            dtype: Optional[torch.dtype] = None,
            set_stats: bool = False) -> List[torch.Tensor]:
    """The raw input of each [yolo] layer, in cfg order (weights: one
    dict a conv, as `darknet.forward` takes them): the head conv's
    linear output. dtype: every layer's output and every conv's weight
    rounded to it and back. set_stats (`make_weights`): each batch
    norm's statistics are first set from its conv's output."""
    if quant is not None:
        raise ValueError("YOLOv7's reference has no integer forward")
    r = rounder(dtype)
    taken = {s for s, p in heads(layers) if p["new_coords"]}
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
                if set_stats and "mean" in wt:
                    var, wt["mean"] = torch.var_mean(y, dim=(0, 2, 3),
                                                     unbiased=False)
                    wt["var"] = var.mean().expand_as(var).clone()
                y = _epilogue(l, wt, y, i in taken)
            elif l.kind == "maxpool":
                y = _maxpool(src[0], l)
            elif l.kind == "route":
                y = torch.cat(src, dim=1) if len(src) > 1 else src[0]
            elif l.kind == "upsample":
                y = darknet._upsample(src[0], l)
            elif l.kind == "yolo":
                y = src[0]
            else:
                raise ValueError(f"layer {i}: {l.kind} is not in YOLOv7")
            vals[i] = r(y)
    return [vals[s] for s, _ in heads(layers)]


def heads(layers: List[Layer]):
    """`darknet.heads`, each head's params with its `scale_x_y` and
    `new_coords`."""
    yolo = [l.opts for l in layers if l.kind == "yolo"]
    return [(s, dict(p, scale_x_y=float(o.get("scale_x_y", 1)),
                     new_coords=int(o.get("new_coords", 0))))
            for (s, p), o in zip(darknet.heads(layers), yolo)]


def decode(raws: List[torch.Tensor], params: List[Dict], net_w: int,
           net_h: int):
    """Every candidate of a batch of heads, in float32 (`detect.decode`'s
    order and outputs), the centres scaled by each head's scale_x_y and
    the sizes by new_coords' 4 * sigmoid(t)^2 (exp without it)."""
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
        if p["new_coords"]:
            sw = 4 * torch.sigmoid(t[..., 2]) ** 2
            sh = 4 * torch.sigmoid(t[..., 3]) ** 2
        else:
            sw, sh = torch.exp(t[..., 2]), torch.exp(t[..., 3])
        bw = sw * aw / net_w
        bh = sh * ah / net_h
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
