"""A plain PyTorch YOLOv3 read from a Darknet cfg: the benchmark's
reference for the serving cells.

It imports nothing of the program under test. It follows Darknet's
layer equations (pjreddie/darknet, `src/*_layer.c`):

- convolutional: zero padding size // 2 when `pad=1`; with
  `batch_normalize=1`, y = scale * (x - mean) / sqrt(var + 1e-6) + shift
  (the inference form, batchnorm_layer.c's `.000001f`), else y = x + bias;
  `leaky` is max(x, 0.1 x), `linear` the identity;
- maxpool: windows start at i * stride and read -inf past the bottom and
  right edges (out = ceil(in / stride));
- shortcut: the previous layer's output plus layer `from`'s;
- route: the listed layers concatenated on channels (negative indices
  relative to the route);
- upsample: nearest neighbour by `stride`;
- yolo: the head's raw input is the output (decoded by `detect.py`).

Three precisions:

- `forward(..., quant=None)`: float32 (float64 if the input is), with
  TF32 off (`no_tf32`);
- `forward(..., quant=calibrate(...))`: symmetric integer post-training
  quantization with `bits` bits, as a deployment of the program's int8
  scheme states it: per-output-channel weight codes from |w|max, one
  scale a watched tensor from its |x|max over a calibration batch, and
  the activations that flow between layers as codes (`plan_flow`). The
  integer sums run in float64, where they are exact; the epilogue
  (dequantize, batch norm, leaky, requantize) in float64.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-6
LEAKY = 0.1


@dataclass
class Layer:
    kind: str  # conv, maxpool, shortcut, route, upsample, yolo
    opts: Dict[str, str]
    srcs: List[int] = field(default_factory=list)  # -1 is the input
    shape: Tuple[int, int, int] = (0, 0, 0)  # (C, H, W) of the output
    in_shape: Tuple[int, int, int] = (0, 0, 0)  # that of its first source


def parse_cfg(path: str) -> Tuple[Dict[str, str], List[Dict[str, str]]]:
    """([net] options, [(section name, options)] of the layers)."""
    sections = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if line.startswith("["):
                sections.append((line.strip("[]").strip(), {}))
            else:
                k, v = line.split("=", 1)
                sections[-1][1][k.strip()] = v.strip()
    return sections[0][1], sections[1:]


def build(path: str, size: int, channels: int = 3) -> List[Layer]:
    """The cfg's layers at a square input of `size`, with their sources
    and output shapes."""
    _, secs = parse_cfg(path)
    layers: List[Layer] = []
    shape_of = lambda j: (channels, size, size) if j < 0 else layers[j].shape  # noqa: E731
    for i, (name, o) in enumerate(secs):
        kind = {"convolutional": "conv"}.get(name, name)
        if kind == "route":
            srcs = [int(v) for v in o["layers"].split(",")]
            srcs = [s + i if s < 0 else s for s in srcs]
            shapes = [shape_of(s) for s in srcs]
            shape = (sum(s[0] for s in shapes), shapes[0][1], shapes[0][2])
        elif kind == "shortcut":
            f_ = int(o["from"])
            srcs = [i - 1, f_ + i if f_ < 0 else f_]
            shape = shape_of(i - 1)
        else:
            srcs = [i - 1]
            c, h, w = shape_of(i - 1)
            if kind == "conv":
                k, s = int(o["size"]), int(o.get("stride", 1))
                p = k // 2 if int(o.get("pad", 0)) else 0
                shape = (int(o["filters"]), (h + 2 * p - k) // s + 1,
                         (w + 2 * p - k) // s + 1)
            elif kind == "maxpool":
                s = int(o["stride"])
                shape = (c, -(-h // s), -(-w // s))
            elif kind == "upsample":
                s = int(o["stride"])
                shape = (c, h * s, w * s)
            elif kind == "yolo":
                shape = (c, h, w)
            else:
                raise ValueError(f"layer {i}: [{name}] is not in YOLOv3")
        layers.append(Layer(kind, o, srcs, shape, shape_of(srcs[0])))
    return layers


def conv_layers(layers: List[Layer]) -> List[int]:
    return [i for i, l in enumerate(layers) if l.kind == "conv"]


def heads(layers: List[Layer]) -> List[Tuple[int, Dict]]:
    """(source layer, params) of each [yolo] layer: num, classes, the
    anchors (flat w, h pairs) and the mask."""
    out = []
    for l in layers:
        if l.kind == "yolo":
            o = l.opts
            out.append((l.srcs[0], {
                "num": len(o["mask"].split(",")),
                "classes": int(o["classes"]),
                "anchors": [float(v) for v in o["anchors"].split(",")],
                "mask": [int(v) for v in o["mask"].split(",")],
            }))
    return out


@contextlib.contextmanager
def no_tf32():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _pad(l: Layer) -> int:
    k = int(l.opts["size"])
    return k // 2 if int(l.opts.get("pad", 0)) else 0


def _epilogue(l: Layer, wt: Dict[str, torch.Tensor], y):
    v = lambda t: t.to(y.dtype).reshape(1, -1, 1, 1)  # noqa: E731
    if int(l.opts.get("batch_normalize", 0)):
        y = (y - v(wt["mean"])) / torch.sqrt(v(wt["var"]) + BN_EPS)
        y = y * v(wt["scale"]) + v(wt["shift"])
    else:
        y = y + v(wt["bias"])
    act = l.opts.get("activation", "linear")
    if act == "leaky":
        return torch.where(y > 0, y, LEAKY * y)
    if act != "linear":
        raise ValueError(f"activation {act} is not in YOLOv3")
    return y


def _maxpool(x, l: Layer):
    size, s = int(l.opts["size"]), int(l.opts["stride"])
    h, w = x.shape[2], x.shape[3]
    oh, ow = -(-h // s), -(-w // s)
    ph, pw = max(0, (oh - 1) * s + size - h), max(0, (ow - 1) * s + size - w)
    x = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
    return F.max_pool2d(x, size, s)


def _upsample(x, l: Layer):
    s = int(l.opts["stride"])
    return x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)


def forward(layers: List[Layer], weights: List[Dict[str, torch.Tensor]],
            x: torch.Tensor, quant: Optional["Quant"] = None,
            watch: Optional[Dict[int, float]] = None) -> List[torch.Tensor]:
    """The raw input of each [yolo] layer, in cfg order. weights: one
    dict a conv, in cfg order (w (O, C, k, k); bias, or shift, scale,
    mean, var). quant: the integer scheme (`calibrate`). watch: filled
    with the |x|max of each watched tensor (None: the input is -1)."""
    if quant is not None:
        return _forward_int(layers, weights, x, quant)
    vals: Dict[int, torch.Tensor] = {-1: x}
    ci = 0
    watched = set(watch_tensors(layers)) if watch is not None else set()
    with no_tf32():
        for i, l in enumerate(layers):
            src = [vals[s] for s in l.srcs]
            if l.kind == "conv":
                wt = weights[ci]
                ci += 1
                y = F.conv2d(src[0], wt["w"].to(x.dtype), None,
                             int(l.opts.get("stride", 1)), _pad(l))
                y = _epilogue(l, wt, y)
            elif l.kind == "maxpool":
                y = _maxpool(src[0], l)
            elif l.kind == "shortcut":
                y = src[0] + src[1]
            elif l.kind == "route":
                y = torch.cat(src, dim=1) if len(src) > 1 else src[0]
            elif l.kind == "upsample":
                y = _upsample(src[0], l)
            else:  # yolo
                y = src[0]
            vals[i] = y
            for t in [s for s in l.srcs if s in watched]:
                m = float(vals[t].abs().max())
                watch[t] = max(watch.get(t, 0.0), m)
    return [vals[s] for s, _ in heads(layers)]


# --------------------------------------------------------------------- #
# integer post-training quantization
# --------------------------------------------------------------------- #


def watch_tensors(layers: List[Layer]) -> List[int]:
    """Tensors that get a calibrated scale: every conv's input and every
    input of an add or of a concat of two or more."""
    out = set()
    for l in layers:
        if l.kind == "conv" or l.kind == "shortcut" or (
                l.kind == "route" and len(l.srcs) > 1):
            out.update(l.srcs)
    return sorted(out)


@dataclass
class Quant:
    bits: int
    act: Dict[int, float]  # tensor -> calibrated scale
    wq: List[torch.Tensor]  # a conv's codes (O, C, k, k), float64
    ws: List[torch.Tensor]  # a conv's scales (O,), float64
    flow: Dict[int, float]  # tensor -> the scale its codes carry

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1


def calibrate(layers, weights, calib: torch.Tensor, bits: int = 8) -> Quant:
    """The scheme from a float32 forward over the calibration batch:
    scale |x|max / qmax a watched tensor (1 where it is 0), per-output-
    channel weight codes round(w / (|w|max / qmax)), the division in the
    weights' float32."""
    qmax = 2 ** (bits - 1) - 1
    amax: Dict[int, float] = {}
    forward(layers, weights, calib, watch=amax)
    act = {t: (m / qmax if m > 0 else 1.0) for t, m in amax.items()}
    wq, ws = [], []
    for wt in weights:
        w = wt["w"].to(torch.float32)
        m = w.abs().amax(dim=(1, 2, 3))
        s = torch.where(m > 0, m / qmax, torch.ones_like(m))
        wq.append(torch.clamp(torch.round(w / s.reshape(-1, 1, 1, 1)),
                              -qmax, qmax).to(torch.float64))
        ws.append(s.to(torch.float64))
    return Quant(bits, act, wq, ws, plan_flow(layers, act))


def plan_flow(layers: List[Layer], act: Dict[int, float]) -> Dict[int, float]:
    """Which tensors flow between layers as codes, and at which scale.
    A tensor flows iff every consumer reads codes: a conv (at the
    tensor's calibrated scale), a maxpool, upsample or one-source route
    whose output flows at the same scale, or an add or a concat of
    several whose inputs all flow at one shared scale, the largest of
    their calibrated scales; joiners whose inputs cannot settle on their
    shared scale are dropped until the plan is stable. Tensors read by
    a [yolo] layer stay float."""
    consumers: Dict[int, List[int]] = {}
    for i, l in enumerate(layers):
        for s in l.srcs:
            consumers.setdefault(s, []).append(i)
    is_joiner = lambda l: l.kind == "shortcut" or (  # noqa: E731
        l.kind == "route" and len(l.srcs) > 1)
    shared = {i: max(act[s] for s in l.srcs)
              for i, l in enumerate(layers)
              if is_joiner(l) and all(s in act for s in l.srcs)}
    enabled = set(shared)
    while True:
        flow: Dict[int, float] = {}
        for d in reversed(range(len(layers))):
            cons = consumers.get(d, [])
            if not cons:
                continue
            direct, through, join, ok = [], [], [], True
            for c in cons:
                lc = layers[c]
                if lc.kind == "conv" and d in act:
                    direct.append(act[d])
                elif is_joiner(lc) and c in enabled:
                    join.append(shared[c])
                elif (lc.kind in ("maxpool", "upsample") or (
                        lc.kind == "route" and len(lc.srcs) == 1)) \
                        and c in flow:
                    through.append(flow[c])
                else:
                    ok = False
                    break
            if not ok or len(set(through)) > 1 or len(set(join)) > 1:
                continue
            if through and direct and through[0] != direct[0]:
                continue
            if join:
                if (through and through[0] != join[0]) or (
                        direct and join[0] < direct[0]):
                    continue
                flow[d] = join[0]
            elif through:
                flow[d] = through[0]
            elif direct:
                flow[d] = direct[0]
        stale = {j for j in enabled
                 if any(flow.get(s) != shared[j] for s in layers[j].srcs)}
        if not stale:
            return flow
        enabled -= stale


def _codes(x: torch.Tensor, s: float, qmax: int) -> torch.Tensor:
    return torch.clamp(torch.round(x.to(torch.float64) / s), -qmax, qmax)


def _forward_int(layers, weights, x, q: Quant) -> List[torch.Tensor]:
    """Values are (codes, scale) where the plan lets them flow, else
    float64 tensors."""
    vals: Dict[int, object] = {-1: x.to(torch.float64)}
    deq = lambda v: v[0] * v[1] if isinstance(v, tuple) else v  # noqa: E731
    qm = q.qmax
    ci = 0
    for i, l in enumerate(layers):
        src = [vals[s] for s in l.srcs]
        out_s = q.flow.get(i)
        if l.kind == "conv":
            sx = q.flow.get(l.srcs[0], q.act[l.srcs[0]])
            xc = src[0][0] if isinstance(src[0], tuple) else _codes(
                src[0], sx, qm)
            acc = F.conv2d(xc, q.wq[ci], None, int(l.opts.get("stride", 1)),
                           _pad(l))
            y = acc * (q.ws[ci] * sx).reshape(1, -1, 1, 1)
            y = _epilogue(l, {k: v.to(torch.float64)
                              for k, v in weights[ci].items()}, y)
            ci += 1
        elif l.kind == "maxpool":
            if isinstance(src[0], tuple):
                y = (_maxpool(src[0][0], l), src[0][1])
            else:
                y = _maxpool(src[0], l)
        elif l.kind == "upsample":
            y = (_upsample(src[0][0], l), src[0][1]) if isinstance(
                src[0], tuple) else _upsample(src[0], l)
        elif l.kind == "route" and len(src) == 1:
            y = src[0]
        elif l.kind == "route":
            ss = {v[1] if isinstance(v, tuple) else None for v in src}
            if len(ss) == 1 and None not in ss and out_s in ss:
                y = (torch.cat([v[0] for v in src], dim=1), out_s)
            else:
                y = torch.cat([deq(v) for v in src], dim=1)
        elif l.kind == "shortcut":
            a, b = src
            if isinstance(a, tuple) and isinstance(b, tuple):
                y = (a[0] + b[0]) * a[1]
            else:
                y = deq(a) + deq(b)
        else:  # yolo
            y = deq(src[0])
        if out_s is not None and not isinstance(y, tuple):
            y = (_codes(y, out_s, qm), out_s)
        vals[i] = y
    return [deq(vals[s]) for s, _ in heads(layers)]


def conv_ops(layers: List[Layer], i: int, batch: int) -> int:
    """Multiply-adds times 2 of conv i at `batch`."""
    c = layers[i].in_shape[0]
    k = int(layers[i].opts["size"])
    o, oh, ow = layers[i].shape
    return 2 * batch * o * oh * ow * c * k * k


def residual_branch_ends(layers: List[Layer]) -> set:
    """Convs whose output a shortcut adds to its skip: the last conv of a
    residual branch."""
    return {l.srcs[0] for l in layers if l.kind == "shortcut"
            if layers[l.srcs[0]].kind == "conv"}


def make_weights(layers: List[Layer], seed: int, device,
                 residual_scale: float = 0.1) -> List[Dict[str, torch.Tensor]]:
    """Seeded float32 weights, one dict a conv in cfg order, drawn on
    `device` by one generator in two calls: He-normal conv weights
    (std sqrt(2 / fan_in)); batch norm scale in [0.8, 1.2) (times
    `residual_scale` on the last conv of a residual branch, so 23 adds
    keep the heads in range), shift and mean in [-0.05, 0.05), var in
    [0.5, 1.5); a head's bias in [-0.05, 0.05)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    idx = conv_layers(layers)
    dims = []
    for i in idx:
        dims.append((layers[i].shape[0], layers[i].in_shape[0],
                     int(layers[i].opts["size"])))
    z = torch.randn(sum(o * c * k * k for o, c, k in dims), generator=gen,
                    device=device)
    u = torch.rand(4 * sum(o for o, _, _ in dims), generator=gen,
                   device=device)
    ends = residual_branch_ends(layers)
    out, zo, uo = [], 0, 0
    for i, (o, c, k) in zip(idx, dims):
        n = o * c * k * k
        wt = {"w": (z[zo:zo + n] * math.sqrt(2.0 / (c * k * k))).reshape(
            o, c, k, k)}
        zo += n
        u4 = u[uo:uo + 4 * o].reshape(4, o)
        uo += 4 * o
        if int(layers[i].opts.get("batch_normalize", 0)):
            wt["scale"] = (0.8 + 0.4 * u4[0]) * (
                residual_scale if i in ends else 1.0)
            wt["shift"] = 0.1 * (u4[1] - 0.5)
            wt["mean"] = 0.1 * (u4[2] - 0.5)
            wt["var"] = 0.5 + u4[3]
        else:
            wt["bias"] = 0.1 * (u4[0] - 0.5)
        out.append(wt)
    return out
