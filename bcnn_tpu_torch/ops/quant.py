"""int8 quantization, ported from `bcnn_tpu.ops.quant`: post-training
quantization (PTQ) for inference, the plain int8 conv, deconv and FC
sums, and quantization-aware training (QAT).

Scheme (symmetric PTQ, as in the JAX package):
  - weights: per-output-channel int8, scales from |w|max / 127;
  - activations: per-tensor int8, scales from a calibration pass, kept as
    Python floats computed in double (m / 127.0) and cast to fp32 only
    at use;
  - convs accumulate in int32 (K4, `ops.conv_int8`; grouped and
    depthwise ones K5, `ops.grouped_int8`; the FC and the deconv also
    run on K4) and dequantize with the fused scale fp32(sx) *
    w_scale[o], then BN/bias and the activation in fp32;
  - `plan_int8_flow` decides which activations live as int8 between
    layers.

QAT (`bcnn_tpu/ops/quant.py:231-300`): with net.qat set, TRAIN and
VALID pass each conv, depthwise, deconv and FC input and weight through
a fake quant (quantize-dequantize) with a straight-through gradient
(`fake_quant_ste`, `fake_quant_weight`); the executor tracks each
watched tensor's abs-max as an EMA in the state ("qat_amax/<idx>", made
by `compile.init_params`), and `qat_export` freezes the trained net
into the PTQ dict.

Layouts: conv and depthwise weights are OIHW here, so their scale runs
over dim 0 (the last dim of HWIO in the JAX package); deconv weights
(C, O, k, k) over dim 1 (dim 2 of the JAX package's (k, k, O, C)); FC
weights are (in, out) in both, over dim 1. Each entry of the dict holds
its weight in the layout its kernel reads, made once
(`weight_entry`): a conv's (O, k, k, C) in memory (K4); a grouped or
depthwise one's (k, k, O, C/G) (K5); a deconv's and an FC's the K4
weight of the equivalent conv.
`bridge.quant_from_numpy` carries a JAX `net.quant` across.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

import torch.nn.functional as F

from ..profiling import span
from ..types import LayerType, Mode
from .conv_int8 import conv2d_int32


def _per_channel_int8(w: np.ndarray, axis: int):
    """(q int8, scale fp32) with the scale over `axis`, as
    `bcnn_tpu.ops.quant.quantize_weights` computes them in numpy."""
    other = tuple(a for a in range(w.ndim) if a != axis)
    amax = np.abs(w).max(axis=other)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    shape = [1] * w.ndim
    shape[axis] = -1
    q = np.clip(np.round(w / scale.reshape(shape)), -127, 127).astype(np.int8)
    return q, scale


def quantize_weights(net, params) -> Dict[str, Dict]:
    """Per-output-channel int8 for conv and depthwise (OIHW, scale over
    O), deconv ((C, O, k, k), scale over O) and FC ((in, out), scale
    over out), `bcnn_tpu/ops/quant.py:35-67`. Returns {param_key:
    `weight_entry`} on the params' device."""
    out = {}
    for node in net.nodes:
        axis = _SCALE_AXIS.get(node.type)
        if axis is None:
            continue
        key = net.tensors[node.src[1]].key
        t = params[key]
        q, scale = _per_channel_int8(
            t.detach().cpu().numpy().astype(np.float32), axis
        )
        out[key] = weight_entry(net, node, torch.from_numpy(q).to(t.device),
                                torch.from_numpy(scale).to(t.device))
    return out


# the output-channel axis of each quantized layer's weight, in the port's
# layout
_SCALE_AXIS = {
    LayerType.CONV2D: 0,
    LayerType.DEPTHWISE_CONV2D: 0,
    LayerType.TRANSPOSE_CONV2D: 1,
    LayerType.FULL_CONNECTED: 1,
}


def weight_entry(net, node, q: torch.Tensor, scale: torch.Tensor) -> Dict:
    """A node's quant entry from its int8 weight q (in the port's layout
    of the layer) and fp32 scale, q held in the layout its kernel reads:
    a conv's channels-last ((O, k, k, C) in memory, K4); a grouped
    conv's and a depthwise layer's (k, k, O, C/G) (K5; for depthwise the
    memory of (k, k, 1, O)); a deconv's and
    an FC's as the weight of the conv that K4 runs for them
    (`deconv_k4_weight`, `fc_k4_weight`)."""
    from .grouped_int8 import grouped_weight

    t = node.type
    if t == LayerType.DEPTHWISE_CONV2D or (
        t == LayerType.CONV2D and node.param["num_groups"] > 1
    ):
        q = grouped_weight(q)
    elif t == LayerType.CONV2D:
        q = q.contiguous(memory_format=torch.channels_last)
    elif t == LayerType.TRANSPOSE_CONV2D:
        q = deconv_k4_weight(q)
    else:
        src = net.tensors[node.src[0]]
        q = fc_k4_weight(q, src.c, src.h, src.w)
    return {"q": q, "scale": scale}


def deconv_k4_weight(q: torch.Tensor) -> torch.Tensor:
    """A deconv's int8 weight (C, O, k, k) as the weight of the conv
    that computes it on the stride-dilated input (`dilate_int8`): (O, C,
    k, k), each window turned by 180 degrees, channels-last."""
    return q.flip(2, 3).transpose(0, 1).contiguous(
        memory_format=torch.channels_last)


def fc_k4_weight(q: torch.Tensor, c: int, h: int, w: int) -> torch.Tensor:
    """An FC's int8 weight (in, out), its rows in the NCHW flatten order
    (c, h, w) of a (c, h, w) input, as a 1x1 conv's (out, in, 1, 1) whose
    rows run in (h, w, c) order: the order of the int8 flow's
    channels-last input, flattened as it lies (no copy of x)."""
    o = q.shape[1]
    return q.reshape(c, h, w, o).permute(3, 1, 2, 0).contiguous().reshape(
        o, -1, 1, 1)


def watch_tensors(net) -> List[int]:
    """Tensor indices whose activation scale the int8 paths need: every
    conv/dw/deconv/fc data input plus joiner (eltwise/concat) inputs,
    `bcnn_tpu/ops/quant.py:70-87`."""
    watch = []
    for node in net.nodes:
        if node.type in (
            LayerType.CONV2D,
            LayerType.DEPTHWISE_CONV2D,
            LayerType.TRANSPOSE_CONV2D,
            LayerType.FULL_CONNECTED,
        ):
            watch.append(node.src[0])
        elif node.type == LayerType.ELTWISE:
            watch.extend(node.src[:2])
        elif node.type == LayerType.CONCAT and len(node.src) > 1:
            watch.extend(node.src)
    return sorted(set(watch))


def _kl_threshold(hist: np.ndarray, n_quant: int = 128) -> int:
    """TensorRT-style entropy calibration over a |x| histogram,
    `bcnn_tpu/ops/quant.py:90-127`: the clip bin i (>= n_quant)
    minimizing KL(P_clip || Q_i). Returns the bin index (exclusive upper
    edge of the kept range). Each level's mass and count of nonzero bins
    are bin counts, whole numbers in float64, so their sums are exact in
    any order: Q_i is bcnn_tpu's level loop's, element for element."""
    n_bins = len(hist)
    total = hist.sum()
    if total == 0:
        return n_bins
    best_i, best_kl = n_bins, np.inf
    for i in range(n_quant, n_bins + 1):
        ref = hist[:i].astype(np.float64).copy()
        ref[i - 1] += hist[i:].sum()  # clip: outliers saturate
        p = ref / ref.sum()
        kept = hist[:i].astype(np.float64)
        edges = (np.arange(n_quant + 1) * i) // n_quant
        level = np.repeat(np.arange(n_quant), np.diff(edges))
        nz = kept > 0
        mass = np.bincount(level, weights=kept, minlength=n_quant)
        count = np.bincount(level, weights=nz, minlength=n_quant)
        q = np.where(nz, (mass / np.maximum(count, 1.0))[level], 0.0)
        qs = q.sum()
        if qs == 0:
            continue
        q /= qs
        m = (p > 0) & (q > 0)
        kl = float(np.sum(p[m] * np.log(p[m] / q[m])))
        if ((p > 0) & (q == 0)).any():
            continue
        if kl < best_kl:
            best_kl, best_i = kl, i
    return best_i


def _percentile(v: np.ndarray, p: float) -> float:
    """`jnp.percentile(v, p)` (linear interpolation) in its float32
    arithmetic: position p/100 * (n - 1), the two order statistics
    around it, weighted. (`torch.quantile` refuses tensors above 2^24
    elements.)"""
    v = v.ravel().astype(np.float32)
    n = np.float32(v.size)
    pos = np.float32(np.float32(p) / np.float32(100)) * (n - np.float32(1))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = pos - lo
    w_lo = np.float32(1) - w_hi
    i_lo = int(min(max(lo, 0), n - 1))
    i_hi = int(min(max(hi, 0), n - 1))
    part = np.partition(v, [i_lo, i_hi])
    return float(part[i_lo] * w_lo + part[i_hi] * w_hi)


def calibrate(
    net,
    params,
    state,
    batches: List[np.ndarray],
    method: str = "absmax",
    percentile: float = 99.9,
    kl_bins: int = 2048,
) -> Dict[int, float]:
    """Observe the conv/fc (and joiner) input tensors over calibration
    batches (PREDICT forwards with the net's own dtypes); returns
    {src_tensor_index: activation_scale}, `bcnn_tpu/ops/quant.py:130-225`.
    method "absmax": max |x| / 127; "percentile": the `percentile`-th
    percentile of |x| (as `jnp.percentile` takes it, on the host), max
    over batches, / 127; "kl": entropy calibration over a kl_bins
    histogram of |x|."""
    from ..compile import execute

    if method not in ("absmax", "percentile", "kl"):
        raise ValueError(f"unknown calibration method: {method!r}")
    watch = watch_tensors(net)
    device = next(iter(params.values())).device

    def run(x):
        with torch.inference_mode():
            ex = execute(
                net, params, state,
                {"input": torch.as_tensor(x, dtype=torch.float32,
                                          device=device)},
                Mode.PREDICT,
            )
            return {i: ex.values[i] for i in watch}

    if method == "kl":
        amax = {i: 0.0 for i in watch}
        for x in batches:
            vals = run(x)
            for i in watch:
                amax[i] = max(amax[i], float(vals[i].abs().max()))
        hists = {i: np.zeros(kl_bins, np.int64) for i in watch}
        for x in batches:
            vals = run(x)
            for i in watch:
                if amax[i] <= 0:
                    continue
                v = vals[i].abs().float().cpu().numpy().ravel()
                h, _ = np.histogram(v, bins=kl_bins, range=(0.0, amax[i]))
                hists[i] += h
        scales = {}
        for i in watch:
            if amax[i] <= 0:
                scales[i] = 1.0
                continue
            cut = _kl_threshold(hists[i])
            thresh = (cut + 0.5) * (amax[i] / kl_bins)
            scales[i] = min(thresh, amax[i]) / 127.0
        return scales

    amax = {i: 0.0 for i in watch}
    for x in batches:
        vals = run(x)
        for i in watch:
            v = vals[i].abs()
            if method == "absmax":
                m = float(v.max())
            else:
                m = _percentile(v.float().cpu().numpy(), percentile)
            amax[i] = max(amax[i], m)
    return {i: (m / 127.0 if m > 0 else 1.0) for i, m in amax.items()}


def quantize_tensor(x: torch.Tensor, scale: float) -> torch.Tensor:
    """int8(clip(round(x / scale), -127, 127)), `bcnn_tpu/ops/quant.py:228`:
    a true division in x's dtype (a bf16 x divides by bf16(scale), as a
    weak-typed JAX scalar does), then rounding half to even. The scale
    goes in as a 0-d tensor on x's device: PyTorch turns a division by a
    Python number on the card into a product with its reciprocal. The
    cast to int8 writes a 4-d x channels-last (NHWC in memory), the int8
    flow's layout, in the same pass."""
    with span("bcnn.build.scale"):
        s = torch.tensor(scale, dtype=x.dtype, device=x.device)
    fmt = torch.channels_last if x.dim() == 4 else torch.preserve_format
    return torch.clamp(torch.round(x / s), -127, 127).to(
        torch.int8, memory_format=fmt)


def conv2d_int8(
    x: torch.Tensor, wq: torch.Tensor, x_scale: float,
    w_scale: torch.Tensor, stride: int, pad: int, groups: int = 1,
) -> torch.Tensor:
    """int8 x int8 -> int32 conv, dequantized to fp32:
    fp32(acc) * (fp32(x_scale) * w_scale), `bcnn_tpu/ops/quant.py:302-324`.
    x int8 (N,C,H,W), wq int8 (O,C/groups,k,k), w_scale (O,). The plain
    version of K4's sum (`ops.conv_int8`)."""
    acc = conv2d_int32(x, wq, stride, pad, groups).to(torch.float32)
    return acc * (w_scale * x_scale).reshape(1, -1, 1, 1)


def conv2d_transpose_int8(
    x: torch.Tensor, wq: torch.Tensor, x_scale: float,
    w_scale: torch.Tensor, stride: int, pad: int,
) -> torch.Tensor:
    """The int8 deconv, dequantized to fp32, `bcnn_tpu/ops/quant.py:
    327-345`: x int8 (N,C,H,W), wq int8 (C,O,k,k), w_scale (O,); the int32
    sum taken in float64 (exact), output s*(h-1) + k - 2p. The plain
    version of what the executor runs on K4 (`dilate_int8`,
    `deconv_k4_weight`)."""
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv_transpose2d(x.double(), wq.double(), None, stride, pad)
    return acc.to(torch.int32).to(torch.float32) * (
        w_scale * x_scale).reshape(1, -1, 1, 1)


def fc_int8(
    x: torch.Tensor, wq: torch.Tensor, x_scale: float, w_scale: torch.Tensor
) -> torch.Tensor:
    """The int8 FC, dequantized to fp32, `bcnn_tpu/ops/quant.py:348-355`:
    x int8 (N, in), wq int8 (in, out), w_scale (out,); the int32 sum taken
    in float64 (exact). The plain version of what the executor runs on
    K4 (`fc_k4_weight`)."""
    acc = (x.double() @ wq.double()).to(torch.int32)
    return acc.to(torch.float32) * (w_scale * x_scale)


def dilate_int8(x: torch.Tensor, stride: int) -> torch.Tensor:
    """x (N, C, H, W) with stride - 1 zeros between neighbouring pixels,
    (N, C, (H-1)*stride + 1, (W-1)*stride + 1), channels-last: a plain
    indexed copy; x itself at stride 1."""
    if stride == 1:
        return x
    n, c, h, w = x.shape
    out = torch.empty((n, c, (h - 1) * stride + 1, (w - 1) * stride + 1),
                      dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last).zero_()
    out[:, :, ::stride, ::stride] = x
    return out


def plan_int8_flow(net, quant) -> Dict[int, float]:
    """Which activation tensors can live as int8 between layers, and at
    what scale: `bcnn_tpu/ops/quant.py:358-516`, the same rules and the
    same fixpoint over joiners. Tensor t is int8-viable with scale s iff
    every consumer is (a) a quantized conv/dw/deconv/FC reading t as data
    (wants the calibrated act_scales[t]), (b) a pass-through op that
    commutes exactly with the quantizer (maxpool, nearest upsample,
    single-source concat, dropout) whose own output is viable at s, or
    (c) with flow_joiners (default on) an eltwise add or multi-source
    concat whose inputs all settle on one shared scale, the max of their
    calibrated scales."""
    L = LayerType
    act_scales = quant["act_scales"]
    weights = quant["weights"]

    def data_srcs(c):
        if c.type == L.CONCAT:
            return list(c.src)
        if c.type == L.ELTWISE:
            return list(c.src[:2])
        return [c.src[0]] if c.src else []

    def is_joiner(c):
        return c.type == L.ELTWISE or (
            c.type == L.CONCAT and len(c.src) > 1
        )

    consumers: Dict[int, list] = {}
    for node in net.nodes:
        for s in data_srcs(node):
            consumers.setdefault(s, []).append(node)

    def quant_consumer_scale(c, t):
        if c.type not in (
            L.CONV2D, L.DEPTHWISE_CONV2D, L.TRANSPOSE_CONV2D,
            L.FULL_CONNECTED,
        ):
            return None
        if not c.src or c.src[0] != t:
            return None
        key = net.tensors[c.src[1]].key
        if key not in weights or t not in act_scales:
            return None
        return act_scales[t]

    allow_pass = quant.get("flow_pass", True)
    allow_join = quant.get("flow_joiners", True)

    joiner_scale: Dict[int, float] = {}
    joiners: Dict[int, object] = {}
    enabled = set()
    for nd in net.nodes:
        if not is_joiner(nd):
            continue
        ss = [act_scales.get(s) for s in data_srcs(nd)]
        if allow_join and all(v is not None for v in ss):
            joiner_scale[id(nd)] = max(ss)
            joiners[id(nd)] = nd
            enabled.add(id(nd))

    while True:
        viable: Dict[int, float] = {}
        for node in reversed(net.nodes):
            if not node.dst:
                continue
            d = node.dst[0]
            cons = consumers.get(d, [])
            if not cons:
                continue  # graph output: keep it for the host
            fixed_p, fixed_j, flex, ok = [], [], [], True
            for c in cons:
                s = quant_consumer_scale(c, d)
                if s is not None:
                    flex.append(s)
                    continue
                if is_joiner(c) and id(c) in enabled:
                    fixed_j.append(joiner_scale[id(c)])
                    continue
                passthrough = allow_pass and (
                    c.type in (L.MAXPOOL, L.UPSAMPLE, L.DROPOUT)
                    or (c.type == L.CONCAT and len(c.src) == 1)
                )
                if passthrough and c.dst and c.dst[0] in viable:
                    fixed_p.append(viable[c.dst[0]])
                    continue
                ok = False
                break
            if not ok:
                continue
            # a direct quantized consumer wants the calibrated scale, a
            # pass-through chain exactly its downstream plan scale, a
            # joiner its shared scale (never below the calibrated one)
            if fixed_p and any(f != fixed_p[0] for f in fixed_p):
                continue
            if fixed_j and any(f != fixed_j[0] for f in fixed_j):
                continue
            if fixed_p and flex and fixed_p[0] != flex[0]:
                continue
            if fixed_j:
                sj = fixed_j[0]
                if fixed_p and fixed_p[0] != sj:
                    continue
                if flex and sj < flex[0]:
                    continue
                viable[d] = sj
            elif fixed_p:
                viable[d] = fixed_p[0]
            elif flex:
                viable[d] = flex[0]
        stale = {
            j
            for j in enabled
            if any(
                viable.get(s) != joiner_scale[j]
                for s in data_srcs(joiners[j])
            )
        }
        if not stale:
            return viable
        enabled -= stale


def ptq_synthetic(net, sess, n: int = 4, seed: int = 1,
                  method: str = "absmax") -> Dict:
    """PTQ of a randomly initialized net, as `bench.py` calls it
    (`bcnn_tpu/ops/quant.py:519-541`): BN running variances reset to 1
    (near-zero ones explode the 1/sqrt(var) scale), then calibration on
    one uniform batch drawn with np.random.RandomState(seed), shaped like
    the net's input with min(n, batch) images. Installs and returns
    net.quant."""
    for k in list(sess.state):
        if "run_var" in k:
            sess.state[k] = torch.ones_like(sess.state[k])
    t0 = net.tensors[0]
    calib = np.random.RandomState(seed).rand(
        min(n, t0.n), t0.c, t0.h, t0.w
    ).astype(np.float32)
    net.quant = {
        "act_scales": calibrate(
            net, sess.params, sess.state, [calib], method=method
        ),
        "weights": quantize_weights(net, sess.params),
    }
    return net.quant


# ------------------------------------------------------------------ #
# Quantization-aware training (`bcnn_tpu/ops/quant.py:231-300`)
# ------------------------------------------------------------------ #


def fake_quant_ste(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantize-dequantize with the clipped straight-
    through gradient, as `bcnn_tpu.ops.quant.fake_quant_ste` takes it:
    the value x + (q - x) inside [-127 s, 127 s] (q = clip(round(x / s))
    * s, the difference held constant), q outside; the gradient 1 inside
    and 0 outside. scale (a 0-d tensor or a keepdims per-channel one)
    is a constant. x is promoted to scale's dtype first, as JAX promotes
    a bf16 x against an fp32 scale; the division is a true one, also on
    the card."""
    s = scale.detach()
    x = x.to(torch.promote_types(x.dtype, s.dtype))
    q = (torch.clamp(torch.round(x / s), -127.0, 127.0) * s).detach()
    inside = x.abs() <= 127.0 * s
    return torch.where(inside, x + (q - x).detach(), q)


def fake_quant_weight(w: torch.Tensor, reduce_axes) -> torch.Tensor:
    """Per-output-channel fake quant of a weight: the scale over the
    non-output axes (`QAT_WEIGHT_AXES`), max|w| / 127 (1 for an all-zero
    channel), the grid `quantize_weights` exports."""
    amax = torch.amax(w.detach().abs(), dim=tuple(reduce_axes),
                      keepdim=True)
    s127 = torch.tensor(127.0, dtype=amax.dtype, device=amax.device)
    scale = torch.where(amax > 0, amax, s127) / s127
    return fake_quant_ste(w, scale)


# the non-output axes of each layer's weight in the port's layouts: conv
# and depthwise OIHW, deconv (C, O, k, k), FC (in, out)
QAT_WEIGHT_AXES = {
    LayerType.CONV2D: (1, 2, 3),
    LayerType.DEPTHWISE_CONV2D: (1, 2, 3),
    LayerType.TRANSPOSE_CONV2D: (0, 2, 3),
    LayerType.FULL_CONNECTED: (0,),
}


def qat_state_keys(net) -> List[str]:
    return [f"qat_amax/{i}" for i in watch_tensors(net)]


def qat_export(net, params, state) -> Dict:
    """Freeze a QAT-trained (params, state) into the net.quant dict of
    the int8 PREDICT path, as `calibrate` + `quantize_weights` make it:
    each watched tensor's scale from its trained EMA abs-max (m / 127 in
    double, 1 where it is 0), the weights quantized from the params."""
    act_scales = {}
    for i in watch_tensors(net):
        v = state.get(f"qat_amax/{i}")
        m = 0.0 if v is None else float(v)
        act_scales[i] = m / 127.0 if m > 0 else 1.0
    return {
        "act_scales": act_scales,
        "weights": quantize_weights(net, params),
    }
