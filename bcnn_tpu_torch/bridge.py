"""Hand weights and training state between the JAX package and the port.

`bcnn_tpu` and the port draw their weights from different generators, so
a parity check makes them once, with `bcnn_tpu`, and passes them over as
numpy arrays keyed by `TensorSpec.key` (`np.asarray` of `Session.params`,
`Session.state` and the leaves of `Session.opt_state`). Conv and
depthwise weights (and their optimizer buffers) are HWIO there and OIHW
here, deconv weights (k, k, O, C) there and (C, O, k, k) here (one
transpose maps both); FC weights are (in, out) in both.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .graph import Net
from .types import Activation, LayerType


def _conv_weight_keys(net: Net) -> set:
    """Weights that are HWIO-like in bcnn_tpu: conv (k,k,I,O), depthwise
    (k,k,1,C) and deconv (k,k,O,C); the same transpose makes them the
    port's OIHW, (C,1,k,k) and (C,O,k,k)."""
    return {
        net.tensors[n.src[1]].key
        for n in net.nodes
        if n.type in (LayerType.CONV2D, LayerType.DEPTHWISE_CONV2D,
                      LayerType.TRANSPOSE_CONV2D)
    }


def tensors_from_numpy(
    net: Net, arrays: Mapping[str, np.ndarray], device="cpu"
) -> Dict[str, torch.Tensor]:
    """Each array as a float32 tensor on `device`, conv weights HWIO ->
    OIHW, checked against its spec's shape."""
    conv_w = _conv_weight_keys(net)
    shapes = {t.key: t.mem_shape for t in net.tensors if t.key is not None}
    out = {}
    for k, v in arrays.items():
        a = np.asarray(v, np.float32)
        if k in conv_w:
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if a.shape != shapes[k]:
            raise ValueError(f"{k}: shape {a.shape}, expected {shapes[k]}")
        # np.array copies: arrays taken from JAX are read-only
        out[k] = torch.from_numpy(np.array(a, order="C")).to(device)
    return out


def params_from_numpy(
    net: Net,
    params_np: Mapping[str, np.ndarray],
    state_np: Mapping[str, np.ndarray],
    device="cpu",
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, state) of `net` as float32 tensors on `device`; the state
    also carries net.qat's ranges ("qat_amax/<idx>", 0-d; the index is
    the same tensor's in both packages) where state_np has them."""
    state = tensors_from_numpy(
        net, {t.key: state_np[t.key] for t in net.state_specs()}, device)
    state.update({
        k: torch.tensor(float(np.asarray(v)), dtype=torch.float32,
                        device=device)
        for k, v in state_np.items() if k.startswith("qat_amax/")})
    return (
        tensors_from_numpy(
            net, {t.key: params_np[t.key] for t in net.param_specs()}, device
        ),
        state,
    )


def params_to_numpy(
    net: Net, tensors: Mapping[str, torch.Tensor]
) -> Dict[str, np.ndarray]:
    """The inverse of `params_from_numpy` for one dict (params, state or
    an optimizer buffer dict): numpy arrays in the JAX package's layout,
    conv weights OIHW -> HWIO."""
    conv_w = _conv_weight_keys(net)
    out = {}
    for k, v in tensors.items():
        a = v.detach().cpu().numpy()
        out[k] = a.transpose(2, 3, 1, 0) if k in conv_w else a
    return out


def opt_state_from_numpy(
    net: Net, opt_np: Mapping[str, Any], device="cpu"
) -> Dict[str, Any]:
    """A JAX optimizer state ({"seen", "velocity", "adam_m", "adam_v"},
    leaves as numpy arrays) as the port's: `seen` a Python int, the
    buffers float32 tensors on `device` in the port's layout."""
    out: Dict[str, Any] = {"seen": int(np.asarray(opt_np["seen"]))}
    for name in ("velocity", "adam_m", "adam_v"):
        out[name] = tensors_from_numpy(net, opt_np[name], device)
    return out


def he_numpy_weights(
    net: Net, seed: int = 0, residual_scale: float = 1.0
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(params, state) of `net` as numpy arrays in bcnn_tpu's layout,
    drawn in tensor order from `np.random.RandomState(seed)`, for parity
    runs that hand the same weights to both packages. Each conv,
    depthwise and FC weight is normal with std sqrt(2 / fan_in) (fan_in:
    the HWIO dims other than O, or the FC's `in`; a deconv's likewise),
    so a deep ReLU net keeps its activations at O(1); the nets' own
    XAVIER fillers let MobileNet-v1's fade to nothing over its 27 ReLU
    layers. Biases and BN shifts (a conv's, or a standalone BN layer's)
    are U(-0.1, 0.1), BN scales U(0.8, 1.2), run_mean U(-0.1, 0.1),
    run_var U(0.5, 1.5), PReLU slopes U(0.05, 0.3). Tensors are told apart by their
    node's type and src slot, never by name. residual_scale multiplies
    the BN scales of each conv whose output is an eltwise's first input
    (a residual branch, Darknet's [shortcut] from the layer before):
    each residual add then grows the trunk's variance by residual_scale^2
    instead of doubling it, so a deep residual net (YOLOv3's 23
    shortcuts) keeps its activations O(1)."""
    role = {}
    for node in net.nodes:
        if node.type in (
            LayerType.CONV2D,
            LayerType.DEPTHWISE_CONV2D,
            LayerType.TRANSPOSE_CONV2D,
            LayerType.FULL_CONNECTED,
        ):
            role[node.src[1]] = "w"
            role[node.src[2]] = "b"
            if node.type == LayerType.CONV2D and node.param["batch_norm"]:
                for slot, r in ((3, "mean"), (4, "var"), (5, "scales")):
                    role[node.src[slot]] = r
            if (node.type == LayerType.CONV2D
                    and node.param["activation"] == Activation.PRELU):
                role[node.src[6 if node.param["batch_norm"] else 3]] = (
                    "slopes")
        elif node.type == LayerType.BATCHNORM:
            for slot, r in ((1, "mean"), (2, "var"), (3, "scales"),
                            (4, "b")):
                role[node.src[slot]] = r
        elif (node.type == LayerType.ACTIVATION
              and node.param["activation"] == Activation.PRELU):
            role[node.src[1]] = "slopes"
    branch = {n.src[0] for n in net.nodes if n.type == LayerType.ELTWISE}
    damped = {
        n.src[5] for n in net.nodes
        if n.type == LayerType.CONV2D and n.param["batch_norm"]
        and n.dst[0] in branch
    }
    conv_w = _conv_weight_keys(net)
    bounds = {"b": (-0.1, 0.1), "mean": (-0.1, 0.1), "var": (0.5, 1.5),
              "scales": (0.8, 1.2), "slopes": (0.05, 0.3)}
    rng = np.random.RandomState(seed)
    params, state = {}, {}
    for i, t in enumerate(net.tensors):
        if t.key is None:
            continue
        r = role.get(i)
        if r is None:
            raise ValueError(f"he_numpy_weights: no rule for {t.key}")
        shape = t.mem_shape
        if r == "w":
            if t.key in conv_w:
                o, ci, kh, kw = shape
                shape, fan_in = (kh, kw, ci, o), kh * kw * ci  # HWIO
            else:
                fan_in = shape[0]
            a = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
        else:
            a = rng.uniform(*bounds[r], shape)
            if i in damped:
                a = a * residual_scale
        (state if r in ("mean", "var") else params)[t.key] = a.astype(
            np.float32
        )
    return params, state


def quant_from_numpy(
    net: Net, quant_np: Mapping[str, Any], device="cpu"
) -> Dict[str, Any]:
    """A JAX `net.quant` (`bcnn_tpu.ops.quant`: PTQ's or QAT's scales and
    int8 weights, leaves as numpy arrays or JAX arrays) as the port's:
    `act_scales` keep their tensor-index keys and float values; each
    weight's `q` goes into the port's layout of its layer (conv and
    depthwise HWIO -> OIHW, deconv (k, k, O, C) -> (C, O, k, k), FC
    (in, out) as it is) as int8 on `device`, with its fp32 `scale`, and
    is then held as `ops.quant.weight_entry` holds it (each in the
    layout its kernel reads, made here once); `act_flow`, `flow_pass`
    and `flow_joiners` are copied."""
    from .ops.quant import weight_entry

    conv_w = _conv_weight_keys(net)
    nodes = {net.tensors[n.src[1]].key: n for n in net.nodes
             if len(n.src) > 1 and net.tensors[n.src[1]].key is not None}
    weights = {}
    for k, entry in quant_np["weights"].items():
        q = np.asarray(entry["q"])
        if q.dtype != np.int8:
            raise ValueError(f"{k}: int8 weights expected, got {q.dtype}")
        t = torch.from_numpy(np.array(q, order="C"))
        if k in conv_w:  # HWIO-like -> the port's (O, I, k, k) order
            t = t.permute(3, 2, 0, 1)
        weights[k] = weight_entry(
            net, nodes[k], t.to(device),
            torch.from_numpy(np.array(entry["scale"], np.float32)).to(device),
        )
    out = {
        "act_scales": {int(i): float(s)
                       for i, s in quant_np["act_scales"].items()},
        "weights": weights,
    }
    for k in ("act_flow", "flow_pass", "flow_joiners"):
        if k in quant_np:
            out[k] = quant_np[k]
    return out
