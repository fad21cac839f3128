"""Config files (.conf / Darknet .cfg): both dialects, ported from
`bcnn_tpu.config` with the same grammar and rules.

  - bh_ini (src/bh/inc/bh/bh_ini.h): `[name]` section lines; every other
    non-empty line not starting with '!', '#' or ';' is one `key=value`
    pair; all whitespace is stripped from a line first (bh_strstrip,
    bh_string.h:138-150), so `anchors = 10,14,  23,27` parses;
  - bcnn_net_set_param (bcnn_net.c:506-593): the first section is [net]
    or [network] and carries net, learner and augmenter parameters;
  - bcnn_layer_param_set (bcnn_net.c:757-969): per-layer keys in two
    dialects, chosen by the weight file's extension (.weights: Darknet,
    bcnn_load_net :1117-1135):
      * bcnn (fmt 0): explicit `src=` / `dst=` tensor names, `pad=`
        literal;
      * Darknet (fmt 1): implicit names lid<N> (src lid{i-1}, dst lid{i}
        for section i, :1188-1201), `pad=1` meaning k/2, `layers=`
        ([route]) and `from=` ([shortcut]) with negative relative
        indices, `padding=` literal with the SAME/VALID flip;
  - bcnn_add_layer (bcnn_net.c:971-1112): section name -> builder.

Beyond bcnn, for Darknet cfgs that bcnn cannot read (YOLOv4, YOLOv7):
the activations `mish` and `swish` (`Activation.MISH`, `SWISH`; any
other unknown name, `logistic` among them, still falls back to RELU, as
in the reference), a [yolo] section's `scale_x_y` (default 1) and
`new_coords` (default 0), and, in the Darknet dialect:
  - Darknet's max-pool (maxpool_layer.c): `padding` (default size - 1)
    pads the input, a window starts at i * stride - padding / 2, so odd
    windows are centred, and the output is (w + padding - size) / stride
    + 1. Pools whose window starts at 0 (every size-2 pool) build as in
    bcnn;
  - a [yolo] section with `new_coords=1` takes the logistic of the conv
    before it (Darknet applies `activation=logistic` in that conv and
    skips it in the layer): that conv is built linear and the head
    applies the logistic to all its channels (`add_sections`). A
    `logistic` anywhere else keeps the fallback.

As in `bcnn_tpu`, LRN's alpha / beta / k parse as floats where the
reference takes atoi (:880-884). `load_net` with a weight file stages
the loaded tensors (CPU, float32) on `net._loaded_params` /
`net._loaded_state`, which `Session.compile_net` takes ahead of its own
initial values.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .graph import Net
from .types import (
    Activation,
    FillerType,
    Loss,
    LrDecay,
    Metric,
    Optimizer,
    Padding,
)

_ACTIVATIONS = {
    "relu": Activation.RELU,
    "tanh": Activation.TANH,
    "ramp": Activation.RAMP,
    "clamp": Activation.CLAMP,
    "softplus": Activation.SOFTPLUS,
    "leaky_relu": Activation.LRELU,
    "lrelu": Activation.LRELU,
    "leaky": Activation.LRELU,
    "prelu": Activation.PRELU,
    "abs": Activation.ABS,
    "none": Activation.NONE,
    "linear": Activation.NONE,
    "mish": Activation.MISH,  # the port's own: bcnn has no Mish
    "swish": Activation.SWISH,  # the port's own: bcnn has no Swish
    # NB: "logistic" is NOT mapped — the reference's parser has no entry
    # for it and falls back to ReLU with a warning (bcnn_net.c:889-916);
    # replicated for config parity (verified by the randomized parity
    # tests). Programmatic nets can still use Activation.LOGISTIC.
}

_METRICS = {
    "error": Metric.ERROR_RATE,
    "logloss": Metric.LOGLOSS,
    "sse": Metric.SSE,
    "mse": Metric.MSE,
    "crps": Metric.CRPS,
    "dice": Metric.DICE,
}

_DECAYS = {
    "sigmoid": LrDecay.SIGMOID,
    "constant": LrDecay.CONSTANT,
    "exp": LrDecay.EXP,
    "inv": LrDecay.INV,
    "step": LrDecay.STEP,
    "poly": LrDecay.POLY,
}


@dataclass
class IniSection:
    name: str
    keys: List[Tuple[str, str]] = field(default_factory=list)


def parse_ini(path: str) -> List[IniSection]:
    sections: List[IniSection] = []
    with open(path) as f:
        for raw in f:
            line = "".join(raw.split())  # strip ALL whitespace (bh_strstrip)
            if not line or line[0] in "!#;":
                continue
            if line[0] == "[":
                sections.append(IniSection(name=line))
                continue
            if "=" not in line or not sections:
                raise ValueError(f"Invalid key line {raw!r}")
            k, _, v = line.partition("=")
            sections[-1].keys.append((k, v))
    return sections


@dataclass
class LayerParam:
    """Mirror of bcnn_layer_param defaults (bcnn_net.c:716-744)."""

    stride: int = 1
    pad: int = 0
    n_filts: int = 1
    size: int = 3
    outputs: int = 0
    num_groups: int = 1
    batchnorm: int = 0
    in_w: int = 0
    in_h: int = 0
    in_c: int = 0
    num_anchors: int = 0
    boxes_per_cell: int = 0
    num_classes: int = 0
    num_coords: int = 4
    alpha: float = 0.0
    beta: float = 0.0
    k: float = 0.0
    rate: float = 1.0
    padding_type: Padding = Padding.SAME
    a: Activation = Activation.NONE
    init: FillerType = FillerType.XAVIER
    cost: Metric = Metric.SSE
    loss: Loss = Loss.EUCLIDEAN
    src_id: Optional[List[str]] = None
    dst_id: Optional[str] = None
    anchors_mask: Optional[List[int]] = None
    anchors: Optional[List[float]] = None
    # the port's own, for Darknet cfgs: a [yolo] section's scale_x_y and
    # new_coords, and the Darknet dialect's `padding=` as Darknet's
    # max-pool reads it
    scale_x_y: float = 1.0
    new_coords: int = 0
    darknet_padding: Optional[int] = None


def _darknet_lid(section_idx: int, l: int) -> str:
    """layers=/from= index mapping (bcnn_net.c:925-967)."""
    return f"lid{l + 1}" if l >= 0 else f"lid{section_idx + l}"


def layer_param_set(
    lp: LayerParam, section_idx: int, name: str, val: str, fmt: int
) -> None:
    if name in ("dropout_rate", "rate"):
        lp.rate = float(val)
    elif name == "filters":
        lp.n_filts = int(val)
    elif name == "size":
        lp.size = int(val)
    elif name == "stride":
        lp.stride = int(val)
    elif name == "padding":
        if fmt == 1:
            lp.pad = int(val)
            lp.padding_type = Padding.SAME if lp.pad else Padding.VALID
            lp.darknet_padding = lp.pad
    elif name == "pad":
        if fmt == 0:
            lp.pad = int(val)
        else:
            lp.pad = lp.size // 2 if int(val) else 0
    elif name in ("num_groups", "groups"):
        lp.num_groups = int(val)
    elif name == "boxes_per_cell":
        lp.boxes_per_cell = int(val)
    elif name in ("num_anchors", "num"):
        lp.num_anchors = int(val)
    elif name in ("num_classes", "classes"):
        lp.num_classes = int(val)
    elif name == "num_coords":
        lp.num_coords = int(val)
    elif name == "anchors":
        lp.anchors = [float(x) for x in val.split(",") if x]
    elif name in ("anchors_mask", "mask"):
        lp.anchors_mask = [int(x) for x in val.split(",") if x]
        lp.boxes_per_cell = len(lp.anchors_mask)
    elif name == "alpha":
        lp.alpha = float(val)
    elif name == "beta":
        lp.beta = float(val)
    elif name == "k":
        lp.k = float(val)
    elif name == "w":
        lp.in_w = int(val)
    elif name == "h":
        lp.in_h = int(val)
    elif name == "c":
        lp.in_c = int(val)
    elif name in ("bn", "batchnorm", "batch_normalize"):
        lp.batchnorm = int(val)
    elif name == "src":
        lp.src_id = val.split(",")
    elif name == "dst":
        lp.dst_id = val
    elif name == "output":
        lp.outputs = int(val)
    elif name == "padding_type":
        lp.padding_type = {
            "same": Padding.SAME,
            "valid": Padding.VALID,
            "caffe": Padding.CAFFE,
        }.get(val, Padding.SAME)
    elif name in ("function", "activation"):
        lp.a = _ACTIVATIONS.get(val, Activation.RELU)
    elif name == "init":
        lp.init = {"xavier": FillerType.XAVIER, "msra": FillerType.MSRA}.get(
            val, FillerType.XAVIER
        )
    elif name == "metric":
        lp.cost = _METRICS.get(val, Metric.SSE)
    elif name == "loss":
        lp.loss = {
            "l2": Loss.EUCLIDEAN,
            "euclidean": Loss.EUCLIDEAN,
            "lifted_struct_similarity": Loss.LIFTED_STRUCT,
        }.get(val, Loss.EUCLIDEAN)
    elif name == "layers":  # Darknet [route]
        ls = [int(x) for x in val.split(",") if x]
        lp.src_id = [_darknet_lid(section_idx, l) for l in ls]
    elif name == "from":  # Darknet [shortcut]
        lp.src_id = [
            f"lid{section_idx - 1}",
            _darknet_lid(section_idx, int(val)),
        ]
    elif name == "scale_x_y":  # Darknet [yolo]
        lp.scale_x_y = float(val)
    elif name == "new_coords":  # Darknet [yolo]
        lp.new_coords = int(val)
    # unknown keys are silently ignored, like the reference


def net_set_param(net: Net, name: str, val: str) -> None:
    """bcnn_net_set_param (bcnn_net.c:506-593)."""
    t0 = net.tensors[0]
    ln = net.learner
    aug = net.data_aug
    if name in ("input_width", "width"):
        t0.w = int(val)
    elif name in ("input_height", "height"):
        t0.h = int(val)
    elif name in ("input_channels", "channels"):
        t0.c = int(val)
    elif name in ("batch_size", "batch"):
        net.batch_size = int(val)
        t0.n = int(val)
    elif ln and name == "max_batches":
        ln.max_batches = int(val)
    elif ln and name in ("learning_policy", "decay_type"):
        ln.decay_type = _DECAYS.get(val, LrDecay.CONSTANT)
    elif ln and name == "optimizer":
        if val == "sgd":
            ln.optimizer = Optimizer.SGD
        elif val == "adam":
            ln.optimizer = Optimizer.ADAM
    elif ln and name == "step":
        ln.step = int(val)
    elif ln and name == "learning_rate":
        ln.base_learning_rate = float(val)
    elif ln and name == "beta1":
        ln.beta1 = float(val)
    elif ln and name == "beta2":
        ln.beta2 = float(val)
    elif ln and name == "decay":
        ln.decay = float(val)
    elif ln and name == "momentum":
        ln.momentum = float(val)
    elif ln and name == "gamma":
        ln.gamma = float(val)
    elif ln and name == "scale":
        ln.scale = float(val)
    elif ln and name == "power":
        ln.power = float(val)
    elif name == "range_shift_x":
        aug["range_shift_x"] = int(val)
    elif name == "range_shift_y":
        aug["range_shift_y"] = int(val)
    elif name == "min_scale":
        aug["min_scale"] = float(val)
    elif name == "max_scale":
        aug["max_scale"] = float(val)
    elif name == "rotation_range":
        aug["rotation_range"] = float(val)
    elif name == "min_contrast":
        aug["min_contrast"] = float(val)
    elif name == "max_contrast":
        aug["max_contrast"] = float(val)
    elif name == "min_brightness":
        aug["min_brightness"] = int(val)
    elif name == "max_brightness":
        aug["max_brightness"] = int(val)
    elif name == "max_distortion":
        aug["max_distortion"] = float(val)
    elif name == "max_spots":
        aug["max_random_spots"] = float(val)
    elif name == "flip_h":
        aug["random_fliph"] = 1
    elif name == "mean_r":
        aug["mean_r"] = float(val) / 255.0
    elif name == "mean_g":
        aug["mean_g"] = float(val) / 255.0
    elif name == "mean_b":
        aug["mean_b"] = float(val) / 255.0
    elif name == "swap_to_bgr":
        aug["swap_to_bgr"] = int(val)
    elif name == "no_input_norm":
        aug["no_input_norm"] = int(val)


def add_layer(net: Net, section_name: str, lp: LayerParam,
              fmt: int = 0) -> None:
    """bcnn_add_layer dispatch (bcnn_net.c:971-1112); fmt 1 (Darknet)
    builds a max-pool by Darknet's rule."""
    name = section_name
    if len(net.nodes) == 0:
        t0 = net.tensors[0]
        if name != "[input]" and (t0.w <= 0 or t0.h <= 0 or t0.c <= 0):
            raise ValueError("Input's width, height and channels must be > 0")
    if not lp.src_id:
        raise ValueError("Invalid input node name (missing 'src')")
    src0 = lp.src_id[0]

    def need_dst():
        if not lp.dst_id:
            raise ValueError(f"{name}: missing 'dst'")
        return lp.dst_id

    if name == "[input]":
        net.add_input(lp.in_w, lp.in_h, lp.in_c, src0)
    elif name in ("[conv]", "[convolutional]"):
        net.add_convolutional_layer(
            lp.n_filts, lp.size, lp.stride, lp.pad, lp.num_groups,
            lp.batchnorm, lp.init, lp.a, 0, src0, need_dst(),
        )
    elif name in ("[deconv]", "[deconvolutional]"):
        net.add_deconvolutional_layer(
            lp.n_filts, lp.size, lp.stride, lp.pad, lp.init, lp.a,
            src0, need_dst(),
        )
    elif name in ("[depthwise-conv]", "[dw-conv]"):
        net.add_depthwise_conv_layer(
            lp.size, lp.stride, lp.pad, 0, lp.init, lp.a, src0, need_dst()
        )
    elif name in ("[activation]", "[nl]"):
        net.add_activation_layer(lp.a, src0)
    elif name in ("[batchnorm]", "[bn]"):
        net.add_batchnorm_layer(src0, need_dst())
    elif name == "[lrn]":
        net.add_lrn_layer(lp.size, lp.alpha, lp.beta, lp.k, src0, need_dst())
    elif name in ("[connected]", "[fullconnected]", "[fc]", "[ip]"):
        net.add_fullc_layer(lp.outputs, lp.init, lp.a, 0, src0, need_dst())
    elif name == "[softmax]":
        net.add_softmax_layer(src0, need_dst())
    elif name in ("[max]", "[maxpool]"):
        darknet = None
        if fmt == 1:
            darknet = (lp.size - 1 if lp.darknet_padding is None
                       else lp.darknet_padding)
        net.add_maxpool_layer(
            lp.size, lp.stride, lp.padding_type, src0, need_dst(),
            darknet_padding=darknet,
        )
    elif name == "[avgpool]":
        net.add_avgpool_layer(src0, need_dst())
    elif name == "[upsample]":
        net.add_upsample_layer(lp.stride, src0, need_dst())
    elif name == "[dropout]":
        net.add_dropout_layer(lp.rate, src0)
    elif name in ("[concat]", "[route]"):
        net.add_concat_layer(lp.src_id, need_dst())
    elif name in ("[eltwise]", "[shortcut]"):
        net.add_eltwise_layer(lp.a, lp.src_id[0], lp.src_id[1], need_dst())
    elif name == "[yolo]":
        net.add_yolo_layer(
            lp.boxes_per_cell, lp.num_classes, lp.num_coords,
            lp.num_anchors, lp.anchors_mask, lp.anchors, src0, need_dst(),
            scale_x_y=lp.scale_x_y, new_coords=lp.new_coords,
        )
    elif name == "[cost]":
        net.add_cost_layer(lp.loss, lp.cost, 1.0, src0, "label", need_dst())
    else:
        raise ValueError(f"Unknown Layer {name}")


def add_sections(net: Net, sections: List[IniSection], fmt: int) -> None:
    """The layers of a parsed config, sections[1:] (bcnn_load_net's loop,
    bcnn_net.c:1181-1205): in the Darknet dialect (fmt 1) a section's
    src and dst default to the implicit lid<N> names, and a conv whose
    `activation=logistic` a following [yolo] with `new_coords=1` takes
    is built linear."""
    for i in range(1, len(sections)):
        lp = LayerParam()
        for k, v in sections[i].keys:
            layer_param_set(lp, i, k, v, fmt)
        if fmt == 1 and _head_takes_logistic(sections, i):
            lp.a = Activation.NONE
        if fmt == 1:
            if lp.src_id is None:
                lp.src_id = [f"lid{i - 1}"]
            if lp.dst_id is None:
                lp.dst_id = f"lid{i}"
        add_layer(net, sections[i].name, lp, fmt)


def _head_takes_logistic(sections: List[IniSection], i: int) -> bool:
    """Whether section i is a conv with `activation=logistic` that the
    [yolo] section after it, with `new_coords=1`, applies itself."""
    if i + 1 >= len(sections) or sections[i + 1].name != "[yolo]":
        return False
    conv = dict(sections[i].keys)
    return (sections[i].name in ("[conv]", "[convolutional]")
            and conv.get("activation") == "logistic"
            and int(dict(sections[i + 1].keys).get("new_coords", 0)) == 1)


def load_net(
    net: Net, config_path: str, model_path: Optional[str] = None
) -> Net:
    """bcnn_load_net (bcnn_net.c:1114-1218): parse config (dialect chosen by
    the model file's extension), build the graph, then load weights."""
    fmt = 0
    if model_path is not None:
        ext = model_path.rsplit(".", 1)
        if len(ext) < 2:
            raise ValueError(
                f"File {model_path} needs an extension "
                "(.bcnnmodel OR .onnx OR .weights)"
            )
        if ext[-1] == "weights":
            fmt = 1
        elif ext[-1] == "onnx":
            fmt = 2

    sections = parse_ini(config_path)
    if not sections:
        raise ValueError(f"Empty config file {config_path}")
    if sections[0].name not in ("[net]", "[network]"):
        raise ValueError(
            f"Invalid config file {config_path}: first section must be "
            "[net] or [network]"
        )
    if not sections[0].keys:
        raise ValueError(f"Invalid config file {config_path}: empty [net]")
    for k, v in sections[0].keys:
        net_set_param(net, k, v)
    add_sections(net, sections, fmt)

    if model_path is not None:
        from .compile import init_params
        from .serialization import load_weights

        params, state = init_params(net, seed=0)
        load_weights(net, params, state, model_path)
        net._loaded_params = params  # taken by Session.compile_net
        net._loaded_state = state
    return net
