"""Graph executor: runs the declarative Net on torch tensors, the ported
subset of `bcnn_tpu.compile`: PREDICT/VALID forwards (YOLOv3-tiny and
MobileNet-v1 layers) in fp32, at bf16 (net.compute_dtype, net.act_dtype)
and, in PREDICT, at int8 (net.quant: PTQ with int8 activations between
layers, the convs on K4), the detection program and the fp32 TRAIN step.

PyTorch runs eagerly, so the executor is a loop over the nodes that
calls one op per node; nothing is traced, and autograd records the TRAIN
forward for the backward. Conventions:
  - `params`: dict key -> tensor, the learned tensors (PARAM specs);
  - `state`:  dict key -> tensor, BN running stats (STATE specs);
  - `values`: tensor index -> tensor; activations have NCHW shapes
    throughout, conv weights OIHW; the int8 flow's activations are held
    channels-last (NHWC in memory), the layout K4 reads and writes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import ops
from .graph import Net, Node, TensorKind
from .types import Activation, LayerType, Mode


def init_params(
    net: Net, seed: int = 0, device="cpu"
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Create (params, state) from the tensor specs' fillers, drawn in
    tensor order from one `torch.Generator` seeded with `seed`;
    unfilled tensors are zeros (calloc semantics, bh_align_calloc)."""
    gen = torch.Generator().manual_seed(seed)
    params: Dict[str, torch.Tensor] = {}
    state: Dict[str, torch.Tensor] = {}
    for t in net.tensors:
        if t.kind == TensorKind.PARAM:
            v = (
                t.filler(gen, t.mem_shape)
                if t.filler is not None
                else torch.zeros(t.mem_shape, dtype=torch.float32)
            )
            params[t.key] = v.to(device)
        elif t.kind == TensorKind.STATE:
            state[t.key] = torch.zeros(
                t.mem_shape, dtype=torch.float32, device=device
            )
    return params, state


# layers whose reference backward OVERWRITES the src grad buffer instead
# of accumulating into it: conv dX ends in a zeroing col2im (bcnn_mat.c
# bcnn_col2im), deconv dX is a beta=0 GEMM (bcnn_deconv_layer.c:236-244),
# standalone BN copies its dx (bcnn_batchnorm_layer.c:326-329), LRN
# overwrites via bcnn_pow; every other layer accumulates (+=)
_OVERWRITE_BWD = frozenset(
    {
        LayerType.CONV2D,
        LayerType.TRANSPOSE_CONV2D,
        LayerType.BATCHNORM,
        LayerType.LRN,
    }
)


def _data_srcs(node: Node):
    """The tensor indices a node reads as DATA (grad-carrying inputs),
    mirroring which src slots the reference's backward writes."""
    if node.type == LayerType.CONCAT:
        return list(node.src)
    if node.type == LayerType.ELTWISE:
        return list(node.src[:2])
    return [node.src[0]] if node.src else []


def build_grad_routing(net: Net):
    """Static SSA pass: for every produced tensor VERSION with more than
    one consumer of which at least one overwrites its grad in the
    reference backward, record the ordered consumer list. Key:
    (tensor index, producing node position) -> [(consumer pos, ov)]."""
    version_producer: Dict[int, int] = {}
    consumers: Dict[Tuple[int, int], list] = {}
    for i, node in enumerate(net.nodes):
        for s in _data_srcs(node):
            key = (s, version_producer.get(s, -1))
            lst = consumers.setdefault(key, [])
            if lst and lst[-1][0] == i:
                continue  # same node reading twice: one tap, summed edges
            lst.append((i, node.type in _OVERWRITE_BWD))
        for d in node.dst:
            version_producer[d] = i
    return {
        k: lst
        for k, lst in consumers.items()
        if k[1] >= 0  # graph inputs carry no grad in the reference
        and len(lst) >= 2
        and any(ov for _, ov in lst)
    }


class _GradSplit(torch.autograd.Function):
    """Identity fan-out, one output per consumer, whose backward combines
    the consumer gradients the way the reference's reverse node scan
    writes the shared grad buffer: from the LATEST consumer to the
    earliest, an accumulating consumer adds its gradient and an
    overwriting one replaces the running value. Plain autograd would sum
    them all."""

    @staticmethod
    def forward(ctx, flags, x):
        ctx.flags = flags
        return tuple(x.clone() for _ in flags)

    @staticmethod
    def backward(ctx, *gs):
        val = None
        for g, ov in reversed(list(zip(gs, ctx.flags))):
            val = g if (ov or val is None) else val + g
        return None, val


_grad_split = _GradSplit.apply

# net attributes that bcnn_tpu honours and the port does not yet, each
# with the modes in which bcnn_tpu reads it
_UNPORTED = (
    ("train_act_dtype", (Mode.TRAIN,)),
    ("qat", (Mode.TRAIN, Mode.VALID)),
    ("bn_frozen_stats", (Mode.TRAIN,)),
    ("yolo_stats", (Mode.TRAIN,)),
    ("compute_dtype", (Mode.TRAIN,)),
)


def refuse_unported(net: Net, mode: Mode) -> None:
    """Raise NotImplementedError for a set attribute that `bcnn_tpu`
    would honour in `mode` and the port cannot: never ignore it."""
    for attr, modes in _UNPORTED:
        if mode in modes and getattr(net, attr, None):
            raise NotImplementedError(
                f"bcnn_tpu_torch: net.{attr} in {mode.name} mode is not "
                "ported yet"
            )


class _Executor:
    """One pass over the graph in any mode."""

    def __init__(
        self,
        net: Net,
        params: Dict[str, torch.Tensor],
        state: Dict[str, torch.Tensor],
        mode: Mode,
    ):
        self.net = net
        self.params = params
        # TRAIN writes the new running stats here, not into the caller's
        self.state = dict(state)
        self.mode = mode
        self.values: Dict[int, torch.Tensor] = {}
        self.surrogate: Optional[torch.Tensor] = None
        self.metrics = []  # per cost node reported value
        refuse_unported(net, mode)
        # bcnn_tpu/compile.py:174-215: compute_dtype in every mode (TRAIN
        # refused above), act_dtype in PREDICT only
        self.compute_dtype = getattr(net, "compute_dtype", None)
        self.act_dtype = (
            getattr(net, "act_dtype", None) if mode == Mode.PREDICT else None
        )
        # int8 activation flow (ops.quant.plan_int8_flow): tensor index ->
        # the scale its int8 codes carry
        quant = getattr(net, "quant", None)
        self.int8_flow: Dict[int, float] = {}
        if quant and mode == Mode.PREDICT and quant.get("act_flow", True):
            from .ops.quant import plan_int8_flow

            self.int8_flow = plan_int8_flow(net, quant)

    def key_of(self, idx: int) -> str:
        return self.net.tensors[idx].key

    def p(self, idx: int) -> torch.Tensor:
        return self.params[self.key_of(idx)]

    def run(self):
        # reference-faithful gradient ROUTING on branched graphs (TRAIN):
        # when a tensor feeds both an accumulating consumer and an earlier
        # overwriting one (a conv), the reference's backward runs the conv
        # LAST and drops the other consumer's gradient. Each consumer of
        # such a tensor reads its own tap of a _GradSplit, which combines
        # their gradients that way. net.ref_grad_routing=False opts out.
        route = (
            build_grad_routing(self.net)
            if self.mode == Mode.TRAIN
            and getattr(self.net, "ref_grad_routing", True)
            else {}
        )
        taps: Dict[Tuple[int, int], torch.Tensor] = {}
        for i, node in enumerate(self.net.nodes):
            fn = getattr(self, f"_{node.type.name.lower()}", None)
            if fn is None:
                raise NotImplementedError(
                    f"layer {node.type.name} (node {i}) is not ported to "
                    "bcnn_tpu_torch yet"
                )
            swapped = {}
            for s in set(_data_srcs(node)):
                tap = taps.get((s, i))
                if tap is not None:
                    swapped[s] = self.values[s]
                    self.values[s] = tap
            fn(node)
            for s, old in swapped.items():
                if s not in node.dst:  # in-place nodes keep their write
                    self.values[s] = old
            for d in node.dst:
                rec = route.get((d, i))
                if rec:
                    outs = _grad_split(tuple(ov for _, ov in rec),
                                       self.values[d])
                    for (pos, _), o in zip(rec, outs):
                        taps[(d, pos)] = o
        return self

    # ------------------------------------------------------------------ #

    def _apply_conv_epilogue(self, node: Node, y, bias_idx, extra):
        """Bias or BN, then the activation, in y's dtype (bf16 on the
        act_dtype path, as `bcnn_tpu/compile.py:316-349` casts). With
        batch_norm the bias tensor is the BN shift, added after
        normalisation; TRAIN normalizes with batch stats and writes the
        new running stats into `state`."""
        p = node.param
        if p.get("batch_norm"):
            mean_k = self.key_of(node.src[extra["mean"]])
            var_k = self.key_of(node.src[extra["var"]])
            scales = self.p(node.src[extra["scales"]])
            biases = self.p(bias_idx)
            if self.mode == Mode.TRAIN:
                y, nm, nv = ops.batch_norm_train(
                    y, scales, biases, self.state[mean_k], self.state[var_k]
                )
                self.state[mean_k], self.state[var_k] = nm, nv
            else:
                y = ops.batch_norm(
                    y, scales, biases, self.state[mean_k],
                    self.state[var_k],
                    folded=self.net.bn_folded and self.mode == Mode.PREDICT,
                )
        else:
            y = y + self.p(bias_idx).to(y.dtype).reshape(1, -1, 1, 1)
        return ops.apply_activation(y, p["activation"])

    # -- int8 PTQ and reduced-precision storage (bcnn_tpu/compile.py:388-436)

    def _quant_entry(self, node: Node):
        """(int8 weight entry, input scale) of a quantized node in
        PREDICT, else None. Where the flow plan routes the input as int8,
        the plan's scale is the one its codes carry."""
        quant = getattr(self.net, "quant", None)
        if not quant or self.mode != Mode.PREDICT:
            return None
        wq = quant["weights"].get(self.key_of(node.src[1]))
        sx = quant["act_scales"].get(node.src[0])
        if wq is None or sx is None:
            return None
        return wq, self.int8_flow.get(node.src[0], sx)

    def _refuse_quantized(self, node: Node):
        if self._quant_entry(node) is not None:
            raise NotImplementedError(
                f"bcnn_tpu_torch: int8 {node.type.name} is not ported yet"
            )

    def _deq(self, idx: int, x):
        """An int8-flow tensor back to fp32 (mixed-input joiners)."""
        if x.dtype == torch.int8:
            return x.to(torch.float32) * self.int8_flow[idx]
        return x

    def _quant_in(self, x, sx: float):
        """A quantized node's input: already int8 (the plan guarantees
        its scale is sx; its producer wrote it channels-last), else
        quantized here, straight into channels-last."""
        from .ops.quant import quantize_tensor

        return x if x.dtype == torch.int8 else quantize_tensor(x, sx)

    def _maybe_emit_int8(self, node: Node, y):
        """Requantize the output when the flow plan says every consumer
        reads it as int8: channels-last, the int8 flow's layout."""
        s = self.int8_flow.get(node.dst[0])
        if s is None:
            return y
        from .ops.quant import quantize_tensor

        return quantize_tensor(y, s)

    def _cast_act(self, y):
        """Boundary cast to act_dtype for fp32 values the conv's own
        out_dtype misses (a quantized conv's fp32 output, a mixed
        concat)."""
        if self.act_dtype is not None and y.dtype == torch.float32:
            return y.to(self.act_dtype)
        return y

    def _conv2d_int8(self, node: Node, x, wq, sx: float):
        """The quantized conv (`bcnn_tpu/compile.py:438-468`): K4 sums the
        int8 product and runs the dequant, BN or bias, the activation and,
        where the plan routes the output as int8, the requantize, in one
        launch on the card, on channels-last x and the quant weight, held
        channels-last since it was made. inv = 1 /
        sqrt(var + eps) takes two correctly rounded ops where bcnn_tpu
        takes rsqrt, so the card and the CPU agree bit for bit."""
        from .ops.conv_int8 import FUSED_ACT, conv_int8_fused

        p = node.param
        if p["num_groups"] != 1:
            raise NotImplementedError(
                "bcnn_tpu_torch: int8 grouped CONV2D is not ported yet"
            )
        act = p["activation"]
        fused = act in FUSED_ACT
        s_out = self.int8_flow.get(node.dst[0]) if fused else None
        bn = {}
        if p.get("batch_norm"):
            bn["scale"] = self.p(node.src[5])
            if not (self.net.bn_folded and self.mode == Mode.PREDICT):
                var = self.state[self.key_of(node.src[4])]
                bn["mean"] = self.state[self.key_of(node.src[3])]
                bn["inv"] = torch.ones_like(var) / torch.sqrt(
                    var + ops.norm.EPS)
        y = conv_int8_fused(
            self._quant_in(x, sx), wq["q"], wq["scale"] * sx,
            self.p(node.src[2]), p["stride"], p["pad"],
            act if fused else Activation.NONE, s_out=s_out, **bn,
        )
        if not fused:
            y = self._maybe_emit_int8(node, ops.apply_activation(y, act))
        return y

    def _conv2d(self, node: Node):
        p = node.param
        x = self.values[node.src[0]]
        q = self._quant_entry(node)
        if q is not None:
            y = self._conv2d_int8(node, x, *q)
        else:
            y = ops.conv2d(
                x, self.p(node.src[1]), p["stride"], p["pad"],
                p["num_groups"], self.compute_dtype, self.act_dtype,
            )
            extra = {"mean": 3, "var": 4, "scales": 5}
            y = self._maybe_emit_int8(
                node, self._apply_conv_epilogue(node, y, node.src[2], extra)
            )
        self.values[node.dst[0]] = self._cast_act(y)

    def _depthwise_conv2d(self, node: Node):
        """The grouped conv, + bias, then the activation, as one K3 launch
        on the card (the layer parses batch_norm but wires no BN). K3
        takes fp32: with compute_dtype, x and w are rounded to it and
        back; the output is cast to act_dtype after K3's fp32 bias and
        activation, where bcnn_tpu adds the bias in bf16 after a bf16
        round (`bcnn_tpu/compile.py:470-496`), a difference of at most
        a bf16 rounding."""
        self._refuse_quantized(node)
        p = node.param
        x, w = self.values[node.src[0]], self.p(node.src[1])
        if self.compute_dtype is not None:
            x, w = x.to(self.compute_dtype), w.to(self.compute_dtype)
        y = ops.depthwise_fused(
            x.to(torch.float32).contiguous(), w.to(torch.float32),
            self.p(node.src[2]), p["stride"], p["pad"], p["activation"],
        )
        self.values[node.dst[0]] = self._cast_act(
            self._maybe_emit_int8(node, y)
        )

    def _full_connected(self, node: Node):
        """`bcnn_tpu/compile.py:529-551`: fp32 out, no boundary cast."""
        self._refuse_quantized(node)
        y = ops.full_connected(
            self.values[node.src[0]],
            self.p(node.src[1]),
            self.p(node.src[2]),
            self.compute_dtype,
        )
        self.values[node.dst[0]] = self._maybe_emit_int8(
            node, ops.apply_activation(y, node.param["activation"])
        )

    def _maxpool(self, node: Node):
        p = node.param
        d = self.net.tensors[node.dst[0]]
        self.values[node.dst[0]] = ops.maxpool(
            self.values[node.src[0]], p["size"], p["stride"], d.h, d.w
        )

    def _avgpool(self, node: Node):
        self.values[node.dst[0]] = ops.global_avgpool(
            self.values[node.src[0]]
        )

    def _softmax(self, node: Node):
        self.values[node.dst[0]] = ops.softmax_passthrough_grad(
            self.values[node.src[0]]
        )

    def _concat(self, node: Node):
        """`bcnn_tpu/compile.py:619-643`: a copy, or a shared-scale int8
        concat, pass int8 through; otherwise int8 inputs are dequantized,
        and the fp32 result requantized or cast to act_dtype."""
        xs = [self.values[i] for i in node.src]
        scs = [self.int8_flow.get(i) for i in node.src]
        if len(xs) == 1 or (
            all(x.dtype == torch.int8 for x in xs)
            and None not in scs
            and all(s == scs[0] for s in scs)
            and self.int8_flow.get(node.dst[0]) == scs[0]
        ):
            self.values[node.dst[0]] = ops.concat_channels(xs)
            return
        y = ops.concat_channels(
            [self._deq(i, x) for i, x in zip(node.src, xs)]
        )
        self.values[node.dst[0]] = self._cast_act(
            self._maybe_emit_int8(node, y)
        )

    def _upsample(self, node: Node):
        self.values[node.dst[0]] = ops.upsample_nn(
            self.values[node.src[0]], node.param["size"]
        )

    def _yolov3(self, node: Node):
        from .ops import yolo as yolo_ops

        p = dict(node.param)
        p["net_w"] = self.net.tensors[0].w
        p["net_h"] = self.net.tensors[0].h
        # the head in fp32 whatever the activation dtype (bcnn_tpu/
        # compile.py:685)
        y, aux = yolo_ops.yolo_forward(
            self.values[node.src[0]].to(torch.float32), self.values.get(1),
            p, self.mode,
        )
        self.values[node.dst[0]] = y
        if aux is not None:
            sur, cost = aux
            self.surrogate = sur if self.surrogate is None else (
                self.surrogate + sur
            )
            self.metrics.append(cost)


def execute(
    net: Net,
    params: Dict[str, torch.Tensor],
    state: Dict[str, torch.Tensor],
    inputs: Dict[str, torch.Tensor],
    mode: Mode,
) -> _Executor:
    """inputs: name -> NCHW tensor ('input' required, 'label' optional)."""
    ex = _Executor(net, params, state, mode)
    for name, arr in inputs.items():
        if name == "input":
            idx = 0
        elif name == "label":
            idx = 1
        else:  # extra named inputs (bcnn_add_input)
            idx = net.get_tensor_index_by_name(name)
        ex.values[idx] = arr
    return ex.run()


def output_value(ex: _Executor, i: int) -> torch.Tensor:
    """Tensor i as the caller sees it: NCHW, the executor's own layout;
    an int8-flow tensor dequantized with its planned scale
    (`bcnn_tpu/compile.py:765-771`)."""
    v = ex.values[i]
    if v.dtype == torch.int8:
        v = v.to(torch.float32) * ex.int8_flow[i]
    return v


def get_loss(ex: _Executor) -> torch.Tensor:
    """bcnn_get_loss (bcnn_net.c:431-450): mean of cost/yolo node outputs,
    0 without any."""
    if not ex.metrics:
        return torch.zeros((), device=ex.values[0].device)
    return sum(ex.metrics) / len(ex.metrics)


def make_detect_fn(
    net: Net,
    thresh: float,
    max_dets: int,
    use_pallas: bool = False,
    topk_first: bool = True,
):
    """Full detection program — forward + decode + on-device NMS,
    returning (boxes (N,K,4), scores (N,K,classes), objectness (N,K)).
    topk_first selects on the objectness logits and decodes only the
    selected rows; otherwise every candidate is decoded, by the K1 CUDA
    kernel (`ops.yolo_decode.decode_fused`, the port of the Pallas
    kernel) when use_pallas is set, else by its plain version. Heads in
    bf16 (act_dtype) are decoded in bf16 as `bcnn_tpu` decodes them,
    except by K1, which takes fp32: its input is cast up."""
    from .ops.yolo import device_decode_nms, device_detect_topk
    from .ops.yolo_decode import decode_fused, decode_grid_ref

    yolo_nodes = [
        (n.src[0], dict(n.param))
        for n in net.nodes
        if n.type == LayerType.YOLOV3
    ]
    if not yolo_nodes:
        raise ValueError("detection program requires a net with YOLO layers")
    net_w, net_h = net.tensors[0].w, net.tensors[0].h

    def detect(params, state, batch):
        ex = execute(net, params, state, batch, Mode.PREDICT)
        raws = [ex.values[src_idx] for src_idx, _ in yolo_nodes]
        if topk_first:
            return device_detect_topk(
                raws, [prm for _, prm in yolo_nodes],
                net_w, net_h, max_dets=max_dets, thresh=thresh,
            )
        all_b, all_o, all_p = [], [], []
        for raw, (_, prm) in zip(raws, yolo_nodes):
            if use_pallas:
                b, o, p = decode_fused(raw.to(torch.float32), prm, net_w,
                                       net_h)
            else:
                b, o, p = decode_grid_ref(raw, prm, net_w, net_h)
            all_b.append(b)
            all_o.append(o)
            all_p.append(p)
        return device_decode_nms(
            torch.cat(all_b, dim=1),
            torch.cat(all_o, dim=1),
            torch.cat(all_p, dim=1),
            max_dets=max_dets,
            thresh=thresh,
        )

    return detect


def _make_train_loss_fn(net: Net, device_augment: Optional[dict]):
    """The TRAIN-mode loss closure: optional on-device augmentation of a
    uint8 batch (and, on a detection net, of its boxes; the transform is
    `data.device_augment`), then the TRAIN forward. Returns
    (surrogate, (state, loss)); the surrogate's gradient in the params is
    the reference's backward. The surrogate is None where no loss layer
    saw a label: every gradient is then 0, as in the JAX package."""
    is_detection = any(n.type == LayerType.YOLOV3 for n in net.nodes)
    if device_augment is not None and is_detection:
        if float(device_augment.get("max_distortion", 0.0)) > 0.0:
            raise ValueError(
                "device_augment: max_distortion cannot be combined with "
                "detection training (no box transform represents it)"
            )

    def loss_fn(params, state, batch, generator):
        if device_augment is not None:
            from .data import device_augment as da

            if is_detection:
                x, lab = da.augment_batch_with_boxes_nchw(
                    batch["input"], batch["label"], generator, device_augment
                )
                batch = dict(batch, input=x, label=lab)
            else:
                batch = dict(batch, input=da.augment_batch_nchw(
                    batch["input"], generator, device_augment
                ))
        elif batch["input"].dtype != torch.float32:
            batch = dict(batch, input=batch["input"].to(torch.float32))
        ex = execute(net, params, state, batch, Mode.TRAIN)
        return ex.surrogate, (ex.state, get_loss(ex))

    return loss_fn


def make_train_step(
    net: Net,
    remat: Optional[bool] = None,
    device_augment: Optional[dict] = None,
    accum_steps: Optional[int] = None,
):
    """One bcnn_train_on_batch equivalent (bcnn_net.c:452-463): forward,
    backward (autograd through the reference's custom gradients), update,
    loss. Returns train_step(params, state, opt_state, batch, generator)
    -> (params, state, opt_state, loss), where params and opt_state are
    updated in place (learner.apply_updates) and state is a new dict.

    device_augment (or net.device_augment): an Augmenter-style config;
    the batch then arrives as raw uint8 pixels (NCHW) and the augmentation
    and [-1, 1] normalisation run on the batch's device, drawing from
    `generator`. remat and accum_steps are not ported."""
    from .learner import apply_updates

    if remat is None:
        remat = bool(getattr(net, "remat", False))
    if accum_steps is None:
        accum_steps = int(getattr(net, "accum_steps", 1) or 1)
    if remat or accum_steps > 1:
        raise NotImplementedError(
            "bcnn_tpu_torch: remat and accum_steps are not ported yet"
        )
    refuse_unported(net, Mode.TRAIN)
    if device_augment is None:
        device_augment = getattr(net, "device_augment", None)
    loss_fn = _make_train_loss_fn(net, device_augment)
    specs = {t.key: t for t in net.param_specs()}

    def train_step(params, state, opt_state, batch, generator=None):
        leaves = {
            k: v.detach().requires_grad_(specs[k].trainable)
            for k, v in params.items()
        }
        sur, (new_state, loss) = loss_fn(leaves, state, batch, generator)
        if sur is not None:
            sur.backward()
        grads = {
            k: v.grad if v.grad is not None else torch.zeros_like(v)
            for k, v in leaves.items() if specs[k].trainable
        }
        params, opt_state = apply_updates(net, params, grads, opt_state)
        return params, new_state, opt_state, loss

    return train_step
