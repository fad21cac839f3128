"""Graph executor: runs the declarative Net on torch tensors, the port of
`bcnn_tpu.compile`: every layer but RESHAPE (which the reference does
not implement either), forward in every mode in fp32, at bf16
(net.compute_dtype, net.act_dtype) and, in PREDICT, at int8 (net.quant:
PTQ with int8 activations between layers; the convs, the FC and the
deconv on K4, the grouped and depthwise convs on K5), the detection
program, and training in fp32 or bf16 (net.compute_dtype,
net.train_act_dtype) in every form of the step: plain, remat,
accum_steps, a K-step scan over staged or device-resident batches, with
net.bn_frozen_stats, net.yolo_stats, net.ref_grad_routing,
net.ref_deconv_quirk and net.qat (quantization-aware training: fake
quant in TRAIN and VALID, the ranges' EMAs in the state).

PyTorch runs eagerly, so the executor is a loop over the nodes that
calls one op per node; nothing is traced, and autograd records the TRAIN
forward for the backward. Conventions:
  - `params`: dict key -> tensor, the learned tensors (PARAM specs);
  - `state`:  dict key -> tensor, BN running stats (STATE specs) and,
    with net.qat, the 0-d "qat_amax/<idx>" ranges;
  - `values`: tensor index -> tensor; activations have NCHW shapes
    throughout, conv weights OIHW; the int8 flow's activations are held
    channels-last (NHWC in memory), the layout K4 reads and writes, and
    so are the bf16 activations of an executor that `channels_last_layout`
    picks for it (bf16 inference on the card), the layout cuDNN's Hopper
    bf16 convs read and write; what callers see (`output_value`, the YOLO
    heads' inputs) is NCHW.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import debug, ops
from .graph import Net, Node, TensorKind, pool_offset
from .profiling import recording, span
from .types import Activation, LayerType, Loss, Mode

# each node's span (`profiling.span`), named once a layer type
_NODE_SPAN = {t: f"bcnn.node.{t.name.lower()}" for t in LayerType}

# the nodes with a channels-last form (`channels_last_layout`): the conv
# (cuDNN, then K6 or the bias and activation), the shortcut add, the route
# (`torch.cat` on dim 1), max pooling (Darknet's pad, then
# `F.max_pool2d`), the upsample and the YOLO heads (NCHW for their reader)
_CHANNELS_LAST_NODES = frozenset({
    LayerType.CONV2D, LayerType.ELTWISE, LayerType.CONCAT,
    LayerType.MAXPOOL, LayerType.UPSAMPLE, LayerType.YOLOV3})
_LAYOUT_COUNTS = {"executors": 0, "nodes": 0, "to_channels_last": 0,
                  "to_nchw": 0}


def layout_counts() -> Dict[str, int]:
    """Since the last `reset_layout_counts`: the executor passes run
    channels-last ("executors"), the nodes they ran ("nodes"), and the
    layout conversions they made: into channels-last (a conv's input that
    came NCHW: the net's input, at its cast to bf16) and back to NCHW (a
    YOLO head's input, a value `output_value` hands out)."""
    return dict(_LAYOUT_COUNTS)


def reset_layout_counts() -> None:
    for k in _LAYOUT_COUNTS:
        _LAYOUT_COUNTS[k] = 0


def channels_last_layout(net: Net, mode: Mode, device_type: str,
                         plain: bool = True) -> bool:
    """Whether an executor holds the net's activations channels-last:
    on a CUDA device, outside TRAIN, at bf16 compute and activations
    (act_dtype holds in PREDICT only), with no int8 quantization, in the
    plain executor (`plain`: not the model axis's, which slice and gather
    channels and rows), and where every node has a channels-last form
    (`_CHANNELS_LAST_NODES`: not K3's depthwise, the FC, avgpool, ...).
    Else NCHW, as every value was before. Same ops either way; only the
    strides differ."""
    bf16 = torch.bfloat16
    return (device_type == "cuda" and plain and mode == Mode.PREDICT
            and getattr(net, "compute_dtype", None) == bf16
            and getattr(net, "act_dtype", None) == bf16
            and not getattr(net, "quant", None)
            and all(n.type in _CHANNELS_LAST_NODES for n in net.nodes))


def _channels_last(x: torch.Tensor) -> bool:
    return x.is_contiguous(memory_format=torch.channels_last)


def init_params(
    net: Net, seed: int = 0, device="cpu"
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Create (params, state) from the tensor specs' fillers, drawn in
    tensor order from one `torch.Generator` seeded with `seed`;
    unfilled tensors are zeros (calloc semantics, bh_align_calloc), and
    so are net.qat's ranges (`bcnn_tpu/compile.py:63-67`)."""
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
    if getattr(net, "qat", None):
        from .ops.quant import qat_state_keys

        for k in qat_state_keys(net):
            state[k] = torch.zeros((), dtype=torch.float32, device=device)
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


def _int8_mish(act: Activation, x: torch.Tensor) -> None:
    """Raises ValueError for a quantized node with MISH or SWISH on the
    card: K4's and K5's epilogues fuse neither, and the int8 flow has not
    been calibrated across a non-monotone activation."""
    if act in (Activation.MISH, Activation.SWISH) and x.is_cuda:
        raise ValueError(f"int8 serving on the card has no {act.name}: K4 "
                         "and K5 do not fuse it (serve the net in bf16 or "
                         "fp32)")


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

class _Executor:
    """One pass over the graph in any mode."""

    def __init__(
        self,
        net: Net,
        params: Dict[str, torch.Tensor],
        state: Dict[str, torch.Tensor],
        mode: Mode,
        seed: Optional[int] = None,
        dropout_masks: Optional[Dict[int, torch.Tensor]] = None,
        mesh=None,
    ):
        self.net = net
        # data parallel (`parallel.Mesh`): the values are this rank's
        # stripe of the batch; BN's statistics, the metrics, QAT's ranges
        # and the lifted loss's pairs are the global batch's, and dropout
        # masks are drawn for the global batch (`parallel/mesh.py`)
        self.mesh = mesh
        self._reduce = mesh.all_reduce if mesh is not None else None
        self.params = params
        # TRAIN writes the new running stats here, not into the caller's
        self.state = dict(state)
        self.mode = mode
        self.values: Dict[int, torch.Tensor] = {}
        self.surrogate: Optional[torch.Tensor] = None
        self.metrics = []  # per cost node reported value
        # TRAIN dropout: node position -> keep mask, given (a parity run
        # hands one device's masks to another) or drawn here from `seed`
        self.seed = seed
        self.dropout_masks = dict(dropout_masks or {})
        self.pos = 0  # the position of the node being run
        # bcnn_tpu/compile.py:174-204: compute_dtype in every mode,
        # act_dtype in PREDICT only, train_act_dtype (the stored boundary
        # tensors; the epilogue math stays fp32) in TRAIN only
        self.compute_dtype = getattr(net, "compute_dtype", None)
        self.act_dtype = (
            getattr(net, "act_dtype", None) if mode == Mode.PREDICT else None
        )
        self.train_act_dtype = (
            getattr(net, "train_act_dtype", None)
            if mode == Mode.TRAIN else None
        )
        self.bn_frozen = bool(getattr(net, "bn_frozen_stats", False))
        # net.yolo_stats: one dict of 0-d tensors per YOLO layer
        self.want_stats = mode == Mode.TRAIN and bool(
            getattr(net, "yolo_stats", False))
        self.yolo_stats = []
        # int8 activation flow (ops.quant.plan_int8_flow): tensor index ->
        # the scale its int8 codes carry
        quant = getattr(net, "quant", None)
        self.int8_flow: Dict[int, float] = {}
        if quant and mode == Mode.PREDICT and quant.get("act_flow", True):
            from .ops.quant import plan_int8_flow

            with span("bcnn.build.int8_flow"):
                self.int8_flow = plan_int8_flow(net, quant)
        # net.qat (True, or a dict with "ema" and "per_layer"): TRAIN and
        # VALID fake-quantize each conv-like input and weight; the input
        # ranges' EMAs live in the state (`bcnn_tpu/compile.py:216-229`).
        # PREDICT ignores it: Session.freeze_qat makes net.quant
        qat = getattr(net, "qat", None)
        self.qat = qat if (qat and mode != Mode.PREDICT) else None
        if self.qat:
            from .ops.quant import watch_tensors

            self.qat_ema = (
                float(qat.get("ema", 0.99)) if isinstance(qat, dict) else 0.99
            )
            self.qat_watch = set(watch_tensors(net))
            self._qat_seen: set = set()
        # the activations' layout, chosen once from what the executor
        # sees: the device of its parameters, the net, the mode, its kind
        dev = next(iter(params.values()), None)
        self.channels_last = channels_last_layout(
            net, mode, dev.device.type if dev is not None else "cpu",
            plain=type(self) is _Executor)

    def key_of(self, idx: int) -> str:
        return self.net.tensors[idx].key

    def p(self, idx: int) -> torch.Tensor:
        return self.params[self.key_of(idx)]

    def run(self, lo: int = 0, hi: Optional[int] = None, taps_in=None):
        """Nodes [lo, hi), the pass's span `bcnn.execute` and each node's
        `bcnn.node.<type>` where a profiler records (`profiling.span`)."""
        if self.channels_last:
            _LAYOUT_COUNTS["executors"] += 1
            _LAYOUT_COUNTS["nodes"] += (
                len(self.net.nodes) if hi is None else hi) - lo
        with span("bcnn.execute"):
            return self._run(lo, hi, taps_in)

    def _run(self, lo, hi, taps_in):
        # Nodes [lo, hi) (`bcnn_tpu/compile.py:237-304`): the pipeline
        # (`parallel/pipeline.py`) runs one stage of the graph so. taps_in
        # seeds the routing taps that earlier stages made for consumers in
        # this range; afterwards self.taps holds every live tap.
        #
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
        if hi is None:
            hi = len(self.net.nodes)
        taps: Dict[Tuple[int, int], torch.Tensor] = dict(taps_in or {})
        checks = debug.CHECKS
        nan, inf = checks["nan"], checks["inf"]
        traced = recording()
        for i in range(lo, hi):
            node = self.net.nodes[i]
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
            self.pos = i
            if traced:
                with torch.profiler.record_function(_NODE_SPAN[node.type]):
                    self._dispatch(fn, node)
            else:
                self._dispatch(fn, node)
            for s, old in swapped.items():
                if s not in node.dst:  # in-place nodes keep their write
                    self.values[s] = old
            if nan or inf:
                debug.check_node(i, node, self.net, self.values, nan, inf)
            for d in node.dst:
                rec = route.get((d, i))
                if rec:
                    outs = _grad_split(tuple(ov for _, ov in rec),
                                       self.values[d])
                    for (pos, _), o in zip(rec, outs):
                        taps[(d, pos)] = o
        self.taps = taps
        if self.qat and self.mode == Mode.TRAIN:
            # the watched tensors no conv-like node observed (joiner
            # inputs), at their end-of-pass values, as calibrate sees them
            # (`bcnn_tpu/compile.py:305-311`)
            for idx in sorted(self.qat_watch - self._qat_seen):
                if idx in self.values:
                    self._qat_observe(idx, self.values[idx])
        return self

    # -- hooks of the model axis (`parallel.model_axis`) ----------------

    def _dispatch(self, fn, node: Node) -> None:
        """Runs one node's method; the model axis's executors wrap it
        (a channel-sharded node gathers its output, a height band
        fetches its halo rows)."""
        fn(node)

    def _out_rows(self, y):
        """A conv's raw output, before its epilogue; a height band's
        executor keeps its own rows of it here."""
        return y

    # ------------------------------------------------------------------ #

    def _apply_conv_epilogue(self, node: Node, y, bias_idx, extra):
        """Bias or BN, then the activation, in y's dtype (bf16 on the
        act_dtype path, as `bcnn_tpu/compile.py:316-349` casts; fp32 in
        TRAIN). With batch_norm the bias tensor is the BN shift, added
        after normalisation; TRAIN normalizes with batch stats (or, with
        net.bn_frozen_stats, the step-start running stats) and writes
        the new running stats into `state`. Outside TRAIN, BN and the
        activation are one K6 launch where `ops.bn_act.takes` the output
        (on the card: bf16 or fp32, no autograd; NONE, RELU, LRELU, MISH
        or SWISH), on the output as it is where it is contiguous NCHW or
        channels-last (K6's two forms), else made contiguous, and the
        vectors made fp32."""
        p = node.param
        if p.get("batch_norm"):
            mean_k = self.key_of(node.src[extra["mean"]])
            var_k = self.key_of(node.src[extra["var"]])
            scales = self.p(node.src[extra["scales"]])
            biases = self.p(bias_idx)
            mean, var = self.state[mean_k], self.state[var_k]
            if self.mode == Mode.TRAIN:
                y, nm, nv = ops.batch_norm_train(
                    y, scales, biases, mean, var,
                    frozen=self.bn_frozen, reduce=self._reduce,
                )
                self.state[mean_k], self.state[var_k] = nm, nv
            else:
                folded = self.net.bn_folded and self.mode == Mode.PREDICT
                act = p["activation"]
                if ops.bn_act.takes(y, act):
                    # a vector rounded to y's dtype first, as the plain
                    # ops round it, then widened: the same values
                    vecs = [v if v.dtype == torch.float32
                            else v.to(y.dtype).float()
                            for v in (scales, biases, mean, var)]
                    if not (y.is_contiguous() or _channels_last(y)):
                        y = y.contiguous()
                    return ops.bn_act.bn_act(y, *vecs, folded, act)
                y = ops.batch_norm(y, scales, biases, mean, var,
                                   folded=folded)
        else:
            y = y + self.p(bias_idx).to(y.dtype).reshape(1, -1, 1, 1)
        slopes = None
        if p["activation"] == Activation.PRELU:  # not trainable here
            slopes = self.p(node.src[extra["slopes"]]).to(y.dtype)
        return ops.apply_activation(y, p["activation"], slopes)

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

    # -- QAT (`bcnn_tpu/compile.py:351-387`) ------------------------------

    def _qat_observe(self, idx: int, x) -> torch.Tensor:
        """The fake-quant scale of tensor idx, a 0-d fp32 tensor: in
        TRAIN the EMA of its abs-max moves (the first observation seeds
        it) and is written to the state; in VALID it is read, the batch's
        own abs-max before any training. max(range, 1e-8) / 127, the
        division a true one on either device."""
        k = f"qat_amax/{idx}"
        obs = x.detach().to(torch.float32).abs().max()
        if self.mesh is not None:  # the global batch's abs-max
            obs = obs.reshape(1)
            self.mesh.all_reduce(obs, "max")
            obs = obs.reshape(())
        old = self.state.get(k)
        if old is None:
            old = torch.zeros((), dtype=torch.float32, device=obs.device)
        if self.mode == Mode.TRAIN:
            new = torch.where(
                old > 0, self.qat_ema * old + (1 - self.qat_ema) * obs, obs)
            self.state[k] = new
            self._qat_seen.add(idx)
        else:
            new = torch.where(old > 0, old, obs)
        return torch.clamp_min(new, 1e-8) / torch.tensor(
            127.0, device=new.device)

    def _qat_on(self, node: Node) -> bool:
        """net.qat quantizes every conv-like node; {"per_layer": True}
        only the layers added with `quantize` set."""
        if not self.qat:
            return False
        if isinstance(self.qat, dict) and self.qat.get("per_layer"):
            return bool(node.param.get("quantize"))
        return True

    def _qat_xw(self, node: Node, x, w):
        """x fake-quantized per tensor at its tracked range, w per output
        channel."""
        from .ops.quant import (QAT_WEIGHT_AXES, fake_quant_ste,
                                fake_quant_weight)

        x = fake_quant_ste(x, self._qat_observe(node.src[0], x))
        return x, fake_quant_weight(w, QAT_WEIGHT_AXES[node.type])

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
        """Boundary cast to the stored activation dtype: train_act_dtype
        in TRAIN (`bcnn_tpu/compile.py:427-436`); in PREDICT, act_dtype
        for fp32 values the conv's own out_dtype misses (a quantized
        conv's fp32 output, a mixed concat). In TRAIN autograd's
        transpose of the cast takes the gradient back to fp32."""
        ad = self.train_act_dtype or self.act_dtype
        if ad is not None and y.dtype == torch.float32:
            return y.to(ad)
        return y

    def _conv_int8(self, node: Node, x, wq, sx: float, groups: int = 1):
        """The quantized conv (`bcnn_tpu/compile.py:438-468`; a depthwise
        layer's, `:470-496`, is the grouped one with groups = C and no
        BN): K4 (groups 1) or K5 sums the int8 product and runs the
        dequant, BN or bias, the activation and, where the plan routes
        the output as int8, the requantize, in one launch on the card,
        on channels-last x and the quant weight, held in the kernel's
        layout since it was made. inv = 1 / sqrt(var + eps) takes two
        correctly rounded ops where bcnn_tpu takes rsqrt, so the card
        and the CPU agree bit for bit. An activation neither kernel fuses
        runs after it, except MISH and SWISH on the card, which raise
        (`_int8_mish`)."""
        from .ops.conv_int8 import FUSED_ACT, conv_int8_fused
        from .ops.grouped_int8 import grouped_int8_fused

        p = node.param
        act = p["activation"]
        _int8_mish(act, x)
        fused = act in FUSED_ACT
        s_out = self.int8_flow.get(node.dst[0]) if fused else None
        bn = {}
        with span("bcnn.build.epilogue"):
            if node.type == LayerType.CONV2D and p.get("batch_norm"):
                bn["scale"] = self.p(node.src[5])
                if not (self.net.bn_folded and self.mode == Mode.PREDICT):
                    var = self.state[self.key_of(node.src[4])]
                    bn["mean"] = self.state[self.key_of(node.src[3])]
                    bn["inv"] = torch.ones_like(var) / torch.sqrt(
                        var + ops.norm.EPS)
            d = wq["scale"] * sx
        args = (self._quant_in(x, sx), wq["q"], d,
                self.p(node.src[2]), p["stride"], p["pad"])
        kw = dict(act=act if fused else Activation.NONE, s_out=s_out, **bn)
        if groups == 1:
            y = conv_int8_fused(*args, **kw)
        else:
            y = grouped_int8_fused(*args, groups, **kw)
        y = self._out_rows(y)
        if not fused:
            y = self._maybe_emit_int8(node, ops.apply_activation(y, act))
        return y

    def _k4_linear(self, node: Node, x, w, d, pad: int):
        """A quantized FC or deconv as the conv K4 runs for it (stride
        1, bias in its epilogue), with the activation and the requantize
        as `_conv_int8` fuses them."""
        from .ops.conv_int8 import FUSED_ACT, conv_int8_fused

        act = node.param["activation"]
        _int8_mish(act, x)
        fused = act in FUSED_ACT
        y = conv_int8_fused(
            x, w, d, self.p(node.src[2]), 1, pad,
            act if fused else Activation.NONE,
            s_out=self.int8_flow.get(node.dst[0]) if fused else None,
        )
        if not fused:
            y = self._maybe_emit_int8(node, ops.apply_activation(y, act))
        return y

    def _conv2d(self, node: Node):
        p = node.param
        x = self.values[node.src[0]]
        q = self._quant_entry(node)
        if q is not None:
            y = self._conv_int8(node, x, *q, groups=p["num_groups"])
        else:
            w = self.p(node.src[1])
            if self._qat_on(node):
                x, w = self._qat_xw(node, x, w)
            if self.channels_last and not _channels_last(x):
                _LAYOUT_COUNTS["to_channels_last"] += 1  # in the bf16 cast
            y = self._out_rows(ops.conv2d(
                x, w, p["stride"], p["pad"],
                p["num_groups"], self.compute_dtype, self.act_dtype,
                channels_last=self.channels_last,
            ))
            extra = {"mean": 3, "var": 4, "scales": 5,
                     "slopes": 6 if p.get("batch_norm") else 3}
            y = self._maybe_emit_int8(
                node, self._apply_conv_epilogue(node, y, node.src[2], extra)
            )
        self.values[node.dst[0]] = self._cast_act(y)

    def _depthwise_conv2d(self, node: Node):
        """The grouped conv, + bias, then the activation (the layer parses
        batch_norm but wires no BN). Outside TRAIN, one K3 launch on the
        card. K3 takes fp32: with compute_dtype, x and w are rounded to it
        and back; the output is cast to act_dtype after K3's fp32 bias and
        activation, where bcnn_tpu adds the bias in bf16 after a bf16
        round (`bcnn_tpu/compile.py:470-496`), a difference of at most
        a bf16 rounding. K3 has no backward: TRAIN runs the grouped conv
        (`ops.conv2d`, with compute_dtype its bf16 form and backward) on
        any device, as bcnn_tpu trains through `ops.depthwise_conv2d`
        and never through its Pallas kernel. Quantized (PREDICT with
        net.quant), one K5 launch with groups = C; under net.qat, x and w
        fake-quantized first."""
        p = node.param
        x, w, b = (self.values[node.src[0]], self.p(node.src[1]),
                   self.p(node.src[2]))
        q = self._quant_entry(node)
        if q is not None:
            self.values[node.dst[0]] = self._cast_act(
                self._conv_int8(node, x, *q, groups=x.shape[1]))
            return
        if self._qat_on(node):
            x, w = self._qat_xw(node, x, w)
        if self.mode == Mode.TRAIN:
            y = self._out_rows(ops.conv2d(x, w, p["stride"], p["pad"],
                                          x.shape[1], self.compute_dtype))
            y = ops.apply_activation(
                y + b.to(y.dtype).reshape(1, -1, 1, 1), p["activation"])
            self.values[node.dst[0]] = self._cast_act(y)
            return
        if self.compute_dtype is not None:
            x, w = x.to(self.compute_dtype), w.to(self.compute_dtype)
        y = self._out_rows(ops.depthwise_fused(
            x.to(torch.float32).contiguous(), w.to(torch.float32), b,
            p["stride"], p["pad"], p["activation"],
        ))
        self.values[node.dst[0]] = self._cast_act(
            self._maybe_emit_int8(node, y)
        )

    def _transpose_conv2d(self, node: Node):
        """The deconv (`bcnn_tpu/compile.py:498-527`): the transpose conv,
        or under net.ref_deconv_quirk with pad > 0 the reference's
        misread col2im bit for bit (`ops.conv.conv2d_transpose_ref_quirk`),
        + bias, the activation, the boundary cast; under net.qat (not
        with the quirk) x and w fake-quantized first. Quantized, K4 runs
        the equivalent conv: the input dilated by the stride
        (`ops.quant.dilate_int8`), pad k-1-p (a negative one crops),
        stride 1, the weight turned and transposed once
        (`deconv_k4_weight`, the quant entry's q); its integer sum equals
        `conv2d_transpose_int8`'s."""
        from .ops.quant import dilate_int8

        p = node.param
        x, w = self.values[node.src[0]], self.p(node.src[1])
        q = self._quant_entry(node)
        if q is not None:
            wq, sx = q
            e = wq["q"].shape[2] - 1 - p["pad"]
            xd = dilate_int8(self._quant_in(x, sx), p["stride"])
            if e < 0:
                xd = xd[:, :, -e:xd.shape[2] + e, -e:xd.shape[3] + e]
                xd = xd.contiguous(memory_format=torch.channels_last)
            y = self._k4_linear(node, xd, wq["q"], wq["scale"] * sx,
                                max(e, 0))
            self.values[node.dst[0]] = self._cast_act(y)
            return
        if p["pad"] > 0 and getattr(self.net, "ref_deconv_quirk", False):
            y = ops.conv.conv2d_transpose_ref_quirk(x, w, p["stride"],
                                                    p["pad"])
        else:
            if self._qat_on(node):
                x, w = self._qat_xw(node, x, w)
            y = ops.conv.conv2d_transpose(x, w, p["stride"], p["pad"],
                                          self.compute_dtype)
        y = y + self.p(node.src[2]).reshape(1, -1, 1, 1)
        self.values[node.dst[0]] = self._cast_act(
            ops.apply_activation(y, p["activation"]))

    def _full_connected(self, node: Node):
        """`bcnn_tpu/compile.py:529-551`: fp32 out, no boundary cast;
        under net.qat, x and w fake-quantized first. Quantized, K4 runs
        it as a 1x1 conv over the int8 x flattened as it lies, NHWC
        (a view of the channels-last x), whose weight rows were put in
        that order once (`ops.quant.fc_k4_weight`); bcnn_tpu flattens in
        NCHW order, which that order of rows undoes."""
        x, w = self.values[node.src[0]], self.p(node.src[1])
        q = self._quant_entry(node)
        if q is not None:
            wq, sx = q
            x = self._quant_in(x, sx)
            xf = (x.permute(0, 2, 3, 1) if x.dim() == 4 else x).reshape(
                x.shape[0], -1, 1, 1)
            self.values[node.dst[0]] = self._k4_linear(
                node, xf, wq["q"], wq["scale"] * sx, 0)
            return
        if self._qat_on(node):
            x, w = self._qat_xw(node, x, w)
        y = ops.full_connected(x, w, self.p(node.src[2]),
                               self.compute_dtype)
        self.values[node.dst[0]] = self._maybe_emit_int8(
            node, ops.apply_activation(y, node.param["activation"])
        )

    def _batchnorm(self, node: Node):
        """The standalone BN layer (`bcnn_tpu/compile.py:566-590`). Under
        train_act_dtype its input is cast up, so that the reference's BN
        statistics and backward run in fp32, and its output cast back.
        Outside TRAIN the per-channel scales and biases stay fp32, so a
        bf16 x meets them in fp32, as in bcnn_tpu."""
        x = self.values[node.src[0]]
        if self.train_act_dtype is not None:
            x = x.to(torch.float32)
        mean_k = self.key_of(node.src[1])
        var_k = self.key_of(node.src[2])
        scales, biases = self.p(node.src[3]), self.p(node.src[4])
        if self.mode == Mode.TRAIN:
            y, nm, nv = ops.batch_norm_train(
                x, scales, biases, self.state[mean_k], self.state[var_k],
                frozen=self.bn_frozen, reduce=self._reduce,
            )
            self.state[mean_k], self.state[var_k] = nm, nv
        else:
            y = ops.batch_norm(
                x, scales, biases, self.state[mean_k], self.state[var_k],
                folded=self.net.bn_folded and self.mode == Mode.PREDICT,
                affine_fp32=True,
            )
        self.values[node.dst[0]] = self._cast_act(y)

    def _lrn(self, node: Node):
        """`bcnn_tpu/compile.py:588-593`."""
        p = node.param
        self.values[node.dst[0]] = ops.lrn(
            self.values[node.src[0]], p["local_size"], p["alpha"],
            p["beta"], p["k"])

    def _dropout(self, node: Node):
        """`bcnn_tpu/compile.py:612-617`, in place: TRAIN only. The keep
        mask is the one given for this node, else drawn on x's device
        from a generator seeded with seed + the node's position, as
        bcnn_tpu folds the node index into the step's key (the step's seed
        is a random 62-bit draw); with no seed, from torch's default
        generator. Either way it is kept in `dropout_masks`. Under a mesh
        the mask, given or drawn, is the global batch's, and the rank
        takes its stripe of it."""
        p = node.param
        x = self.values[node.src[0]]
        if self.mode != Mode.TRAIN or p["rate"] <= 0.0:
            self.values[node.dst[0]] = x
            return
        keep = self.dropout_masks.get(self.pos)
        if keep is None:
            gen = None
            if self.seed is not None:
                gen = torch.Generator(device=x.device).manual_seed(
                    self.seed + self.pos)
            d = self.mesh.size if self.mesh is not None else 1
            keep = ops.dropout_mask((x.shape[0] * d,) + tuple(x.shape[1:]),
                                    p["rate"], x.device, gen)
            self.dropout_masks[self.pos] = keep
        if self.mesh is not None:
            keep = self.mesh.stripe(keep.to(x.device))
        self.values[node.dst[0]] = ops.dropout(x, p["scale"], keep)

    def _maxpool(self, node: Node):
        p = node.param
        d = self.net.tensors[node.dst[0]]
        self.values[node.dst[0]] = ops.maxpool(
            self.values[node.src[0]], p["size"], p["stride"], d.h, d.w,
            pool_offset(p),
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

    def _eltwise(self, node: Node):
        """`bcnn_tpu/compile.py:645-670`: the add, the activation, then
        the requantize or the boundary cast. Two int8 inputs carry one
        scale (plan_int8_flow's joiner fixpoint): their sum is exact in
        int32, then one dequant multiply; both are channels-last, and
        every step keeps that layout. A mixed pair is dequantized first.
        In TRAIN autograd differentiates the add (`ops.eltwise_add`), and
        under ref_grad_routing a source that also feeds a conv loses the
        add's gradient, as in `run`."""
        p = node.param
        a = self.values[node.src[0]]
        b = self.values[node.src[1]]
        if a.dtype == torch.int8 and b.dtype == torch.int8:
            y = ops.eltwise_add(
                a.to(torch.int32), b.to(torch.int32), p["stride"],
                p["min_dim"],
            ).to(torch.float32) * self.int8_flow[node.src[0]]
        else:
            y = ops.eltwise_add(
                self._deq(node.src[0], a), self._deq(node.src[1], b),
                p["stride"], p["min_dim"],
            )
        y = ops.apply_activation(y, p["activation"])
        self.values[node.dst[0]] = self._cast_act(
            self._maybe_emit_int8(node, y)
        )

    def _activation(self, node: Node):
        """The standalone activation layer (`bcnn_tpu/compile.py:553-
        562`), in place: dst is src. PRELU's slopes are src[1], trained
        through the reference's output-based backward."""
        p = node.param
        slopes = (self.p(node.src[1]) if p["activation"] == Activation.PRELU
                  else None)
        self.values[node.dst[0]] = ops.apply_activation(
            self.values[node.src[0]], p["activation"], slopes
        )

    def _reshape(self, node: Node):
        raise NotImplementedError(
            "RESHAPE has no implementation in the reference either "
            "(enum only, bcnn.h:157)"
        )

    def _cost(self, node: Node):
        """The cost layer (`bcnn_tpu/compile.py:708-740`): the euclidean or
        the lifted-structure surrogate into the training loss and,
        outside PREDICT, the reported metric; nothing without a label
        (forward only). For the lifted loss the reference reports 0 under
        SSE, MSE and CRPS (it reads a never-written buffer); bcnn_tpu
        reports the loss itself there, and so does the port.

        Under a mesh the euclidean surrogate is the rank's share of the
        batch sum (the gradient all-reduce adds the shares) and the
        metric, a batch sum, is all-reduced; the lifted loss is pairwise
        over the global batch: the embeddings and labels are gathered,
        every rank computes the whole surrogate and metric, and each
        rank's gradient is that of its own rows
        (`parallel.mesh.gather_rows`), so that the all-reduce counts it
        once."""
        from .ops.losses import compute_metric, euclidean_surrogate
        from .ops.lifted_struct import lifted_struct_surrogate
        from .types import Metric

        p = node.param
        label = self.values.get(1)
        if label is None:
            return
        x = self.values[node.src[0]]
        x = x.reshape(x.shape[0], -1)
        label = label.reshape(label.shape[0], -1)
        lifted = p["loss"] == Loss.LIFTED_STRUCT
        if lifted and self.mesh is not None:
            from .parallel.mesh import gather_rows

            x = gather_rows(self.mesh, x)
            label = self.mesh.all_gather(label.contiguous())
        sur = (lifted_struct_surrogate if lifted else euclidean_surrogate)(
            x, label, p["scale"])
        self.surrogate = sur if self.surrogate is None else (
            self.surrogate + sur
        )
        if self.mode == Mode.PREDICT:
            return
        if lifted and p["loss_metric"] in (Metric.SSE, Metric.MSE,
                                           Metric.CRPS):
            self.metrics.append(sur / max(p["scale"], 1e-12))
        elif lifted:
            self.metrics.append(compute_metric(x, label, p["loss_metric"]))
        else:
            self.metrics.append(self._global_sum(
                compute_metric(x, label, p["loss_metric"])))

    def _global_sum(self, v: torch.Tensor) -> torch.Tensor:
        """A batch sum of the rank's stripe -> the global batch's (as is
        without a mesh); outside autograd."""
        if self.mesh is None:
            return v
        v = v.detach().reshape(1).clone()
        self.mesh.all_reduce(v)
        return v.reshape(())

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
        # compile.py:685); a float64 net stays in float64. A channels-last
        # input goes NCHW once, in place, so that the detection program's
        # decode reads it as every other net's
        x = self.values[node.src[0]]
        if self.channels_last and not x.is_contiguous():
            x = self.values[node.src[0]] = x.contiguous()
            _LAYOUT_COUNTS["to_nchw"] += 1
        y, aux = yolo_ops.yolo_forward(
            x if x.dtype in ops.activations.WIDE else x.to(torch.float32),
            self.values.get(1),
            p, self.mode, with_stats=self.want_stats,
        )
        self.values[node.dst[0]] = y
        if aux is not None:
            sur, cost = aux[:2]
            self.surrogate = sur if self.surrogate is None else (
                self.surrogate + sur
            )
            self.metrics.append(self._global_sum(cost))
            if self.want_stats:
                self.yolo_stats.append(aux[2])


# the executor's dtype rules, node by node (`value_dtypes`): the nodes
# whose output `_Executor._cast_act` stores in the activation dtype
_ACT_CAST = frozenset({LayerType.CONV2D, LayerType.DEPTHWISE_CONV2D,
                       LayerType.TRANSPOSE_CONV2D, LayerType.BATCHNORM})
# the nodes that write an int8 output where the flow plan routes it
_EMIT_INT8 = frozenset({LayerType.CONV2D, LayerType.DEPTHWISE_CONV2D,
                        LayerType.TRANSPOSE_CONV2D,
                        LayerType.FULL_CONNECTED, LayerType.CONCAT,
                        LayerType.ELTWISE})


def value_dtypes(net: Net, mode: Mode) -> Dict[int, torch.dtype]:
    """The dtype in which the executor writes each tensor a node
    produces, in `mode` (host-fed tensors fp32): int8 where the int8
    flow plan routes the output of a node that requantizes (PREDICT with
    net.quant: a conv, depthwise, deconv, FC, shortcut add or concat of
    several sources); else a conv, depthwise, deconv or BN output in the
    stored activation dtype (train_act_dtype in TRAIN, act_dtype in
    PREDICT) or fp32; the FC's and the YOLO layer's fp32; the shortcut
    add and a concat of several sources in their inputs' promoted dtype,
    cast to the activation dtype where that is fp32; a single-source
    concat and the ops that keep their input's dtype (pooling, upsample,
    softmax, LRN, dropout, the activation layer) their input's. The
    pipeline (`parallel/pipeline.py`) sizes its transfers and checks
    every boundary value by it; `tests/test_torch_pipeline_parallel.py`
    holds it to what the executor writes."""
    from .ops.quant import plan_int8_flow

    quant = getattr(net, "quant", None)
    flow = (plan_int8_flow(net, quant)
            if quant and mode == Mode.PREDICT and quant.get("act_flow", True)
            else {})
    act = (getattr(net, "train_act_dtype", None) if mode == Mode.TRAIN
           else getattr(net, "act_dtype", None) if mode == Mode.PREDICT
           else None)
    f32 = torch.float32
    out: Dict[int, torch.dtype] = {}

    def cast(dt):
        return act if (act is not None and dt == f32) else dt

    for node in net.nodes:
        if not node.dst:
            continue
        srcs = [out.get(s, f32) for s in node.src
                if net.tensors[s].kind == TensorKind.DATA]
        t = node.type
        single = t == LayerType.CONCAT and len(srcs) == 1
        if node.dst[0] in flow and t in _EMIT_INT8 and not single:
            dt = torch.int8
        elif t in _ACT_CAST:
            dt = act or f32
        elif t in (LayerType.FULL_CONNECTED, LayerType.YOLOV3):
            dt = f32
        elif single:
            dt = srcs[0]
        elif t in (LayerType.CONCAT, LayerType.ELTWISE):
            data = srcs[:2] if t == LayerType.ELTWISE else srcs
            promoted = f32 if torch.int8 in data else data[0]
            for d in data[1:]:
                if d != torch.int8:
                    promoted = torch.promote_types(promoted, d)
            dt = cast(promoted)
        else:
            dt = srcs[0] if srcs else f32
        for d in node.dst:
            out[d] = dt
    return out


def execute(
    net: Net,
    params: Dict[str, torch.Tensor],
    state: Dict[str, torch.Tensor],
    inputs: Dict[str, torch.Tensor],
    mode: Mode,
    seed: Optional[int] = None,
    dropout_masks: Optional[Dict[int, torch.Tensor]] = None,
    mesh=None,
) -> _Executor:
    """inputs: name -> NCHW tensor ('input' required, 'label' optional).
    seed and dropout_masks: TRAIN dropout's draws (`_Executor._dropout`);
    the executor's `dropout_masks` holds every mask the pass used.
    mesh: a `parallel.Mesh`; the inputs are then this rank's stripe of
    the global batch (`parallel.make_dp_train_step` and its kin)."""
    ex = _Executor(net, params, state, mode, seed, dropout_masks, mesh)
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
    """Tensor i as the caller sees it: NCHW (a value of a channels-last
    executor made contiguous); an int8-flow tensor dequantized with its
    planned scale (`bcnn_tpu/compile.py:765-771`)."""
    v = ex.values[i]
    if v.dtype == torch.int8:
        v = v.to(torch.float32) * ex.int8_flow[i]
    elif ex.channels_last and not v.is_contiguous():
        v = v.contiguous()
        _LAYOUT_COUNTS["to_nchw"] += 1
    return v


def get_loss(ex: _Executor) -> torch.Tensor:
    """bcnn_get_loss (bcnn_net.c:431-450): mean of cost/yolo node outputs,
    0 without any."""
    if not ex.metrics:
        return torch.zeros((), device=ex.values[0].device)
    return sum(ex.metrics) / len(ex.metrics)


def make_forward(net: Net, output_names, mode: Mode):
    """The forward of `bcnn_tpu/compile.py:781-790`: forward(params,
    state, inputs, seed=None) -> (the requested tensors, NCHW, int8-flow
    ones dequantized; the new state). Nothing is traced: it runs the
    executor eagerly under the caller's grad mode (`deploy.export_forward`
    traces it)."""
    out_idx = [net.get_tensor_index_by_name(n) for n in output_names]

    def forward(params, state, inputs, seed=None):
        ex = execute(net, params, state, inputs, mode, seed)
        return tuple(output_value(ex, i) for i in out_idx), ex.state

    return forward


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
        with span("bcnn.decode"):
            for raw, (_, prm) in zip(raws, yolo_nodes):
                if use_pallas:
                    b, o, p = decode_fused(raw.to(torch.float32), prm,
                                           net_w, net_h)
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


def child_generators(generator: Optional[torch.Generator], n: int):
    """n CPU generators drawn in turn from `generator` (None: n Nones),
    each seeded with one 62-bit draw: a step's or a microbatch's own
    stream, as bcnn_tpu splits or folds a key."""
    if generator is None:
        return [None] * n
    return [
        torch.Generator().manual_seed(
            int(torch.randint(2**62, (), generator=generator)))
        for _ in range(n)
    ]


def _make_train_loss_fn(net: Net, device_augment: Optional[dict],
                        remat: bool = False, mesh=None):
    """The TRAIN-mode loss closure: optional on-device augmentation of a
    uint8 batch (and, on a detection net, of its boxes; the transform is
    `data.device_augment`), then the TRAIN forward. Returns
    (surrogate, (state, loss, yolo_stats)); the surrogate's gradient in
    the params is the reference's backward. The surrogate is None where
    no loss layer saw a label: every gradient is then 0, as in the JAX
    package.

    remat: the forward runs under `torch.utils.checkpoint` (non-reentrant,
    so the custom Functions are recomputed as they ran), which keeps
    only its inputs and recomputes the rest in the backward. The
    augmentation runs before it, once: its draws come from an explicit
    generator, whose state a recompute would not restore. The running
    stats, loss and stats are those of the first forward; the
    recompute's are dropped.

    A net with dropout draws one seed for the pass from the generator,
    after the augmentation's draws: the masks come from it
    (`_Executor._dropout`), so a recompute draws the same ones.

    mesh (`parallel.Mesh`): the batch is this rank's stripe; the
    augmentation draws each image's parameters for the global batch and
    takes the rank's stripe of them, so every rank's generator moves as
    one device's would, and the forward runs under the mesh."""
    is_detection = any(n.type == LayerType.YOLOV3 for n in net.nodes)
    has_dropout = any(n.type == LayerType.DROPOUT for n in net.nodes)
    if device_augment is not None and is_detection:
        if float(device_augment.get("max_distortion", 0.0)) > 0.0:
            raise ValueError(
                "device_augment: max_distortion cannot be combined with "
                "detection training (no box transform represents it)"
            )

    stripe = (mesh.rank, mesh.size) if mesh is not None else None

    def prepare(batch, generator):
        if device_augment is not None:
            from .data import device_augment as da

            if is_detection:
                x, lab = da.augment_batch_with_boxes_nchw(
                    batch["input"], batch["label"], generator, device_augment,
                    stripe=stripe,
                )
                return dict(batch, input=x, label=lab)
            return dict(batch, input=da.augment_batch_nchw(
                batch["input"], generator, device_augment, stripe=stripe,
            ))
        if batch["input"].dtype != torch.float32:
            return dict(batch, input=batch["input"].to(torch.float32))
        return batch

    def forward(params, state, batch, seed):
        ex = execute(net, params, state, batch, Mode.TRAIN, seed, mesh=mesh)
        return ex.surrogate, (ex.state, get_loss(ex), ex.yolo_stats)

    def loss_fn(params, state, batch, generator):
        batch = prepare(batch, generator)
        seed = None
        if has_dropout and generator is not None:
            seed = int(torch.randint(2**62, (), generator=generator))
        if remat:
            from torch.utils.checkpoint import checkpoint

            return checkpoint(forward, params, state, batch, seed,
                              use_reentrant=False)
        return forward(params, state, batch, seed)

    return loss_fn


def _sum_stats(a, b):
    """Per-layer stats dicts added key by key (stats are batch sums)."""
    return [{k: x[k] + y[k] for k in x} for x, y in zip(a, b)]


def _stack_stats(steps):
    """Per-step lists of per-layer stats dicts -> one list of dicts whose
    values have a leading step axis."""
    return [
        {k: torch.stack([st[i][k] for st in steps]) for k in steps[0][i]}
        for i in range(len(steps[0]))
    ]


def make_train_step(
    net: Net,
    remat: Optional[bool] = None,
    device_augment: Optional[dict] = None,
    accum_steps: Optional[int] = None,
):
    """One bcnn_train_on_batch equivalent (bcnn_net.c:452-463): forward,
    backward (autograd through the reference's custom gradients), update,
    loss. Returns train_step(params, state, opt_state, batch, generator)
    -> (params, state, opt_state, loss), or, with net.yolo_stats, a
    5-tuple ending in the list (one dict per YOLO layer) of the step's
    stats; params and opt_state are updated in place
    (learner.apply_updates) and state is a new dict.

    remat (or net.remat): the forward is recomputed in the backward
    (`torch.utils.checkpoint`), which trades operations for activation
    memory; the step's numbers are those of the plain step.

    accum_steps (or net.accum_steps): the batch runs as that many
    sequential microbatches of batch_size / accum_steps (a batch they do
    not divide raises ValueError), each with its own generator drawn
    from the step's; gradients, losses and stats are SUMMED over them,
    with no division, then ONE optimizer update. BN in TRAIN normalizes
    each microbatch with its own batch stats, and the running stats go
    through the microbatches in turn (`bcnn_tpu/compile.py:919-985`).

    device_augment (or net.device_augment): an Augmenter-style config;
    the batch then arrives as raw uint8 pixels (NCHW) and the augmentation
    and [-1, 1] normalisation run on the batch's device, drawing from
    `generator`."""
    from .learner import apply_updates

    if remat is None:
        remat = bool(getattr(net, "remat", False))
    if accum_steps is None:
        accum_steps = int(getattr(net, "accum_steps", 1) or 1)
    if accum_steps > 1 and net.batch_size % accum_steps:
        raise ValueError(
            f"batch_size {net.batch_size} not divisible by "
            f"accum_steps {accum_steps}"
        )
    if device_augment is None:
        device_augment = getattr(net, "device_augment", None)
    want_stats = bool(getattr(net, "yolo_stats", False))
    loss_fn = _make_train_loss_fn(net, device_augment, remat)
    specs = {t.key: t for t in net.param_specs()}

    def train_step(params, state, opt_state, batch, generator=None):
        leaves = {
            k: v.detach().requires_grad_(specs[k].trainable)
            for k, v in params.items()
        }
        if accum_steps > 1:
            mb = net.batch_size // accum_steps
            micro = [{k: v[m * mb:(m + 1) * mb] for k, v in batch.items()}
                     for m in range(accum_steps)]
            gens = child_generators(generator, accum_steps)
        else:
            micro, gens = [batch], [generator]
        loss = stats = None
        for mbatch, gen in zip(micro, gens):
            # leaf gradients add up over the microbatches' backwards
            sur, (state, l_m, s_m) = loss_fn(leaves, state, mbatch, gen)
            if sur is not None:
                sur.backward()
            loss = l_m if loss is None else loss + l_m
            stats = s_m if stats is None else _sum_stats(stats, s_m)
        grads = {
            k: v.grad if v.grad is not None else torch.zeros_like(v)
            for k, v in leaves.items() if specs[k].trainable
        }
        params, opt_state = apply_updates(net, params, grads, opt_state)
        if want_stats:
            return params, state, opt_state, loss.detach(), stats
        return params, state, opt_state, loss.detach()

    return train_step


def make_train_scan(net: Net, device_augment: Optional[dict] = None):
    """K training steps in one call over pre-staged device batches
    (`bcnn_tpu/compile.py:988-1031`): train_scan(params, state,
    opt_state, batches, generator) with batches {"input": (K, B, C, H,
    W), "label": (K, B, L)}; step k draws from the k-th of
    `child_generators(generator, K)`. Returns (params, state, opt_state,
    losses (K,)), and with net.yolo_stats the per-layer stats with a
    leading K axis. The steps are the bare step (no remat, no
    accum_steps), as in bcnn_tpu, and equal K calls of it."""
    step = make_train_step(net, remat=False, device_augment=device_augment,
                           accum_steps=1)
    want_stats = bool(getattr(net, "yolo_stats", False))

    def train_scan(params, state, opt_state, batches, generator=None):
        k_steps = batches["input"].shape[0]
        return _run_steps(
            step, want_stats, params, state, opt_state,
            ({"input": batches["input"][k], "label": batches["label"][k]}
             for k in range(k_steps)),
            child_generators(generator, k_steps),
        )

    return train_scan


def _run_steps(step, want_stats, params, state, opt_state, batches, gens):
    losses, stats = [], []
    for batch, gen in zip(batches, gens):
        out = step(params, state, opt_state, batch, gen)
        params, state, opt_state, loss = out[:4]
        losses.append(loss)
        if want_stats:
            stats.append(out[4])
    if want_stats:
        return params, state, opt_state, torch.stack(losses), _stack_stats(
            stats)
    return params, state, opt_state, torch.stack(losses)


def make_train_scan_resident(net: Net,
                             device_augment: Optional[dict] = None):
    """make_train_scan over a dataset held on the device
    (`bcnn_tpu/compile.py:1034-1087`): train_scan(params, state,
    opt_state, dataset, idx, generator), dataset {"input": (N, C, H, W),
    "label": (N, L)} on the device (uint8 images with device_augment,
    normalised fp32 otherwise) and idx a (K, B) int64 tensor there; step
    k gathers rows idx[k] on the device. Equal to make_train_scan on the
    gathered batches."""
    step = make_train_step(net, remat=False, device_augment=device_augment,
                           accum_steps=1)
    want_stats = bool(getattr(net, "yolo_stats", False))

    def train_scan(params, state, opt_state, dataset, idx, generator=None):
        return _run_steps(
            step, want_stats, params, state, opt_state,
            ({k: v.index_select(0, i) for k, v in dataset.items()}
             for i in idx),
            child_generators(generator, idx.shape[0]),
        )

    return train_scan


def make_eval_step(net: Net):
    """bcnn_predict_on_batch in VALID mode (`bcnn_tpu/compile.py:
    1090-1100`): eval_step(params, state, batch) -> the loss, with no
    state change and no autograd."""

    def eval_step(params, state, batch):
        with torch.inference_mode():
            return get_loss(execute(net, params, state, batch, Mode.VALID))

    return eval_step
