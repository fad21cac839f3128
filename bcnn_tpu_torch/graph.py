"""Declarative graph IR: the tensor table, the learner config, the
augmentation config and every `add_*_layer` method that `config.add_layer`
dispatches to, ported from `bcnn_tpu.graph`, and `resize`. The
executor runs every layer but RESHAPE, which the reference does not
implement either.

The port carries its own copy because every module of `bcnn_tpu` imports
JAX when it is loaded, and the port never does. Names, pytree keys, node
src wiring order (weights at src[1], bias at src[2], then run_mean,
run_var, scales, PReLU slopes) and the shape formulas are those of
`bcnn_tpu.graph`; `tests/test_torch_graph.py` holds the two to each other.

Layout: `TensorSpec.shape` is the reference's NCHW. `mem_shape` is the
port's in-memory layout: conv weights are OIHW `(n, c/groups, k, k)`,
depthwise weights `(c, 1, k, k)` and deconv weights `(c_src, n, k, k)`
(`conv_transpose2d`'s), where `bcnn_tpu` keeps HWIO; FC weights are
`(in, out)` in both, rows in NCHW flatten order. Each conv-family layout
is the flat order of the reference's weight blob.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .initializers import Filler
from .types import (
    DETECTION_MAX_BOXES,
    Activation,
    FillerType,
    LayerType,
    Loss,
    LrDecay,
    Metric,
    Mode,
    Optimizer,
    Padding,
)


class TensorKind(enum.IntEnum):
    DATA = 0    # activations / graph intermediates
    PARAM = 1   # learned weights (entries of the params dict)
    STATE = 2   # non-learned mutable state (BN running stats)


@dataclass
class TensorSpec:
    """Mirror of bcnn_tensor metadata (bcnn.h:242-255), without storage."""

    name: str
    n: int = 0
    c: int = 0
    h: int = 0
    w: int = 0
    kind: TensorKind = TensorKind.DATA
    # params/state dict key for PARAM/STATE tensors (unique within the net)
    key: Optional[str] = None
    # in-memory array shape in the port's layout
    mem_shape: Optional[Tuple[int, ...]] = None
    # initializer fn(generator, shape) -> tensor for PARAM tensors
    filler: Optional[Callable] = None
    # optimizer metadata (see learner.py): which tensors each layer's
    # update() touches in the reference
    trainable: bool = False
    weight_decay: bool = False     # decay*batch folded into grad (weights only)
    adam_capable: bool = False     # uses Adam rule when optimizer is Adam
    batch_div_one: bool = False    # PReLU slopes divide lr by 1, not batch
    grad_div_batch: bool = False   # deconv weights: dW GEMM alpha = 1/batch

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (self.n, self.c, self.h, self.w)

    def size(self) -> int:
        return self.n * self.c * self.h * self.w

    def size3d(self) -> int:
        return self.c * self.h * self.w


@dataclass
class Node:
    """Mirror of bcnn_node (src/bcnn_node.h:36-49): an op instance."""

    type: LayerType
    src: List[int] = field(default_factory=list)
    dst: List[int] = field(default_factory=list)
    param: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Learner:
    """Mirror of bcnn_learner config (src/bcnn_net.h + bcnn_learner.c)."""

    optimizer: Optimizer = Optimizer.SGD
    base_learning_rate: float = 0.001
    momentum: float = 0.9
    decay: float = 0.0          # L2 weight decay, folded into the grad
    beta1: float = 0.9
    beta2: float = 0.999
    decay_type: LrDecay = LrDecay.CONSTANT
    gamma: float = 0.0
    # 0.0 is the reference's calloc default (bcnn_net.c:79): STEP decay is
    # then base*0^(iter/step), full rate before `step` and 0 after
    scale: float = 0.0
    power: float = 0.0
    max_batches: int = 0
    step: int = 1


class BuildError(ValueError):
    pass


class Net:
    """The graph builder: the public surface of `bcnn_tpu.graph.Net`."""

    def __init__(self, mode: Mode = Mode.PREDICT):
        self.mode = Mode(mode)
        self.batch_size = 0
        self.learner: Optional[Learner] = (
            Learner() if self.mode != Mode.PREDICT else None
        )
        self.tensors: List[TensorSpec] = []
        self.nodes: List[Node] = []
        # True once BN constants were folded into scales/biases
        # (bcnn_net.c:1281-1292 semantics)
        self.bn_folded = False
        # bcnn_set_num_threads: the host kernels' (bip's) thread cap
        self.num_threads = 1
        # precision knobs, as bcnn_tpu/compile.py:174-215 reads them (None:
        # fp32 throughout, the parity path):
        # - compute_dtype (torch.bfloat16): bf16 conv/FC inputs, fp32
        #   accumulation and master params, in every mode; in TRAIN the
        #   conv backward runs in bf16 too (ops.conv), as do the FC's
        #   and the depthwise layer's;
        # - act_dtype (torch.bfloat16): bf16 activations between layers in
        #   PREDICT;
        # - train_act_dtype (torch.bfloat16): bf16 activations between
        #   layers in TRAIN (read like bn_frozen_stats, yolo_stats, remat,
        #   accum_steps and device_augment with getattr: unset is off);
        # - quant: the int8 dict of ops.quant (PREDICT only): PTQ's
        #   (calibrate + quantize_weights, or ptq_synthetic) or QAT's
        #   (Session.freeze_qat);
        # - qat (True, or {"ema": 0.99, "per_layer": False}; read with
        #   getattr): quantization-aware training. TRAIN and VALID
        #   fake-quantize every conv, depthwise, deconv and FC input and
        #   weight (with per_layer, only the layers built with
        #   `quantize`); each input's range is an EMA ("ema") of its
        #   abs-max, held in the state as "qat_amax/<idx>". PREDICT
        #   ignores it.
        self.compute_dtype = None
        self.act_dtype = None
        self.quant = None
        self._used_keys: set = set()
        # data augmentation config (bcnn_data.h:53-94), written by
        # config.net_set_param
        self.data_aug: Dict[str, Any] = {}
        # tensor 0: input, tensor 1: label (bcnn_net.c:67-77)
        self.add_tensor(TensorSpec(name="input"))
        self.add_tensor(TensorSpec(name="label"))

    # ------------------------------------------------------------------ #
    # tensor table
    # ------------------------------------------------------------------ #

    def add_tensor(self, t: TensorSpec) -> int:
        if t.kind in (TensorKind.PARAM, TensorKind.STATE) and t.key is None:
            key = t.name
            if key in self._used_keys:
                key = f"{key}@{len(self.tensors)}"
            t.key = key
            self._used_keys.add(key)
        self.tensors.append(t)
        return len(self.tensors) - 1

    def get_tensor_index_by_name(self, name: str) -> int:
        """Reverse scan: latest tensor with the name wins
        (bcnn_net.c:379-386)."""
        for i in range(len(self.tensors) - 1, -1, -1):
            if self.tensors[i].name == name:
                return i
        return -1

    def tensor(self, name: str) -> TensorSpec:
        i = self.get_tensor_index_by_name(name)
        if i < 0:
            raise BuildError(f"no tensor named {name!r}")
        return self.tensors[i]

    def _resolve_src(self, node: Node, src_id: str, what: str) -> int:
        """First-layer fallback to tensor 0, as in every reference builder
        (e.g. bcnn_conv_layer.c:54-73)."""
        if self.nodes:
            idx = self.get_tensor_index_by_name(src_id)
            if idx < 0:
                raise BuildError(f"{what}: invalid input node name {src_id!r}")
            node.src.append(idx)
            return idx
        if self.tensors[0].size() <= 0:
            raise BuildError(
                "Invalid input size of the network. "
                "Hint: use set_input_shape() first"
            )
        node.src.append(0)
        return 0

    def _src(self, node: Node) -> TensorSpec:
        return self.tensors[node.src[0]]

    def _add_dst(self, node: Node, dst_id: str, n, c, h, w) -> int:
        idx = self.add_tensor(TensorSpec(name=dst_id, n=n, c=c, h=h, w=w))
        node.dst.append(idx)
        return idx

    def add_node(self, node: Node) -> None:
        self.nodes.append(node)

    # ------------------------------------------------------------------ #
    # net-level config
    # ------------------------------------------------------------------ #

    def set_input_shape(self, w: int, h: int, c: int, batch_size: int):
        """bcnn_set_input_shape (bcnn_net.c:280-285)."""
        self.batch_size = batch_size
        t = self.tensors[0]
        t.n, t.c, t.h, t.w = batch_size, c, h, w

    def add_input(self, w: int, h: int, c: int, name: str) -> int:
        """bcnn_add_input (bcnn_net.c:260-278): extra named input tensor."""
        return self.add_tensor(
            TensorSpec(name=name, n=self.batch_size, c=c, h=h, w=w)
        )

    def set_mode(self, mode: Mode):
        self.mode = Mode(mode)

    # learner setters (bcnn_learner.c:178-226)
    def set_sgd_optimizer(self, learning_rate: float, momentum: float):
        self.learner = self.learner or Learner()
        self.learner.optimizer = Optimizer.SGD
        self.learner.base_learning_rate = learning_rate
        self.learner.momentum = momentum

    def set_adam_optimizer(
        self, learning_rate: float, beta1: float = 0.9, beta2: float = 0.999
    ):
        self.learner = self.learner or Learner()
        self.learner.optimizer = Optimizer.ADAM
        self.learner.base_learning_rate = learning_rate
        self.learner.beta1 = beta1
        self.learner.beta2 = beta2
        self.learner.momentum = 0.9  # for bias updates (bcnn_learner.c:204)

    def set_learning_rate_policy(
        self,
        decay_type: LrDecay,
        gamma: float = 0.0,
        scale: float = 1.0,
        power: float = 0.0,
        max_batches: int = 0,
        step: int = 1,
    ):
        self.learner = self.learner or Learner()
        ln = self.learner
        ln.decay_type = LrDecay(decay_type)
        ln.gamma, ln.scale, ln.power = gamma, scale, power
        ln.max_batches, ln.step = max_batches, step

    def set_weight_regularizer(self, weight_decay: float):
        self.learner = self.learner or Learner()
        self.learner.decay = weight_decay

    def set_num_threads(self, n: int):
        """bcnn_set_num_threads (bcnn_net.c:185-232): caps the pool of the
        native host kernels (bip's augmentation and the batched loader)
        for the calling thread, as `bcnn_tpu.graph.Net.set_num_threads`
        does; PyTorch's own threads are the caller's to set."""
        from . import bip

        self.num_threads = max(1, int(n))
        bip.set_num_threads(self.num_threads)

    # ------------------------------------------------------------------ #
    # layer builders — shape math cited from the reference
    # ------------------------------------------------------------------ #

    def _add_param(
        self,
        node: Node,
        name: str,
        ref_shape: Tuple[int, int, int, int],
        mem_shape: Tuple[int, ...],
        filler: Optional[Callable],
        kind: TensorKind = TensorKind.PARAM,
        **opt,
    ) -> int:
        """`opt`: the optimizer metadata fields of TensorSpec."""
        n, c, h, w = ref_shape
        idx = self.add_tensor(
            TensorSpec(
                name=name,
                n=n,
                c=c,
                h=h,
                w=w,
                kind=kind,
                mem_shape=tuple(mem_shape),
                filler=filler,
                **opt,
            )
        )
        node.src.append(idx)
        return idx

    def add_convolutional_layer(
        self,
        n: int,
        size: int,
        stride: int,
        pad: int,
        num_groups: int,
        batch_norm: int,
        init: FillerType,
        activation: Activation,
        quantize: int,
        src_id: str,
        dst_id: str,
    ):
        """bcnn_add_convolutional_layer (bcnn_conv_layer.c:45-365).

        Weights (n, c/groups, k, k), OIHW in memory, filler range
        k*k*c/groups; dst (h + 2p - k)/s + 1. With batch_norm the `_b`
        tensor is the BN shift, added after normalisation, and the BN
        scales are never updated by the optimizer (bcnn_update_conv_layer
        touches only src[1], src[2]).
        """
        node = Node(type=LayerType.CONV2D)
        self._resolve_src(node, src_id, "Convolution layer")
        s = self._src(node)
        if s.c % num_groups or n % num_groups:
            raise BuildError("channels must be a multiple of num_groups")
        cpg = s.c // num_groups
        self._add_param(
            node,
            f"{src_id}_w",
            (n, cpg, size, size),
            (n, cpg, size, size),  # OIHW
            Filler(type=init, range=size * size * cpg),
            trainable=True,
            weight_decay=True,
            adam_capable=True,
        )
        self._add_param(
            node, f"{src_id}_b", (1, 1, 1, n), (n,), None, trainable=True
        )
        oh = (s.h + 2 * pad - size) // stride + 1
        ow = (s.w + 2 * pad - size) // stride + 1
        self._add_dst(node, dst_id, s.n, n, oh, ow)
        node.param = dict(
            num=n,
            size=size,
            stride=stride,
            pad=pad,
            num_groups=num_groups,
            batch_norm=int(batch_norm),
            activation=Activation(activation),
            quantize=int(quantize),
        )
        vec = ((1, 1, 1, n), (n,))
        if batch_norm:
            for stat in ("run_mean", "run_var"):
                self._add_param(
                    node, f"{src_id}_{stat}", *vec, None, kind=TensorKind.STATE
                )
            self._add_param(
                node, f"{src_id}_scales", *vec,
                Filler(type=FillerType.FIXED, value=1.0),
            )
        if activation == Activation.PRELU:
            self._add_param(node, f"{src_id}_prelu_slopes", *vec, None)
        self.add_node(node)

    def add_depthwise_conv_layer(
        self,
        size: int,
        stride: int,
        pad: int,
        batch_norm: int,
        init: FillerType,
        activation: Activation,
        src_id: str,
        dst_id: str,
    ):
        """bcnn_add_depthwise_conv_layer (bcnn_depthwise_conv_layer.c:43-160).

        One k*k filter per input channel, (c, 1, k, k) in memory; filler
        range k*k*c; dst channels == src channels, spatial
        (h + 2p - k)/s + 1. batch_norm is parsed, but no BN tensors are
        wired, as in the reference.
        """
        node = Node(type=LayerType.DEPTHWISE_CONV2D)
        self._resolve_src(node, src_id, "Depthwise conv layer")
        s = self._src(node)
        self._add_param(
            node,
            f"{src_id}_w",
            (1, 1, 1, s.c * size * size),
            (s.c, 1, size, size),  # OIHW with groups = c
            Filler(type=init, range=size * size * s.c),
            trainable=True,
            weight_decay=True,
            adam_capable=True,
        )
        self._add_param(
            node, f"{src_id}_b", (1, 1, 1, s.c), (s.c,), None, trainable=True
        )
        oh = (s.h + 2 * pad - size) // stride + 1
        ow = (s.w + 2 * pad - size) // stride + 1
        self._add_dst(node, dst_id, s.n, s.c, oh, ow)
        node.param = dict(
            size=size,
            stride=stride,
            pad=pad,
            batch_norm=int(batch_norm),
            activation=Activation(activation),
        )
        self.add_node(node)

    def add_deconvolutional_layer(
        self,
        n: int,
        size: int,
        stride: int,
        pad: int,
        init: FillerType,
        activation: Activation,
        src_id: str,
        dst_id: str,
    ):
        """bcnn_add_deconvolutional_layer (bcnn_deconv_layer.c:40-140).

        Weights (c_src, n, k, k) in memory, the blob's order and
        `conv_transpose2d`'s; filler range k*k*c_src; dst spatial
        s*(h-1) + k - 2p (bcnn_deconv_layer.c:97-101).
        """
        node = Node(type=LayerType.TRANSPOSE_CONV2D)
        self._resolve_src(node, src_id, "Deconvolution layer")
        s = self._src(node)
        self._add_param(
            node,
            f"{src_id}_w",
            (1, 1, 1, s.c * n * size * size),
            (s.c, n, size, size),
            Filler(type=init, range=size * size * s.c),
            trainable=True,
            weight_decay=True,
            adam_capable=True,
            grad_div_batch=True,  # ref dW GEMM alpha = 1/batch_size
        )
        self._add_param(
            node, f"{src_id}_b", (1, 1, 1, n), (n,), None, trainable=True
        )
        oh = stride * (s.h - 1) + size - 2 * pad
        ow = stride * (s.w - 1) + size - 2 * pad
        self._add_dst(node, dst_id, s.n, n, oh, ow)
        node.param = dict(
            num=n,
            size=size,
            stride=stride,
            pad=pad,
            activation=Activation(activation),
        )
        self.add_node(node)

    def add_fullc_layer(
        self,
        output_size: int,
        init: FillerType,
        activation: Activation,
        quantize: int,
        src_id: str,
        dst_id: str,
    ):
        """bcnn_add_fullc_layer (bcnn_fc_layer.c:39-140).

        Weights (in, out) in memory for x @ W, rows in the NCHW flatten
        order of the source; filler range = input size; dst (n, out, 1, 1).
        """
        node = Node(type=LayerType.FULL_CONNECTED)
        self._resolve_src(node, src_id, "Full-connected layer")
        s = self._src(node)
        input_size = s.size3d()
        self._add_param(
            node,
            f"{src_id}_w",
            (output_size, s.c, s.h, s.w),
            (input_size, output_size),
            Filler(type=init, range=input_size),
            trainable=True,
            weight_decay=True,
            adam_capable=True,
        )
        self._add_param(
            node,
            f"{src_id}_b",
            (1, 1, 1, output_size),
            (output_size,),
            None,
            trainable=True,
        )
        self._add_dst(node, dst_id, s.n, output_size, 1, 1)
        node.param = dict(
            output_size=output_size,
            activation=Activation(activation),
            quantize=int(quantize),
        )
        self.add_node(node)

    def add_activation_layer(self, activation: Activation, src_id: str):
        """bcnn_add_activation_layer (bcnn_activation_layer.c:36-98).

        In place: the node's dst index is its src index, so later reads
        of the name see the activated value. PReLU adds per-channel
        slopes `<src>_w_prelu`, stepped by the SGD rule whatever the
        optimizer, lr divided by 1."""
        node = Node(type=LayerType.ACTIVATION)
        if not self.nodes:
            raise BuildError("Activation layer can't be the first layer")
        idx = self.get_tensor_index_by_name(src_id)
        if idx < 0:
            raise BuildError(
                f"Activation layer: invalid input node name {src_id!r}"
            )
        node.src.append(idx)
        node.dst.append(idx)
        s = self.tensors[idx]
        if activation == Activation.PRELU:
            self._add_param(
                node,
                f"{src_id}_w_prelu",
                (1, 1, 1, s.c),
                (s.c,),
                None,
                trainable=True,
                weight_decay=True,
                adam_capable=False,
                batch_div_one=True,
            )
        node.param = dict(activation=Activation(activation))
        self.add_node(node)

    def add_batchnorm_layer(self, src_id: str, dst_id: str):
        """bcnn_add_batchnorm_layer (bcnn_batchnorm_layer.c:36-140).

        src wiring: [x, run_mean, run_var, scales, biases]. The reference
        has no update() for this layer: scales and biases get gradients
        but are never stepped; only the running stats change."""
        node = Node(type=LayerType.BATCHNORM)
        if not self.nodes:
            raise BuildError(
                "Batchnorm layer can't be the first layer of the network"
            )
        self._resolve_src(node, src_id, "Batchnorm layer")
        s = self._src(node)
        vec = ((1, 1, 1, s.c), (s.c,))
        for stat in ("run_mean", "run_var"):
            self._add_param(node, f"{src_id}_{stat}", *vec, None,
                            kind=TensorKind.STATE)
        self._add_param(node, f"{src_id}_scales", *vec,
                        Filler(type=FillerType.FIXED, value=1.0))
        self._add_param(node, f"{src_id}_b", *vec, None)
        self._add_dst(node, dst_id, s.n, s.c, s.h, s.w)
        node.param = dict()
        self.add_node(node)

    def add_lrn_layer(
        self,
        local_size: int,
        alpha: float,
        beta: float,
        k: float,
        src_id: str,
        dst_id: str,
    ):
        """bcnn_add_lrn_layer: cross-channel local response
        normalization (bcnn.h:850-868). The reference's builder never
        stores its k argument (bcnn_lrn_layer.c:49-52), so k is 0 here,
        as in `bcnn_tpu`."""
        node = Node(type=LayerType.LRN)
        self._resolve_src(node, src_id, "LRN layer")
        s = self._src(node)
        self._add_dst(node, dst_id, s.n, s.c, s.h, s.w)
        node.param = dict(
            local_size=local_size, alpha=alpha, beta=beta, k=0.0
        )
        self.add_node(node)

    def add_maxpool_layer(
        self, size: int, stride: int, padding: Padding, src_id: str,
        dst_id: str, darknet_padding: Optional[int] = None,
    ):
        """bcnn_add_maxpool_layer (bcnn_maxpool_layer.c:41-143).

        Window origin is i*stride (never negative); out-of-range positions
        read -FLT_MAX (bcnn_maxpool_layer.c:163-183), so effective padding is
        high-side only.

        darknet_padding (a Darknet cfg's pool, the port's own): Darknet's
        rule (maxpool_layer.c) instead, the output (x + darknet_padding -
        size) / stride + 1 and the window origin i*stride -
        darknet_padding / 2. The param holds it where the rule differs
        from bcnn's: a window origin below 0, or a padding other than 0
        or size - 1 (those two give bcnn's VALID and SAME sizes).
        """
        node = Node(type=LayerType.MAXPOOL)
        self._resolve_src(node, src_id, "Maxpool layer")
        node.param = dict(size=size, stride=stride, padding=Padding(padding))
        p = darknet_padding
        if p is not None and (p // 2 or p not in (0, size - 1)):
            node.param["darknet_padding"] = p
        s = self._src(node)
        self._add_dst(node, dst_id, s.n, s.c,
                      *(_pool_out_of(x, node.param) for x in (s.h, s.w)))
        self.add_node(node)

    def add_avgpool_layer(self, src_id: str, dst_id: str):
        """bcnn_add_avgpool_layer: global average pool to 1x1xC
        (bcnn_avgpool_layer.c:82-100)."""
        node = Node(type=LayerType.AVGPOOL)
        self._resolve_src(node, src_id, "Avgpool layer")
        s = self._src(node)
        self._add_dst(node, dst_id, s.n, s.c, 1, 1)
        node.param = dict()
        self.add_node(node)

    def add_softmax_layer(self, src_id: str, dst_id: str):
        """bcnn_add_softmax_layer: softmax over the channels at each
        position, a vector softmax when h*w == 1
        (bcnn_softmax_layer.c:88-160); its backward copies the gradient
        (bcnn_softmax_layer.c:161-175)."""
        node = Node(type=LayerType.SOFTMAX)
        self._resolve_src(node, src_id, "Softmax layer")
        s = self._src(node)
        self._add_dst(node, dst_id, s.n, s.c, s.h, s.w)
        node.param = dict()
        self.add_node(node)

    def add_dropout_layer(self, rate: float, src_id: str):
        """bcnn_add_dropout_layer: inverted dropout, train-only, in place
        (dst index == src index, bcnn_dropout_layer.c:31-60)."""
        node = Node(type=LayerType.DROPOUT)
        if not self.nodes:
            raise BuildError("Dropout layer can't be the first layer")
        idx = self.get_tensor_index_by_name(src_id)
        if idx < 0:
            raise BuildError(
                f"Dropout layer: invalid input node name {src_id!r}"
            )
        node.src.append(idx)
        node.dst.append(idx)
        node.param = dict(
            rate=float(rate),
            scale=1.0 / (1.0 - rate) if rate < 1.0 else 1.0,
        )
        self.add_node(node)

    def add_concat_layer(self, src_ids: Sequence[str], dst_id: str):
        """bcnn_add_concat_layer: channel-axis concat of N sources
        (bcnn_concat_layer.c:36-110)."""
        node = Node(type=LayerType.CONCAT)
        if not self.nodes:
            raise BuildError("Concat layer can't be the first layer")
        out_c = 0
        for sid in src_ids:
            idx = self.get_tensor_index_by_name(sid)
            if idx < 0:
                raise BuildError(f"Concat layer: invalid input name {sid!r}")
            node.src.append(idx)
            out_c += self.tensors[idx].c
        s0 = self.tensors[node.src[0]]
        for idx in node.src[1:]:
            t = self.tensors[idx]
            if (t.w, t.h) != (s0.w, s0.h):
                raise BuildError("Concat layer: inconsistent spatial sizes")
        self._add_dst(node, dst_id, s0.n, out_c, s0.h, s0.w)
        node.param = dict()
        self.add_node(node)

    def add_eltwise_layer(
        self, activation: Activation, src_id1: str, src_id2: str, dst_id: str
    ):
        """bcnn_add_eltwise_layer: add with stride broadcast across
        spatial sizes (Darknet's [shortcut]); the strides and the common
        (c, h, w) are fixed at build (bcnn_eltwise_layer.c:58-95)."""
        node = Node(type=LayerType.ELTWISE)
        i1 = self.get_tensor_index_by_name(src_id1)
        i2 = self.get_tensor_index_by_name(src_id2)
        if i1 < 0 or i2 < 0:
            raise BuildError("Eltwise layer: invalid input name")
        node.src += [i1, i2]
        t1, t2 = self.tensors[i1], self.tensors[i2]
        stride = (
            max(1, t1.w // t2.w if t2.w else 1),
            max(1, t2.w // t1.w if t1.w else 1),
        )
        min_dim = (min(t1.c, t2.c), min(t1.h, t2.h), min(t1.w, t2.w))
        self._add_dst(node, dst_id, t1.n, t1.c, t1.h, t1.w)
        node.param = dict(
            activation=Activation(activation), stride=stride, min_dim=min_dim
        )
        self.add_node(node)

    def add_upsample_layer(self, size: int, src_id: str, dst_id: str):
        """bcnn_add_upsample_layer: nearest-neighbor x size
        (bcnn_upsample_layer.c:36-75)."""
        node = Node(type=LayerType.UPSAMPLE)
        self._resolve_src(node, src_id, "Upsample layer")
        s = self._src(node)
        self._add_dst(node, dst_id, s.n, s.c, s.h * size, s.w * size)
        node.param = dict(size=size)
        self.add_node(node)

    def add_yolo_layer(
        self,
        num_boxes_per_cell: int,
        classes: int,
        coords: int,
        total: int,
        mask: Sequence[int],
        anchors: Sequence[float],
        src_id: str,
        dst_id: str,
        scale_x_y: float = 1.0,
        new_coords: int = 0,
    ):
        """bcnn_add_yolo_layer (bcnn_yolo.c:36-135).

        dst shape == src shape; anchors are a constant of the node; the
        label tensor is shaped (n, 1, 1, boxes*(4+1)) with the 50-box
        layout (bcnn_yolo.c:68-73). scale_x_y (the port's own, Darknet's
        [yolo] key): a box centre is (cell + sigmoid(t) * s - (s - 1) /
        2) / grid; the param holds it where it is not 1. new_coords (the
        port's own, Darknet's [yolo] key; YOLOv7): the head takes the
        logistic of every channel and a box's width is 4 * sigmoid(tw)^2
        * anchor_w / net_w (no exp), likewise its height; the param holds
        it where it is 1.
        """
        node = Node(type=LayerType.YOLOV3)
        self._resolve_src(node, src_id, "Yolo layer")
        s = self._src(node)
        if num_boxes_per_cell * (classes + coords + 1) != s.c:
            raise BuildError(
                f"Yolo layer: inconsistent number of channels "
                f"{num_boxes_per_cell * (classes + coords + 1)} != {s.c}"
            )
        lbl = self.tensors[1]
        lbl.n, lbl.c, lbl.h, lbl.w = (
            s.n,
            1,
            1,
            DETECTION_MAX_BOXES * (4 + 1),
        )
        self._add_dst(node, dst_id, s.n, s.c, s.h, s.w)
        anchors = list(anchors) if anchors is not None else [0.5] * (total * 2)
        node.param = dict(
            num=num_boxes_per_cell,
            classes=classes,
            coords=coords,
            total=total,
            mask=list(mask) if mask is not None else list(range(total)),
            anchors=anchors,
        )
        if scale_x_y != 1.0:
            node.param["scale_x_y"] = float(scale_x_y)
        if new_coords:
            node.param["new_coords"] = 1
        self.add_node(node)

    def add_cost_layer(
        self,
        loss: Loss,
        loss_metric: Metric,
        scale: float,
        src_id: str,
        label_id: str = "label",
        dst_id: str = "cost",
    ):
        """bcnn_add_cost_layer (bcnn_cost_layer.c:36-91): reshapes the
        label tensor (index 1) to src's shape; src wiring [x, label]."""
        node = Node(type=LayerType.COST)
        if not self.nodes:
            raise BuildError("Cost layer can't be the first layer")
        idx = self.get_tensor_index_by_name(src_id)
        if idx < 0:
            raise BuildError(f"Cost layer: invalid input name {src_id!r}")
        node.src.append(idx)
        s = self.tensors[idx]
        lbl = self.tensors[1]
        lbl.n, lbl.c, lbl.h, lbl.w = s.n, s.c, s.h, s.w
        node.src.append(1)
        self._add_dst(node, dst_id, s.n, s.c, s.h, s.w)
        node.param = dict(
            loss=Loss(loss), loss_metric=Metric(loss_metric), scale=scale
        )
        self.add_node(node)

    def resize(self, w: int, h: int, c: Optional[int] = None,
               batch_size: Optional[int] = None):
        """bcnn_resize_net (bcnn_net.c:287-335), as
        `bcnn_tpu.graph.Net.resize`: a new input size (and channel count,
        batch size) for a fully convolutional graph, by re-running the
        builders' shape formulas over the nodes; an FC whose input size
        changes raises BuildError. Parameters keep their shapes, so a
        compiled session's weights stand; the executor reads the new
        shapes at the next call."""
        t0 = self.tensors[0]
        t0.w, t0.h = w, h
        if c is not None:
            t0.c = c
        if batch_size is not None:
            self.batch_size = batch_size
            t0.n = batch_size
        for node in self.nodes:
            s = self.tensors[node.src[0]]
            d = self.tensors[node.dst[0]] if node.dst else None
            p = node.param
            ty = node.type
            if ty in (LayerType.CONV2D, LayerType.DEPTHWISE_CONV2D):
                d.n = s.n
                d.h = (s.h + 2 * p["pad"] - p["size"]) // p["stride"] + 1
                d.w = (s.w + 2 * p["pad"] - p["size"]) // p["stride"] + 1
            elif ty == LayerType.TRANSPOSE_CONV2D:
                d.n = s.n
                d.h = p["stride"] * (s.h - 1) + p["size"] - 2 * p["pad"]
                d.w = p["stride"] * (s.w - 1) + p["size"] - 2 * p["pad"]
            elif ty == LayerType.MAXPOOL:
                d.n = s.n
                d.h, d.w = _pool_out_of(s.h, p), _pool_out_of(s.w, p)
            elif ty == LayerType.AVGPOOL:
                d.n, d.h, d.w = s.n, 1, 1
            elif ty == LayerType.FULL_CONNECTED:
                tw = self.tensors[node.src[1]]
                if tw.size3d() != s.size3d():
                    raise BuildError(
                        "resize: fully-connected input size changed "
                        "(resize supports fully-convolutional graphs)"
                    )
                d.n = s.n
            elif ty == LayerType.UPSAMPLE:
                d.n, d.h, d.w = s.n, s.h * p["size"], s.w * p["size"]
            elif ty == LayerType.CONCAT:
                d.n, d.h, d.w = s.n, s.h, s.w
                d.c = sum(self.tensors[i].c for i in node.src)
            elif ty == LayerType.ELTWISE:
                t1, t2 = self.tensors[node.src[0]], self.tensors[node.src[1]]
                d.n, d.c, d.h, d.w = t1.n, t1.c, t1.h, t1.w
                p["stride"] = (
                    max(1, t1.w // t2.w if t2.w else 1),
                    max(1, t2.w // t1.w if t1.w else 1),
                )
                p["min_dim"] = (
                    min(t1.c, t2.c), min(t1.h, t2.h), min(t1.w, t2.w)
                )
            elif ty == LayerType.YOLOV3:
                d.n, d.c, d.h, d.w = s.n, s.c, s.h, s.w
            elif ty == LayerType.COST:
                lbl = self.tensors[1]
                lbl.n, lbl.c, lbl.h, lbl.w = s.n, s.c, s.h, s.w
                d.n, d.c, d.h, d.w = s.n, s.c, s.h, s.w
            elif node.dst and node.dst[0] != node.src[0]:
                d.n, d.c, d.h, d.w = s.n, s.c, s.h, s.w
        return self

    # ------------------------------------------------------------------ #
    # introspection helpers
    # ------------------------------------------------------------------ #

    def param_specs(self) -> List[TensorSpec]:
        return [t for t in self.tensors if t.kind == TensorKind.PARAM]

    def state_specs(self) -> List[TensorSpec]:
        return [t for t in self.tensors if t.kind == TensorKind.STATE]


def _pool_out_of(x: int, p: Dict) -> int:
    """A max-pool node's output size from its param: Darknet's rule where
    it holds "darknet_padding", else bcnn's."""
    if "darknet_padding" in p:
        return (x + p["darknet_padding"] - p["size"]) // p["stride"] + 1
    return _pool_out(x, p["size"], p["stride"], p["padding"])


def pool_offset(p: Dict) -> int:
    """How far a max-pool node's windows start before i*stride: 0 in
    bcnn's rule, darknet_padding / 2 in Darknet's."""
    return p.get("darknet_padding", 0) // 2


def _pool_out(x: int, size: int, stride: int, padding: Padding) -> int:
    """Pooling output size (bcnn_maxpool_layer.c:62-83)."""
    if padding == Padding.SAME:
        return (x + stride - 1) // stride
    if padding == Padding.VALID:
        return (x - size + stride) // stride
    return int(math.ceil((x - size) / stride)) + 1  # CAFFE
