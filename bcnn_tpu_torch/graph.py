"""Declarative graph IR: the tensor table and the layer builders of the
detection slice, ported from `bcnn_tpu.graph`.

The port carries its own copy because every module of `bcnn_tpu` imports
JAX when it is loaded, and the port never does. Names, pytree keys, node
src wiring order (weights at src[1], bias at src[2], then run_mean,
run_var, scales, PReLU slopes) and the shape formulas are those of
`bcnn_tpu.graph`; `tests/test_torch_graph.py` holds the two to each other.

Layout: `TensorSpec.shape` is the reference's NCHW. `mem_shape` is the
port's in-memory layout: conv weights are OIHW `(n, c/groups, k, k)`,
where `bcnn_tpu` keeps HWIO.
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
    Mode,
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

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (self.n, self.c, self.h, self.w)

    def size(self) -> int:
        return self.n * self.c * self.h * self.w


@dataclass
class Node:
    """Mirror of bcnn_node (src/bcnn_node.h:36-49): an op instance."""

    type: LayerType
    src: List[int] = field(default_factory=list)
    dst: List[int] = field(default_factory=list)
    param: Dict[str, Any] = field(default_factory=dict)


class BuildError(ValueError):
    pass


class Net:
    """The graph builder: the builders the YOLOv3-tiny graph needs."""

    def __init__(self, mode: Mode = Mode.PREDICT):
        self.mode = Mode(mode)
        self.batch_size = 0
        self.tensors: List[TensorSpec] = []
        self.nodes: List[Node] = []
        # True once BN constants were folded into scales/biases
        # (bcnn_net.c:1281-1292 semantics)
        self.bn_folded = False
        self._used_keys: set = set()
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
    ) -> int:
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
        tensor is the BN shift, added after normalisation.
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
        )
        self._add_param(node, f"{src_id}_b", (1, 1, 1, n), (n,), None)
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

    def add_maxpool_layer(
        self, size: int, stride: int, padding: Padding, src_id: str, dst_id: str
    ):
        """bcnn_add_maxpool_layer (bcnn_maxpool_layer.c:41-143).

        Window origin is i*stride (never negative); out-of-range positions
        read -FLT_MAX (bcnn_maxpool_layer.c:163-183), so effective padding is
        high-side only.
        """
        node = Node(type=LayerType.MAXPOOL)
        self._resolve_src(node, src_id, "Maxpool layer")
        s = self._src(node)
        oh = _pool_out(s.h, size, stride, padding)
        ow = _pool_out(s.w, size, stride, padding)
        self._add_dst(node, dst_id, s.n, s.c, oh, ow)
        node.param = dict(size=size, stride=stride, padding=Padding(padding))
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
    ):
        """bcnn_add_yolo_layer (bcnn_yolo.c:36-135).

        dst shape == src shape; anchors are a constant of the node; the
        label tensor is shaped (n, 1, 1, boxes*(4+1)) with the 50-box
        layout (bcnn_yolo.c:68-73).
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
        self.add_node(node)

    # ------------------------------------------------------------------ #
    # introspection helpers
    # ------------------------------------------------------------------ #

    def param_specs(self) -> List[TensorSpec]:
        return [t for t in self.tensors if t.kind == TensorKind.PARAM]

    def state_specs(self) -> List[TensorSpec]:
        return [t for t in self.tensors if t.kind == TensorKind.STATE]


def _pool_out(x: int, size: int, stride: int, padding: Padding) -> int:
    """Pooling output size (bcnn_maxpool_layer.c:62-83)."""
    if padding == Padding.SAME:
        return (x + stride - 1) // stride
    if padding == Padding.VALID:
        return (x - size + stride) // stride
    return int(math.ceil((x - size) / stride)) + 1  # CAFFE
