"""TFLite export of a port net, the port of `tools/bcnn2tflite.py` and
`tools/tflite_writer.py`.

Two backends, as in the JAX package's converter:
  - direct (`write_tflite`): a minimal FlatBuffers builder (wire format
    only) and the subset of the TFLite schema the op map needs, the
    reference's bcnn2tflite.cc:203-218 op map minus YOLO, which the
    reference's converter rejects too. No TensorFlow needed.
  - TensorFlow (`build_tf_forward`): the graph rebuilt as a tf.function
    and serialized through tf.lite.TFLiteConverter; it also emits the
    YOLO layer's activated head. Imported only when that backend runs.
`convert_net(..., backend="auto")` takes TensorFlow where it imports,
else the direct writer.

Both read the port's params and state (torch tensors, conv weights
OIHW) through `bridge.params_to_numpy`, which gives them in the JAX
package's layouts (conv HWIO, depthwise (k, k, 1, C), deconv
(k, k, O, C), FC (in, out)); from there the emission is the JAX-side
writer's, line for line, so that the same weights give the same bytes:
the OHWI weight layout, BatchNorm folded into a MUL/ADD pair (or into
the conv's weights and bias) with the port's own EPS, and the injected
flatten/reshape around FULLY_CONNECTED (bcnn2tflite.cc:52-80).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import bridge
from .ops.norm import EPS
from .types import Activation, LayerType

# ------------------------------------------------------------------ #
# FlatBuffers wire format (build back-to-front; offsets measured from
# the END of the growing buffer, like the reference implementations)
# ------------------------------------------------------------------ #


class Builder:
    def __init__(self):
        self.buf = bytearray()
        self.minalign = 1
        self.vt_slots: Optional[List[int]] = None
        self.object_end = 0

    # -- low level ---------------------------------------------------- #
    def offset(self) -> int:
        return len(self.buf)

    def pad(self, n: int):
        if n:
            self.buf[:0] = b"\0" * n

    def prep(self, size: int, additional: int):
        if size > self.minalign:
            self.minalign = size
        align = (~(len(self.buf) + additional)) + 1
        self.pad(align & (size - 1))

    def push(self, fmt: str, value):
        b = struct.pack("<" + fmt, value)
        self.buf[:0] = b

    def place_u32_at(self, off_from_end: int, value: int):
        pos = len(self.buf) - off_from_end
        self.buf[pos : pos + 4] = struct.pack("<i", value)

    # -- scalars ------------------------------------------------------ #
    def prepend(self, fmt: str, size: int, value):
        self.prep(size, 0)
        self.push(fmt, value)

    def prepend_uoffset(self, obj: int):
        self.prep(4, 0)
        assert obj <= self.offset()
        self.push("I", self.offset() - obj + 4)

    # -- vectors / strings -------------------------------------------- #
    def vector(self, data: bytes, elem_size: int, count: int,
               align: Optional[int] = None) -> int:
        self.prep(4, elem_size * count)
        self.prep(align or elem_size, elem_size * count)
        self.buf[:0] = data
        self.push("I", count)
        return self.offset()

    def int32_vector(self, values: Sequence[int]) -> int:
        return self.vector(
            struct.pack(f"<{len(values)}i", *values), 4, len(values)
        )

    def offset_vector(self, offsets: Sequence[int]) -> int:
        self.prep(4, 4 * len(offsets))
        for o in reversed(offsets):
            self.prepend_uoffset(o)
        self.push("I", len(offsets))
        return self.offset()

    def string(self, s: str) -> int:
        raw = s.encode("utf-8")
        self.prep(4, len(raw) + 1)
        self.buf[:0] = raw + b"\0"
        self.push("I", len(raw))
        return self.offset()

    # -- tables -------------------------------------------------------- #
    def start_table(self, n_slots: int):
        assert self.vt_slots is None
        self.vt_slots = [0] * n_slots
        self.object_end = self.offset()

    def slot(self, i: int):
        self.vt_slots[i] = self.offset()

    def field_scalar(self, i: int, fmt: str, size: int, value, default):
        if value != default:
            self.prepend(fmt, size, value)
            self.slot(i)

    def field_bool(self, i: int, value: bool, default: bool = False):
        self.field_scalar(i, "b", 1, 1 if value else 0,
                          1 if default else 0)

    def field_offset(self, i: int, obj: Optional[int]):
        if obj:
            self.prepend_uoffset(obj)
            self.slot(i)

    def end_table(self) -> int:
        assert self.vt_slots is not None
        slots = self.vt_slots
        self.vt_slots = None
        # placeholder soffset to vtable
        self.prep(4, 0)
        self.push("i", 0)
        object_offset = self.offset()
        # trim trailing empty slots
        while slots and slots[-1] == 0:
            slots.pop()
        # vtable entries, reversed (we prepend)
        for off in reversed(slots):
            self.prepend("H", 2, object_offset - off if off else 0)
        self.prepend("H", 2, object_offset - self.object_end)  # table size
        self.prepend("H", 2, 2 * len(slots) + 4)  # vtable size
        vt_offset = self.offset()
        self.place_u32_at(object_offset, vt_offset - object_offset)
        return object_offset

    def finish(self, root: int, file_identifier: Optional[str] = None):
        self.prep(self.minalign, 8 if file_identifier else 4)
        if file_identifier:
            self.buf[:0] = file_identifier.encode("ascii")[:4]
        self.prepend_uoffset(root)
        return bytes(self.buf)


# ------------------------------------------------------------------ #
# TFLite schema subset (schema.fbs v3)
# ------------------------------------------------------------------ #

FLOAT32 = 0
INT32 = 2

# BuiltinOperator codes
ADD = 0
CONCATENATION = 2
CONV_2D = 3
DEPTHWISE_CONV_2D = 4
FULLY_CONNECTED = 9
LOGISTIC = 14
MAX_POOL_2D = 17
MUL = 18
RELU = 19
RESHAPE = 22
SOFTMAX = 25
TANH = 28
PAD = 34
TRANSPOSE = 39
MEAN = 40
PRELU = 54
PADV2 = 60
TRANSPOSE_CONV = 67
RESIZE_NEAREST_NEIGHBOR = 97
LEAKY_RELU = 98

# BuiltinOptions union discriminants
OPT_NONE = 0
OPT_CONV2D = 1
OPT_DEPTHWISE = 2
OPT_POOL2D = 5
OPT_FULLY_CONNECTED = 8
OPT_SOFTMAX = 9
OPT_CONCATENATION = 10
OPT_ADD = 11
OPT_RESHAPE = 17
OPT_MUL = 21
OPT_PAD = 22
OPT_TRANSPOSE = 26
OPT_REDUCER = 27
OPT_PADV2 = 43
OPT_TRANSPOSE_CONV = 49
OPT_RESIZE_NN = 74
OPT_LEAKY_RELU = 75

PADDING_SAME = 0
PADDING_VALID = 1

ACT_NONE = 0
ACT_RELU = 1
ACT_TANH = 4


class TFLiteModel:
    """Accumulates tensors/operators, then serializes."""

    def __init__(self):
        self.buffers: List[bytes] = [b""]  # buffer 0: empty sentinel
        self.tensors: List[Dict] = []
        self.operators: List[Dict] = []
        self.opcodes: List[int] = []

    def add_buffer(self, data: np.ndarray) -> int:
        self.buffers.append(np.ascontiguousarray(data).tobytes())
        return len(self.buffers) - 1

    def add_tensor(self, shape, name: str, dtype=FLOAT32,
                   buffer: int = 0) -> int:
        self.tensors.append(
            dict(shape=[int(s) for s in shape], name=name, type=dtype,
                 buffer=buffer)
        )
        return len(self.tensors) - 1

    def const(self, arr: np.ndarray, name: str) -> int:
        dtype = INT32 if arr.dtype == np.int32 else FLOAT32
        return self.add_tensor(
            arr.shape, name, dtype, self.add_buffer(arr)
        )

    def opcode_index(self, code: int) -> int:
        if code not in self.opcodes:
            self.opcodes.append(code)
        return self.opcodes.index(code)

    def add_op(self, code: int, inputs, outputs, opt_type=OPT_NONE,
               opt: Optional[Dict] = None):
        self.operators.append(
            dict(opcode=self.opcode_index(code), inputs=list(inputs),
                 outputs=list(outputs), opt_type=opt_type,
                 opt=opt or {})
        )

    # -- serialization ------------------------------------------------- #

    def _options_table(self, b: Builder, opt_type: int, o: Dict) -> int:
        if opt_type == OPT_CONV2D:
            b.start_table(6)
            b.field_scalar(0, "b", 1, o["padding"], -1)
            b.field_scalar(1, "i", 4, o["stride"], 0)
            b.field_scalar(2, "i", 4, o["stride"], 0)
            b.field_scalar(3, "b", 1, o.get("act", 0), -1)
            b.field_scalar(4, "i", 4, 1, 0)  # dilation_w_factor
            b.field_scalar(5, "i", 4, 1, 0)
            return b.end_table()
        if opt_type == OPT_DEPTHWISE:
            b.start_table(7)
            b.field_scalar(0, "b", 1, o["padding"], -1)
            b.field_scalar(1, "i", 4, o["stride"], 0)
            b.field_scalar(2, "i", 4, o["stride"], 0)
            b.field_scalar(3, "i", 4, 1, 0)  # depth_multiplier
            b.field_scalar(4, "b", 1, o.get("act", 0), -1)
            b.field_scalar(5, "i", 4, 1, 0)
            b.field_scalar(6, "i", 4, 1, 0)
            return b.end_table()
        if opt_type == OPT_POOL2D:
            b.start_table(6)
            b.field_scalar(0, "b", 1, o["padding"], -1)
            b.field_scalar(1, "i", 4, o["stride"], 0)
            b.field_scalar(2, "i", 4, o["stride"], 0)
            b.field_scalar(3, "i", 4, o["size"], 0)
            b.field_scalar(4, "i", 4, o["size"], 0)
            b.field_scalar(5, "b", 1, o.get("act", 0), -1)
            return b.end_table()
        if opt_type == OPT_FULLY_CONNECTED:
            b.start_table(2)
            b.field_scalar(0, "b", 1, o.get("act", 0), -1)
            return b.end_table()
        if opt_type == OPT_SOFTMAX:
            b.start_table(1)
            b.field_scalar(0, "f", 4, 1.0, 0.0)
            return b.end_table()
        if opt_type == OPT_CONCATENATION:
            b.start_table(2)
            b.field_scalar(0, "i", 4, o["axis"], 0)
            b.field_scalar(1, "b", 1, o.get("act", 0), -1)
            return b.end_table()
        if opt_type in (OPT_ADD, OPT_MUL):
            b.start_table(1)
            b.field_scalar(0, "b", 1, o.get("act", 0), -1)
            return b.end_table()
        if opt_type == OPT_RESHAPE:
            b.start_table(1)
            b.field_offset(0, b.int32_vector(o["new_shape"]))
            return b.end_table()
        if opt_type == OPT_REDUCER:
            b.start_table(1)
            b.field_bool(0, o.get("keep_dims", True))
            return b.end_table()
        if opt_type == OPT_TRANSPOSE_CONV:
            b.start_table(3)
            b.field_scalar(0, "b", 1, o["padding"], -1)
            b.field_scalar(1, "i", 4, o["stride"], 0)
            b.field_scalar(2, "i", 4, o["stride"], 0)
            return b.end_table()
        if opt_type == OPT_RESIZE_NN:
            b.start_table(2)
            b.field_bool(0, False)
            b.field_bool(1, False)
            return b.end_table()
        if opt_type == OPT_LEAKY_RELU:
            b.start_table(1)
            b.field_scalar(0, "f", 4, o["alpha"], 0.0)
            return b.end_table()
        if opt_type in (OPT_PAD, OPT_PADV2, OPT_TRANSPOSE):
            b.start_table(0)
            return b.end_table()
        return 0

    def serialize(self, inputs: Sequence[int],
                  outputs: Sequence[int]) -> bytes:
        b = Builder()

        buffer_tables = []
        for data in self.buffers:
            vec = 0
            if data:
                vec = b.vector(data, 1, len(data), align=16)
            b.start_table(1)
            b.field_offset(0, vec)
            buffer_tables.append(b.end_table())

        tensor_tables = []
        for t in self.tensors:
            name = b.string(t["name"])
            shape = b.int32_vector(t["shape"])
            b.start_table(4)
            b.field_offset(0, shape)
            b.field_scalar(1, "b", 1, t["type"], 0)
            b.field_scalar(2, "I", 4, t["buffer"], 0)
            b.field_offset(3, name)
            tensor_tables.append(b.end_table())

        op_tables = []
        for op in self.operators:
            opts = self._options_table(b, op["opt_type"], op["opt"])
            ins = b.int32_vector(op["inputs"])
            outs = b.int32_vector(op["outputs"])
            b.start_table(5)
            b.field_scalar(0, "I", 4, op["opcode"], 0)
            b.field_offset(1, ins)
            b.field_offset(2, outs)
            b.field_scalar(3, "B", 1, op["opt_type"], 0)
            b.field_offset(4, opts)
            op_tables.append(b.end_table())

        sg_name = b.string("main")
        sg_tensors = b.offset_vector(tensor_tables)
        sg_inputs = b.int32_vector(list(inputs))
        sg_outputs = b.int32_vector(list(outputs))
        sg_ops = b.offset_vector(op_tables)
        b.start_table(5)
        b.field_offset(0, sg_tensors)
        b.field_offset(1, sg_inputs)
        b.field_offset(2, sg_outputs)
        b.field_offset(3, sg_ops)
        b.field_offset(4, sg_name)
        subgraph = b.end_table()

        opcode_tables = []
        for code in self.opcodes:
            b.start_table(4)
            # deprecated byte field (id 0) for classic codes, plus the
            # modern int32 field (id 3)
            b.field_scalar(0, "b", 1, min(code, 127), 0)
            b.field_scalar(2, "i", 4, 1, 1)  # version
            b.field_scalar(3, "i", 4, code, 0)
            opcode_tables.append(b.end_table())

        # the JAX package's description, so that both writers' bytes agree
        desc = b.string("bcnn_tpu direct export")
        v_opcodes = b.offset_vector(opcode_tables)
        v_subgraphs = b.offset_vector([subgraph])
        v_buffers = b.offset_vector(buffer_tables)
        b.start_table(5)
        b.field_scalar(0, "I", 4, 3, 0)  # schema version
        b.field_offset(1, v_opcodes)
        b.field_offset(2, v_subgraphs)
        b.field_offset(3, desc)
        b.field_offset(4, v_buffers)
        model = b.end_table()

        return b.finish(model, "TFL3")


# ------------------------------------------------------------------ #
# Graph emission: a port Net -> TFLiteModel
# ------------------------------------------------------------------ #


def _host(net, params, state):
    """The port's params and state as numpy arrays in the JAX package's
    layouts (conv weights HWIO)."""
    return bridge.params_to_numpy(net, params), bridge.params_to_numpy(
        net, state)


def _bcnn_pool(prm) -> None:
    """A max-pool both writers export: bcnn's windows, from i*stride."""
    if "darknet_padding" in prm:
        raise ValueError("a Darknet cfg's padded max-pool is not supported "
                         "by tflite export")


def write_tflite(net, params, state, out_path: Optional[str]) -> bytes:
    """Emit the net's PREDICT forward as a .tflite flatbuffer. Same op
    map as the TF-backed path (`build_tf_forward`) and as the reference's
    bcnn2tflite.cc:203-218; YOLOV3 is rejected like the reference."""
    params, state = _host(net, params, state)
    m = TFLiteModel()
    t0 = net.tensors[0]
    x_in = m.add_tensor([1, t0.h, t0.w, t0.c], "input")
    values: Dict[int, int] = {0: x_in}
    shapes: Dict[int, list] = {0: [1, t0.h, t0.w, t0.c]}

    def p(idx):
        return np.asarray(params[net.tensors[idx].key], np.float32)

    def s(idx):
        return np.asarray(state[net.tensors[idx].key], np.float32)

    uid = [0]

    def fresh(shape, tag) -> int:
        uid[0] += 1
        return m.add_tensor(shape, f"{tag}_{uid[0]}")

    def pad_input(tid, shape, pad, value=0.0):
        if pad == 0:
            return tid, shape
        ns = [shape[0], shape[1] + 2 * pad, shape[2] + 2 * pad, shape[3]]
        out = fresh(ns, "pad")
        pads = m.const(
            np.asarray(
                [[0, 0], [pad, pad], [pad, pad], [0, 0]], np.int32
            ),
            f"pads_{uid[0]}",
        )
        if value == 0.0:
            m.add_op(PAD, [tid, pads], [out], OPT_PAD)
        else:
            cv = m.const(
                np.asarray(value, np.float32).reshape(()), f"padv_{uid[0]}"
            )
            m.add_op(PADV2, [tid, pads, cv], [out], OPT_PADV2)
        return out, ns

    def emit_act(tid, shape, act, slopes=None):
        if act in (Activation.NONE,):
            return tid
        out = fresh(shape, "act")
        if act == Activation.RELU:
            m.add_op(RELU, [tid], [out])
        elif act == Activation.LRELU:
            m.add_op(LEAKY_RELU, [tid], [out], OPT_LEAKY_RELU,
                     dict(alpha=0.1))
        elif act == Activation.LOGISTIC:
            m.add_op(LOGISTIC, [tid], [out])
        elif act == Activation.TANH:
            m.add_op(TANH, [tid], [out])
        elif act == Activation.PRELU:
            alpha = m.const(
                np.asarray(slopes, np.float32).reshape(1, 1, -1),
                f"alpha_{uid[0]}",
            )
            m.add_op(PRELU, [tid, alpha], [out])
        else:
            raise ValueError(f"activation {act} unsupported in tflite")
        return out

    for node in net.nodes:
        t = node.type
        if t == LayerType.COST:
            continue
        prm = node.param
        src = values[node.src[0]] if node.src else None
        in_shape = shapes[node.src[0]] if node.src else None
        d = net.tensors[node.dst[0]]
        out_shape = [1, d.h, d.w, d.c]

        if t == LayerType.CONV2D:
            if prm["num_groups"] != 1:
                raise ValueError("grouped conv unsupported in tflite")
            w = p(node.src[1])  # HWIO
            bias = p(node.src[2])
            if prm.get("batch_norm"):
                scales = p(node.src[5])
                if not net.bn_folded:
                    mean, var = s(node.src[3]), s(node.src[4])
                    denom = np.sqrt(var + EPS)
                    bias = bias - scales * mean / denom
                    scales = scales / denom
                w = w * scales  # fold into output channels (last axis)
            else:
                scales = None
            wt = m.const(
                np.transpose(w, (3, 0, 1, 2)), f"w_{uid[0]}"
            )  # OHWI
            bt = m.const(bias.reshape(-1), f"b_{uid[0]}")
            src, in_shape = pad_input(src, in_shape, prm["pad"])
            act = prm["activation"]
            fused = ACT_RELU if act == Activation.RELU else ACT_NONE
            out = fresh(out_shape, "conv")
            m.add_op(
                CONV_2D, [src, wt, bt], [out], OPT_CONV2D,
                dict(padding=PADDING_VALID, stride=prm["stride"],
                     act=fused),
            )
            if act != Activation.RELU:
                slopes = (
                    p(node.src[6 if prm.get("batch_norm") else 3])
                    if act == Activation.PRELU else None
                )
                out = emit_act(out, out_shape, act, slopes)
        elif t == LayerType.DEPTHWISE_CONV2D:
            w = p(node.src[1])  # (k,k,1,C) -> (1,k,k,C)
            wt = m.const(
                np.transpose(w, (2, 0, 1, 3)), f"w_{uid[0]}"
            )
            bt = m.const(p(node.src[2]).reshape(-1), f"b_{uid[0]}")
            src, in_shape = pad_input(src, in_shape, prm["pad"])
            act = prm["activation"]
            fused = ACT_RELU if act == Activation.RELU else ACT_NONE
            out = fresh(out_shape, "dwconv")
            m.add_op(
                DEPTHWISE_CONV_2D, [src, wt, bt], [out], OPT_DEPTHWISE,
                dict(padding=PADDING_VALID, stride=prm["stride"],
                     act=fused),
            )
            if act != Activation.RELU:
                out = emit_act(out, out_shape, act)
        elif t == LayerType.TRANSPOSE_CONV2D:
            w = p(node.src[1])  # (k,k,O_deconv,I) -> OHWI
            wt = m.const(np.transpose(w, (2, 0, 1, 3)), f"w_{uid[0]}")
            oshape = m.const(
                np.asarray(out_shape, np.int32), f"oshape_{uid[0]}"
            )
            out = fresh(out_shape, "deconv")
            m.add_op(
                TRANSPOSE_CONV, [oshape, wt, src], [out],
                OPT_TRANSPOSE_CONV,
                dict(
                    padding=(
                        PADDING_VALID if prm["pad"] == 0 else PADDING_SAME
                    ),
                    stride=prm["stride"],
                ),
            )
            bias = m.const(
                p(node.src[2]).reshape(1, 1, 1, -1), f"b_{uid[0]}"
            )
            out2 = fresh(out_shape, "deconv_b")
            m.add_op(ADD, [out, bias], [out2], OPT_ADD)
            out = emit_act(out2, out_shape, prm["activation"])
        elif t == LayerType.FULL_CONNECTED:
            if in_shape[1] != 1 or in_shape[2] != 1:
                # NCHW flatten order: TRANSPOSE to NCHW then RESHAPE
                perm = m.const(
                    np.asarray([0, 3, 1, 2], np.int32), f"perm_{uid[0]}"
                )
                tshape = [in_shape[0], in_shape[3], in_shape[1],
                          in_shape[2]]
                tr = fresh(tshape, "nchw")
                m.add_op(TRANSPOSE, [src, perm], [tr], OPT_TRANSPOSE)
                src = tr
            flat = int(np.prod(in_shape[1:]))
            rshape = m.const(
                np.asarray([1, flat], np.int32), f"rshape_{uid[0]}"
            )
            fl = fresh([1, flat], "flat")
            m.add_op(RESHAPE, [src, rshape], [fl], OPT_RESHAPE,
                     dict(new_shape=[1, flat]))
            w = p(node.src[1])  # (in, out) -> (out, in)
            wt = m.const(np.transpose(w, (1, 0)), f"w_{uid[0]}")
            bt = m.const(p(node.src[2]).reshape(-1), f"b_{uid[0]}")
            act = prm["activation"]
            fused = ACT_RELU if act == Activation.RELU else ACT_NONE
            fc = fresh([1, d.c], "fc")
            m.add_op(FULLY_CONNECTED, [fl, wt, bt], [fc],
                     OPT_FULLY_CONNECTED, dict(act=fused))
            if act != Activation.RELU:
                fc = emit_act(fc, [1, d.c], act)
            # back to the framework's (1,1,1,C) NHWC bookkeeping — the
            # reference injects the same fake reshape (bcnn2tflite.cc:52)
            rshape2 = m.const(
                np.asarray(out_shape, np.int32), f"rshape_{uid[0]}"
            )
            out = fresh(out_shape, "fc4d")
            m.add_op(RESHAPE, [fc, rshape2], [out], OPT_RESHAPE,
                     dict(new_shape=out_shape))
        elif t == LayerType.MAXPOOL:
            _bcnn_pool(prm)
            k_, st = prm["size"], prm["stride"]
            ph = max(0, (d.h - 1) * st + k_ - in_shape[1])
            pw = max(0, (d.w - 1) * st + k_ - in_shape[2])
            if ph or pw:
                ns = [1, in_shape[1] + ph, in_shape[2] + pw, in_shape[3]]
                padded = fresh(ns, "mp_pad")
                pads = m.const(
                    np.asarray(
                        [[0, 0], [0, ph], [0, pw], [0, 0]], np.int32
                    ),
                    f"pads_{uid[0]}",
                )
                cv = m.const(
                    np.asarray(-3.4e38, np.float32).reshape(()),
                    f"padv_{uid[0]}",
                )
                m.add_op(PADV2, [src, pads, cv], [padded], OPT_PADV2)
                src = padded
            out = fresh(out_shape, "maxpool")
            m.add_op(
                MAX_POOL_2D, [src], [out], OPT_POOL2D,
                dict(padding=PADDING_VALID, stride=st, size=k_),
            )
        elif t == LayerType.AVGPOOL:
            axes = m.const(
                np.asarray([1, 2], np.int32), f"axes_{uid[0]}"
            )
            out = fresh(out_shape, "gap")
            m.add_op(MEAN, [src, axes], [out], OPT_REDUCER,
                     dict(keep_dims=True))
        elif t == LayerType.SOFTMAX:
            out = fresh(out_shape, "softmax")
            m.add_op(SOFTMAX, [src], [out], OPT_SOFTMAX)
        elif t == LayerType.DROPOUT:
            out = src
            out_shape = in_shape
        elif t == LayerType.ACTIVATION:
            slopes = (
                p(node.src[1])
                if prm["activation"] == Activation.PRELU else None
            )
            out = emit_act(src, in_shape, prm["activation"], slopes)
            out_shape = in_shape
        elif t == LayerType.BATCHNORM:
            scales, bias = p(node.src[3]), p(node.src[4])
            if not net.bn_folded:
                mean, var = s(node.src[1]), s(node.src[2])
                denom = np.sqrt(var + EPS)
                bias = bias - scales * mean / denom
                scales = scales / denom
            sc = m.const(
                scales.reshape(1, 1, 1, -1), f"scale_{uid[0]}"
            )
            bi = m.const(bias.reshape(1, 1, 1, -1), f"bias_{uid[0]}")
            mul = fresh(out_shape, "bn_mul")
            m.add_op(MUL, [src, sc], [mul], OPT_MUL)
            out = fresh(out_shape, "bn_add")
            m.add_op(ADD, [mul, bi], [out], OPT_ADD)
        elif t == LayerType.CONCAT:
            out = fresh(out_shape, "concat")
            m.add_op(
                CONCATENATION, [values[i] for i in node.src], [out],
                OPT_CONCATENATION, dict(axis=3),
            )
        elif t == LayerType.ELTWISE:
            if shapes[node.src[0]] != shapes[node.src[1]]:
                raise ValueError(
                    "strided eltwise unsupported in tflite export"
                )
            out = fresh(out_shape, "add")
            m.add_op(
                ADD, [values[node.src[0]], values[node.src[1]]], [out],
                OPT_ADD,
            )
            out = emit_act(out, out_shape, prm["activation"])
        elif t == LayerType.UPSAMPLE:
            size = m.const(
                np.asarray([d.h, d.w], np.int32), f"size_{uid[0]}"
            )
            out = fresh(out_shape, "upsample")
            m.add_op(
                RESIZE_NEAREST_NEIGHBOR, [src, size], [out],
                OPT_RESIZE_NN,
            )
        else:
            raise ValueError(
                f"layer {t} not supported by the direct tflite writer "
                "(same coverage as the reference's converter)"
            )
        values[node.dst[0]] = out
        shapes[node.dst[0]] = out_shape

    out_tensor = None
    for node in reversed(net.nodes):
        if node.type != LayerType.COST:
            out_tensor = values[node.dst[0]]
            break

    blob = m.serialize([x_in], [out_tensor])
    if out_path:
        with open(out_path, "wb") as f:
            f.write(blob)
    return blob


# ------------------------------------------------------------------ #
# TensorFlow backend and the converter's entry point
# ------------------------------------------------------------------ #


def build_tf_forward(net, params, state):
    """Returns a tf.function(x_nhwc) reproducing the net's PREDICT forward
    (params and state the port's, as `write_tflite` takes them)."""
    import tensorflow as tf

    params, state = _host(net, params, state)

    def act_fn(a, slopes=None):
        def apply(y):
            if a == Activation.NONE:
                return y
            if a == Activation.RELU:
                return tf.nn.relu(y)
            if a == Activation.LRELU:
                return tf.nn.leaky_relu(y, alpha=0.1)
            if a == Activation.LOGISTIC:
                return tf.sigmoid(y)
            if a == Activation.TANH:
                return tf.tanh(y)
            if a == Activation.PRELU:
                s = tf.constant(np.asarray(slopes, np.float32))
                return tf.where(y > 0, y, s * y)
            if a == Activation.CLAMP:
                return tf.clip_by_value(y, 0.0, 1.0)
            raise ValueError(f"activation {a} not supported by tflite export")

        return apply

    def p(idx):
        return np.asarray(params[net.tensors[idx].key], np.float32)

    def s(idx):
        return np.asarray(state[net.tensors[idx].key], np.float32)

    def forward(x):
        values = {0: x}
        for node in net.nodes:
            t = node.type
            if t == LayerType.CONV2D:
                prm = node.param
                xin = values[node.src[0]]
                w = tf.constant(p(node.src[1]))
                pad = prm["pad"]
                if pad:
                    xin = tf.pad(
                        xin, [[0, 0], [pad, pad], [pad, pad], [0, 0]]
                    )
                y = tf.nn.conv2d(
                    xin, w, strides=prm["stride"], padding="VALID"
                )
                if prm.get("batch_norm"):
                    scales = p(node.src[5])
                    bias = p(node.src[2])
                    if not net.bn_folded:
                        mean, var = s(node.src[3]), s(node.src[4])
                        denom = np.sqrt(var + EPS)
                        bias = bias - scales * mean / denom
                        scales = scales / denom
                    y = y * scales + bias
                else:
                    y = y + p(node.src[2])
                slopes = (
                    p(node.src[6 if prm.get("batch_norm") else 3])
                    if prm["activation"] == Activation.PRELU
                    else None
                )
                y = act_fn(prm["activation"], slopes)(y)
            elif t == LayerType.DEPTHWISE_CONV2D:
                prm = node.param
                xin = values[node.src[0]]
                w = p(node.src[1])  # (k,k,1,C) -> tf wants (k,k,C,1)
                w = tf.constant(np.transpose(w, (0, 1, 3, 2)))
                pad = prm["pad"]
                if pad:
                    xin = tf.pad(
                        xin, [[0, 0], [pad, pad], [pad, pad], [0, 0]]
                    )
                y = tf.nn.depthwise_conv2d(
                    xin, w,
                    strides=[1, prm["stride"], prm["stride"], 1],
                    padding="VALID",
                )
                y = y + p(node.src[2])
                y = act_fn(prm["activation"])(y)
            elif t == LayerType.TRANSPOSE_CONV2D:
                prm = node.param
                xin = values[node.src[0]]
                d = net.tensors[node.dst[0]]
                # mem (k,k,I=out,O=in); tf.conv2d_transpose wants
                # (k,k,out,in)
                w = tf.constant(p(node.src[1]))
                y = tf.nn.conv2d_transpose(
                    xin, w,
                    output_shape=[tf.shape(xin)[0], d.h, d.w, d.c],
                    strides=prm["stride"],
                    padding="VALID" if prm["pad"] == 0 else "SAME",
                )
                y = y + p(node.src[2])
                y = act_fn(prm["activation"])(y)
            elif t == LayerType.FULL_CONNECTED:
                prm = node.param
                xin = values[node.src[0]]
                if len(xin.shape) == 4:
                    # NCHW flatten order (the injected reshape,
                    # bcnn2tflite.cc:52-80)
                    xin = tf.transpose(xin, (0, 3, 1, 2))
                xin = tf.reshape(xin, (tf.shape(xin)[0], -1))
                y = tf.matmul(xin, tf.constant(p(node.src[1]))) + p(
                    node.src[2]
                )
                y = act_fn(prm["activation"])(y)
                y = tf.reshape(y, (-1, 1, 1, y.shape[-1]))
            elif t == LayerType.MAXPOOL:
                prm = node.param
                _bcnn_pool(prm)
                d = net.tensors[node.dst[0]]
                xin = values[node.src[0]]
                sh = xin.shape
                k_, st = prm["size"], prm["stride"]
                ph = max(0, (d.h - 1) * st + k_ - int(sh[1]))
                pw = max(0, (d.w - 1) * st + k_ - int(sh[2]))
                if ph or pw:
                    xin = tf.pad(
                        xin, [[0, 0], [0, ph], [0, pw], [0, 0]],
                        constant_values=-3.4e38,
                    )
                y = tf.nn.max_pool2d(xin, k_, st, padding="VALID")
            elif t == LayerType.AVGPOOL:
                y = tf.reduce_mean(
                    values[node.src[0]], axis=[1, 2], keepdims=True
                )
            elif t == LayerType.SOFTMAX:
                y = tf.nn.softmax(values[node.src[0]], axis=-1)
            elif t == LayerType.DROPOUT:
                y = values[node.src[0]]
            elif t == LayerType.ACTIVATION:
                prm = node.param
                slopes = (
                    p(node.src[1])
                    if prm["activation"] == Activation.PRELU
                    else None
                )
                y = act_fn(prm["activation"], slopes)(values[node.src[0]])
            elif t == LayerType.BATCHNORM:
                xin = values[node.src[0]]
                scales, bias = p(node.src[3]), p(node.src[4])
                if not net.bn_folded:
                    mean, var = s(node.src[1]), s(node.src[2])
                    denom = np.sqrt(var + EPS)
                    bias = bias - scales * mean / denom
                    scales = scales / denom
                y = xin * scales + bias
            elif t == LayerType.CONCAT:
                y = tf.concat([values[i] for i in node.src], axis=-1)
            elif t == LayerType.ELTWISE:
                prm = node.param
                y = values[node.src[0]] + values[node.src[1]]
                y = act_fn(prm["activation"])(y)
            elif t == LayerType.UPSAMPLE:
                xin = values[node.src[0]]
                sz = node.param["size"]
                y = tf.image.resize(
                    xin,
                    [int(xin.shape[1]) * sz, int(xin.shape[2]) * sz],
                    method="nearest",
                )
            elif t == LayerType.COST:
                continue
            elif t == LayerType.YOLOV3:
                # activated head (logistic slices)
                prm = node.param
                xin = values[node.src[0]]
                num, classes = prm["num"], prm["classes"]
                e = 5 + classes
                shp = xin.shape
                xr = tf.reshape(
                    xin, (-1, int(shp[1]), int(shp[2]), num, e)
                )
                y = tf.concat(
                    [
                        tf.sigmoid(xr[..., 0:2]),
                        xr[..., 2:4],
                        tf.sigmoid(xr[..., 4:]),
                    ],
                    axis=-1,
                )
                y = tf.reshape(y, (-1, int(shp[1]), int(shp[2]), num * e))
            else:
                raise ValueError(f"layer {t} not supported by tflite export")
            values[node.dst[0]] = y
        # output: last non-cost node's tensor
        for node in reversed(net.nodes):
            if node.type != LayerType.COST:
                return values[node.dst[0]]

    return forward


def convert_net(net, params, state, out_path: Optional[str],
                backend: str = "auto") -> bytes:
    """backend: 'auto' (TF when importable, else direct), 'tf', 'direct'.
    Returns the flatbuffer, also written to `out_path` unless it is
    None."""
    if backend == "auto":
        try:
            import tensorflow  # noqa: F401

            backend = "tf"
        except ImportError:
            backend = "direct"
    if backend == "direct":
        return write_tflite(net, params, state, out_path)

    import tensorflow as tf

    t0 = net.tensors[0]
    forward = build_tf_forward(net, params, state)
    fn = tf.function(
        forward,
        input_signature=[
            tf.TensorSpec([1, t0.h, t0.w, t0.c], tf.float32)
        ],
    )
    conc = fn.get_concrete_function()
    converter = tf.lite.TFLiteConverter.from_concrete_functions([conc])
    tflite_model = converter.convert()
    if out_path:
        with open(out_path, "wb") as f:
            f.write(tflite_model)
    return tflite_model
