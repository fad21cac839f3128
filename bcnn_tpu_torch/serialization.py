"""Weight files: `.bcnnmodel` (bit-compatible with the reference and with
`bcnn_tpu.serialization`) and Darknet `.weights`, ported from
`bcnn_tpu.serialization`.

Formats (src/bcnn_net.c):
  - save (bcnn_save_weights :595-681): magic "BCNN" + 3 x u32 version,
    then per node in graph order: the conv family and FC write biases
    then weights; a CONV2D with BN appends running mean, variance,
    scales, and a CONV2D with PReLU then its slopes (the reference's
    save omits them though its loader reads them, :1310-1332;
    `bcnn_tpu` writes them, and so does the port); a standalone PReLU
    activation writes its slopes; a standalone BATCHNORM writes mean,
    variance, scales, biases.
  - load (bcnn_load_weights :1485-1558): the format from the extension
    (.weights: Darknet). Darknet puts BN scales before mean / variance
    and a conv's weights last, a conv's PReLU slopes after them, and it
    holds no standalone PReLU slopes (:1543); its header is 3 x i32 and a `seen`
    counter, u64 from version 0.2 on, else u32; transposed-era files
    (major or minor > 1000) hold FC weights (in, out) (:1427-1459).
  - BN fold at load in PREDICT (:1281-1292): b <- b - s*m / sqrt(v +
    1e-6), s <- s / sqrt(v + 1e-6), and `net.bn_folded` is set; the
    executor then computes y*s + b.

Blobs are the reference's flat orders. The port's conv, depthwise and
deconv weights lie in memory in those orders already (OIHW, (c, 1, k,
k), (c_src, n, k, k)); FC weights are (in, out) in memory and (out, in)
in a blob. params / state are dicts key -> tensor; a load writes float32 tensors on
`device` into them.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict

import numpy as np
import torch

from .graph import Net, Node
from .types import Activation, LayerType, Mode

BCNN_MAGIC = b"BCNN"
VERSION = (0, 2, 0)
BN_FOLD_EPS = 1e-6

_CONV_FAMILY = (
    LayerType.CONV2D,
    LayerType.TRANSPOSE_CONV2D,
    LayerType.DEPTHWISE_CONV2D,
)


def _is_prelu(node: Node, layer: LayerType) -> bool:
    return (node.type == layer
            and node.param.get("activation") == Activation.PRELU)


def _conv_prelu_src_index(node: Node) -> int:
    """A conv's PReLU slopes: src[3] without BN, src[6] with
    (bcnn_net.c:1311-1313)."""
    return 3 + 3 * int(bool(node.param.get("batch_norm")))


def _w_mem_to_blob(node: Node, w: np.ndarray) -> np.ndarray:
    if node.type == LayerType.FULL_CONNECTED:
        return np.ascontiguousarray(w.T).ravel()  # (in,out) -> (out,in)
    return np.ascontiguousarray(w).ravel()


def _w_blob_to_mem(net: Net, node: Node, blob: np.ndarray) -> np.ndarray:
    mem_shape = net.tensors[node.src[1]].mem_shape
    if node.type == LayerType.FULL_CONNECTED:
        in_sz, out_sz = mem_shape
        return np.ascontiguousarray(blob.reshape(out_sz, in_sz).T)
    return blob.reshape(mem_shape)


def _getter(net: Net, params: Dict, state: Dict):
    def get(idx):
        t = net.tensors[idx]
        src = params if t.key in params else state
        return src[t.key].detach().to("cpu", torch.float32).numpy()

    return get


# --------------------------------------------------------------------- #
# save
# --------------------------------------------------------------------- #

def save_weights(net: Net, params: Dict, state: Dict, filename: str):
    """bcnn_save_weights: the `.bcnnmodel` byte stream."""
    get = _getter(net, params, state)
    with open(filename, "wb") as fp:
        fp.write(BCNN_MAGIC)
        fp.write(struct.pack("<3I", *VERSION))
        for node in net.nodes:
            if node.type in _CONV_FAMILY or (
                node.type == LayerType.FULL_CONNECTED
            ):
                get(node.src[2]).ravel().tofile(fp)
                _w_mem_to_blob(node, get(node.src[1])).tofile(fp)
                if node.type == LayerType.CONV2D and node.param.get(
                    "batch_norm"
                ):
                    get(node.src[3]).ravel().tofile(fp)  # run mean
                    get(node.src[4]).ravel().tofile(fp)  # run var
                    get(node.src[5]).ravel().tofile(fp)  # scales
                if _is_prelu(node, LayerType.CONV2D):
                    get(node.src[_conv_prelu_src_index(node)]).ravel(
                    ).tofile(fp)
            elif _is_prelu(node, LayerType.ACTIVATION):
                get(node.src[1]).ravel().tofile(fp)
            elif node.type == LayerType.BATCHNORM:
                get(node.src[1]).ravel().tofile(fp)  # mean
                get(node.src[2]).ravel().tofile(fp)  # var
                get(node.src[3]).ravel().tofile(fp)  # scales
                get(node.src[4]).ravel().tofile(fp)  # biases


def save_weights_darknet(
    net: Net, params: Dict, state: Dict, filename: str, seen: int = 0
):
    """Darknet `.weights`, the byte stream the reference's format-1
    loader reads (bcnn_net.c:1506-1552), as `bcnn_tpu` writes it: the
    conv family biases, [BN scales, means, variances], weights; a
    standalone BN scales, means, variances (no biases); FC biases,
    weights (out, in); a conv's PReLU slopes after its weights.
    Header 3 x i32 version (0, 2, 0) + u64 `seen`."""
    get = _getter(net, params, state)
    with open(filename, "wb") as fp:
        fp.write(struct.pack("<3i", *VERSION))
        fp.write(struct.pack("<Q", seen))
        for node in net.nodes:
            if node.type in _CONV_FAMILY:
                get(node.src[2]).ravel().tofile(fp)  # biases
                if node.type == LayerType.CONV2D and node.param.get(
                    "batch_norm"
                ):
                    get(node.src[5]).ravel().tofile(fp)  # scales
                    get(node.src[3]).ravel().tofile(fp)  # run mean
                    get(node.src[4]).ravel().tofile(fp)  # run var
                _w_mem_to_blob(node, get(node.src[1])).tofile(fp)
                if _is_prelu(node, LayerType.CONV2D):
                    get(node.src[_conv_prelu_src_index(node)]).ravel(
                    ).tofile(fp)
            elif node.type == LayerType.BATCHNORM:
                get(node.src[3]).ravel().tofile(fp)  # scales
                get(node.src[1]).ravel().tofile(fp)  # means
                get(node.src[2]).ravel().tofile(fp)  # variances
            elif node.type == LayerType.FULL_CONNECTED:
                get(node.src[2]).ravel().tofile(fp)
                _w_mem_to_blob(node, get(node.src[1])).tofile(fp)


# --------------------------------------------------------------------- #
# load
# --------------------------------------------------------------------- #

def model_find_format(filename: str) -> int:
    """0 = bcnn, 1 = darknet, 2 = onnx (bcnn_net.c:1461-1480)."""
    ext = filename.rsplit(".", 1)[-1]
    if ext == "weights":
        return 1
    if ext == "onnx":
        return 2
    return 0


def _read(fp: BinaryIO, n: int, what: str) -> np.ndarray:
    a = np.fromfile(fp, np.float32, n)
    if a.size != n:
        raise ValueError(
            f"Inconsistent {what} size: expected {n} but found {a.size}"
        )
    return a


def load_weights(net: Net, params: Dict, state: Dict, filename: str,
                 device=None):
    """Read `filename` into params / state (in place, float32 tensors on
    `device`); returns (params, state). Folds BN when net.mode is
    PREDICT and sets net.bn_folded. Without `device` the tensors land
    where the tensors of `params` (or `state`) lie, a Session's device,
    and on "cuda" where there are none: a CPU caller passes
    device="cpu"."""
    fmt = model_find_format(filename)
    if fmt == 2:
        raise NotImplementedError("onnx weights not supported (as reference)")
    need_transpose = False
    out_p: Dict[str, np.ndarray] = {}
    out_s: Dict[str, np.ndarray] = {}
    fold = net.mode == Mode.PREDICT
    with open(filename, "rb") as fp:
        if fmt == 0:
            if fp.read(4) != BCNN_MAGIC:
                raise ValueError(f"Invalid format for model file {filename}")
            struct.unpack("<3I", fp.read(12))
        else:
            major, minor, _ = struct.unpack("<3i", fp.read(12))
            if (major * 10 + minor) >= 2 and major < 1000 and minor < 1000:
                struct.unpack("<Q", fp.read(8))
            else:
                struct.unpack("<i", fp.read(4))
            need_transpose = (major > 1000) or (minor > 1000)
        for node in net.nodes:
            if node.type in _CONV_FAMILY:
                _load_conv(net, node, fp, fmt, out_p, out_s, fold)
            elif _is_prelu(node, LayerType.ACTIVATION) and fmt == 0:
                t = net.tensors[node.src[1]]
                out_p[t.key] = _read(
                    fp, int(np.prod(t.mem_shape)), "prelu slopes"
                ).reshape(t.mem_shape)
            elif node.type == LayerType.BATCHNORM:
                tb = net.tensors[node.src[4]]
                old_b = params[tb.key].detach().to(
                    "cpu", torch.float32).numpy()
                _load_batchnorm(net, node, fp, fmt, out_p, out_s, fold, old_b)
            elif node.type == LayerType.FULL_CONNECTED:
                _load_fullc(net, node, fp, out_p, need_transpose)
    device = _device_of(params, state, device)
    for src, dst in ((out_p, params), (out_s, state)):
        for k, v in src.items():
            dst[k] = torch.from_numpy(np.array(v, np.float32)).to(device)
    if fold:
        net.bn_folded = True
    return params, state


def _device_of(params: Dict, state: Dict, device) -> torch.device:
    """`device`, else that of the first tensor of params or state, else
    "cuda", which must then be there."""
    if device is None:
        have = [*params.values(), *state.values()]
        device = have[0].device if have else torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "load_weights: the weights go to the card (no device given and "
            "no params to follow), but CUDA is not available; pass "
            'device="cpu" to load them on the CPU')
    return device


def _fold_bn(b: np.ndarray, s: np.ndarray, m: np.ndarray, v: np.ndarray):
    """bcnn_net.c:1281-1292, in float32 as `bcnn_tpu` computes it."""
    denom = np.sqrt(v + BN_FOLD_EPS)
    return b - (s * m) / denom, s / denom


def _load_conv(net, node, fp, fmt, params, state, fold):
    tw = net.tensors[node.src[1]]
    tb = net.tensors[node.src[2]]
    w_sz = int(np.prod(tw.mem_shape))
    b = _read(fp, int(np.prod(tb.mem_shape)), f"biases {tb.name}")
    if fmt == 0:
        w_blob = _read(fp, w_sz, f"weights {tw.name}")
    if node.type == LayerType.CONV2D and node.param.get("batch_norm"):
        tm = net.tensors[node.src[3]]
        tv = net.tensors[node.src[4]]
        ts = net.tensors[node.src[5]]
        c = int(np.prod(ts.mem_shape))
        if fmt == 1:
            s = _read(fp, c, "batchnorm scales")
        m = _read(fp, c, "batchnorm means")
        v = _read(fp, c, "batchnorm variances")
        if fmt == 0:
            s = _read(fp, c, "batchnorm scales")
        if fold:
            b, s = _fold_bn(b, s, m, v)
        state[tm.key] = m
        state[tv.key] = v
        params[ts.key] = s
    if fmt == 1:
        w_blob = _read(fp, w_sz, f"weights {tw.name}")
    params[tb.key] = b
    params[tw.key] = _w_blob_to_mem(net, node, w_blob)
    if _is_prelu(node, LayerType.CONV2D):
        tsl = net.tensors[node.src[_conv_prelu_src_index(node)]]
        params[tsl.key] = _read(
            fp, int(np.prod(tsl.mem_shape)), "prelu slopes"
        )


def _load_batchnorm(net, node, fp, fmt, params, state, fold, old_b):
    tm = net.tensors[node.src[1]]
    tv = net.tensors[node.src[2]]
    ts = net.tensors[node.src[3]]
    tb = net.tensors[node.src[4]]
    c = net.tensors[node.dst[0]].c
    if fmt == 1:
        s = _read(fp, c, "scales")
    m = _read(fp, c, "means")
    v = _read(fp, c, "variances")
    if fmt == 0:
        s = _read(fp, c, "scales")
        b = _read(fp, c, "biases")
    else:  # Darknet keeps no biases here: the ones in memory stand
        b = old_b.copy()
    if fold:
        b, s = _fold_bn(b, s, m, v)
    state[tm.key] = m
    state[tv.key] = v
    params[ts.key] = s
    params[tb.key] = b


def _load_fullc(net, node, fp, params, need_transpose):
    tw = net.tensors[node.src[1]]
    tb = net.tensors[node.src[2]]
    in_sz, out_sz = tw.mem_shape
    params[tb.key] = _read(fp, out_sz, f"biases {tb.name}")
    w_blob = _read(fp, in_sz * out_sz, f"weights {tw.name}")
    if need_transpose:
        # old darknet stores (in, out); bcnn_transpose makes it (out, in)
        # before the standard blob -> mem step (bcnn_net.c:1448-1451)
        w_blob = np.ascontiguousarray(
            w_blob.reshape(in_sz, out_sz).T
        ).ravel()
    params[tw.key] = _w_blob_to_mem(net, node, w_blob)
