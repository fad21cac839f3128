"""The port's config parser (`bcnn_tpu_torch.config`) held to
`bcnn_tpu.config`: the sections, the layer parameters of both dialects,
the [net] parameters, and the graphs that `parse_ini` + `add_layer` build
from the repo's cfgs (names, shapes, src wiring, params and state keys,
learner and augmentation config); `load_net` with a Darknet `.weights`
file that `bcnn_tpu` wrote stages equal tensors, and the session serves
them as `bcnn_tpu` does. Layers the executor does not run still raise."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import bcnn_tpu as bt
from bcnn_tpu import config as jconfig
from bcnn_tpu.serialization import save_weights_darknet as jax_save_darknet

from bcnn_tpu_torch import Net, Session, bridge
from bcnn_tpu_torch import config as tconfig
from bcnn_tpu_torch.types import LayerType, Mode
from tests.test_torch_int8_layout import darknet_parse

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YOLOV3_CFG = os.path.join(ROOT, "examples", "yolo", "yolov3.cfg")
TINY_CFG = os.path.join(ROOT, "examples", "yolo", "yolov3-tiny.cfg")
MNIST_CONF = os.path.join(ROOT, "examples", "mnist_cl", "mnist.conf")
LIFTED_CONF = os.path.join(ROOT, "examples", "lifted_structure_loss",
                           "lifted_structure.conf")
CFGS = {"yolov3": YOLOV3_CFG, "yolov3-tiny": TINY_CFG, "mnist": MNIST_CONF,
        "lifted_structure": LIFTED_CONF}
DARKNET = ("yolov3", "yolov3-tiny")

# weight layouts: (k, k, I, O) HWIO there; OIHW, (c, 1, k, k) and
# (c_src, n, k, k) here
_TO_PORT = {LayerType.CONV2D: (3, 2, 0, 1),
            LayerType.DEPTHWISE_CONV2D: (3, 2, 0, 1),
            LayerType.TRANSPOSE_CONV2D: (3, 2, 0, 1)}


def weight_perm(net):
    return {net.tensors[n.src[1]].key: _TO_PORT[n.type]
            for n in net.nodes if n.type in _TO_PORT}


def build(name, mode):
    """(bcnn_tpu's net, the port's) from cfg `name` in `mode`."""
    ref, port = bt.Net(bt.Mode(int(mode))), Net(mode)
    if name in DARKNET:
        return (darknet_parse(jconfig, ref, CFGS[name]),
                darknet_parse(tconfig, port, CFGS[name]))
    return (jconfig.load_net(ref, CFGS[name]),
            tconfig.load_net(port, CFGS[name]))


def assert_same_graph(ref, port):
    perm = weight_perm(port)
    assert port.batch_size == ref.batch_size
    assert len(port.tensors) == len(ref.tensors)
    for r, p in zip(ref.tensors, port.tensors):
        assert (p.name, p.key, int(p.kind), p.shape) == (
            r.name, r.key, int(r.kind), r.shape)
        if p.key in perm:
            assert p.mem_shape == tuple(r.mem_shape[i] for i in perm[p.key])
        else:
            assert p.mem_shape == (
                None if r.mem_shape is None else tuple(r.mem_shape))
        for f in ("trainable", "weight_decay", "adam_capable",
                  "batch_div_one", "grad_div_batch"):
            assert getattr(p, f) == getattr(r, f), (p.name, f)
        if r.filler is None:
            assert p.filler is None
        else:
            assert (int(p.filler.type), p.filler.range, p.filler.value) == (
                int(r.filler.type), r.filler.range, r.filler.value)
    assert len(port.nodes) == len(ref.nodes)
    for r, p in zip(ref.nodes, port.nodes):
        assert (int(p.type), p.src, p.dst) == (int(r.type), r.src, r.dst)
        assert p.param == r.param
    assert port.data_aug == ref.data_aug
    if ref.learner is None:
        assert port.learner is None
    else:
        assert {k: (int(v) if hasattr(v, "value") else v) for k, v in
                dataclasses.asdict(port.learner).items()} == {
            k: (int(v) if hasattr(v, "value") else v) for k, v in
            dataclasses.asdict(ref.learner).items()}


@pytest.mark.parametrize("name", list(CFGS))
def test_parse_ini_equal(name):
    ref, port = jconfig.parse_ini(CFGS[name]), tconfig.parse_ini(CFGS[name])
    assert [(s.name, s.keys) for s in port] == [(s.name, s.keys) for s in ref]


@pytest.mark.parametrize("mode", [Mode.PREDICT, Mode.TRAIN],
                         ids=["predict", "train"])
@pytest.mark.parametrize("name", list(CFGS))
def test_cfg_graph_equal(name, mode):
    ref, port = build(name, mode)
    assert_same_graph(ref, port)


def test_yolov3_cfg_counts():
    _, net = build("yolov3", Mode.PREDICT)
    types = [n.type for n in net.nodes]
    assert (types.count(LayerType.CONV2D), types.count(LayerType.ELTWISE),
            types.count(LayerType.CONCAT), types.count(LayerType.UPSAMPLE),
            types.count(LayerType.YOLOV3)) == (75, 23, 4, 2, 3)
    heads = [net.tensors[n.dst[0]].h for n in net.nodes
             if n.type == LayerType.YOLOV3]
    assert heads == [19, 38, 76]  # the cfg's 608 px
    for n in net.nodes:
        if n.type == LayerType.ELTWISE:
            assert n.param["stride"] == (1, 1)


LAYER_KEYS = [
    ("filters", "12"), ("size", "5"), ("stride", "2"), ("pad", "1"),
    ("padding", "0"), ("padding", "3"), ("groups", "2"), ("num", "9"),
    ("classes", "20"), ("num_coords", "4"), ("boxes_per_cell", "2"),
    ("anchors", "10,14,  23,27"), ("mask", "0,1,2"), ("alpha", "0.0001"),
    ("beta", "0.75"), ("k", "2"), ("w", "8"), ("h", "9"), ("c", "3"),
    ("batch_normalize", "1"), ("src", "a,b"), ("dst", "d"),
    ("output", "10"), ("padding_type", "valid"), ("padding_type", "caffe"),
    ("padding_type", "odd"), ("activation", "leaky"),
    ("activation", "logistic"), ("function", "prelu"), ("init", "msra"),
    ("init", "other"), ("metric", "error"), ("metric", "dice"),
    ("loss", "lifted_struct_similarity"), ("layers", "-1,61"),
    ("layers", "-4"), ("from", "-3"), ("rate", "0.5"),
    ("unknown_key", "7"),
]


def _fields(lp):
    return {k: (int(v) if hasattr(v, "value") else v)
            for k, v in dataclasses.asdict(lp).items()}


# the port's own fields (Darknet cfgs beyond bcnn): their values after each
# key of LAYER_KEYS
PORT_FIELDS = {"scale_x_y": lambda fmt, k, v: 1.0,
               "new_coords": lambda fmt, k, v: 0,
               "darknet_padding": lambda fmt, k, v: (
                   int(v) if fmt == 1 and k == "padding" else None)}


@pytest.mark.parametrize("fmt", [0, 1], ids=["bcnn", "darknet"])
def test_layer_param_set_equal_in_both_dialects(fmt):
    for pairs in ([kv] for kv in LAYER_KEYS):
        ref, port = jconfig.LayerParam(), tconfig.LayerParam()
        for k, v in [("size", "3")] + pairs:
            jconfig.layer_param_set(ref, 7, k, v, fmt)
            tconfig.layer_param_set(port, 7, k, v, fmt)
        own = {k: f(fmt, *pairs[0]) for k, f in PORT_FIELDS.items()}
        assert _fields(port) == dict(_fields(ref), **own), pairs


NET_KEYS = [
    ("width", "64"), ("height", "48"), ("channels", "3"), ("batch", "4"),
    ("max_batches", "100"), ("learning_policy", "step"),
    ("optimizer", "adam"), ("step", "10"), ("learning_rate", "0.01"),
    ("beta1", "0.8"), ("beta2", "0.99"), ("decay", "0.0005"),
    ("momentum", "0.7"), ("gamma", "0.1"), ("scale", "0.5"),
    ("power", "2"), ("range_shift_x", "5"), ("range_shift_y", "6"),
    ("min_scale", "0.8"), ("max_scale", "1.2"), ("rotation_range", "30"),
    ("min_contrast", "0.6"), ("max_contrast", "1.4"),
    ("min_brightness", "-40"), ("max_brightness", "40"),
    ("max_distortion", "0.2"), ("max_spots", "3"), ("flip_h", "1"),
    ("mean_r", "120"), ("mean_g", "110"), ("mean_b", "100"),
    ("swap_to_bgr", "1"), ("no_input_norm", "1"), ("angle", "0"),
]


@pytest.mark.parametrize("mode", [Mode.PREDICT, Mode.TRAIN],
                         ids=["predict", "train"])
def test_net_set_param_equal(mode):
    ref, port = bt.Net(bt.Mode(int(mode))), Net(mode)
    for k, v in NET_KEYS:
        jconfig.net_set_param(ref, k, v)
        tconfig.net_set_param(port, k, v)
    assert port.data_aug == ref.data_aug
    assert port.tensors[0].shape == ref.tensors[0].shape
    assert port.batch_size == ref.batch_size
    if mode == Mode.TRAIN:
        assert _fields(port.learner) == _fields(ref.learner)


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


BAD_CFGS = {
    "empty": "# nothing\n",
    "no_net": "[convolutional]\nfilters=4\n",
    "empty_net": "[net]\n[convolutional]\nfilters=4\n",
    "bad_line": "[net]\nwidth=8\nnot a pair\n",
    "unknown_layer": "[net]\nwidth=8\nheight=8\nchannels=1\n[mystery]\n"
                     "src=input\ndst=a\n",
    "no_dst": "[net]\nwidth=8\nheight=8\nchannels=1\n[convolutional]\n"
              "filters=2\nsrc=input\n",
    "no_src": "[net]\nwidth=8\nheight=8\nchannels=1\n[convolutional]\n"
              "filters=2\ndst=a\n",
    "no_input_size": "[net]\nbatch=1\n[convolutional]\nfilters=2\n"
                     "src=input\ndst=a\n",
}


@pytest.mark.parametrize("case", list(BAD_CFGS))
def test_bad_configs_raise_as_bcnn_tpu(tmp_path, case):
    path = _write(tmp_path, "bad.conf", BAD_CFGS[case])
    with pytest.raises(ValueError) as ref:
        jconfig.load_net(bt.Net(bt.Mode.PREDICT), path)
    with pytest.raises(ValueError) as port:
        tconfig.load_net(Net(Mode.PREDICT), path)
    assert str(port.value) == str(ref.value)


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    """yolov3-tiny.cfg at its own 416 px with a Darknet .weights file that
    bcnn_tpu wrote from He-scaled numpy weights (seed 0)."""
    ref = darknet_parse(jconfig, bt.Net(bt.Mode.PREDICT), TINY_CFG)
    p_np, s_np = bridge.he_numpy_weights(
        darknet_parse(tconfig, Net(Mode.PREDICT), TINY_CFG), 0)
    path = str(tmp_path_factory.mktemp("tiny") / "yolov3-tiny.weights")
    jax_save_darknet(ref, p_np, s_np, path, seen=12345)
    return path


def test_load_net_with_weights_stages_equal_tensors(tiny_files):
    ref = jconfig.load_net(bt.Net(bt.Mode.PREDICT), TINY_CFG, tiny_files)
    port = tconfig.load_net(Net(Mode.PREDICT), TINY_CFG, tiny_files)
    assert_same_graph(ref, port)
    assert port.bn_folded and ref.bn_folded
    perm = weight_perm(port)
    for table in ("_loaded_params", "_loaded_state"):
        r, p = getattr(ref, table), getattr(port, table)
        assert set(p) == set(r)
        for k, v in p.items():
            want = np.asarray(r[k], np.float32)
            if k in perm:
                want = want.transpose(perm[k])
            assert v.device.type == "cpu" and v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)


def test_load_net_session_serves_the_loaded_weights(tiny_files):
    """The flagship path, cfg + .weights -> Session: the staged tensors
    win over the session's own initial values, and the heads equal
    bcnn_tpu's to fp32 rounding."""
    ref = jconfig.load_net(bt.Net(bt.Mode.PREDICT), TINY_CFG, tiny_files)
    port = tconfig.load_net(Net(Mode.PREDICT), TINY_CFG, tiny_files)
    js = bt.Session(ref, 0).compile_net()
    ts = Session(port, 5, device="cpu").compile_net()
    key = port.tensors[port.nodes[0].src[1]].key
    assert torch.equal(ts.params[key], port._loaded_params[key])
    x = np.random.RandomState(2).rand(1, 3, 416, 416).astype(np.float32)
    heads = ["lid16", "lid23"]
    want, _ = js.predict_on_batch(x, outputs=heads)
    got, _ = ts.predict_on_batch(x, outputs=heads)
    for name, g, w in zip(heads, got, want):
        w = np.asarray(w)
        assert w.std() > 0.1, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


UNRUN = {
    "activation": "[activation]\nfunction=relu\nsrc=c1\n",
    "dropout": "[dropout]\nrate=0.5\nsrc=c1\n",
    "lrn": "[lrn]\nsize=3\nalpha=0.0001\nbeta=0.75\nsrc=c1\ndst=n1\n",
    "deconv": "[deconvolutional]\nfilters=2\nsize=2\nstride=2\nsrc=c1\n"
              "dst=d1\n",
    "cost": "[cost]\nloss=euclidean\nmetric=sse\nsrc=c1\ndst=out\n",
}


@pytest.mark.parametrize("layer", list(UNRUN))
def test_layers_the_executor_does_not_run_still_raise(tmp_path, layer):
    """Built from a cfg, equal to bcnn_tpu's graph; ported since, each
    layer runs and gives bcnn_tpu's output (PREDICT) and loss (TRAIN,
    where dropout draws its own mask: the net has no cost layer after it,
    so both losses are 0; tests/test_torch_layers_left.py holds each
    layer's values and gradients)."""
    text = ("[net]\nwidth=8\nheight=8\nchannels=1\nbatch=2\n"
            "learning_rate=0.01\n[convolutional]\nfilters=4\nsize=3\n"
            "pad=1\nsrc=input\ndst=c1\n" + UNRUN[layer])
    path = _write(tmp_path, f"{layer}.conf", text)
    for mode in (Mode.PREDICT, Mode.TRAIN):
        port = tconfig.load_net(Net(mode), path)
        ref = jconfig.load_net(bt.Net(bt.Mode(int(mode))), path)
        assert_same_graph(ref, port)
        out = port.tensors[port.nodes[-1].dst[0]].name
        sess = Session(port, 0, device="cpu").compile_net()
        js = bt.Session(ref, 0).compile_net()
        sess.params, sess.state = bridge.params_from_numpy(
            port, {k: np.asarray(v) for k, v in js.params.items()},
            {k: np.asarray(v) for k, v in js.state.items()})
        sess.compile_net()
        x = np.random.RandomState(1).randn(2, 1, 8, 8).astype(np.float32)
        lab = np.random.RandomState(2).rand(
            *((2,) + port.tensors[1].shape[1:])).astype(np.float32)
        if mode == Mode.TRAIN:
            np.testing.assert_allclose(
                float(sess.train_on_batch(x, lab)),
                float(js.train_on_batch(x, lab)), rtol=1e-5)
        else:
            # the cost layer writes no output; LRN's (k = 0: x times a
            # window's sum of squares to the -beta) turns the conv's
            # rounding into a relative error of 2.5e-5: rtol 1e-4 there
            names = ["c1"] + [out] * (layer != "cost")
            got, _ = sess.predict_on_batch(x, outputs=names)
            want, _ = js.predict_on_batch(x, outputs=names)
            for name, g, w in zip(names, got, want):
                np.testing.assert_allclose(
                    g.numpy(), np.asarray(w), atol=1e-6,
                    rtol=1e-4 if name == "n1" else 1e-5)
