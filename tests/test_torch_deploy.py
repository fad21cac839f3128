"""Serving artifacts of the port (`bcnn_tpu_torch.deploy`, on
`torch.export`), the counterparts of the seven tests of
tests/test_deploy.py, on the CPU: each exported program against the
live port Session (bit-equal: the same ops on the same values) and
against `bcnn_tpu.deploy`'s artifact of the same weights, run by
`bcnn_tpu.deploy.load_exported`; then the graph of an exported int8
and fp32 net holds the kernels' ops (`bcnn_tpu_torch::conv_int8`,
`depthwise`, `grouped_int8`), one node a launch, and no aten
convolution in their place.

Tolerances against bcnn_tpu: fp32 outputs rtol 1e-4, atol 1e-5 (the
sums taken in another order); detections 1e-4; int8 heads within 2^-5
of their largest value (tests/test_torch_quant.py's HEAD_TOL: BN's
1/sqrt(var + eps) is rounded twice in the port, once by XLA's rsqrt, so
a code may land one LSB apart and move the layers after it)."""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcnn_tpu as bt
import bcnn_tpu_torch as tt
from bcnn_tpu import deploy as jdeploy
from bcnn_tpu.ops import quant as jq
from bcnn_tpu_torch import Session, bridge, deploy
from bcnn_tpu_torch.models import mobilenet_v1, yolov3_tiny
from bcnn_tpu_torch.ops.quant import ptq_synthetic
from bcnn_tpu_torch.types import LayerType

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
DET_TOL = 1e-4
HEAD_TOL = 2.0**-5
ops = torch.ops.bcnn_tpu_torch
aten = torch.ops.aten
# the aten convolutions an exported graph may hold (export keeps conv2d)
ATEN_CONVS = (aten.conv2d.default, aten.convolution.default)


def classif_net(pkg, batch=4):
    """tests/test_deploy.py's classifier in either package."""
    net = pkg.Net(pkg.Mode.PREDICT)
    A, F = pkg.Activation, pkg.FillerType
    net.set_input_shape(16, 16, 3, batch)
    net.add_convolutional_layer(8, 3, 1, 1, 1, 1, F.XAVIER, A.LRELU, 0,
                                "input", "c1")
    net.add_batchnorm_layer("c1", "b1")
    net.add_maxpool_layer(2, 2, pkg.Padding.SAME, "b1", "p1")
    net.add_fullc_layer(5, F.MSRA, A.NONE, 0, "p1", "f")
    net.add_softmax_layer("f", "s")
    return net


def detect_net(pkg, batch=2):
    net = pkg.Net(pkg.Mode.PREDICT)
    A, F = pkg.Activation, pkg.FillerType
    net.set_input_shape(64, 64, 3, batch)
    net.add_convolutional_layer(8, 3, 2, 1, 1, 1, F.XAVIER, A.LRELU, 0,
                                "input", "c1")
    net.add_convolutional_layer(21, 1, 1, 0, 1, 0, F.XAVIER, A.NONE, 0,
                                "c1", "head")
    net.add_yolo_layer(3, 2, 4, 6, [3, 4, 5],
                       [10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319],
                       "head", "out")
    return net


def int8_net(pkg):
    """tests/test_deploy.py's int8 PTQ net."""
    net = pkg.Net(pkg.Mode.PREDICT)
    A, F = pkg.Activation, pkg.FillerType
    net.set_input_shape(32, 32, 3, 2)
    net.add_convolutional_layer(8, 3, 1, 1, 1, 1, F.XAVIER, A.LRELU, 1,
                                "input", "c1")
    net.add_maxpool_layer(2, 2, pkg.Padding.SAME, "c1", "p1")
    net.add_convolutional_layer(12, 3, 1, 1, 1, 1, F.XAVIER, A.RELU, 0,
                                "p1", "c2")
    net.add_fullc_layer(5, F.MSRA, A.NONE, 0, "c2", "f")
    return net


def pair(make_net, seed=0, **kw):
    """(bcnn_tpu Session, port Session on the CPU) of one net, He-scaled
    weights from `seed` handed to both."""
    jnet, net = make_net(bt, **kw), make_net(tt, **kw)
    p_np, s_np = bridge.he_numpy_weights(net, seed)
    js = bt.Session(jnet, 0).compile_net()
    js.params = {k: jnp.asarray(v) for k, v in p_np.items()}
    js.state = {k: jnp.asarray(v) for k, v in s_np.items()}
    ts = Session(net, 0, device="cpu")
    ts.params, ts.state = bridge.params_from_numpy(net, p_np, s_np)
    return js, ts.compile_net()


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def graph_ops(blob):
    """The op targets of a single-platform artifact's graph, in order."""
    ep = torch.export.load(io.BytesIO(blob))
    return [n.target for n in ep.graph.nodes if n.op == "call_function"]


def aten_convs(targets):
    return sum(t in ATEN_CONVS for t in targets)


def test_forward_export_matches_live(tmp_path):
    js, ts = pair(classif_net)
    x = np.random.RandomState(0).randn(4, 3, 16, 16).astype(np.float32)
    (live,), _ = ts.predict_on_batch(x, outputs=["s"])
    path = str(tmp_path / "model.pt2")
    blob = ts.export_serving(path, outputs=["s"])
    assert len(blob) > 1000 and os.path.getsize(path) == len(blob)
    served = deploy.load_exported(path)
    (got,) = served(x)
    assert torch.equal(got, live)
    (jgot,) = jdeploy.load_exported(js.export_serving(
        str(tmp_path / "model.stablehlo"), outputs=["s"]))(x)
    close(got, jgot)
    # the weights are baked in: training the session in place leaves
    # the artifact as it was
    for v in ts.params.values():
        v.zero_()
    (got2,) = served(x)
    assert torch.equal(got2, got)


def test_forward_export_default_output():
    js, ts = pair(classif_net)
    blob = deploy.export_forward(ts.net, ts.params, ts.state)
    served = deploy.load_exported(blob)
    x = np.random.RandomState(1).randn(4, 3, 16, 16).astype(np.float32)
    (got,) = served(x)
    assert tuple(got.shape) == (4, 5, 1, 1)
    assert served.platforms == ("cpu",)
    (want,) = jdeploy.load_exported(jdeploy.export_forward(
        js.net, js.params, js.state))(x)
    close(got, want)


def test_detect_export_matches_live(tmp_path):
    js, ts = pair(detect_net, seed=2)
    x = np.random.RandomState(2).rand(2, 3, 64, 64).astype(np.float32)
    live = ts.detect_on_batch(x, thresh=0.4, max_dets=16)
    path = str(tmp_path / "detect.pt2")
    ts.export_serving(path, detect=True, thresh=0.4, max_dets=16)
    got = deploy.load_exported(path)(x)
    for g, l in zip(got, live):
        assert torch.equal(g, l)
    jpath = str(tmp_path / "detect.stablehlo")
    js.export_serving(jpath, detect=True, thresh=0.4, max_dets=16)
    want = jdeploy.load_exported(jpath)(x)
    assert float(got[2].max()) > 0.4  # some detections survive
    for g, w in zip(got, want):
        close(g, w, rtol=DET_TOL, atol=DET_TOL)


def test_int8_quantized_export_matches_live():
    """int8 PTQ with the activation-flow plan: bcnn_tpu calibrates and
    quantizes, the quant dict crosses (`bridge.quant_from_numpy`), and
    the port's artifact equals its live int8 forward bit for bit."""
    js, ts = pair(int8_net)
    rng = np.random.RandomState(0)
    calib = rng.rand(4, 3, 32, 32).astype(np.float32)
    js.net.quant = {
        "act_scales": jq.calibrate(js.net, js.params, js.state, [calib]),
        "weights": jq.quantize_weights(js.net, js.params),
    }
    ts.net.quant = bridge.quant_from_numpy(ts.net, js.net.quant)
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    (live,), _ = ts.predict_on_batch(x, outputs=["f"])
    blob = deploy.export_forward(ts.net, ts.params, ts.state, outputs=["f"])
    (got,) = deploy.load_exported(blob)(x)
    assert torch.equal(got, live)
    (want,) = jdeploy.load_exported(jdeploy.export_forward(
        js.net, js.params, js.state, outputs=["f"]))(x)
    want = np.asarray(want)
    close(got, want, rtol=0, atol=HEAD_TOL * np.abs(want).max())
    targets = graph_ops(blob)
    assert targets.count(ops.conv_int8.default) == 3  # two convs, the FC
    assert aten_convs(targets) == 0


def test_multi_platform_export_runs_on_cpu():
    """One artifact holds a program per platform; here, without a card,
    the CUDA one is the CPU trace to be moved to the card at load, and
    the CPU one runs."""
    _, ts = pair(classif_net)
    blob = deploy.export_forward(ts.net, ts.params, ts.state,
                                 platforms=("cuda", "cpu"))
    served = deploy.load_exported(blob)
    assert served.platforms == ("cuda", "cpu")
    x = np.random.RandomState(3).randn(4, 3, 16, 16).astype(np.float32)
    (got,) = served(x)  # uploaded to the one platform here: the CPU
    (live,), _ = ts.predict_on_batch(x)
    assert got.device.type == "cpu" and torch.equal(got, live)


def test_a_cuda_program_refuses_a_cpu_tensor():
    """A program for the card is handed no CPU tensor: it raises, it
    copies nothing over, and it never runs the CPU's plain versions."""
    _, ts = pair(classif_net)
    served = deploy.load_exported(deploy.export_forward(
        ts.net, ts.params, ts.state, platforms=("cuda",)))
    assert served.platforms == ("cuda",)
    x = torch.zeros(4, 3, 16, 16)
    with pytest.raises(ValueError, match="cuda"):
        served(x)


def test_exported_call_accepts_device_tensors():
    """A tensor goes straight in (cast to fp32 on its device) and equals
    the numpy path."""
    _, ts = pair(classif_net)
    served = deploy.load_exported(deploy.export_forward(
        ts.net, ts.params, ts.state, outputs=["s"]))
    x = np.random.RandomState(4).randn(4, 3, 16, 16).astype(np.float32)
    (from_np,) = served(x)
    (from_dev,) = served(torch.from_numpy(x))
    (from_f64,) = served(torch.from_numpy(x).double())
    assert torch.equal(from_np, from_dev) and torch.equal(from_np, from_f64)


def test_detect_export_requires_yolo():
    _, ts = pair(classif_net)
    with pytest.raises(ValueError, match="YOLO"):
        deploy.export_detect(ts.net, ts.params, ts.state)
    with pytest.raises(ValueError, match="YOLO"):
        ts.export_serving(None, detect=True)


def test_export_serving_argument_errors():
    _, ts = pair(classif_net)
    with pytest.raises(ValueError, match="outputs"):
        ts.export_serving(None, detect=True, outputs=["s"])
    with pytest.raises(ValueError, match="thresh"):
        ts.export_serving(None, max_dets=5)
    with pytest.raises(ValueError, match="platforms"):
        ts.export_serving(None, platforms=("tpu",))


# --------------------------------------------- the kernels in the graph #


@pytest.fixture(scope="module")
def mobilenet():
    net = mobilenet_v1(1, 10, width_mult=0.25)
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0))
    x = np.random.RandomState(5).rand(1, 3, 224, 224).astype(np.float32)
    return sess.compile_net(), x


def test_mobilenet_fp32_export_holds_k3_per_depthwise_layer(mobilenet):
    sess, x = mobilenet
    blob = sess.export_serving(None, outputs=["softmax"])
    targets = graph_ops(blob)
    dw = sum(n.type == LayerType.DEPTHWISE_CONV2D for n in sess.net.nodes)
    convs = sum(n.type == LayerType.CONV2D for n in sess.net.nodes)
    assert dw == 13
    assert targets.count(ops.depthwise.default) == dw
    assert aten_convs(targets) == convs  # the stem and the 1x1 convs
    ep = torch.export.load(io.BytesIO(blob))
    for n in ep.graph.nodes:  # no grouped aten conv stands for K3
        if n.target in ATEN_CONVS:
            assert n.args[1].meta["val"].shape[1] == n.args[0].meta[
                "val"].shape[1]
    (got,) = deploy.load_exported(blob)(x)
    (live,), _ = sess.predict_on_batch(x, outputs=["softmax"])
    assert torch.equal(got, live)


def test_mobilenet_int8_export_holds_k5_and_k4(mobilenet):
    sess, x = mobilenet
    net = sess.net
    ptq_synthetic(net, sess)
    try:
        blob = sess.export_serving(None, outputs=["softmax"])
        (live,), _ = sess.predict_on_batch(x, outputs=["softmax"])
    finally:
        net.quant = None
    targets = graph_ops(blob)
    assert targets.count(ops.grouped_int8.default) == 13
    convs = sum(n.type in (LayerType.CONV2D, LayerType.FULL_CONNECTED)
                for n in net.nodes)
    assert targets.count(ops.conv_int8.default) == convs == 15
    assert aten_convs(targets) == 0
    (got,) = deploy.load_exported(blob)(x)
    assert torch.equal(got, live)


def test_int8_detect_export_holds_k4_per_conv_and_keeps_its_layouts():
    """YOLOv3-tiny int8 (64 px): 13 conv_int8 nodes, and after save and
    load every weight constant keeps the layout its kernel reads (K4's
    (O, k, k, C) in memory), which the card's kernel checks."""
    net = yolov3_tiny(2, 64, 64, 4)
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0))
    sess.compile_net()
    ptq_synthetic(net, sess)
    blob = sess.export_serving(None, detect=True, thresh=0.3, max_dets=20)
    ep = torch.export.load(io.BytesIO(blob))
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count(ops.conv_int8.default) == 13
    assert aten_convs(targets) == 0
    weights = [e["q"] for e in net.quant["weights"].values()]
    consts = list(ep.constants.values())
    for w in weights:
        same = [c for c in consts if c.shape == w.shape and c.dtype == w.dtype
                and torch.equal(c, w)]
        assert same and all(c.stride() == w.stride() for c in same)
    x = np.random.RandomState(6).rand(2, 3, 64, 64).astype(np.float32)
    live = sess.detect_on_batch(x, 0.3, 20)
    for g, l in zip(deploy.load_exported(blob)(x), live):
        assert torch.equal(g, l)
