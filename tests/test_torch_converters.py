"""The converters against bcnn_tpu on the CPU.

Caffe and ONNX: tools/caffe2bcnn.py and tools/onnx2bcnn.py import no
framework; they write a .conf and a .bcnnmodel, which the port's
`config.load_net` reads as bcnn_tpu's does. On the cases of
tests/test_converters.py and tests/test_onnx_converter.py, the port's
loaded weights equal bcnn_tpu's (OIHW against HWIO) and its PREDICT
forward stays within rtol 1e-5, atol 1e-6 (Caffe) or rtol 1e-4, atol
1e-5 (ONNX, also against the torch module the ONNX came from) of
bcnn_tpu's.

TFLite: `bcnn_tpu_torch.tflite` on the cases of tests/test_tflite.py.
The direct writer's blob on the port's copy of bcnn_tpu's weights is
byte-equal to tools/tflite_writer.write_tflite's on bcnn_tpu's own, and
tensorflow's TFLite interpreter runs the blobs of both backends within
rtol 1e-4, atol 1e-5 of the port's forward; YOLO is rejected.
"""

import os
import sys

import numpy as np
import pytest
import torch

import bcnn_tpu as bt
import bcnn_tpu.models
from bcnn_tpu.config import load_net as jax_load_net

import bcnn_tpu_torch as tt
from bcnn_tpu_torch import bridge
from bcnn_tpu_torch.config import load_net
from bcnn_tpu_torch.models import lenet_mnist, yolov3_tiny
from bcnn_tpu_torch.tflite import convert_net

TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "tools")
sys.path.insert(0, TOOLS)

torch.set_num_threads(1)

CAFFE_RTOL, CAFFE_ATOL = 1e-5, 1e-6
ONNX_RTOL, ONNX_ATOL = 1e-4, 1e-5
TFLITE_RTOL, TFLITE_ATOL = 1e-4, 1e-5


def both_loaded(conf, model):
    """(bcnn_tpu session, port session) of `conf` + `model` in PREDICT,
    each loaded by its own package's config.load_net."""
    jnet = bt.Net(bt.Mode.PREDICT)
    jax_load_net(jnet, conf, model)
    net = tt.Net(tt.Mode.PREDICT)
    load_net(net, conf, model)
    return (bt.Session(jnet, 0).compile_net(),
            tt.Session(net, 0, device="cpu").compile_net())


def same_weights(js, ts):
    """Every param and state tensor of the port equals bcnn_tpu's, conv
    weights compared in bcnn_tpu's HWIO layout."""
    for mine, theirs in ((ts.params, js.params), (ts.state, js.state)):
        got = bridge.params_to_numpy(ts.net, mine)
        assert set(got) == set(theirs)
        for k, v in got.items():
            np.testing.assert_array_equal(v, np.asarray(theirs[k]),
                                          err_msg=k)


def both_forward(js, ts, x, name=None):
    if name is None:
        last = [n for n in ts.net.nodes if n.type != tt.LayerType.COST][-1]
        name = ts.net.tensors[last.dst[0]].name
    (want,), _ = js.predict_on_batch(x, outputs=[name])
    (got,), _ = ts.predict_on_batch(x, outputs=[name])
    return got.numpy(), np.asarray(want)


# ---------------------------------------------------------------- Caffe


def test_caffe_roundtrip_weights_and_forward(tmp_path):
    """tests/test_converters.py:66: conv, ReLU, max pool, FC, softmax."""
    from caffe2bcnn import convert

    from tests.test_converters import make_caffe_model

    prototxt, caffemodel, conv_w, conv_b, _, _ = make_caffe_model(tmp_path)
    conf, model = str(tmp_path / "net.conf"), str(tmp_path / "net.bcnnmodel")
    convert(prototxt, caffemodel, conf, model)
    js, ts = both_loaded(conf, model)
    same_weights(js, ts)
    w_key = [t.key for t in ts.net.param_specs() if t.name == "data_w"][0]
    np.testing.assert_array_equal(ts.params[w_key].numpy(),
                                  conv_w.reshape(4, 3, 3, 3))  # OIHW
    b_key = [t.key for t in ts.net.param_specs() if t.name == "data_b"][0]
    np.testing.assert_array_equal(ts.params[b_key].numpy(), conv_b)
    x = np.random.RandomState(1).randn(1, 3, 8, 8).astype(np.float32)
    got, want = both_forward(js, ts, x, "prob")
    np.testing.assert_allclose(got, want, rtol=CAFFE_RTOL, atol=CAFFE_ATOL)
    np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-4)


def caffe_bn_model(pb, tmp_path, conv):
    """tests/test_converters.py:95's BatchNorm layer (mean, var and a
    scale factor of 2, eps 1e-3), behind a 1x1 conv when `conv`:
    (prototxt, caffemodel) paths."""
    conv_txt = (
        'layer { name: "c" type: "Convolution" bottom: "data" top: "c"\n'
        '        convolution_param { num_output: 2 kernel_size: 1 } }\n'
        if conv else "")
    prototxt = tmp_path / f"bn{int(conv)}.prototxt"
    prototxt.write_text(
        """
layer { name: "data" type: "Input" top: "data"
        input_param { shape { dim: 1 dim: 2 dim: 4 dim: 4 } } }
""" + conv_txt + f"""
layer {{ name: "bn" type: "BatchNorm" bottom: "{'c' if conv else 'data'}"
        top: "bn" batch_norm_param {{ eps: 0.001 }} }}
"""
    )
    model = pb.NetParameter()
    if conv:
        c = model.layer.add()
        c.name, c.type = "c", "Convolution"
        rng = np.random.RandomState(6)
        c.blobs.add().data.extend(rng.randn(4).astype(np.float32).tolist())
        c.blobs.add().data.extend(rng.randn(2).astype(np.float32).tolist())
    bn = model.layer.add()
    bn.name, bn.type = "bn", "BatchNorm"
    bn.blobs.add().data.extend([1.0, 2.0])
    bn.blobs.add().data.extend([4.0, 9.0])
    bn.blobs.add().data.extend([2.0])
    caffemodel = tmp_path / f"bn{int(conv)}.caffemodel"
    caffemodel.write_bytes(model.SerializeToString())
    return str(prototxt), str(caffemodel)


def test_caffe_batchnorm_fold(tmp_path):
    """tests/test_converters.py:95: the BatchNorm blobs' scale factor and
    eps folded into the .bcnnmodel. That net (BatchNorm first) is
    refused by both packages' builders alike; behind a 1x1 conv both
    load it to the same weights and run it alike."""
    from caffe2bcnn import _load_proto_module, convert

    from bcnn_tpu.graph import BuildError as JaxBuildError
    from bcnn_tpu_torch.graph import BuildError

    pb = _load_proto_module()
    for conv in (False, True):
        prototxt, caffemodel = caffe_bn_model(pb, tmp_path, conv)
        conf = str(tmp_path / f"bn{int(conv)}.conf")
        weights = str(tmp_path / f"bn{int(conv)}.bcnnmodel")
        convert(prototxt, caffemodel, conf, weights)
        if not conv:
            with pytest.raises(JaxBuildError, match="first layer") as want:
                both_loaded(conf, weights)
            with pytest.raises(BuildError) as got:
                load_net(tt.Net(tt.Mode.PREDICT), conf, weights)
            assert str(got.value) == str(want.value)
            continue
        js, ts = both_loaded(conf, weights)
        assert ts.net.bn_folded and js.net.bn_folded
        same_weights(js, ts)
        x = np.random.RandomState(2).randn(1, 2, 4, 4).astype(np.float32)
        got, want = both_forward(js, ts, x)
        np.testing.assert_allclose(got, want, rtol=CAFFE_RTOL,
                                   atol=CAFFE_ATOL)


# ----------------------------------------------------------------- ONNX


def onnx_classif_chain(pb):
    """tests/test_onnx_converter.py:104's model and torch module."""
    from tests.test_onnx_converter import make_model

    rng = np.random.RandomState(3)
    W1 = rng.randn(4, 3, 3, 3).astype(np.float32) * 0.5
    B1 = rng.randn(4).astype(np.float32)
    bn_s = rng.rand(4).astype(np.float32) + 0.5
    bn_b = rng.randn(4).astype(np.float32)
    bn_m = rng.randn(4).astype(np.float32)
    bn_v = rng.rand(4).astype(np.float32) + 0.2
    W2 = rng.randn(6, 4, 3, 3).astype(np.float32) * 0.3
    B2 = rng.randn(6).astype(np.float32)
    FW = rng.randn(5, 6 * 4 * 4).astype(np.float32) * 0.1
    FB = rng.randn(5).astype(np.float32)
    m = make_model(
        pb, (1, 3, 8, 8),
        nodes=[
            ("Conv", ["input", "W1", "B1"], ["c1"],
             {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1],
              "strides": [1, 1]}),
            ("BatchNormalization",
             ["c1", "bn_s", "bn_b", "bn_m", "bn_v"], ["b1"],
             {"epsilon": 1e-3}),
            ("Relu", ["b1"], ["r1"], {}),
            ("MaxPool", ["r1"], ["p1"],
             {"kernel_shape": [2, 2], "strides": [2, 2]}),
            ("Conv", ["p1", "W2", "B2"], ["c2"],
             {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1],
              "strides": [1, 1]}),
            ("LeakyRelu", ["c2"], ["l2"], {"alpha": 0.1}),
            ("Flatten", ["l2"], ["fl"], {"axis": 1}),
            ("Gemm", ["fl", "FW", "FB"], ["fc"], {"transB": 1}),
            ("Softmax", ["fc"], ["prob"], {"axis": 1}),
        ],
        inits={"W1": W1, "B1": B1, "bn_s": bn_s, "bn_b": bn_b,
               "bn_m": bn_m, "bn_v": bn_v, "W2": W2, "B2": B2,
               "FW": FW, "FB": FB},
        output_name="prob",
    )
    x = rng.randn(1, 3, 8, 8).astype(np.float32)
    tm = torch.nn.Sequential(
        torch.nn.Conv2d(3, 4, 3, padding=1),
        torch.nn.BatchNorm2d(4, eps=1e-3),
        torch.nn.ReLU(),
        torch.nn.MaxPool2d(2),
        torch.nn.Conv2d(4, 6, 3, padding=1),
        torch.nn.LeakyReLU(0.1),
        torch.nn.Flatten(),
        torch.nn.Linear(6 * 4 * 4, 5),
        torch.nn.Softmax(dim=1),
    ).eval()
    with torch.no_grad():
        for mod, vals in ((tm[0], (W1, B1)), (tm[4], (W2, B2)),
                          (tm[7], (FW, FB)), (tm[1], (bn_s, bn_b))):
            mod.weight.copy_(torch.from_numpy(vals[0]))
            mod.bias.copy_(torch.from_numpy(vals[1]))
        tm[1].running_mean.copy_(torch.from_numpy(bn_m))
        tm[1].running_var.copy_(torch.from_numpy(bn_v))
        want = tm(torch.from_numpy(x)).numpy()
    return m, x, want


def onnx_depthwise_residual(pb):
    """tests/test_onnx_converter.py:178's model and torch forward."""
    from tests.test_onnx_converter import make_model

    rng = np.random.RandomState(4)
    C = 3
    DW = rng.randn(C, 1, 3, 3).astype(np.float32) * 0.5
    DB = rng.randn(C).astype(np.float32)
    FW = rng.randn(4, C).astype(np.float32)
    FB = rng.randn(4).astype(np.float32)
    m = make_model(
        pb, (2, C, 6, 6),
        nodes=[
            ("Conv", ["input", "DW", "DB"], ["d1"],
             {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1],
              "strides": [1, 1], "group": C}),
            ("Add", ["d1", "input"], ["a1"], {}),
            ("GlobalAveragePool", ["a1"], ["g1"], {}),
            ("Flatten", ["g1"], ["fl"], {"axis": 1}),
            ("Gemm", ["fl", "FW", "FB"], ["fc"], {"transB": 1}),
        ],
        inits={"DW": DW, "DB": DB, "FW": FW, "FB": FB},
        output_name="fc",
    )
    x = rng.randn(2, C, 6, 6).astype(np.float32)
    conv = torch.nn.Conv2d(C, C, 3, padding=1, groups=C)
    fc = torch.nn.Linear(C, 4)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(DW))
        conv.bias.copy_(torch.from_numpy(DB))
        fc.weight.copy_(torch.from_numpy(FW))
        fc.bias.copy_(torch.from_numpy(FB))
        t = torch.from_numpy(x)
        want = fc((conv(t) + t).mean(dim=(2, 3))).numpy()
    return m, x, want


def onnx_deconv_prelu_upsample(pb):
    """tests/test_onnx_converter.py:219's model and torch forward."""
    from tests.test_onnx_converter import make_model

    rng = np.random.RandomState(5)
    TW = rng.randn(3, 4, 3, 3).astype(np.float32) * 0.4
    TB = rng.randn(4).astype(np.float32)
    slopes = rng.rand(4).astype(np.float32) * 0.5
    m = make_model(
        pb, (1, 3, 5, 5),
        nodes=[
            ("ConvTranspose", ["input", "TW", "TB"], ["u1"],
             {"kernel_shape": [3, 3], "strides": [2, 2],
              "pads": [1, 1, 1, 1]}),
            ("PRelu", ["u1", "slopes"], ["p1"], {}),
            ("Upsample", ["p1"], ["up"],
             {"mode": b"nearest", "scales": [1.0, 1.0, 2.0, 2.0]}),
        ],
        inits={"TW": TW, "TB": TB, "slopes": slopes},
        output_name="up",
    )
    x = rng.randn(1, 3, 5, 5).astype(np.float32)
    deconv = torch.nn.ConvTranspose2d(3, 4, 3, stride=2, padding=1)
    prelu = torch.nn.PReLU(4)
    with torch.no_grad():
        deconv.weight.copy_(torch.from_numpy(TW))
        deconv.bias.copy_(torch.from_numpy(TB))
        prelu.weight.copy_(torch.from_numpy(slopes))
        y = prelu(deconv(torch.from_numpy(x)))
        want = torch.nn.functional.interpolate(y, scale_factor=2,
                                               mode="nearest").numpy()
    return m, x, want


@pytest.mark.parametrize("case", [onnx_classif_chain, onnx_depthwise_residual,
                                  onnx_deconv_prelu_upsample],
                         ids=["classif_chain", "depthwise_residual",
                              "deconv_prelu_upsample"])
def test_onnx_forward_matches_bcnn_tpu_and_torch(case, tmp_path):
    from onnx2bcnn import _load_proto_module, convert

    m, x, want = case(_load_proto_module())
    path = tmp_path / "m.onnx"
    path.write_bytes(m.SerializeToString())
    conf, weights = str(tmp_path / "m.conf"), str(tmp_path / "m.bcnnmodel")
    convert(str(path), conf, weights)
    js, ts = both_loaded(conf, weights)
    same_weights(js, ts)
    got, ref = both_forward(js, ts, x)
    np.testing.assert_allclose(got, ref, rtol=ONNX_RTOL, atol=ONNX_ATOL)
    np.testing.assert_allclose(got.reshape(want.shape), want,
                               rtol=ONNX_RTOL, atol=ONNX_ATOL)


def test_onnx_unsupported_op_raises(tmp_path):
    """tests/test_onnx_converter.py:259: the converter raises before the
    port is reached, naming the op."""
    from onnx2bcnn import _load_proto_module, convert

    from tests.test_onnx_converter import make_model

    m = make_model(_load_proto_module(), (1, 3, 4, 4),
                   nodes=[("InstanceNormalization", ["input"], ["y"], {})],
                   inits={}, output_name="y")
    p = tmp_path / "bad.onnx"
    p.write_bytes(m.SerializeToString())
    with pytest.raises(NotImplementedError, match="InstanceNormalization"):
        convert(str(p), str(tmp_path / "o.conf"), str(tmp_path / "o.model"))
    assert not (tmp_path / "o.model").exists()


# --------------------------------------------------------------- TFLite


def interp_run(blob, x_nchw):
    tf = pytest.importorskip("tensorflow")
    interp = tf.lite.Interpreter(model_content=blob)
    interp.allocate_tensors()
    inp = interp.get_input_details()[0]
    out = interp.get_output_details()[0]
    interp.set_tensor(inp["index"], np.transpose(x_nchw, (0, 2, 3, 1)))
    interp.invoke()
    y = interp.get_tensor(out["index"])
    return np.transpose(y, (0, 3, 1, 2)) if y.ndim == 4 else y  # NCHW


def bridged(jnet, jsess, net):
    """The port's CPU session of `net` on bcnn_tpu's weights."""
    ts = tt.Session(net, 0, device="cpu")
    ts.params, ts.state = bridge.params_from_numpy(
        net, {k: np.asarray(v) for k, v in jsess.params.items()},
        {k: np.asarray(v) for k, v in jsess.state.items()})
    return ts.compile_net()


def check_tflite(jnet, jsess, net, x, out_name):
    """The port's direct blob byte-equal to bcnn_tpu's; the interpreter
    on each backend's blob within tolerance of the port's forward."""
    from tflite_writer import write_tflite

    ts = bridged(jnet, jsess, net)
    blob = convert_net(net, ts.params, ts.state, None, backend="direct")
    assert blob == write_tflite(jnet, jsess.params, jsess.state, None)
    (want,), _ = ts.predict_on_batch(x, outputs=[out_name])
    want = want.numpy().reshape(-1)
    pytest.importorskip("tensorflow")
    tf_blob = convert_net(net, ts.params, ts.state, None, backend="tf")
    for b in (blob, tf_blob):
        np.testing.assert_allclose(interp_run(b, x).reshape(-1), want,
                                   rtol=TFLITE_RTOL, atol=TFLITE_ATOL)


def test_tflite_cli_conf_weights(tmp_path):
    """tests/test_tflite.py:15: the CLI from a .conf and a .bcnnmodel;
    --direct byte-equal to bcnn_tpu's tool, and the TensorFlow backend's
    file loads in the interpreter and runs as the port's forward."""
    from bcnn2tflite import main as jax_main

    sys.path.insert(0, TOOLS)
    from bcnn2tflite_torch import main

    conf = tmp_path / "n.conf"
    conf.write_text(
        """
[net]
input_width=8
input_height=8
input_channels=3
batch_size=1

[conv]
filters=4
size=3
stride=1
pad=1
activation=relu
src=input
dst=c1

[softmax]
src=c1
dst=s
"""
    )
    jnet = bt.Net(bt.Mode.PREDICT)
    jax_load_net(jnet, str(conf))
    jsess = bt.Session(jnet, 0).compile_net()
    w = tmp_path / "n.bcnnmodel"
    bt.save_weights(jnet, {k: np.asarray(v) for k, v in jsess.params.items()},
                    {k: np.asarray(v) for k, v in jsess.state.items()},
                    str(w))
    mine, theirs = tmp_path / "mine.tflite", tmp_path / "theirs.tflite"
    assert main(["x", str(conf), str(w), str(mine), "--direct"]) == 0
    assert jax_main(["x", str(conf), str(w), str(theirs), "--direct"]) == 0
    assert mine.read_bytes() == theirs.read_bytes()
    pytest.importorskip("tensorflow")
    auto = tmp_path / "auto.tflite"
    assert main(["x", str(conf), str(w), str(auto)]) == 0
    assert auto.stat().st_size > 500
    net = tt.Net(tt.Mode.PREDICT)
    load_net(net, str(conf), str(w))
    ts = tt.Session(net, 0, device="cpu").compile_net()
    x = np.random.RandomState(1).randn(1, 3, 8, 8).astype(np.float32)
    (want,), _ = ts.predict_on_batch(x, outputs=["s"])
    for blob in (mine.read_bytes(), auto.read_bytes()):
        np.testing.assert_allclose(interp_run(blob, x).reshape(-1),
                                   want.numpy().reshape(-1),
                                   rtol=TFLITE_RTOL, atol=TFLITE_ATOL)


def residual_net(pkg):
    """tests/test_tflite.py:62's net in package `pkg`."""
    A, X = pkg.Activation, pkg.FillerType.XAVIER
    net = pkg.Net(pkg.Mode.PREDICT)
    net.set_input_shape(16, 16, 3, 1)
    net.add_convolutional_layer(8, 3, 1, 1, 1, 1, X, A.LRELU, 0, "input",
                                "c1")
    net.add_maxpool_layer(2, 2, pkg.Padding.SAME, "c1", "p1")
    net.add_convolutional_layer(8, 3, 1, 1, 1, 0, X, A.RELU, 0, "p1", "c2")
    net.add_eltwise_layer(A.NONE, "p1", "c2", "add1")
    net.add_fullc_layer(6, X, A.NONE, 0, "add1", "f")
    net.add_softmax_layer("f", "s")
    return net


def zoo_net(pkg):
    """tests/test_tflite.py:143's layer zoo in package `pkg`."""
    A, X = pkg.Activation, pkg.FillerType.XAVIER
    net = pkg.Net(pkg.Mode.PREDICT)
    net.set_input_shape(16, 16, 3, 1)
    net.add_convolutional_layer(8, 3, 1, 1, 1, 1, X, A.PRELU, 0, "input",
                                "c1")
    net.add_depthwise_conv_layer(3, 1, 1, 0, X, A.LRELU, "c1", "dw")
    net.add_batchnorm_layer("dw", "bn")
    net.add_convolutional_layer(8, 1, 1, 0, 1, 0, X, A.TANH, 0, "bn", "c2")
    net.add_eltwise_layer(A.NONE, "c1", "c2", "add")
    net.add_maxpool_layer(2, 2, pkg.Padding.SAME, "add", "mp")
    net.add_deconvolutional_layer(6, 2, 2, 0, X, A.LOGISTIC, "mp", "up")
    net.add_upsample_layer(2, "up", "us")
    net.add_concat_layer(["us", "us"], "cat")
    net.add_avgpool_layer("cat", "gap")
    net.add_fullc_layer(5, X, A.NONE, 0, "gap", "fc")
    net.add_softmax_layer("fc", "sm")
    return net


def test_tflite_export_matches_forward():
    """tests/test_tflite.py:62: conv + BN with non-trivial running
    stats, max pool, residual add, FC, softmax."""
    jnet = residual_net(bt)
    jsess = bt.Session(jnet, 0).compile_net()
    for k in jsess.state:
        if "run_var" in k:
            jsess.state[k] = np.abs(np.random.RandomState(0).randn(
                *np.asarray(jsess.state[k]).shape)).astype(np.float32) + 0.5
    x = np.random.RandomState(1).randn(1, 3, 16, 16).astype(np.float32)
    check_tflite(jnet, jsess, residual_net(tt), x, "s")


def test_tflite_lenet():
    """tests/test_tflite.py:119: LeNet, running variances of one."""
    import jax.numpy as jnp

    jnet = bt.models.lenet_mnist(batch_size=1, mode=bt.Mode.PREDICT)
    jsess = bt.Session(jnet, 0).compile_net()
    for k in list(jsess.state):
        if "run_var" in k:
            jsess.state[k] = jnp.ones_like(jsess.state[k])
    x = np.random.RandomState(0).randn(1, 1, 28, 28).astype(np.float32)
    check_tflite(jnet, jsess, lenet_mnist(1, tt.Mode.PREDICT), x, "softmax")


def test_tflite_layer_zoo():
    """tests/test_tflite.py:143: depthwise, deconv, PReLU / LRELU / tanh /
    logistic, standalone BN, concat, eltwise, upsample, global avgpool."""
    import jax.numpy as jnp

    jnet = zoo_net(bt)
    jsess = bt.Session(jnet, 0).compile_net()
    for k in list(jsess.state):
        if "run_var" in k:
            jsess.state[k] = jnp.ones_like(jsess.state[k])
    x = np.random.RandomState(1).randn(1, 3, 16, 16).astype(np.float32)
    check_tflite(jnet, jsess, zoo_net(tt), x, "sm")


def test_tflite_rejects_yolo():
    """tests/test_tflite.py:196: the direct writer rejects YOLO, as the
    reference's converter does."""
    net = yolov3_tiny(1, 64, 64, 2, mode=tt.Mode.PREDICT)
    sess = tt.Session(net, 0, device="cpu").compile_net()
    with pytest.raises(ValueError, match="not supported"):
        convert_net(net, sess.params, sess.state, None, backend="direct")
