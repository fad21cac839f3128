"""The int8 layers the port added beside K4's convs, against bcnn_tpu on
the CPU: the quantized depthwise layer and grouped CONV2D (K5's plain
version), the FC and the deconv (each run as the conv K4 computes for
it), layer by layer and end to end in MobileNet-v1 (width 0.25) and
ResNet-18 (64 px), and `bridge.quant_from_numpy` on a dict of all four
kinds.

Every JAX quant dict crosses with bridge.quant_from_numpy. Tolerances,
those of tests/test_torch_quant.py:
  - each node fed bcnn_tpu's own inputs to it: every int8 output within
    1 LSB of bcnn_tpu's in fewer than 1e-4 of its entries (the sums are
    exact in both; BN's 1/sqrt(var + eps) rounds apart from XLA's
    rsqrt), every fp32 output within rtol 1e-5, atol 1e-6;
  - end to end: the softmax within 2^-5 of its largest value (one LSB
    in an early layer moves every layer after it) and the same argmax.
The small nets take bcnn_tpu.compile.init_params' weights and BN stats
from a numpy seed; MobileNet-v1 and ResNet-18 take
`bridge.he_numpy_weights` (their XAVIER fillers make the logits fade to
a uniform softmax, whose argmax would test nothing)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcnn_tpu as bt
from bcnn_tpu import Session as JaxSession
from bcnn_tpu.compile import execute as jax_execute
from bcnn_tpu.models import mobilenet_v1 as jax_mobilenet
from bcnn_tpu.models import resnet18 as jax_resnet18
from bcnn_tpu.ops import quant as jq
from bcnn_tpu.types import Mode as JaxMode

from bcnn_tpu_torch import bridge
from bcnn_tpu_torch import graph as tgraph
from bcnn_tpu_torch.compile import _Executor
from bcnn_tpu_torch.models import mobilenet_v1, resnet18
from bcnn_tpu_torch.ops import quant as tq
from bcnn_tpu_torch.ops.conv_int8 import conv_int8_fused
from bcnn_tpu_torch.ops.grouped_int8 import grouped_int8_fused
from bcnn_tpu_torch.types import Activation, LayerType, Mode
from tests.test_torch_quant import HEAD_TOL, jax_to_port, nchw, to_torch
from tests.test_torch_slice import bn_stats

torch.set_num_threads(1)


def grouped_net(pkg):
    """Depthwise at stride 1 and 2 with each fused activation and one
    that no kernel fuses, grouped convs (2 groups with BN, 4 without),
    and an FC on a 4-d input with H, W > 1 (the NCHW flatten)."""
    A, F = pkg.Activation, pkg.FillerType
    net = pkg.Net(pkg.Mode.PREDICT)
    net.set_input_shape(9, 9, 8, 2)
    net.add_convolutional_layer(8, 3, 1, 1, 1, 1, F.XAVIER, A.LRELU, 0,
                                "input", "c0")
    net.add_depthwise_conv_layer(3, 1, 1, 0, F.XAVIER, A.RELU, "c0", "dw1")
    net.add_depthwise_conv_layer(3, 2, 1, 0, F.XAVIER, A.LRELU, "dw1",
                                 "dw2")
    net.add_depthwise_conv_layer(3, 1, 1, 0, F.XAVIER, A.LOGISTIC, "dw2",
                                 "dw3")
    net.add_depthwise_conv_layer(3, 1, 1, 0, F.XAVIER, A.NONE, "dw3",
                                 "dw4")
    net.add_convolutional_layer(8, 3, 1, 1, 2, 1, F.XAVIER, A.RELU, 0,
                                "dw4", "g2")
    net.add_convolutional_layer(12, 1, 1, 0, 4, 0, F.XAVIER, A.LRELU, 0,
                                "g2", "g4")
    net.add_fullc_layer(5, F.XAVIER, A.NONE, 0, "g4", "fc")
    return net


def deconv_net(pkg):
    """Deconvs at stride 2, pad 0 and pad 1, then an FC on (N, C, 1, 1)
    after the average pool and a second FC after it."""
    A, F = pkg.Activation, pkg.FillerType
    net = pkg.Net(pkg.Mode.PREDICT)
    net.set_input_shape(6, 6, 4, 2)
    net.add_convolutional_layer(6, 3, 1, 1, 1, 0, F.XAVIER, A.RELU, 0,
                                "input", "c0")
    net.add_deconvolutional_layer(4, 3, 2, 0, F.XAVIER, A.RELU, "c0", "d1")
    net.add_deconvolutional_layer(5, 4, 2, 1, F.XAVIER, A.LRELU, "d1", "d2")
    net.add_deconvolutional_layer(3, 3, 1, 1, F.XAVIER, A.NONE, "d2", "d3")
    net.add_avgpool_layer("d3", "gap")
    net.add_fullc_layer(7, F.XAVIER, A.RELU, 0, "gap", "fc1")
    net.add_fullc_layer(4, F.XAVIER, A.NONE, 0, "fc1", "fc2")
    return net


def small_pair(build, seed=0):
    """(bcnn_tpu session, port session, input) of a small net: bcnn_tpu's
    init_params weights, BN stats from a numpy seed, PTQ by bcnn_tpu's
    calibrate + quantize_weights on the input, carried to the port."""
    jnet, net = build(bt), build(tgraph)
    js = JaxSession(jnet, 0).compile_net()
    js.state = {k: jnp.asarray(v)
                for k, v in bn_stats(jnet.state_specs(), seed).items()}
    ts = jax_to_port(js, net)
    t0 = net.tensors[0]
    x = np.random.RandomState(seed + 1).rand(
        t0.n, t0.c, t0.h, t0.w).astype(np.float32)
    quantize(js, ts, x)
    return js, ts, x


def quantize(js, ts, x):
    js.net.quant = {
        "act_scales": jq.calibrate(js.net, js.params, js.state, [x]),
        "weights": jq.quantize_weights(js.net, js.params),
    }
    js._forward_cache = {}
    ts.net.quant = bridge.quant_from_numpy(ts.net, js.net.quant)


def he_pair(jnet, net, size, seed):
    """Both packages on `bridge.he_numpy_weights(net, seed)`, PTQ on one
    uniform batch."""
    if size != net.tensors[0].w:
        jnet.resize(size, size)
        net.resize(size, size)
    p_np, s_np = bridge.he_numpy_weights(net, seed)
    js = JaxSession(jnet, 0).compile_net()
    js.params = {k: jnp.asarray(v) for k, v in p_np.items()}
    js.state = {k: jnp.asarray(v) for k, v in s_np.items()}
    ts = jax_to_port(js, net)
    t0 = net.tensors[0]
    x = np.random.RandomState(seed + 1).rand(
        t0.n, t0.c, t0.h, t0.w).astype(np.float32)
    quantize(js, ts, x)
    return js, ts, x


def layer_by_layer(js, ts, x):
    """Each node of the port fed bcnn_tpu's own inputs to it; returns
    {layer type: outputs checked}."""
    jex = jax_execute(js.net, js.params, js.state, {"input": jnp.asarray(x)},
                      JaxMode.PREDICT, None)
    ex = _Executor(ts.net, ts.params, ts.state, Mode.PREDICT)
    assert ex.int8_flow == jex.int8_flow
    checked = {}
    for node in ts.net.nodes:
        for s in node.src:
            if ts.net.tensors[s].key is None:
                ex.values[s] = to_torch(jex.values[s])
        getattr(ex, f"_{node.type.name.lower()}")(node)
        got, want = ex.values[node.dst[0]], jex.values[node.dst[0]]
        name = ts.net.tensors[node.dst[0]].name
        if want.dtype == jnp.int8:
            assert got.dtype == torch.int8, name
            d = np.abs(got.numpy().astype(np.int32) - nchw(want))
            assert d.max() <= 1, name
            assert (d > 0).mean() < 1e-4, name
        else:
            assert got.dtype == torch.float32, name
            np.testing.assert_allclose(got.numpy(), nchw(want), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        kind = (node.type, want.dtype == jnp.int8)
        checked[kind] = checked.get(kind, 0) + 1
    return checked


def test_depthwise_grouped_and_fc_layer_by_layer():
    js, ts, x = small_pair(grouped_net)
    checked = layer_by_layer(js, ts, x)
    L = LayerType
    # dw1, dw2, dw4 emit int8 (the non-fused LOGISTIC's dw3 too, after its
    # activation); dw4's consumer is the grouped conv
    assert checked[(L.DEPTHWISE_CONV2D, True)] == 4
    assert checked[(L.CONV2D, True)] == 3  # c0, g2, g4
    assert checked[(L.FULL_CONNECTED, False)] == 1
    assert len(ts.net.quant["weights"]) == 8


def test_deconv_and_fc_layer_by_layer():
    js, ts, x = small_pair(deconv_net, seed=3)
    checked = layer_by_layer(js, ts, x)
    L = LayerType
    assert checked[(L.TRANSPOSE_CONV2D, True)] == 2  # d1, d2
    assert checked[(L.TRANSPOSE_CONV2D, False)] == 1  # d3, into the pool
    assert checked[(L.FULL_CONNECTED, True)] == 1  # fc1, into fc2
    assert checked[(L.FULL_CONNECTED, False)] == 1


@pytest.mark.parametrize("build", [grouped_net, deconv_net])
def test_small_nets_end_to_end(build):
    js, ts, x = small_pair(build, seed=5)
    name = ts.net.tensors[ts.net.nodes[-1].dst[0]].name
    (want,), _ = js.predict_on_batch(x, outputs=[name])
    (got,), _ = ts.predict_on_batch(x, outputs=[name])
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    assert np.abs(got.numpy() - want).max() <= HEAD_TOL * np.abs(want).max()


@pytest.mark.parametrize("model", ["mobilenet_v1", "resnet18"])
def test_int8_classifiers_end_to_end(model):
    """MobileNet-v1 at width 0.25 and 224 px (tests/test_quant.py:34's
    net), ResNet-18 at 64 px, batch 2: every conv-like layer quantized,
    the softmax against bcnn_tpu's, the same argmax."""
    if model == "mobilenet_v1":
        jnet = jax_mobilenet(2, 10, JaxMode.PREDICT, width_mult=0.25)
        net = mobilenet_v1(2, 10, Mode.PREDICT, width_mult=0.25)
        js, ts, x = he_pair(jnet, net, 224, 0)
    else:
        js, ts, x = he_pair(jax_resnet18(2, 10, JaxMode.PREDICT),
                            resnet18(2, 10, Mode.PREDICT), 64, 1)
    n_layers = sum(n.type in tq._SCALE_AXIS for n in ts.net.nodes)
    assert len(ts.net.quant["weights"]) == n_layers
    (wfc, want), _ = js.predict_on_batch(x, outputs=["fc", "softmax"])
    (gfc, got), _ = ts.predict_on_batch(x, outputs=["fc", "softmax"])
    want, got = np.asarray(want).reshape(2, -1), got.numpy().reshape(2, -1)
    tol = HEAD_TOL * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    # each image's top class leads the next by more than the tolerance
    top2 = np.sort(want, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 2 * tol).all()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_quant_from_numpy_carries_all_four_kinds():
    """A JAX dict with conv, grouped conv, depthwise, deconv and FC
    weights: each carried into the layout its kernel reads, and the two
    dicts (the port's own quantize_weights and the carried one) give
    equal outputs."""
    for build in (grouped_net, deconv_net):
        js, ts, x = small_pair(build, seed=7)
        carried = ts.net.quant
        own = tq.quantize_weights(ts.net, ts.params)
        assert set(own) == set(carried["weights"])
        for node in ts.net.nodes:
            key = ts.net.tensors[node.src[1]].key if len(node.src) > 1 \
                else None
            if key not in own:
                continue
            a, b = own[key], carried["weights"][key]
            assert set(a) == set(b)
            for part in a:
                assert a[part].dtype == b[part].dtype
                assert a[part].stride() == b[part].stride(), (key, part)
                assert torch.equal(a[part], b[part]), (key, part)
            if node.type == LayerType.DEPTHWISE_CONV2D or (
                    node.type == LayerType.CONV2D
                    and node.param["num_groups"] > 1):
                assert a["q"].permute(2, 3, 0, 1).is_contiguous()
            elif node.type == LayerType.CONV2D:
                assert a["q"].is_contiguous(
                    memory_format=torch.channels_last)
            else:  # deconv and FC: the weight of K4's conv
                assert a["q"].is_contiguous(
                    memory_format=torch.channels_last)
        name = ts.net.tensors[ts.net.nodes[-1].dst[0]].name
        (g1,), _ = ts.predict_on_batch(x, outputs=[name])
        ts.net.quant = {**carried, "weights": own}
        (g2,), _ = ts.predict_on_batch(x, outputs=[name])
        assert torch.equal(g1, g2)


@pytest.mark.parametrize("stride,pad,k", [(2, 0, 3), (2, 1, 4), (1, 1, 3),
                                          (3, 2, 3)])
def test_int8_deconv_on_k4_equals_its_plain_version(stride, pad, k):
    """The deconv as K4's conv (dilated input, pad k-1-p, the turned
    weight) against `conv2d_transpose_int8` bit for bit, and both
    against bcnn_tpu's; pad > k - 1 crops."""
    from bcnn_tpu.ops.quant import conv2d_transpose_int8 as jconvt

    rng = np.random.RandomState(stride * 10 + pad)
    x = rng.randint(-127, 128, (2, 5, 6, 7)).astype(np.int8)
    w = rng.randint(-127, 128, (5, 3, k, k)).astype(np.int8)
    sw = rng.uniform(0.01, 0.02, 3).astype(np.float32)
    xt, wt, swt = map(torch.from_numpy, (x, w, sw))
    want = tq.conv2d_transpose_int8(xt, wt, 0.05, swt, stride, pad)
    ref = jconvt(jnp.asarray(x.transpose(0, 2, 3, 1)),
                 jnp.asarray(w.transpose(2, 3, 1, 0)), 0.05,
                 jnp.asarray(sw), stride, pad)
    np.testing.assert_array_equal(want.numpy(), nchw(ref))
    e = k - 1 - pad
    xd = tq.dilate_int8(xt.contiguous(memory_format=torch.channels_last),
                        stride)
    if e < 0:
        xd = xd[:, :, -e:xd.shape[2] + e, -e:xd.shape[3] + e]
    got = conv_int8_fused(xd, tq.deconv_k4_weight(wt), swt * 0.05,
                          torch.zeros(3), 1, max(e, 0))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_int8_fc_on_k4_equals_its_plain_version():
    """The FC as K4's 1x1 conv over the NHWC-flattened x, its rows put in
    that order (fc_k4_weight), against `fc_int8` on the NCHW-flattened x
    bit for bit, and that against bcnn_tpu's."""
    from bcnn_tpu.ops.quant import fc_int8 as jfc

    rng = np.random.RandomState(11)
    x = rng.randint(-127, 128, (3, 6, 4, 5)).astype(np.int8)
    w = rng.randint(-127, 128, (6 * 4 * 5, 9)).astype(np.int8)
    sw = rng.uniform(0.01, 0.02, 9).astype(np.float32)
    xt, wt, swt = map(torch.from_numpy, (x, w, sw))
    want = tq.fc_int8(xt.reshape(3, -1), wt, 0.05, swt)
    ref = jfc(jnp.asarray(x.reshape(3, -1)), jnp.asarray(w), 0.05,
              jnp.asarray(sw))
    np.testing.assert_array_equal(want.numpy(), np.asarray(ref))
    xcl = xt.contiguous(memory_format=torch.channels_last)
    got = conv_int8_fused(xcl.permute(0, 2, 3, 1).reshape(3, -1, 1, 1),
                          tq.fc_k4_weight(wt, 6, 4, 5), swt * 0.05,
                          torch.zeros(9), 1, 0)
    np.testing.assert_array_equal(got.reshape(3, 9).numpy(), want.numpy())


@pytest.mark.parametrize("groups,bn", [(2, False), (2, True), (4, False),
                                       (4, True), (8, False)])
def test_grouped_int8_plain_version_against_bcnn_tpu(groups, bn):
    """K5's plain version (the grouped sum, then K4's epilogue) against
    bcnn_tpu's conv2d_int8 with feature_group_count and the epilogue as
    separate jnp ops: within 1 LSB of the requantized output in fewer
    than 1e-4 of its entries (BN's rsqrt), the fp32 output within rtol
    1e-5."""
    from bcnn_tpu.ops.quant import conv2d_int8 as jconv

    rng = np.random.RandomState(groups + 10 * bn)
    c, o = 8, 8 if groups == 8 else 12
    x = rng.randint(-127, 128, (2, c, 7, 6)).astype(np.int8)
    w = rng.randint(-127, 128, (o, c // groups, 3, 3)).astype(np.int8)
    sw = rng.uniform(0.002, 0.004, o).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, o).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, o).astype(np.float32)
    mean = rng.uniform(-0.1, 0.1, o).astype(np.float32)
    var = rng.uniform(0.5, 1.5, o).astype(np.float32)
    y = jconv(jnp.asarray(x.transpose(0, 2, 3, 1)),
              jnp.asarray(w.transpose(2, 3, 1, 0)), 0.05, jnp.asarray(sw),
              1, 1, groups)
    if bn:
        y = (y - mean) * jnp.asarray(1 / np.sqrt(var.astype(np.float64)
                                                 + 1e-5), jnp.float32)
        y = y * scale + bias
    else:
        y = y + bias
    y = jnp.where(y > 0, y, 0.1 * y)
    vec = lambda a: torch.from_numpy(a)  # noqa: E731
    kw = {}
    if bn:
        vt = vec(var)
        kw = dict(scale=vec(scale), mean=vec(mean),
                  inv=torch.ones_like(vt) / torch.sqrt(vt + 1e-5))
    got = grouped_int8_fused(
        torch.from_numpy(x).contiguous(memory_format=torch.channels_last),
        torch.from_numpy(w), vec(sw) * 0.05, vec(bias), 1, 1, groups,
        Activation.LRELU, **kw)
    np.testing.assert_allclose(got.numpy(), nchw(y), rtol=1e-5, atol=1e-6)
    s = 0.02
    q = grouped_int8_fused(
        torch.from_numpy(x), torch.from_numpy(w), vec(sw) * 0.05, vec(bias),
        1, 1, groups, Activation.LRELU, s_out=s, **kw)
    jqv = np.asarray(jq.quantize_tensor(y, s)).astype(np.int32)
    d = np.abs(q.numpy().astype(np.int32) - nchw(jqv))
    assert d.max() <= 1 and (d > 0).mean() < 1e-4
