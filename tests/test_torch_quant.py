"""int8 PTQ in the port against bcnn_tpu.ops.quant on the CPU: weight
quantization, the watched tensors, the int8 flow plan, calibration, the
int32 conv sum, the int8 forward of YOLOv3-tiny layer by layer and end to
end, detection, and (each once a refusal) QAT in TRAIN and VALID and the
int8 depthwise, FC, grouped conv and deconv.

Every JAX quant dict crosses with bridge.quant_from_numpy, so both
packages quantize with identical scales. Tolerances:
  - int8 flow tensors, each layer fed bcnn_tpu's own input to it: within
    1 LSB. The sums are exact in both; the epilogue rounds alike except
    BN's 1/sqrt(var + eps), which the port takes as two correctly rounded
    ops where XLA takes rsqrt, so a value on a rounding boundary of
    y / s may land one code apart (2 of 294,912 at lid1, 96 px).
  - heads end to end: within 2^-5 of their largest value: one such LSB
    in an early layer moves the layers after it.
  - calibration: 1e-6 relative (the fp32 forwards differ in sum order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnn_tpu import Session as JaxSession
from bcnn_tpu.compile import execute as jax_execute
from bcnn_tpu.models import mobilenet_v1 as jax_mobilenet
from bcnn_tpu.models import yolov3_tiny as jax_tiny
from bcnn_tpu.ops import quant as jq
from bcnn_tpu.ops.yolo import device_detect_topk as jax_detect_topk
from bcnn_tpu.types import Mode as JaxMode

import bcnn_tpu as bt
from bcnn_tpu_torch import Session, bridge
from bcnn_tpu_torch import graph as tgraph
from bcnn_tpu_torch import types as ttypes
from bcnn_tpu_torch.compile import _Executor, execute
from bcnn_tpu_torch.models import mobilenet_v1, yolov3_tiny
from bcnn_tpu_torch.ops import quant as tq
from bcnn_tpu_torch.ops.conv_int8 import conv2d_int32
from bcnn_tpu_torch.ops.yolo import device_detect_topk
from bcnn_tpu_torch.types import Mode
from tests.test_torch_slice import bn_stats

torch.set_num_threads(1)

BATCH, SIZE, CLASSES = 2, 96, 4
HEAD_TOL = 2.0**-5
CAL_RTOL = 1e-6


def jax_to_port(js, net):
    ts = Session(net, 0, device="cpu")
    ts.params, ts.state = bridge.params_from_numpy(
        net,
        {k: np.asarray(v) for k, v in js.params.items()},
        {k: np.asarray(v) for k, v in js.state.items()},
    )
    return ts.compile_net()


def nchw(v):
    a = np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def to_torch(v):
    t = torch.from_numpy(np.ascontiguousarray(nchw(v)))
    return t.to(torch.bfloat16) if v.dtype == jnp.bfloat16 else t


def yolo_pair(bf16=False):
    """YOLOv3-tiny 96 px, batch 2, JAX weights, BN stats from a numpy
    seed, PTQ by bcnn_tpu's ptq_synthetic (bench.py's call), the quant
    dict carried to the port."""
    jnet = jax_tiny(BATCH, SIZE, SIZE, CLASSES, mode=JaxMode.PREDICT)
    net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES)
    if bf16:
        jnet.compute_dtype = jnet.act_dtype = jnp.bfloat16
        net.compute_dtype = net.act_dtype = torch.bfloat16
    js = JaxSession(jnet, 0).compile_net()
    js.state = {k: jnp.asarray(v)
                for k, v in bn_stats(jnet.state_specs()).items()}
    jq.ptq_synthetic(jnet, js)
    ts = jax_to_port(js, net)
    net.quant = bridge.quant_from_numpy(net, jnet.quant)
    x = np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(
        np.float32)
    return js, ts, x


@pytest.fixture(scope="module")
def pair():
    return yolo_pair()


@pytest.fixture(scope="module")
def bench_pair():
    return yolo_pair(bf16=True)


def branched(pkg):
    """tests/test_quant.py:213's net: t feeds a conv directly and a
    maxpool -> conv chain."""
    net = pkg.Net(pkg.Mode.PREDICT)
    net.set_input_shape(8, 8, 1, 2)
    A, F = pkg.Activation, pkg.FillerType
    net.add_convolutional_layer(4, 3, 1, 1, 1, 0, F.XAVIER, A.NONE, 0,
                                "input", "t")
    net.add_convolutional_layer(4, 3, 1, 1, 1, 0, F.XAVIER, A.NONE, 0, "t",
                                "direct")
    net.add_maxpool_layer(2, 2, pkg.Padding.VALID, "t", "pool")
    net.add_convolutional_layer(4, 3, 1, 1, 1, 0, F.XAVIER, A.NONE, 0,
                                "pool", "chained")
    return net


# -------------------------------------------------------- weights, plan #


@pytest.mark.parametrize("which", ["yolo", "mobilenet", "branched"])
def test_quantize_weights_bit_equal(which):
    if which == "yolo":
        jnet, net = (jax_tiny(1, 64, 64, 3, mode=JaxMode.PREDICT),
                     yolov3_tiny(1, 64, 64, 3))
    elif which == "mobilenet":
        jnet = jax_mobilenet(1, 10, JaxMode.PREDICT, width_mult=0.25)
        net = mobilenet_v1(1, 10, Mode.PREDICT, width_mult=0.25)
    else:
        jnet, net = branched(bt), branched(tgraph_pkg())
    js = JaxSession(jnet, 3).compile_net()
    ts = jax_to_port(js, net)
    want = jq.quantize_weights(jnet, js.params)
    got = tq.quantize_weights(net, ts.params)
    assert set(got) == set(want) and got
    conv_w = bridge._conv_weight_keys(net)
    carried = bridge.quant_from_numpy(
        net, {"act_scales": {}, "weights": want})["weights"]
    fc_in = {net.tensors[n.src[1]].key: net.tensors[n.src[0]]
             for n in net.nodes if n.type == ttypes.LayerType.FULL_CONNECTED}
    for k, w in want.items():
        q = np.asarray(w["q"])
        if k in conv_w:
            q = q.transpose(3, 2, 0, 1)
        elif k in fc_in:  # K4's 1x1 conv: (out, in), in in (h, w, c) order
            t = fc_in[k]
            q = q.reshape(t.c, t.h, t.w, -1).transpose(3, 1, 2, 0).reshape(
                q.shape[1], -1, 1, 1)
        assert got[k]["q"].dtype == torch.int8
        assert torch.equal(got[k]["q"], carried[k]["q"])
        np.testing.assert_array_equal(got[k]["q"].numpy(), q)
        np.testing.assert_array_equal(got[k]["scale"].numpy(),
                                      np.asarray(w["scale"]))


def tgraph_pkg():
    """The port's builders under bcnn_tpu's names, for `branched`."""
    class P:
        Net, Mode, Activation = tgraph.Net, ttypes.Mode, ttypes.Activation
        FillerType, Padding = ttypes.FillerType, ttypes.Padding
    return P


@pytest.mark.parametrize("joiners", [True, False])
def test_watch_and_plan_equal_for_yolo(pair, joiners):
    js, ts, _ = pair
    assert tq.watch_tensors(ts.net) == jq.watch_tensors(js.net)
    jquant = {**js.net.quant, "flow_joiners": joiners}
    tquant = {**ts.net.quant, "flow_joiners": joiners}
    plan = tq.plan_int8_flow(ts.net, tquant)
    assert plan == jq.plan_int8_flow(js.net, jquant)
    assert len(plan) >= 10


@pytest.mark.parametrize("flip", [False, True])
def test_watch_and_plan_equal_for_the_branched_net(flip):
    """The fan-out tensor t stays out of the plan where its maxpool chain
    wants another scale than its direct consumer (flip: t's extreme
    negative, so the pool calibrates smaller)."""
    jnet, net = branched(bt), branched(tgraph_pkg())
    js = JaxSession(jnet, 3).compile_net()
    if flip:
        for k in ("input_w", "input_b"):
            js.params[k] = -js.params[k]
    ts = jax_to_port(js, net)
    calib = np.random.RandomState(0).rand(2, 1, 8, 8).astype(np.float32)
    scales = jq.calibrate(jnet, js.params, js.state, [calib])
    jquant = {"act_scales": scales,
              "weights": jq.quantize_weights(jnet, js.params)}
    tquant = bridge.quant_from_numpy(net, jquant)
    assert tq.watch_tensors(net) == jq.watch_tensors(jnet)
    for joiners in (True, False):
        for flow_pass in (True, False):
            opts = {"flow_joiners": joiners, "flow_pass": flow_pass}
            assert tq.plan_int8_flow(net, {**tquant, **opts}) == (
                jq.plan_int8_flow(jnet, {**jquant, **opts}))


def test_kl_threshold_equal():
    rng = np.random.RandomState(0)
    for hist in (rng.poisson(50, 2048), np.abs(rng.randn(300000) * 30)):
        if hist.dtype != np.int64:
            hist = np.histogram(hist, 2048, (0, hist.max()))[0]
        assert tq._kl_threshold(hist) == jq._kl_threshold(hist)


@pytest.mark.parametrize("method,pct,rtol", [
    ("absmax", None, CAL_RTOL), ("kl", None, CAL_RTOL),
    # XLA's CPU division makes q = 99.9 / 100 one fp32 ulp below 0.999
    # (0.99899995; the port divides exactly): the interpolation position
    # moves by one ulp of q * (n - 1), the value by that share of the gap
    # between the two order statistics: 7.3e-6 at one tensor here, the
    # rest within 5e-7
    ("percentile", 99.9, 1e-5),
])
def test_calibrate_matches_bcnn_tpu(method, pct, rtol):
    jnet = jax_tiny(1, 64, 64, 3, mode=JaxMode.PREDICT)
    net = yolov3_tiny(1, 64, 64, 3)
    js = JaxSession(jnet, 0).compile_net()
    js.state = {k: jnp.asarray(v)
                for k, v in bn_stats(jnet.state_specs()).items()}
    ts = jax_to_port(js, net)
    rng = np.random.RandomState(2)
    batches = [rng.rand(1, 3, 64, 64).astype(np.float32) for _ in range(2)]
    kw = dict(method=method, kl_bins=256)
    if pct is not None:
        kw["percentile"] = pct
    want = jq.calibrate(jnet, js.params, js.state, batches, **kw)
    got = tq.calibrate(net, ts.params, ts.state, batches, **kw)
    assert sorted(got) == sorted(want)
    for i in want:
        assert isinstance(got[i], float)
        np.testing.assert_allclose(got[i], want[i], rtol=rtol, atol=0)


# ------------------------------------------------------------ the conv #


@pytest.mark.parametrize("n", [7, 1000, 4096, 65536])
def test_percentile_as_jnp_takes_it(n):
    """On one array: at p = 50 the position is exact in both, and the
    values agree to the rounding of the weighted sum (1e-6); at 99.9
    within XLA's one ulp of q (above)."""
    v = np.abs(np.random.RandomState(n).randn(n)).astype(np.float32)
    np.testing.assert_allclose(tq._percentile(v, 50.0),
                               float(jnp.percentile(v, 50.0)), rtol=CAL_RTOL)
    np.testing.assert_allclose(tq._percentile(v, 99.9),
                               float(jnp.percentile(v, 99.9)), rtol=1e-5)


@pytest.mark.parametrize("c,o,k,stride,pad,groups", [
    (3, 5, 3, 1, 1, 1), (8, 6, 3, 2, 1, 1), (6, 6, 3, 1, 1, 6),
    (512, 7, 3, 1, 1, 1),  # K = 4,608: |acc| beyond 2^24, exact in both
])
def test_conv2d_int8_sum_is_exact(c, o, k, stride, pad, groups):
    rng = np.random.RandomState(c + o)
    x = rng.randint(-127, 128, (2, 9, 11, c)).astype(np.int8)
    w = np.full((k, k, c // groups, o), 127, np.int8)
    w[..., 1:] = rng.randint(-127, 128, w[..., 1:].shape)
    x[0] = 127  # one image of extremes: a sum of 127^2 K
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32)
    got = conv2d_int32(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                       torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                       stride, pad, groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), nchw(want))
    # and dequantized as bcnn_tpu does: fp32(acc) * (fp32(sx) * w_scale)
    ws = rng.uniform(1e-3, 1e-2, o).astype(np.float32)
    deq = jq.conv2d_int8(jnp.asarray(x), jnp.asarray(w), 0.037,
                         jnp.asarray(ws), stride, pad, groups)
    tdeq = tq.conv2d_int8(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                          torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                          0.037, torch.from_numpy(ws), stride, pad, groups)
    np.testing.assert_array_equal(tdeq.numpy(), nchw(deq))


def test_quantize_tensor_divides_and_rounds_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0, 0.3])
    np.testing.assert_array_equal(tq.quantize_tensor(x, 1.0).numpy(),
                                  [0, 2, 2, 0, -2, 127, -127, 0])
    v = np.random.RandomState(0).randn(4096).astype(np.float32)
    for s in (0.0123, 1 / 3, 0.7):
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            want = jq.quantize_tensor(jnp.asarray(v).astype(jdt), s)
            got = tq.quantize_tensor(torch.from_numpy(v).to(dt), s)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------- the int8 path #


def test_int8_flow_tensors_within_one_lsb_layer_by_layer(pair):
    """Each node of the port fed bcnn_tpu's own inputs to it: every int8
    flow tensor within 1 LSB of bcnn_tpu's, every other output within
    fp32 rounding."""
    js, ts, x = pair
    jex = jax_execute(js.net, js.params, js.state, {"input": jnp.asarray(x)},
                      JaxMode.PREDICT, None)
    ex = _Executor(ts.net, ts.params, ts.state, Mode.PREDICT)
    assert ex.int8_flow == jex.int8_flow and len(ex.int8_flow) >= 10
    n_int8 = 0
    for node in ts.net.nodes:
        for s in node.src:
            if ts.net.tensors[s].key is None:
                ex.values[s] = to_torch(jex.values[s])
        getattr(ex, f"_{node.type.name.lower()}")(node)
        got, want = ex.values[node.dst[0]], jex.values[node.dst[0]]
        name = ts.net.tensors[node.dst[0]].name
        if want.dtype == jnp.int8:
            n_int8 += 1
            assert got.dtype == torch.int8, name
            d = np.abs(got.numpy().astype(np.int32) - nchw(want))
            assert d.max() <= 1, name
            assert (d > 0).mean() < 1e-4, name
        else:
            np.testing.assert_allclose(got.float().numpy(), nchw(want),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    assert n_int8 == len(ex.int8_flow)


def test_int8_heads_end_to_end(pair):
    js, ts, x = pair
    names = ["lid16", "lid23", "lid17", "lid24"]
    ref, _ = js.predict_on_batch(x, outputs=names)
    out, _ = ts.predict_on_batch(x, outputs=names)
    for name, o, r in zip(names, out, ref):
        o, r = o.float().numpy(), np.asarray(r, np.float32)
        assert o.shape == r.shape and r.std() > 0.02, name
        assert np.abs(o - r).max() <= HEAD_TOL * np.abs(r).max(), name


def test_output_value_dequantizes_int8_flow_tensors(pair):
    js, ts, x = pair
    (lid1,), _ = ts.predict_on_batch(x, outputs=["lid1"])
    (ref,), _ = js.predict_on_batch(x, outputs=["lid1"])
    assert lid1.dtype == torch.float32
    s = ts.net.quant["act_scales"][ts.net.get_tensor_index_by_name("lid2")]
    assert np.abs(lid1.numpy() - np.asarray(ref)).max() <= s * 1.0001


def test_detect_is_equal_on_equal_heads(pair):
    """Both packages' top-k-first detection tails on bcnn_tpu's own int8
    heads: the same slots and values to fp32 rounding."""
    js, ts, x = pair
    jex = jax_execute(js.net, js.params, js.state, {"input": jnp.asarray(x)},
                      JaxMode.PREDICT, None)
    nodes = [n for n in ts.net.nodes if n.type.name == "YOLOV3"]
    params = [dict(n.param) for n in nodes]
    want = jax_detect_topk([jex.values[n.src[0]] for n in nodes], params,
                           SIZE, SIZE, max_dets=20, thresh=0.3)
    got = device_detect_topk([to_torch(jex.values[n.src[0]]) for n in nodes],
                             params, SIZE, SIZE, max_dets=20, thresh=0.3)
    assert (np.asarray(want[2]) > 0).sum() > 0
    np.testing.assert_array_equal(got[2].numpy() > 0, np.asarray(want[2]) > 0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_bench_config_heads_and_detections_equal(bench_pair):
    """bench.py's int8 program (bf16 compute and storage + PTQ): the raw
    heads come out bit-equal to bcnn_tpu's here, and so do the kept
    slots, objectness and scores; boxes within one bf16 rounding (XLA
    takes the exp of the bf16 box logits without rounding it to bf16)."""
    js, ts, x = bench_pair
    ref, _ = js.predict_on_batch(x, outputs=["lid16", "lid23"])
    out, _ = ts.predict_on_batch(x, outputs=["lid16", "lid23"])
    for o, r in zip(out, ref):
        assert o.dtype == torch.bfloat16
        np.testing.assert_array_equal(o.float().numpy(),
                                      np.asarray(r, np.float32))
    want = js.detect_on_batch(x, 0.3, 20)
    got = ts.detect_on_batch(x, 0.3, 20)
    np.testing.assert_array_equal(got[2].float().numpy(),
                                  np.asarray(want[2], np.float32))
    np.testing.assert_array_equal(got[1].float().numpy(),
                                  np.asarray(want[1], np.float32))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2.0**-7, atol=2.0**-9)


def test_act_flow_on_and_off_bit_identical(pair):
    """tests/test_quant.py:93-138 in the port: with flow_joiners off, the
    int8 flow (producers emit int8, pass-through ops carry it) equals
    quantize-at-every-consumer bit for bit, and covers the backbone."""
    _, ts, x = pair
    base = dict(ts.net.quant)
    outs = {}
    try:
        for flow in (False, True):
            ts.net.quant = {**base, "act_flow": flow, "flow_joiners": False}
            outs[flow], _ = ts.predict_on_batch(x, outputs=["lid17", "lid24"])
        plan = tq.plan_int8_flow(ts.net, ts.net.quant)
        with torch.inference_mode():
            ex = execute(ts.net, ts.params, ts.state,
                         {"input": torch.from_numpy(x)}, Mode.PREDICT)
    finally:
        ts.net.quant = base
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a, b)
    assert len(plan) >= 10
    assert sum(v.dtype == torch.int8 for v in ex.values.values()) >= 10


def test_ptq_synthetic_matches_bcnn_tpu():
    """The port's ptq_synthetic on the same weights and BN stats: run_var
    reset to 1, the same calibration batch, equal int8 weights and act
    scales within CAL_RTOL."""
    jnet = jax_tiny(1, 64, 64, 3, mode=JaxMode.PREDICT)
    net = yolov3_tiny(1, 64, 64, 3)
    js = JaxSession(jnet, 0).compile_net()
    ts = jax_to_port(js, net)
    want = jq.ptq_synthetic(jnet, js)
    got = tq.ptq_synthetic(net, ts)
    assert net.quant is got
    assert all(bool((v == 1).all()) for k, v in ts.state.items()
               if "run_var" in k)
    assert sorted(got["act_scales"]) == sorted(want["act_scales"])
    for i, s in want["act_scales"].items():
        np.testing.assert_allclose(got["act_scales"][i], s, rtol=CAL_RTOL)
    assert set(got["weights"]) == set(want["weights"])


def test_quant_from_numpy_carries_the_dict(pair):
    js, ts, _ = pair
    q = ts.net.quant
    assert q["act_scales"] == {int(k): float(v)
                               for k, v in js.net.quant["act_scales"].items()}
    k = ts.net.tensors[ts.net.nodes[0].src[1]].key
    assert q["weights"][k]["q"].shape == (16, 3, 3, 3)
    assert q["weights"][k]["q"].dtype == torch.int8
    opts = {"act_flow": False, "flow_pass": True, "flow_joiners": False}
    q2 = bridge.quant_from_numpy(ts.net, {**js.net.quant, **opts})
    assert all(q2[key] == v for key, v in opts.items())


# ------------------------------- training attributes, int8 layers left #


def _small_train_net(layer, pkg=tgraph, dtype=torch.bfloat16, qat=None):
    """A TRAIN net of one FC or depthwise layer with compute_dtype (or
    net.qat), in the port (pkg = its graph module) or in bcnn_tpu
    (bt)."""
    net = pkg.Net(Mode.TRAIN)
    net.set_input_shape(6, 6, 2, 2)
    if layer == "FULL_CONNECTED":
        net.add_fullc_layer(3, ttypes.FillerType.XAVIER,
                            ttypes.Activation.NONE, 0, "input", "f")
    else:
        net.add_depthwise_conv_layer(3, 1, 1, 0, ttypes.FillerType.XAVIER,
                                     ttypes.Activation.RELU, "input", "d")
    net.compute_dtype = dtype
    if qat is not None:
        net.qat = qat
    return net


@pytest.mark.parametrize("case", [
    "qat", "compute_dtype FULL_CONNECTED", "compute_dtype DEPTHWISE_CONV2D",
    "train_scan_on_batches", "train_scan_resident_on_batches"])
def test_unported_training_attributes_raise(case):
    """What the port refused in training: net.qat, refused before, runs
    since: an FC layer under QAT in TRAIN, its output, gradients and
    tracked range against bcnn_tpu's (fp32: the output and gradients
    within 1e-5 of their largest entry, the range at rtol 1e-6). In
    Session's scans over the data loader, the step forms they do not run
    (remat), and the resident scan without device_augment (its records
    are raw uint8), still raise. compute_dtype in TRAIN on FC and
    depthwise, refused before, runs since: the layer's output and its
    gradients against bcnn_tpu's (forward rtol 1e-5 of the largest;
    gradients within 2^-7 of the largest, one bf16 rounding;
    tests/test_torch_layers_left.py holds the roundings themselves)."""
    if case == "qat" or case.startswith("compute_dtype"):
        if case == "qat":
            layer, tol = "FULL_CONNECTED", 1e-5
            net = _small_train_net(layer, dtype=None, qat=True)
            jnet = _small_train_net(layer, bt, None, qat=True)
        else:
            layer, tol = case.split()[1], 2.0**-7
            net = _small_train_net(layer)
            jnet = _small_train_net(layer, bt, jnp.bfloat16)
        sess = Session(net, 0, device="cpu").compile_net()
        rng = np.random.RandomState(len(layer))
        x = rng.randn(2, 2, 6, 6).astype(np.float32)
        out = net.tensors[net.nodes[0].dst[0]]
        g = rng.randn(2, out.c, out.h, out.w).astype(np.float32)
        leaves = {k: v.detach().requires_grad_() for k, v in
                  sess.params.items()}
        ex = execute(net, leaves, sess.state,
                     {"input": torch.from_numpy(x)}, Mode.TRAIN)
        y = ex.values[net.nodes[0].dst[0]]
        (y * torch.from_numpy(g)).sum().backward()
        p_np = bridge.params_to_numpy(net, sess.params)
        s_np = {k: np.asarray(v) for k, v in sess.state.items()}

        def jfn(p):
            jex = jax_execute(jnet, p, {k: jnp.asarray(v)
                                        for k, v in s_np.items()},
                              {"input": jnp.asarray(x)}, JaxMode.TRAIN)
            v = jex.values[jnet.nodes[0].dst[0]]
            return v, jnp.sum(v * jnp.transpose(jnp.asarray(g),
                                                (0, 2, 3, 1))), jex.state

        jp = {k: jnp.asarray(v) for k, v in p_np.items()}
        jg = jax.grad(lambda p: jfn(p)[1])(jp)
        jv, _, jstate = jfn(jp)
        jy = np.asarray(jv, np.float32)
        if jy.ndim == 4:
            jy = np.transpose(jy, (0, 3, 1, 2))
        np.testing.assert_allclose(y.detach().float().numpy(),
                                   jy.reshape(y.shape), rtol=0,
                                   atol=1e-5 * np.abs(jy).max())
        got = bridge.params_to_numpy(
            net, {k: v.grad for k, v in leaves.items()})
        for k, v in got.items():
            r = np.asarray(jg[k], np.float32)
            assert v.dtype == np.float32 and np.abs(r).max() > 0, k
            np.testing.assert_allclose(v, r, rtol=0,
                                       atol=tol * np.abs(r).max(),
                                       err_msg=k)
        qat_keys = [k for k in jstate if k.startswith("qat_amax/")]
        assert len(qat_keys) == (1 if case == "qat" else 0)
        for k in qat_keys:
            assert float(ex.state[k]) > 0
            np.testing.assert_allclose(float(ex.state[k]),
                                       float(jstate[k]), rtol=1e-6)
        # inference runs
        with torch.no_grad():
            execute(net, sess.params, sess.state,
                    {"input": torch.zeros(2, 2, 6, 6)}, Mode.VALID)
    else:
        net = yolov3_tiny(1, 64, 64, 2, mode=Mode.TRAIN)
        net.remat = True
        sess = Session(net, 0, device="cpu").compile_net()
        match = ("remat" if case == "train_scan_on_batches"
                 else "device_augment")
        with pytest.raises(ValueError, match=match):
            getattr(sess, case)(2)


def test_qat_raises_in_valid_mode():
    """net.qat in VALID, refused before, runs: YOLOv3-tiny at 64 px with
    {"ema": 0.9} and no training yet (each range the batch's own
    abs-max), the heads and the loss of predict_on_batch against
    bcnn_tpu's (rtol 1e-4, HEAD_TOL of the largest head value: a
    fake-quant code at a rounding boundary may land one apart)."""
    jnet = jax_tiny(1, 64, 64, 2, mode=JaxMode.TRAIN)
    net = yolov3_tiny(1, 64, 64, 2, mode=Mode.TRAIN)
    for n in (jnet, net):
        n.qat = {"ema": 0.9}
    js = JaxSession(jnet, 0).compile_net()
    sess = jax_to_port(js, net)
    x = np.random.RandomState(2).rand(1, 3, 64, 64).astype(np.float32)
    lab = np.zeros((1, 250), np.float32)
    lab[:, :5] = [0.5, 0.5, 0.3, 0.4, 1]
    names = ["lid16", "lid23"]
    want, wloss = js.predict_on_batch(x, lab, outputs=names)
    got, loss = sess.predict_on_batch(x, lab, outputs=names)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        assert np.abs(g.numpy() - w).max() <= HEAD_TOL * np.abs(w).max()
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-4)
    assert all(float(v) == 0 for k, v in sess.state.items()
               if k.startswith("qat_amax/"))  # VALID reads, never writes


def _int8_pair(jnet, net, keep, x):
    """bcnn_tpu's session and the port's on its weights (BN stats from a
    numpy seed), the layers of type `keep` quantized by bcnn_tpu's
    quantize_weights with act scale 0.1, the dict carried across."""
    js = JaxSession(jnet, 0).compile_net()
    js.state = {k: jnp.asarray(v)
                for k, v in bn_stats(jnet.state_specs()).items()}
    ts = jax_to_port(js, net)
    keys = {net.tensors[n.src[1]].key: n.src[0] for n in net.nodes
            if n.type in keep}
    w = jq.quantize_weights(jnet, js.params)
    jnet.quant = {"act_scales": {i: 0.1 for i in keys.values()},
                  "weights": {k: w[k] for k in keys}}
    net.quant = bridge.quant_from_numpy(net, jnet.quant)
    return js, ts


def _same_output(js, ts, x, name, tol=HEAD_TOL):
    (want,), _ = js.predict_on_batch(x, outputs=[name])
    (got,), _ = ts.predict_on_batch(x, outputs=[name])
    want = np.asarray(want)
    if want.ndim == 4 and got.dim() == 4 and want.shape[1:] != tuple(
            got.shape[1:]):
        want = nchw(want)
    assert np.abs(want).max() > 0
    assert np.abs(got.numpy() - want.reshape(got.shape)).max() <= (
        tol * np.abs(want).max())


@pytest.mark.parametrize("kind", ["depthwise", "fc"])
def test_quantized_depthwise_and_fc_raise(kind):
    """A quantized depthwise layer or FC, refused before, runs (K5, K4
    on the card): MobileNet-v1 at width 0.25 with only that kind
    quantized, its softmax against bcnn_tpu's within HEAD_TOL of the
    largest."""
    jnet = jax_mobilenet(1, 10, JaxMode.PREDICT, width_mult=0.25)
    net = mobilenet_v1(1, 10, Mode.PREDICT, width_mult=0.25)
    want = {"depthwise": ttypes.LayerType.DEPTHWISE_CONV2D,
            "fc": ttypes.LayerType.FULL_CONNECTED}[kind]
    x = np.random.RandomState(4).rand(1, 3, 224, 224).astype(np.float32)
    js, ts = _int8_pair(jnet, net, (want,), x)
    assert len(net.quant["weights"]) == (13 if kind == "depthwise" else 1)
    _same_output(js, ts, x, "softmax")


def _one_layer(pkg, deconv=False, groups=1):
    net = pkg.Net(pkg.Mode.PREDICT)
    net.set_input_shape(8, 8, 4, 1)
    A, F = pkg.Activation, pkg.FillerType
    if deconv:
        net.add_deconvolutional_layer(4, 3, 2, 1, F.XAVIER, A.NONE,
                                      "input", "d")
    else:
        net.add_convolutional_layer(4, 3, 1, 1, groups, 0, F.XAVIER, A.NONE,
                                    0, "input", "g")
    return net


def test_quantized_grouped_conv_raises():
    """A quantized CONV2D with 2 groups, refused before, runs (K5 on
    the card): its output against bcnn_tpu's within 1e-5 of the
    largest (one int8 sum, the same rounding)."""
    x = np.random.RandomState(5).rand(1, 4, 8, 8).astype(np.float32)
    js, ts = _int8_pair(_one_layer(bt, groups=2),
                        _one_layer(tgraph, groups=2),
                        (ttypes.LayerType.CONV2D,), x)
    assert ts.net.nodes[0].param["num_groups"] == 2
    _same_output(js, ts, x, "g", 1e-5)


def test_quantized_deconv_raises():
    """A quantized TRANSPOSE_CONV2D (stride 2, pad 1), refused before,
    runs as the conv K4 computes for it: its output against bcnn_tpu's
    within 1e-5 of the largest."""
    x = np.random.RandomState(6).rand(1, 4, 8, 8).astype(np.float32)
    js, ts = _int8_pair(_one_layer(bt, deconv=True),
                        _one_layer(tgraph, deconv=True),
                        (ttypes.LayerType.TRANSPOSE_CONV2D,), x)
    _same_output(js, ts, x, "d", 1e-5)
