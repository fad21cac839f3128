"""The MobileNet-v1 classification slice: its graph, its ops and the
whole PREDICT forward through bcnn_tpu and through the port, on the
same numpy-seeded inputs and weights, on the CPU. JAX works in
NHWC/HWIO, the port in NCHW/OIHW; the tests transpose at the boundary.

Weights come from `bridge.he_numpy_weights` (He-normal convs, depthwise
and FC, U(-0.1, 0.1) biases, BN scales U(0.8, 1.2), run_var U(0.5, 1.5),
run_mean U(-0.1, 0.1)): the nets' own XAVIER fillers make MobileNet-v1's
logits about 1e-17, and any tolerance would pass on those.

Tolerances: the depthwise kernel's plain version against the Pallas
kernel in interpret mode at atol 1e-4, the tolerance
tests/test_dw_pallas.py sets for it; the layer ops at rtol 1e-5, atol
1e-5 (sums taken in another order); the whole net at rtol 1e-4, atol
1e-4, the repo's fp32 tolerance."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnn_tpu import Session as JaxSession
from bcnn_tpu import ops as jops
from bcnn_tpu.models import mobilenet_v1 as jax_mobilenet
from bcnn_tpu.ops.dw_pallas import depthwise_fused as jax_depthwise_fused
from bcnn_tpu.types import Mode as JaxMode

from bcnn_tpu_torch import Session, bridge, ops
from bcnn_tpu_torch.models import mobilenet_v1
from bcnn_tpu_torch.ops import library
from bcnn_tpu_torch.ops.depthwise import depthwise_fused, depthwise_fused_ref
from bcnn_tpu_torch.types import Activation, LayerType, Mode

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5
NET_RTOL, NET_ATOL = 1e-4, 1e-4
PALLAS_ATOL = 1e-4  # tests/test_dw_pallas.py:56


def nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def nhwc(a):
    return np.transpose(np.asarray(a), (0, 2, 3, 1))


def hwio_dw(w_c1kk):
    """(C, 1, k, k) -> (k, k, 1, C)."""
    return np.transpose(w_c1kk, (2, 3, 1, 0))


# ---------------------------------------------------------------- graph #


HWIO_TYPES = (LayerType.CONV2D, LayerType.DEPTHWISE_CONV2D)
OPT_FIELDS = ("trainable", "weight_decay", "adam_capable", "batch_div_one",
              "grad_div_batch")


@pytest.mark.parametrize(
    "batch,classes,width", [(1, 1000, 1.0), (2, 10, 0.25), (64, 1000, 1.0)]
)
def test_mobilenet_graph_matches_bcnn_tpu(batch, classes, width):
    ref = jax_mobilenet(batch, classes, JaxMode.PREDICT, width_mult=width)
    port = mobilenet_v1(batch, classes, Mode.PREDICT, width_mult=width)
    hwio = {port.tensors[n.src[1]].key for n in port.nodes
            if n.type in HWIO_TYPES}
    assert len(port.tensors) == len(ref.tensors)
    for r, p in zip(ref.tensors, port.tensors):
        assert (p.name, p.key, int(p.kind), p.shape) == (
            r.name, r.key, int(r.kind), r.shape
        )
        if p.key in hwio:  # HWIO there, OIHW here
            kh, kw, ci, co = r.mem_shape
            assert p.mem_shape == (co, ci, kh, kw)
        else:
            assert p.mem_shape == r.mem_shape
        if r.filler is None:
            assert p.filler is None
        else:
            assert (int(p.filler.type), p.filler.range, p.filler.value) == (
                int(r.filler.type), r.filler.range, r.filler.value
            )
        assert [getattr(p, f) for f in OPT_FIELDS] == [
            getattr(r, f) for f in OPT_FIELDS
        ], p.name
    assert len(port.nodes) == len(ref.nodes)
    for r, p in zip(ref.nodes, port.nodes):
        assert (int(p.type), p.src, p.dst) == (int(r.type), r.src, r.dst)
        assert p.param == r.param
    dws = [n for n in port.nodes if n.type == LayerType.DEPTHWISE_CONV2D]
    assert len(dws) == 13
    # keys are named after the source tensor
    assert port.tensors[dws[0].src[1]].key == "conv1_w"
    assert port.tensors[port.nodes[2].src[1]].key == "dw1_w"
    fc = port.tensors[port.nodes[-2].src[1]]
    assert fc.mem_shape == (max(8, int(1024 * width)), classes)


def test_mobilenet_is_predict_only():
    """Outside PREDICT the net ends in bcnn_tpu's cost layer (euclidean,
    ERROR_RATE) and trains with its SGD; the cost and its TRAIN and
    VALID modes are held to bcnn_tpu in tests/test_torch_losses.py."""
    for mode in (Mode.TRAIN, Mode.VALID):
        port = mobilenet_v1(1, 10, mode)
        ref = jax_mobilenet(1, 10, JaxMode(int(mode)))
        assert len(port.nodes) == len(ref.nodes)
        cost, rcost = port.nodes[-1], ref.nodes[-1]
        assert cost.type == LayerType.COST
        assert (cost.src, cost.dst) == (rcost.src, rcost.dst)
        assert cost.param == rcost.param
        assert (port.learner.base_learning_rate, port.learner.momentum) == (
            ref.learner.base_learning_rate, ref.learner.momentum) == (
            0.01, 0.9)
    assert mobilenet_v1(1, 10).nodes[-1].type == LayerType.SOFTMAX


def test_he_numpy_weights():
    net = mobilenet_v1(1, 10, width_mult=0.25)
    p, s = bridge.he_numpy_weights(net, 3)
    p2, _ = bridge.he_numpy_weights(net, 3)
    assert set(p) == {t.key for t in net.param_specs()}
    assert set(s) == {t.key for t in net.state_specs()}
    assert all(np.array_equal(v, p2[k]) for k, v in p.items())
    w = p["dw13_w"]  # pw13's 1x1 weight, HWIO (1, 1, 256, 256)
    assert w.shape == (1, 1, 256, 256)
    assert abs(w.std() - np.sqrt(2 / 256)) < 0.05 * np.sqrt(2 / 256)
    dw = p["pw12_w"]  # dw13's weight, (3, 3, 1, 256)
    assert dw.shape == (3, 3, 1, 256)
    assert abs(dw.std() - np.sqrt(2 / 9)) < 0.05 * np.sqrt(2 / 9)
    assert p["avgpool_w"].shape == (256, 10)
    assert 0.5 <= s["dw1_run_var"].min() and s["dw1_run_var"].max() <= 1.5
    assert 0.8 <= p["dw1_scales"].min() and p["dw1_scales"].max() <= 1.2


def test_bridge_round_trips_depthwise_and_fc_weights():
    net = mobilenet_v1(1, 10, width_mult=0.25)
    p, s = bridge.he_numpy_weights(net, 0)
    tp, _ = bridge.params_from_numpy(net, p, s)
    assert tuple(tp["conv1_w"].shape) == (8, 1, 3, 3)
    np.testing.assert_array_equal(
        tp["conv1_w"].numpy(), np.transpose(p["conv1_w"], (3, 2, 0, 1))
    )
    np.testing.assert_array_equal(tp["avgpool_w"].numpy(), p["avgpool_w"])
    back = bridge.params_to_numpy(net, tp)
    for k, v in p.items():
        np.testing.assert_array_equal(back[k], v)


# ------------------------------------------------------------ depthwise #


@pytest.mark.parametrize(
    "h,w,c,k,stride,act",
    [  # tests/test_dw_pallas.py:31-41
        (15, 13, 128, 3, 1, Activation.RELU),
        (15, 13, 128, 3, 2, Activation.LRELU),
        (7, 7, 1024, 3, 1, Activation.CLAMP),
    ],
)
def test_depthwise_ref_matches_pallas_interpret(h, w, c, k, stride, act):
    rng = np.random.default_rng(h * w + c + k + stride)
    pad = k // 2
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((k, k, 1, c)) * 0.1).astype(np.float32)
    b = rng.standard_normal((c,)).astype(np.float32)
    ref = jax_depthwise_fused(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), stride, pad, act,
        interpret=True,
    )
    got = depthwise_fused_ref(
        torch.from_numpy(nchw(x).copy()),
        torch.from_numpy(np.transpose(wt, (3, 2, 0, 1)).copy()),
        torch.from_numpy(b), stride, pad, act,
    )
    assert tuple(got.shape) == nchw(ref).shape
    np.testing.assert_allclose(got.numpy(), nchw(ref), atol=PALLAS_ATOL)


DW_CASES = [
    # (c, h, w, k, stride, pad, act): MobileNet's C = 32 and 64, which the
    # TPU kernel's gate refused, pad 0, k = 5, stride 3, every activation
    (32, 16, 16, 3, 1, 1, Activation.RELU),
    (64, 15, 13, 3, 2, 1, Activation.LRELU),
    (32, 15, 13, 5, 3, 0, Activation.CLAMP),
    (64, 9, 11, 5, 1, 0, Activation.NONE),
    (3, 10, 7, 3, 1, 1, Activation.TANH),
    (5, 8, 8, 1, 2, 0, Activation.SOFTPLUS),
]


@pytest.mark.parametrize("c,h,w,k,stride,pad,act", DW_CASES)
def test_depthwise_ref_matches_bcnn_tpu(c, h, w, k, stride, pad, act):
    rng = np.random.RandomState(c + h + k + stride)
    x = rng.randn(2, c, h, w).astype(np.float32)
    wt = (rng.randn(c, 1, k, k) * 0.3).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    ref = jops.apply_activation(
        jops.depthwise_conv2d(
            jnp.asarray(nhwc(x)), jnp.asarray(hwio_dw(wt)), stride, pad
        ) + jnp.asarray(b),
        act,
    )
    args = (torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b),
            stride, pad, act)
    before = library.launches("depthwise")
    got = depthwise_fused(*args)  # CPU tensors: the plain version
    assert library.launches("depthwise") == before
    assert torch.equal(got, depthwise_fused_ref(*args))
    np.testing.assert_allclose(got.numpy(), nchw(ref), rtol=RTOL, atol=ATOL)


def test_depthwise_keeps_autograd_on_cpu_and_refuses_mixed_devices():
    x = torch.randn(1, 4, 6, 6)
    w = torch.randn(4, 1, 3, 3, requires_grad=True)
    b = torch.zeros(4)
    # on the CPU the plain version records the graph
    y = depthwise_fused(x, w, b, 1, 1, Activation.RELU)
    y.sum().backward()
    assert w.grad is not None and w.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="devices"):
        depthwise_fused(x.to("meta"), w.detach(), b, 1, 1)


# ------------------------------------------------- avgpool, FC, softmax #


def test_global_avgpool():
    x = np.random.RandomState(0).randn(2, 6, 5, 7).astype(np.float32)
    ref = jops.global_avgpool(jnp.asarray(nhwc(x)))
    got = ops.global_avgpool(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 6, 1, 1)
    np.testing.assert_allclose(got.numpy(), nchw(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 5, 3, 4), (3, 11, 1, 1)])
def test_full_connected_flatten_order(shape):
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    fan_in = int(np.prod(shape[1:]))
    w = rng.randn(fan_in, 7).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    ref = jops.full_connected(
        jnp.asarray(nhwc(x)), jnp.asarray(w), jnp.asarray(b)
    )
    got = ops.full_connected(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    )
    assert tuple(got.shape) == (shape[0], 7, 1, 1)
    np.testing.assert_allclose(got.numpy(), nchw(ref), rtol=RTOL, atol=ATOL)
    # the flatten order matters: a transposed input gives other values
    if shape[2] * shape[3] > 1:
        other = np.transpose(x, (0, 2, 3, 1)).reshape(shape[0], -1) @ w + b
        assert np.abs(got.numpy().reshape(shape[0], -1) - other).max() > 1e-2


@pytest.mark.parametrize("shape", [(3, 10, 1, 1), (2, 6, 4, 5)])
def test_softmax_forward_and_passthrough_backward(shape):
    rng = np.random.RandomState(sum(shape))
    x = (3 * rng.randn(*shape)).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    ref, vjp = jax.vjp(jops.softmax_passthrough_grad, jnp.asarray(nhwc(x)))
    (ref_gx,) = vjp(jnp.asarray(nhwc(g)))
    xt = torch.from_numpy(x).requires_grad_()
    y = ops.softmax_passthrough_grad(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(
        y.detach().numpy(), nchw(ref), rtol=RTOL, atol=1e-7
    )
    np.testing.assert_allclose(y.detach().numpy().sum(1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(xt.grad.numpy(), nchw(ref_gx))
    np.testing.assert_array_equal(xt.grad.numpy(), g)  # no Jacobian


# ----------------------------------------------------------- the slice #


OUTPUTS = ["pw13", "fc", "softmax"]


@pytest.fixture(scope="module")
def slice_pair():
    net = mobilenet_v1(2, 10, Mode.PREDICT, width_mult=0.25)
    p_np, s_np = bridge.he_numpy_weights(net, 0)
    jnet = jax_mobilenet(2, 10, JaxMode.PREDICT, width_mult=0.25)
    js = JaxSession(jnet, 0).compile_net()
    js.params = {k: jnp.asarray(v) for k, v in p_np.items()}
    js.state = {k: jnp.asarray(v) for k, v in s_np.items()}
    ts = Session(net, 0, device="cpu")
    ts.params, ts.state = bridge.params_from_numpy(net, p_np, s_np)
    ts.compile_net()
    x = np.random.RandomState(1).rand(2, 3, 224, 224).astype(np.float32)
    return js, ts, x


def test_mobilenet_slice_matches_bcnn_tpu(slice_pair):
    js, ts, x = slice_pair
    ref, ref_loss = js.predict_on_batch(x, outputs=OUTPUTS)
    before = library.launches("depthwise")
    out, loss = ts.predict_on_batch(x, outputs=OUTPUTS)
    assert library.launches("depthwise") == before  # the plain one runs
    assert float(loss) == float(ref_loss) == 0.0
    for name, o, r in zip(OUTPUTS, out, ref):
        o, r = o.numpy(), np.asarray(r)
        assert o.shape == r.shape, name
        assert np.isfinite(o).all(), name
        np.testing.assert_allclose(o, r, rtol=NET_RTOL, atol=NET_ATOL,
                                   err_msg=name)
    pw13, fc, soft = (o.numpy() for o in out)
    assert pw13.shape == (2, 256, 7, 7) and pw13.std() > 0.1
    assert fc.shape == (2, 10, 1, 1) and fc.std() > 0.05
    logits = fc.reshape(2, -1)
    top2 = np.sort(logits, 1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 10 * NET_ATOL  # no near-tie
    np.testing.assert_array_equal(
        logits.argmax(1), np.asarray(ref[1]).reshape(2, -1).argmax(1)
    )
    np.testing.assert_allclose(soft.sum(1), 1.0, rtol=1e-5)


def test_default_output_is_the_softmax(slice_pair):
    _, ts, x = slice_pair
    (y,), _ = ts.predict_on_batch(x)
    (s,), _ = ts.predict_on_batch(x, outputs=["softmax"])
    assert torch.equal(y, s)


def test_no_jax_in_the_mobilenet_path():
    """MobileNet-v1 at width 0.25 through the port in a fresh interpreter
    loads no JAX module."""
    code = textwrap.dedent(
        """
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from bcnn_tpu_torch import Session, bridge
        from bcnn_tpu_torch.models import mobilenet_v1
        net = mobilenet_v1(1, 10, width_mult=0.25)
        sess = Session(net, 0, device="cpu")
        sess.params, sess.state = bridge.params_from_numpy(
            net, *bridge.he_numpy_weights(net, 0))
        sess.compile_net()
        x = np.random.RandomState(0).rand(1, 3, 224, 224)
        (y,), _ = sess.predict_on_batch(x.astype(np.float32))
        assert tuple(y.shape) == (1, 10, 1, 1)
        assert abs(float(y.sum()) - 1.0) < 1e-5
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "bcnn_tpu.")))
        assert not bad, bad
        print("OK")
        """
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=root, timeout=120,
    )
    assert res.returncode == 0 and res.stdout.strip() == "OK", res.stderr
