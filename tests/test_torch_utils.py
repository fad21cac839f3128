"""The port's profiling, debug and log modules (`bcnn_tpu_torch.profiling`,
`debug`, `log`), the counterparts of tests/test_utils.py, on the CPU:
profile_forward reports every node, memory_report on a forward and a
training step (flops from FlopCounterMode, K3's by its formula),
check_pytree_finite, the executor's NaN and Inf checks naming the node,
trace writing a Chrome trace, and print_net_summary's lines equal to
bcnn_tpu.log's."""

import json
import os

import numpy as np
import pytest
import torch

import bcnn_tpu as bt
from bcnn_tpu import log as jlog
from bcnn_tpu.models import yolov3_tiny as jax_tiny

from bcnn_tpu_torch import Mode, Session, bridge, debug, log, profiling
from bcnn_tpu_torch.compile import execute, make_train_step
from bcnn_tpu_torch.models import lenet_mnist, mobilenet_v1, yolov3_tiny
from bcnn_tpu_torch.types import LayerType
from tests.test_torch_deploy import classif_net

import bcnn_tpu_torch as tt

torch.set_num_threads(1)


def lenet(mode, batch):
    return Session(lenet_mnist(batch, mode), 0, device="cpu").compile_net()


def test_profile_forward_reports_all_nodes(capsys):
    sess = lenet(Mode.PREDICT, 2)
    x = np.random.RandomState(0).randn(2, 1, 28, 28).astype(np.float32)
    timings = profiling.profile_forward(sess, x, runs=1)
    assert len(timings) == len(sess.net.nodes)
    assert all(t >= 0 for _, _, t in timings)
    types = [t for t, _, _ in timings]
    assert "CONV2D" in types and "FULL_CONNECTED" in types
    profiling.print_profile(timings)
    out = capsys.readouterr().out
    assert "total" in out and "CONV2D" in out


def test_memory_report_on_forward_and_train_step():
    sess = lenet(Mode.PREDICT, 4)
    net = sess.net
    x = torch.from_numpy(
        np.random.RandomState(0).randn(4, 1, 28, 28).astype(np.float32))

    def fwd(params, state, xin):
        ex = execute(net, params, state, {"input": xin}, Mode.PREDICT)
        return ex.values[max(ex.values)]  # the last tensor made

    with torch.inference_mode():
        rep = profiling.memory_report(fwd, sess.params, sess.state, x)
    assert rep["argument_size_in_bytes"] > 0
    assert rep["output_size_in_bytes"] == 4 * 10 * 4
    assert rep["argument_size_in_bytes"] < 100e6
    assert rep["flops"] > 1e6  # the convs and FCs
    assert "peak_bytes" not in rep  # the CPU has no device peak

    tsess = lenet(Mode.TRAIN, 4)
    y = torch.zeros(4, 10, 1, 1)
    y[:, 0] = 1
    rep2 = profiling.memory_report(
        make_train_step(tsess.net), tsess.params, tsess.state,
        tsess.opt_state, {"input": x, "label": y})
    assert rep2["argument_size_in_bytes"] > rep["argument_size_in_bytes"]
    assert rep2["flops"] > 2 * rep["flops"]  # the backward's convs too


def test_memory_report_counts_the_depthwise_kernel():
    """MobileNet-v1's flops: every conv and the FC as aten counts them,
    and the 13 depthwise layers (K3's op) by its formula, exactly."""
    net = mobilenet_v1(1, 10, width_mult=0.25)
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0))
    sess.compile_net()
    x = np.random.RandomState(1).rand(1, 3, 224, 224).astype(np.float32)
    rep = profiling.memory_report(
        lambda xin: sess.predict_on_batch(xin, outputs=["softmax"])[0], x)
    want = 0
    for node in net.nodes:
        d, s = net.tensors[node.dst[0]], net.tensors[node.src[0]]
        if node.type == LayerType.CONV2D:
            k = node.param["size"]
            want += 2 * d.c * d.h * d.w * s.c * k * k
        elif node.type == LayerType.DEPTHWISE_CONV2D:
            k = node.param["size"]
            want += 2 * d.c * d.h * d.w * k * k
        elif node.type == LayerType.FULL_CONNECTED:
            want += 2 * s.c * s.h * s.w * d.c
    assert rep["flops"] == want


def test_check_pytree_finite():
    ok = {"a": np.ones(3), "b": {"c": torch.zeros(2)}, "d": [1.0, 2]}
    assert debug.check_pytree_finite(ok, "ok") is ok
    with pytest.raises(FloatingPointError, match="'a'"):
        debug.check_pytree_finite({"a": np.array([1.0, np.nan])}, "bad")
    with pytest.raises(FloatingPointError, match="inner"):
        debug.check_pytree_finite(
            {"b": {"inner": torch.tensor([float("inf")])}}, "bad")


@pytest.fixture
def overflowing():
    """tests/test_deploy.py's classifier whose conv weights (all 1e38)
    overflow to +inf on positive inputs; its FC, of mixed signs, then
    turns inf into NaN."""
    net = classif_net(tt)
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0))
    sess.compile_net()
    sess.params["input_w"] = torch.full_like(sess.params["input_w"], 1e38)
    x = np.random.RandomState(2).rand(4, 3, 16, 16).astype(np.float32) + 1
    yield sess, x
    debug.enable_nan_checks(False)
    debug.enable_inf_checks(False)


def test_nan_and_inf_checks_name_the_node(overflowing):
    sess, x = overflowing
    (out,), _ = sess.predict_on_batch(x)  # off: no check
    assert torch.isnan(out).all()
    debug.enable_nan_checks()
    with pytest.raises(FloatingPointError,
                       match=r"NaN in tensor 'f', written by node 3 "
                             r"\(FULL_CONNECTED\)"):
        sess.predict_on_batch(x)
    debug.enable_inf_checks()
    with pytest.raises(FloatingPointError,
                       match=r"Inf in tensor 'c1', written by node 0 "
                             r"\(CONV2D\)"):
        sess.predict_on_batch(x)
    debug.enable_nan_checks(False)
    debug.enable_inf_checks(False)
    sess.predict_on_batch(x)  # off again


def test_trace_writes_a_chrome_trace(tmp_path):
    sess = lenet(Mode.PREDICT, 2)
    x = np.random.RandomState(3).randn(2, 1, 28, 28).astype(np.float32)
    with profiling.trace(str(tmp_path / "tr")):
        sess.predict_on_batch(x)
    (name,) = os.listdir(tmp_path / "tr")
    with open(tmp_path / "tr" / name) as fp:
        events = json.load(fp)["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("level", [bt.LogLevel.INFO, bt.LogLevel.ERROR])
def test_print_net_summary_equals_bcnn_tpu(level):
    got, want = [], []
    log.print_net_summary(yolov3_tiny(2, 96, 96, 4),
                          log.LogContext(got.append, int(level)))
    jlog.print_net_summary(jax_tiny(2, 96, 96, 4),
                           jlog.LogContext(want.append, level))
    assert got == want
    assert len(got) == (0 if level == bt.LogLevel.ERROR else 1 + len(
        yolov3_tiny(2, 96, 96, 4).nodes))


def test_log_context_levels_and_the_global_context():
    lines = []
    ctx = log.set_log_context(lines.append, tt.LogLevel.WARNING)
    try:
        assert log.get_log_context() is ctx
        ctx.info("hidden")
        ctx.warning("shown")
        ctx.error("also")
        assert lines == ["\x1b[33m[WARNING]\x1b[0m shown",
                         "\x1b[31m[ERROR]\x1b[0m also"]
    finally:
        log.set_log_context()
