"""Quantization-aware training in the port (net.qat) against bcnn_tpu on
the CPU: the fake quant and its straight-through gradient, the weight
fake quant per layer kind, training steps (plain, remat, accum_steps,
{"per_layer": True}, {"ema": 0.9}) on tests/test_qat.py's net and on one
with a depthwise layer and a deconv, VALID on frozen ranges, qat_export
and Session.freeze_qat, the frozen int8 net, and a QAT step of
YOLOv3-tiny with device augmentation.

Tolerances:
  - the fake quant: bit-equal, value and gradient;
  - each range ("qat_amax/<idx>"): rtol 1e-6 (its abs-max is taken of
    fp32 values that each package sums in its own order);
  - each parameter's update as tests/test_torch_train_shortcut's
    `assert_updates` holds it: within 1e-3 of the largest entry of the
    update of a float64 step that takes the port's own choices
    (`bcnn_tpu_torch.replay`: its kink sides, max-pool picks and
    fake-quant codes; a plain float64 step rounds the largest input of a
    range inside it, where fp32's 127 * (m / 127) leaves it outside with
    no gradient) and of bcnn_tpu's (or twice bcnn_tpu's own distance to
    float64); the loss rtol 1e-4. An input on a rounding boundary of
    x / s (a code near .5) may round to another code in each package;
    each step prints how many codes differ and holds them to 1 in 1,000.
    On YOLOv3-tiny one differing code moves the layers after it (BN over
    8 values a channel at 2x2), so there the port's step is also run on
    bcnn_tpu's codes, which are held so layer by layer (TINY_APART). A
    float64 replay holds each code it imposes to its own x / s
    (`replay.CODE_EPS`);
  - the frozen dicts: int8 weights bit-equal, scales rtol 1e-6; the
    frozen int8 net's softmax within 2^-5 of its largest value."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcnn_tpu as bt
from bcnn_tpu import Session as JaxSession
from bcnn_tpu import learner as jlearner
from bcnn_tpu.compile import execute as jax_execute
from bcnn_tpu.compile import make_train_step as jax_make_train_step
from bcnn_tpu.data import device_augment as jda
from bcnn_tpu.models import yolov3_tiny as jax_tiny
from bcnn_tpu.ops import quant as jq

from bcnn_tpu_torch import Session, bridge, replay
from bcnn_tpu_torch import graph as tgraph
from bcnn_tpu_torch.compile import execute, make_train_step
from bcnn_tpu_torch.data import device_augment as tda
from bcnn_tpu_torch.learner import init_opt_state
from bcnn_tpu_torch.models import yolov3_tiny
from bcnn_tpu_torch.ops import quant as tq
from bcnn_tpu_torch.types import LayerType, Mode
from tests.test_torch_quant import HEAD_TOL
from tests.test_torch_slice import bn_stats
from tests.test_torch_train_shortcut import UPDATE_TOL, assert_updates

torch.set_num_threads(1)

LOSS_RTOL, AMAX_RTOL = 1e-4, 1e-6
# the share of YOLOv3-tiny's fake-quant codes that may differ between
# the packages' own TRAIN forwards at 64 px: a code apart in one layer
# moves every layer after it (BN over 8 values a channel at 2x2), so
# 21,292 of 141,312 (15%) differ there; layer by layer, each given
# bcnn_tpu's codes upstream, 5 of 129,024 do, held as
# test_three_steps_match_bcnn_tpu holds its nets (1 in 1,000)
TINY_APART = 0.25


def qat_net(pkg, batch, qat=True, bn=False, extra=False, flags=(1, 1, 1)):
    """tests/test_qat.py's `_small_net` (conv, max-pool, conv, FC,
    softmax, euclidean cost; 12x12x3) in either package; `extra` puts a
    depthwise layer and a stride-2 deconv between the pool and the
    second conv; `flags` are the convs' and the FC's `quantize`."""
    net = pkg.Net(pkg.Mode.TRAIN)
    net.set_input_shape(12, 12, 3, batch)
    net.set_sgd_optimizer(0.02, 0.9)
    X, A = pkg.FillerType.XAVIER, pkg.Activation
    net.add_convolutional_layer(16, 3, 1, 1, 1, int(bn), X, A.RELU,
                                flags[0], "input", "c1")
    net.add_maxpool_layer(2, 2, pkg.Padding.SAME, "c1", "p1")
    src = "p1"
    if extra:
        net.add_depthwise_conv_layer(3, 1, 1, 0, X, A.LRELU, "p1", "dw")
        net.add_deconvolutional_layer(8, 2, 2, 0, X, A.RELU, "dw", "up")
        src = "up"
    net.add_convolutional_layer(32, 3, 1 if not extra else 2, 1, 1, int(bn),
                                X, A.RELU, flags[1], src, "c2")
    net.add_fullc_layer(4, X, A.NONE, flags[2], "c2", "fc")
    net.add_softmax_layer("fc", "sm")
    net.add_cost_layer(pkg.Loss.EUCLIDEAN, pkg.Metric.ERROR_RATE, 1.0,
                       "sm", "label", "cost")
    if qat:
        net.qat = qat
    return net


def task_batch(rng, n):
    """tests/test_qat.py's separable 4-class task."""
    lab = rng.randint(0, 4, n)
    x = rng.randn(n, 3, 12, 12).astype(np.float32) * 0.1
    for i, c in enumerate(lab):
        x[i, c % 3, 2 * c:2 * c + 4, 2 * c:2 * c + 4] += 1.5
    y = np.zeros((n, 4, 1, 1), np.float32)
    y[np.arange(n), lab] = 1.0
    return x, y


def start(jnet, net, seed=0):
    """bcnn_tpu's init_params (with its zero ranges) and BN stats from a
    numpy seed, as numpy arrays in its layout."""
    js = JaxSession(jnet, seed).compile_net()
    p_np = {k: np.asarray(v) for k, v in js.params.items()}
    s_np = {k: np.asarray(v) for k, v in js.state.items()}
    s_np.update(bn_stats(jnet.state_specs(), seed))
    assert sorted(k for k in s_np if k.startswith("qat_amax/")) == sorted(
        jq.qat_state_keys(jnet))
    return p_np, s_np


def jax_watched(jnet, p_np, s_np, batch):
    """bcnn_tpu's TRAIN forward (jitted): its watched values, NCHW, and
    its state after the pass."""
    watch = jq.watch_tensors(jnet)

    @jax.jit
    def run(p, s, b):
        ex = jax_execute(jnet, p, s, b, bt.Mode.TRAIN, jax.random.PRNGKey(0))
        return {i: ex.values[i] for i in watch}, ex.state

    vals, state = run({k: jnp.asarray(v) for k, v in p_np.items()},
                      {k: jnp.asarray(v) for k, v in s_np.items()},
                      {k: jnp.asarray(v) for k, v in batch.items()})
    vals = {i: np.asarray(v, np.float32) for i, v in vals.items()}
    return ({i: v.transpose(0, 3, 1, 2) if v.ndim == 4 else v
             for i, v in vals.items()},
            {k: np.asarray(v) for k, v in state.items()})


def codes_apart(jnet, net, p_np, s_np, batch, jax_run=None):
    """How many fake-quant codes of the watched inputs differ between the
    packages' TRAIN forwards from the same weights (each with its own
    abs-max scale)."""
    jvals, jstate = jax_run or jax_watched(jnet, p_np, s_np, batch)
    params, state = bridge.params_from_numpy(net, p_np, s_np)
    with torch.no_grad():
        ex = execute(net, params, state,
                     {k: torch.from_numpy(v) for k, v in batch.items()},
                     Mode.TRAIN)
    apart = total = 0
    for i in tq.watch_tensors(net):
        k = f"qat_amax/{i}"
        a = jvals[i]
        b = ex.values[i].float().numpy()
        ca = np.clip(np.round(a / (max(float(jstate[k]), 1e-8) / 127)),
                     -127, 127)
        cb = np.clip(np.round(b / (max(float(ex.state[k]), 1e-8) / 127)),
                     -127, 127)
        apart += int((ca != cb.reshape(ca.shape)).sum())
        total += ca.size
    return apart, total


@contextlib.contextmanager
def input_codes(taken, apart):
    """A context in which the port's fake quant of each conv's input
    (every other call: a node's input, then its weight) outputs the next
    (codes, inside) of `taken`, as `replay.impose` outputs a recorded
    code, and appends to `apart` how many of them differ from the codes
    of the port's own x / s there; the weights' fake quant computes as
    always."""
    fq0, calls = tq.fake_quant_ste, iter(range(2 * len(taken)))

    def fake_quant(x, scale):
        j = next(calls)
        if j % 2:
            return fq0(x, scale)
        code, inside = taken[j // 2]
        assert code.shape == x.shape
        apart.append(int((replay.fake_quant_choice(x, scale)[0]
                          != code).sum()))
        q = (code.to(x.dtype) * scale.detach()).detach()
        return torch.where(inside, x + (q - x).detach(), q)

    tq.fake_quant_ste = fake_quant
    try:
        yield
    finally:
        tq.fake_quant_ste = fq0
    assert next(calls, None) is None  # every conv took its codes


def own_f64(net, p_np, s_np, batch):
    """The parameters (bcnn_tpu's layout) after a float64 step that takes
    the port's own fp32 choices on the CPU."""
    params, state = bridge.params_from_numpy(net, p_np, s_np)
    ch = replay.Choices()
    replay.sgd_update(net, params, state, batch, choices=replay.record(ch))
    assert ch.codes  # the fake quant ran
    update, _ = replay.sgd_update(net, params, state, batch, torch.float64,
                                  choices=replay.impose(ch))
    return bridge.params_to_numpy(
        net, {k: v + update.get(k, 0) for k, v in params.items()})


def port_step(net, p_np, s_np, batch, **form):
    params, state = bridge.params_from_numpy(net, p_np, s_np)
    step = make_train_step(net, **form)
    params, state, _, loss = step(
        params, state, init_opt_state(net, params),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return params, state, float(loss)


def jax_step(jnet, p_np, s_np, batch, **form):
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    jp, js, _, loss = jax_make_train_step(jnet, **form)(
        jp, {k: jnp.asarray(v) for k, v in s_np.items()},
        jlearner.init_opt_state(jnet, jp),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    return jp, js, float(loss)


def assert_ranges(state, jstate, n):
    keys = [k for k in jstate if k.startswith("qat_amax/")]
    assert len(keys) == n
    for k in keys:
        assert float(jstate[k]) > 0, k
        np.testing.assert_allclose(float(state[k]), float(jstate[k]),
                                   rtol=AMAX_RTOL, err_msg=k)


def assert_bn(net, state, jstate):
    for k, v in bridge.params_to_numpy(net, state).items():
        if not k.startswith("qat_amax/"):
            np.testing.assert_allclose(v, np.asarray(jstate[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


# ------------------------------------------------------------ the primitive #


def test_fake_quant_ste_bit_equal():
    """Values on, between and past the grid (±127 s and beyond), codes at
    .5 (half to even), and a per-channel scale: value and gradient
    bit-equal to bcnn_tpu's."""
    s = np.float32(0.1)
    x = np.asarray([0.04, -0.26, 0.05, 0.15, -0.25, 12.6, 12.7, 12.75,
                    12.8, -12.7, -12.71, -14.0, 0.0, 1e-9, 3.3333333],
                   np.float32)
    cases = [(x, np.asarray(s)),
             (np.random.RandomState(0).randn(3, 4, 5).astype(np.float32)
              * 2, np.asarray([[[0.01]], [[0.02]], [[0.03]]], np.float32))]
    for v, sc in cases:
        jv, js = jnp.asarray(v), jnp.asarray(sc)
        want = np.asarray(jq.fake_quant_ste(jv, js))
        jg = np.asarray(jax.grad(
            lambda a: jnp.sum(jq.fake_quant_ste(a, js) * jnp.arange(
                a.size, dtype=jnp.float32).reshape(a.shape)))(jv))
        tv = torch.from_numpy(v).requires_grad_()
        got = tq.fake_quant_ste(tv, torch.from_numpy(sc))
        (got * torch.arange(v.size, dtype=torch.float32).reshape(
            v.shape)).sum().backward()
        np.testing.assert_array_equal(got.detach().numpy(), want)
        np.testing.assert_array_equal(tv.grad.numpy(), jg)
    # the straight-through gradient: 1 inside [-127 s, 127 s], 0 outside
    tv = torch.from_numpy(x).requires_grad_()
    tq.fake_quant_ste(tv, torch.tensor(0.1)).sum().backward()
    assert tv.grad[x.tolist().index(np.float32(-14.0))] == 0
    assert tv.grad[0] == 1


@pytest.mark.parametrize("kind", ["CONV2D", "DEPTHWISE_CONV2D",
                                  "TRANSPOSE_CONV2D", "FULL_CONNECTED"])
def test_fake_quant_weight_per_layer_kind(kind):
    """Each layer kind's weight in the port's layout against bcnn_tpu's
    in its own (HWIO, (k, k, O, C) for a deconv, (in, out)): the
    per-output-channel fake quant, value and gradient, bit-equal; an
    all-zero channel stays zero."""
    rng = np.random.RandomState(len(kind))
    shape = {"CONV2D": (3, 3, 5, 6), "DEPTHWISE_CONV2D": (3, 3, 1, 7),
             "TRANSPOSE_CONV2D": (4, 4, 6, 5),
             "FULL_CONNECTED": (20, 6)}[kind]
    w = rng.randn(*shape).astype(np.float32)
    w[..., 0] = 0.0 if kind != "FULL_CONNECTED" else w[..., 0]
    g = rng.randn(*shape).astype(np.float32)
    lt = LayerType[kind]
    jw = jnp.asarray(w)
    want = np.asarray(jq.fake_quant_weight(jw, jq.QAT_WEIGHT_AXES[lt]))
    jg = np.asarray(jax.grad(lambda a: jnp.sum(
        jq.fake_quant_weight(a, jq.QAT_WEIGHT_AXES[lt]) * g))(jw))
    to_port = (lambda a: a.transpose(3, 2, 0, 1)) if len(shape) == 4 else \
        (lambda a: a)
    tw = torch.from_numpy(np.ascontiguousarray(to_port(w))).requires_grad_()
    got = tq.fake_quant_weight(tw, tq.QAT_WEIGHT_AXES[lt])
    (got * torch.from_numpy(np.ascontiguousarray(to_port(g)))).sum(
    ).backward()
    np.testing.assert_array_equal(got.detach().numpy(), to_port(want))
    np.testing.assert_array_equal(tw.grad.numpy(), to_port(jg))


# ---------------------------------------------------------- training steps #


@pytest.mark.parametrize("bn,extra", [(False, False), (True, False),
                                      (True, True)])
def test_three_steps_match_bcnn_tpu(bn, extra):
    """Three SGD steps, each from the port's parameters and state after
    the last (a fresh optimizer state each, in both packages): the loss,
    the ranges, the BN stats, and each parameter's update
    (`assert_updates`)."""
    jnet = qat_net(bt, 4, bn=bn, extra=extra)
    net = qat_net(tgraph, 4, bn=bn, extra=extra)
    p_np, s_np = start(jnet, net)
    rng = np.random.RandomState(1)
    n_ranges = len(jq.qat_state_keys(jnet))
    for step in range(3):
        x, y = task_batch(rng, 4)
        batch = {"input": x, "label": y}
        apart, total = codes_apart(jnet, net, p_np, s_np, batch)
        print(f"step {step}: {apart} of {total} fake-quant codes differ")
        assert apart <= max(2, total // 1000)
        jp, js, jloss = jax_step(jnet, p_np, s_np, batch)
        params, state, loss = port_step(net, p_np, s_np, batch)
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        assert_ranges(state, js, n_ranges)
        assert_bn(net, state, js)
        assert_updates(net, p_np, s_np, x, y, params, jp,
                       own_f64(net, p_np, s_np, batch))
        p_np = bridge.params_to_numpy(net, params)
        s_np = bridge.params_to_numpy(net, state)


@pytest.mark.parametrize("qat", [{"per_layer": True}, {"ema": 0.9}])
def test_qat_options_match_bcnn_tpu(qat):
    """{"per_layer": True} quantizes only the layers built with
    `quantize` (here c1 and the FC, not c2; c2's input is still watched
    and observed at the end of the pass); {"ema": 0.9} moves each range
    by a tenth of the new abs-max: two steps, the second from the
    first's ranges."""
    flags = (1, 0, 1) if qat.get("per_layer") else (1, 1, 1)
    jnet = qat_net(bt, 4, qat=qat, bn=True, flags=flags)
    net = qat_net(tgraph, 4, qat=dict(qat), bn=True, flags=flags)
    p_np, s_np = start(jnet, net, seed=2)
    rng = np.random.RandomState(3)
    for _ in range(2):
        x, y = task_batch(rng, 4)
        batch = {"input": x, "label": y}
        jp, js, jloss = jax_step(jnet, p_np, s_np, batch)
        params, state, loss = port_step(net, p_np, s_np, batch)
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        assert_ranges(state, js, 3)
        assert_updates(net, p_np, s_np, x, y, params, jp,
                       own_f64(net, p_np, s_np, batch))
        p_np = bridge.params_to_numpy(net, params)
        s_np = bridge.params_to_numpy(net, state)


@pytest.mark.parametrize("form", ["remat", "accum_steps"])
def test_step_forms_match_bcnn_tpu(form):
    """remat: the recompute leaves each range as one forward moved it
    (bcnn_tpu's jax.checkpoint keeps the forward's state,
    `bcnn_tpu/compile.py:935`), so the step equals the plain one and
    bcnn_tpu's. accum_steps=2: each microbatch moves the ranges in turn,
    one update; against bcnn_tpu's (within UPDATE_TOL of its largest
    update entry)."""
    kw = {"remat": True} if form == "remat" else {"accum_steps": 2}
    jnet = qat_net(bt, 4, bn=True)
    net = qat_net(tgraph, 4, bn=True)
    p_np, s_np = start(jnet, net, seed=4)
    x, y = task_batch(np.random.RandomState(5), 4)
    batch = {"input": x, "label": y}
    jp, js, jloss = jax_step(jnet, p_np, s_np, batch, **kw)
    params, state, loss = port_step(net, p_np, s_np, batch, **kw)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert_ranges(state, js, 3)
    assert_bn(net, state, js)
    if form == "remat":
        plain_p, plain_s, plain_loss = port_step(net, p_np, s_np, batch)
        assert loss == plain_loss
        for k in plain_s:
            assert torch.equal(state[k], plain_s[k]), k
        assert_updates(net, p_np, s_np, x, y, params, jp,
                       own_f64(net, p_np, s_np, batch))
        return
    # two microbatches: the ranges moved twice from zero, not seeded once
    _, once_s, _ = port_step(net, p_np, s_np, batch)
    assert any(not torch.equal(state[k], once_s[k]) for k in state
               if k.startswith("qat_amax/"))
    for k, v in bridge.params_to_numpy(net, params).items():
        du, du_j = v - p_np[k], np.asarray(jp[k]) - p_np[k]
        np.testing.assert_allclose(
            du, du_j, rtol=0,
            atol=max(UPDATE_TOL * np.abs(du_j).max(),
                     np.spacing(np.abs(p_np[k]).max())), err_msg=k)


# ------------------------------------------------ VALID, export, the freeze #


@pytest.fixture(scope="module")
def trained():
    """Both packages after two QAT steps from the same start (the port's
    own trajectory; bcnn_tpu's state and params are then set to the
    port's, so that what follows compares like with like)."""
    jnet = qat_net(bt, 4, bn=True, extra=True)
    net = qat_net(tgraph, 4, bn=True, extra=True)
    p_np, s_np = start(jnet, net, seed=6)
    rng = np.random.RandomState(7)
    for _ in range(2):
        x, y = task_batch(rng, 4)
        params, state, _ = port_step(net, p_np, s_np,
                                     {"input": x, "label": y})
        p_np = bridge.params_to_numpy(net, params)
        s_np = bridge.params_to_numpy(net, state)
    js = JaxSession(jnet, 0).compile_net()
    js.params = {k: jnp.asarray(v) for k, v in p_np.items()}
    js.state = {k: jnp.asarray(v) for k, v in s_np.items()}
    ts = Session(net, 0, device="cpu")
    ts.params, ts.state = bridge.params_from_numpy(net, p_np, s_np)
    ts.compile_net()
    return js, ts, task_batch(rng, 4)


def test_valid_reads_frozen_ranges(trained):
    js, ts, (x, y) = trained
    before = {k: v.clone() for k, v in ts.state.items()}
    want, wloss = js.predict_on_batch(x, y, outputs=["sm"])
    got, loss = ts.predict_on_batch(x, y, outputs=["sm"])
    np.testing.assert_allclose(float(loss), float(wloss), rtol=LOSS_RTOL)
    w = np.asarray(want[0]).reshape(got[0].shape)
    assert np.abs(got[0].numpy() - w).max() <= HEAD_TOL * np.abs(w).max()
    assert all(torch.equal(before[k], ts.state[k]) for k in before)


def test_freeze_qat_gives_bcnn_tpu_dict_and_outputs(trained):
    """qat_export and Session.freeze_qat: bcnn_tpu's dict (int8 weights
    bit-equal in the port's layouts, scales rtol 1e-6); then PREDICT
    takes the int8 path (K4 and K5 on the card) and its softmax matches
    bcnn_tpu's frozen net."""
    js, ts, (x, _) = trained
    jnet, net = js.net, ts.net
    want = jq.qat_export(jnet, js.params, js.state)
    got = tq.qat_export(net, ts.params, ts.state)
    carried = bridge.quant_from_numpy(net, want)
    assert set(got["weights"]) == set(carried["weights"])
    for k, e in got["weights"].items():
        for part, t in e.items():
            assert torch.equal(t, carried["weights"][k][part]), (k, part)
    assert sorted(got["act_scales"]) == sorted(want["act_scales"])
    for i, s in want["act_scales"].items():
        np.testing.assert_allclose(got["act_scales"][i], s, rtol=AMAX_RTOL)
    try:
        jq_dict = js.freeze_qat()
        tq_dict = ts.freeze_qat()
        assert net.quant is tq_dict and jnet.quant is jq_dict
        jnet.set_mode(bt.Mode.PREDICT)
        net.set_mode(Mode.PREDICT)
        js._forward_cache = {}
        (w,), _ = js.predict_on_batch(x, outputs=["sm"])
        (g,), _ = ts.predict_on_batch(x, outputs=["sm"])
        w = np.asarray(w).reshape(g.shape)
        assert np.abs(g.numpy() - w).max() <= HEAD_TOL * np.abs(w).max()
        kinds = {n.type for n in net.nodes
                 if len(n.src) > 1 and net.tensors[n.src[1]].key
                 in tq_dict["weights"]}
        assert kinds == {LayerType.CONV2D, LayerType.DEPTHWISE_CONV2D,
                         LayerType.TRANSPOSE_CONV2D,
                         LayerType.FULL_CONNECTED}
    finally:
        jnet.set_mode(bt.Mode.TRAIN)
        net.set_mode(Mode.TRAIN)
        jnet.quant = net.quant = None


# ----------------------------------------- YOLOv3-tiny with augmentation #


def test_yolov3_tiny_qat_step_with_device_augmentation(monkeypatch):
    """YOLOv3-tiny at 64 px, batch 2, net.qat, rotation and the rest of
    the device augmentation (tests/test_torch_train.py's draws handed to
    both packages). Session.train_on_batch: each update within
    UPDATE_TOL of a float64 step on its own augmented batch and choices.
    Against bcnn_tpu (its augment, then its step): the port's step on
    bcnn_tpu's batch with bcnn_tpu's fake-quant codes (its watched
    values and ranges: one code apart moves the deep 2x2 layers) gives
    its loss, its 15 ranges and its updates; the codes that differ are
    bounded both ways (TINY_APART)."""
    from tests.test_torch_train import AUG, _det_labels, _step_params

    jnet = jax_tiny(2, 64, 64, 4, mode=bt.Mode.TRAIN)
    net = yolov3_tiny(2, 64, 64, 4, mode=Mode.TRAIN)
    jnet.qat = net.qat = True
    p_np, s_np = start(jnet, net, seed=8)
    rng = np.random.RandomState(9)
    x = (rng.rand(2, 3, 64, 64) * 255).astype(np.uint8)
    lab = _det_labels(rng)
    draw = {k: np.asarray(v, np.float32)
            for k, v in _step_params(rng).items()}
    pj = {k: jnp.asarray(v) for k, v in draw.items()}
    aug_one = jax.vmap(functools.partial(jda._augment_one,
                                         **jda._geo_kwargs(AUG)))
    xa = (aug_one(jnp.asarray(np.transpose(x, (0, 2, 3, 1)), jnp.float32),
                  pj) - 127.5) * (1 / 127.5)
    batch = {"input": np.asarray(jnp.transpose(xa, (0, 3, 1, 2))),
             "label": np.asarray(jda.transform_boxes(jnp.asarray(lab), pj,
                                                     64, 64))}
    jp, js, jloss = jax_step(jnet, p_np, s_np, batch)

    # the port through its entry point, held to its own float64 step
    monkeypatch.setattr(tda, "sample_params", lambda *a: {
        k: torch.from_numpy(v) for k, v in draw.items()})
    net.device_augment = AUG
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(net, p_np, s_np)
    sess.compile_net()
    loss = float(sess.train_on_batch(x, lab))
    xt, lt = tda.augment_batch_with_boxes_nchw(
        torch.from_numpy(x), torch.from_numpy(lab), None, AUG)
    own = own_f64(net, p_np, s_np, {"input": xt, "label": lt})
    assert np.isfinite(loss) and loss > 0
    for k, v in bridge.params_to_numpy(net, sess.params).items():
        du, d64 = v - p_np[k], own[k] - p_np[k]
        np.testing.assert_allclose(
            du, d64, rtol=0, atol=max(UPDATE_TOL * np.abs(d64).max(),
                                      np.spacing(np.abs(p_np[k]).max())),
            err_msg=k)
    net.device_augment = None

    # on bcnn_tpu's batch and codes (its kink sides and picks follow)
    jvals, jstate = jax_run = jax_watched(jnet, p_np, s_np, batch)
    apart, total = codes_apart(jnet, net, p_np, s_np, batch, jax_run)
    print(f"{apart} of {total} fake-quant codes differ")
    assert apart <= TINY_APART * total
    params, state = bridge.params_from_numpy(net, p_np, s_np)
    taken = []
    for node in net.nodes:
        if node.type == LayerType.CONV2D:
            i = node.src[0]
            s = torch.tensor(max(float(jstate[f"qat_amax/{i}"]), 1e-8)) / \
                torch.tensor(127.0)
            taken.append(replay.fake_quant_choice(
                torch.from_numpy(np.ascontiguousarray(jvals[i])), s))
    local = []
    update, ex = replay.sgd_update(net, params, state, batch,
                                   choices=input_codes(taken, local))
    n_taken = sum(c.numel() for c, _ in taken)
    print(f"given bcnn_tpu's codes upstream, {sum(local)} of {n_taken} "
          f"differ {local}")
    assert sum(local) <= max(2, n_taken // 1000)
    np.testing.assert_allclose(float(ex.metrics[0] + ex.metrics[1]) / 2,
                               jloss, rtol=LOSS_RTOL)
    assert_ranges(ex.state, js, 15)
    for k, v in bridge.params_to_numpy(
            net, {k: params[k] + update[k] for k in update}).items():
        du, du_j = v - p_np[k], np.asarray(jp[k]) - p_np[k]
        np.testing.assert_allclose(
            du, du_j, rtol=0,
            atol=max(UPDATE_TOL * np.abs(du_j).max(),
                     np.spacing(np.abs(p_np[k]).max())), err_msg=k)
