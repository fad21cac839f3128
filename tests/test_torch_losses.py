"""The port's cost layer (`ops/losses.py`, `compile._Executor._cost`) and
standalone activation layer (`_activation`) against bcnn_tpu's, on the
CPU, with bcnn_tpu's weights.

Tolerances (float32):
  - compute_metric: ERROR_RATE exact (a count); SSE, MSE, CRPS, LOGLOSS
    and DICE rtol 1e-6 (float sums taken in another order);
  - a small net (conv, activation, max-pool, FC, activation, softmax,
    cost) in TRAIN, VALID and PREDICT: outputs rtol 1e-5 atol 1e-6, the
    loss rtol 1e-5, gradients within 1e-4 of each tensor's largest;
  - MobileNet-v1 (width 0.25, batch 2, 224 px) in TRAIN and VALID: the
    VALID error count exact, the surrogate rtol 1e-4, every gradient
    within 1e-3 of its tensor's largest (tests/test_torch_train.py's
    gradient tolerance), against bcnn_tpu's EAGER jax.grad: its jitted
    gradient of this net differs from its own eager one by 4.5% of a
    tensor's largest entry (XLA's fusions; batch-2 BN over 7x7 planes
    amplifies the rounding), where the port's agrees with the eager one
    within 4e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnn_tpu import Mode as JMode
from bcnn_tpu import Net as JNet
from bcnn_tpu.compile import execute as jexecute
from bcnn_tpu.compile import get_loss as jget_loss
from bcnn_tpu.compile import init_params as jinit_params
from bcnn_tpu.models import mobilenet_v1 as jmobilenet
from bcnn_tpu.ops import losses as jlosses
from bcnn_tpu.types import Activation as JActivation

from bcnn_tpu_torch import bridge
from bcnn_tpu_torch.compile import execute, get_loss
from bcnn_tpu_torch.graph import Net
from bcnn_tpu_torch.models import mobilenet_v1
from bcnn_tpu_torch.ops import losses
from bcnn_tpu_torch.types import (Activation, FillerType, LayerType, Loss,
                                  Metric, Mode)

torch.set_num_threads(1)

N, F = 6, 10


def _x_label(seed, metric):
    rng = np.random.RandomState(seed)
    if metric in (Metric.LOGLOSS, Metric.DICE):
        x = rng.rand(N, F).astype(np.float32)
    else:
        x = rng.randn(N, F).astype(np.float32)
    x[0, 3] = x[0, 7] = x[0].max() + 1.0  # a tie: the first maximum wins
    label = np.zeros((N, F), np.float32)
    label[np.arange(N), rng.randint(F, size=N)] = 1.0
    if metric in (Metric.SSE, Metric.MSE, Metric.CRPS):
        label += 0.1 * rng.randn(N, F).astype(np.float32)
    return x, label


@pytest.mark.parametrize("metric", list(Metric), ids=lambda m: m.name)
@pytest.mark.parametrize("seed", [0, 1])
def test_compute_metric_matches_bcnn_tpu(metric, seed):
    x, label = _x_label(seed, metric)
    got = losses.compute_metric(torch.from_numpy(x), torch.from_numpy(label),
                                metric)
    ref = np.asarray(jlosses.compute_metric(jnp.asarray(x),
                                            jnp.asarray(label), metric))
    assert got.dtype == torch.float32 and got.dim() == 0
    if metric == Metric.ERROR_RATE:
        assert float(got) == float(ref)
    else:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_euclidean_surrogate_and_huber_match_bcnn_tpu():
    x, label = _x_label(2, Metric.SSE)
    xt = torch.from_numpy(x).requires_grad_()
    lt = torch.from_numpy(label).requires_grad_()
    sur = losses.euclidean_surrogate(xt, lt, 0.7)
    sur.backward()
    ref, (gx, gl) = jax.value_and_grad(
        lambda a, b: jlosses.euclidean_surrogate(a, b, 0.7), (0, 1))(
        jnp.asarray(x), jnp.asarray(label))
    np.testing.assert_allclose(float(sur.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), 0.7 * (x - label),
                               rtol=1e-5, atol=1e-6)
    assert lt.grad is None or not lt.grad.any()  # the label is constant
    assert not np.asarray(gl).any()
    for d in (0.5, 2.0):
        e, g = losses.huber(torch.from_numpy(x), torch.from_numpy(label), d)
        je, jg = jlosses.huber(jnp.asarray(x), jnp.asarray(label), d)
        np.testing.assert_allclose(float(e), float(je), rtol=1e-6)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


# ------------------------------------------------------ a small net #

BATCH, SIZE, CLASSES = 4, 10, 5
# bcnn_tpu's members (MISH and SWISH are the port's own:
# tests/test_torch_yolov4.py, tests/test_torch_yolov7.py)
ACTS = [a for a in Activation if a not in (Activation.NONE, Activation.PRELU)
        and a.name in JActivation.__members__]


def small(cls, mode, act, metric):
    """conv -> activation -> max-pool -> FC -> activation -> softmax ->
    cost, in either package."""
    net = cls(mode)
    net.set_input_shape(SIZE, SIZE, 2, BATCH)
    if mode != Mode.PREDICT:
        net.set_sgd_optimizer(0.01, 0.9)
    net.add_convolutional_layer(4, 3, 1, 1, 1, 0, FillerType.XAVIER,
                                Activation.NONE, 0, "input", "c1")
    net.add_activation_layer(act, "c1")
    net.add_maxpool_layer(2, 2, 0, "c1", "p1")
    net.add_fullc_layer(CLASSES, FillerType.XAVIER, Activation.NONE, 0,
                        "p1", "fc")
    net.add_activation_layer(act, "fc")
    net.add_softmax_layer("fc", "sm")
    net.add_cost_layer(Loss.EUCLIDEAN, metric, 0.5, "sm", "label", "cost")
    return net


def _batch(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(BATCH, 2, SIZE, SIZE).astype(np.float32)
    x[0, 0, :3, :3] = 0.0  # zeros: the activations' kinks
    label = np.zeros((BATCH, CLASSES), np.float32)
    label[np.arange(BATCH), rng.randint(CLASSES, size=BATCH)] = 1.0
    return x, label


def _pair(mode, act, metric):
    jnet = small(JNet, JMode(int(mode)), act, metric)
    net = small(Net, mode, act, metric)
    jp, js = jinit_params(jnet, 3)
    params, state = bridge.params_from_numpy(
        net, {k: np.asarray(v) for k, v in jp.items()},
        {k: np.asarray(v) for k, v in js.items()})
    return jnet, net, jp, js, params, state


def _nchw(v):
    v = np.asarray(v)
    return np.transpose(v, (0, 3, 1, 2)) if v.ndim == 4 else v


@pytest.mark.parametrize("act", ACTS, ids=lambda a: a.name)
@pytest.mark.parametrize("mode", [Mode.VALID, Mode.PREDICT],
                         ids=lambda m: m.name)
def test_cost_and_activation_forward_match_bcnn_tpu(mode, act):
    jnet, net, jp, js, params, state = _pair(mode, act, Metric.SSE)
    x, label = _batch(1)
    jex = jexecute(jnet, jp, js, {"input": jnp.asarray(x),
                                  "label": jnp.asarray(label)},
                   JMode(int(mode)))
    with torch.inference_mode():
        ex = execute(net, params, state, {"input": torch.from_numpy(x),
                                          "label": torch.from_numpy(label)},
                     mode)
    for name in ("c1", "fc", "sm"):
        i = net.get_tensor_index_by_name(name)
        np.testing.assert_allclose(ex.values[i].numpy(),
                                   _nchw(jex.values[i]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    loss, ref = float(get_loss(ex)), float(jget_loss(jex))
    np.testing.assert_allclose(loss, ref, rtol=1e-5)
    if mode == Mode.PREDICT:  # the cost layer reports nothing
        assert loss == 0.0 and not ex.metrics
    else:
        assert loss > 0
    np.testing.assert_allclose(float(ex.surrogate), float(jex.surrogate),
                               rtol=1e-5)


@pytest.mark.parametrize("act", ACTS, ids=lambda a: a.name)
@pytest.mark.parametrize("metric", [Metric.ERROR_RATE, Metric.SSE],
                         ids=lambda m: m.name)
def test_cost_and_activation_train_match_bcnn_tpu(act, metric):
    """TRAIN: the reported metric and the surrogate's gradients in every
    parameter, the kinks included."""
    jnet, net, jp, js, params, state = _pair(Mode.TRAIN, act, metric)
    x, label = _batch(2)
    batch = {"input": jnp.asarray(x), "label": jnp.asarray(label)}

    def jloss(p):
        ex = jexecute(jnet, p, js, batch, JMode.TRAIN)
        return ex.surrogate, jget_loss(ex)

    (jsur, jmetric), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    ex = execute(net, leaves, state, {"input": torch.from_numpy(x),
                                      "label": torch.from_numpy(label)},
                 Mode.TRAIN)
    ex.surrogate.backward()
    np.testing.assert_allclose(float(ex.surrogate), float(jsur), rtol=1e-5)
    np.testing.assert_allclose(float(get_loss(ex)), float(jmetric),
                               rtol=1e-5)
    got = bridge.params_to_numpy(net, {k: v.grad for k, v in leaves.items()})
    for k, g in got.items():
        r = np.asarray(jgrads[k])
        assert np.abs(r).max() > 0, k
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=k)


def test_cost_without_a_label_is_forward_only():
    _, net, _, _, params, state = _pair(Mode.TRAIN, Activation.RELU,
                                        Metric.SSE)
    x, _ = _batch(3)
    ex = execute(net, params, state, {"input": torch.from_numpy(x)},
                 Mode.TRAIN)
    assert ex.surrogate is None and float(get_loss(ex)) == 0.0


def _train_grads(jnet, net, jp, js, params, state, x, label):
    """(bcnn_tpu's surrogate, metric and gradients; the port's surrogate,
    metric and gradients in bcnn_tpu's layout) of one TRAIN forward."""
    batch = {"input": jnp.asarray(x), "label": jnp.asarray(label)}

    def jloss(p):
        ex = jexecute(jnet, p, js, batch, JMode.TRAIN)
        return ex.surrogate, jget_loss(ex)

    (jsur, jmetric), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    ex = execute(net, leaves, state, {"input": torch.from_numpy(x),
                                      "label": torch.from_numpy(label)},
                 Mode.TRAIN)
    ex.surrogate.backward()
    return (float(jsur), float(jmetric), jgrads), (
        float(ex.surrogate), float(get_loss(ex)),
        bridge.params_to_numpy(net, {k: v.grad for k, v in leaves.items()}))


@pytest.mark.parametrize("metric", [Metric.SSE, Metric.ERROR_RATE],
                         ids=lambda m: m.name)
def test_unported_loss_and_prelu_raise(metric):
    """Ported since, the two cases this test once refused: the small
    net's cost node switched to the lifted-structure loss (the reported
    value is the loss itself under SSE, as bcnn_tpu reports it), and the
    small net with PReLU activations (slopes drawn away from the
    reference's zero init, so that they act); each against bcnn_tpu's
    surrogate, metric and gradients (the slopes' included)."""
    from bcnn_tpu.types import Loss as JLoss

    jnet, net, jp, js, params, state = _pair(Mode.TRAIN, Activation.RELU,
                                             metric)
    net.nodes[-1].param["loss"] = Loss.LIFTED_STRUCT
    jnet.nodes[-1].param["loss"] = JLoss.LIFTED_STRUCT
    x, label = _batch(3)
    label[2:] = label[:2]  # positive pairs
    ref, got = _train_grads(jnet, net, jp, js, params, state, x, label)
    assert ref[0] > 0
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    for k, g in got[2].items():
        r = np.asarray(ref[2][k])
        assert np.abs(r).max() > 0, k
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=k)

    jnet, net, jp, js, params, state = _pair(Mode.TRAIN, Activation.PRELU,
                                             metric)
    rng = np.random.RandomState(4)
    for t in net.param_specs():
        if t.key.endswith("_w_prelu"):
            v = rng.uniform(0.05, 0.3, t.mem_shape).astype(np.float32)
            jp[t.key], params[t.key] = jnp.asarray(v), torch.from_numpy(v)
    ref, got = _train_grads(jnet, net, jp, js, params, state, x, label)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    slopes = [k for k in got[2] if k.endswith("_w_prelu")]
    assert len(slopes) == 2
    for k, g in got[2].items():
        r = np.asarray(ref[2][k])
        assert np.abs(r).max() > 0, k
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=k)


# --------------------------------------------------------- MobileNet-v1 #


@pytest.fixture(scope="module")
def mobilenet_pair():
    net = mobilenet_v1(2, 10, Mode.TRAIN, width_mult=0.25)
    jnet = jmobilenet(2, 10, JMode.TRAIN, width_mult=0.25)
    p_np, s_np = bridge.he_numpy_weights(net, 0)
    rng = np.random.RandomState(1)
    x = rng.rand(2, 3, 224, 224).astype(np.float32)
    label = np.zeros((2, 10), np.float32)
    label[[0, 1], [3, 7]] = 1.0
    return jnet, net, p_np, s_np, x, label


def test_mobilenet_train_and_valid_match_bcnn_tpu(mobilenet_pair):
    """MobileNet-v1 now has its TRAIN and VALID modes: the VALID error
    rate, the TRAIN surrogate and its gradients (depthwise through the
    plain grouped conv) against jax.grad."""
    jnet, net, p_np, s_np, x, label = mobilenet_pair
    assert net.nodes[-1].type == LayerType.COST
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    js = {k: jnp.asarray(v) for k, v in s_np.items()}
    batch = {"input": jnp.asarray(x), "label": jnp.asarray(label)}
    params, state = bridge.params_from_numpy(net, p_np, s_np)
    inputs = {"input": torch.from_numpy(x), "label": torch.from_numpy(label)}

    jvalid = float(jget_loss(jexecute(jnet, jp, js, batch, JMode.VALID)))
    with torch.inference_mode():
        valid = float(get_loss(execute(net, params, state, inputs,
                                       Mode.VALID)))
    assert valid == jvalid

    (jsur, jg) = jax.value_and_grad(lambda p: jexecute(
        jnet, p, js, batch, JMode.TRAIN).surrogate)(jp)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    sur = execute(net, leaves, state, inputs, Mode.TRAIN).surrogate
    sur.backward()
    np.testing.assert_allclose(float(sur.detach()), float(jsur), rtol=1e-4)
    got = bridge.params_to_numpy(net, {k: v.grad for k, v in leaves.items()})
    assert set(got) == set(jg)
    for k in got:
        r = np.asarray(jg[k])
        assert np.abs(r).max() > 0, k
        np.testing.assert_allclose(got[k], r, rtol=0,
                                   atol=1e-3 * np.abs(r).max(), err_msg=k)
