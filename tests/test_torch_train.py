"""The port's training path against bcnn_tpu's on the CPU: the learner,
the BN backward, the YOLO deltas, the gradient routing, the conv
gradients, and three augmented training steps of YOLOv3-tiny through
`Session.train_on_batch`, on the same numpy inputs and JAX's weights.

Tolerances:
  - learner: rtol 1e-5, atol 1e-7 (the same float32 formulas; XLA's pow
    and numpy's may differ by an ulp);
  - BN, deltas, conv: rtol 1e-4 or tighter (sums taken in another order);
  - gradients of the whole net: rtol 1e-3 of each tensor's largest
    gradient (a 13-conv chain of such sums);
  - the trajectory: losses rtol 1e-4; each parameter's total update
    within 1e-3 of its largest entry; BN running stats rtol 1e-4,
    atol 1e-5.
A max-pool window whose two largest inputs differ by less than the two
forwards' rounding routes its gradient to another input in each package
(the repo's own training-parity tests budget for such flips); the net
tests check that every window picks the same input in both forwards
(`same_pool_choice`)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bcnn_tpu import learner as jlearner
from bcnn_tpu import ops as jops
from bcnn_tpu.compile import _grad_split as jax_grad_split
from bcnn_tpu.compile import build_grad_routing as jax_routing
from bcnn_tpu.compile import execute as jax_execute
from bcnn_tpu.compile import init_params as jax_init_params
from bcnn_tpu.compile import make_train_step as jax_make_train_step
from bcnn_tpu.data import device_augment as jda
from bcnn_tpu.graph import Net as JaxNet
from bcnn_tpu.models import yolov3_tiny as jax_tiny
from bcnn_tpu.ops import norm as jnorm
from bcnn_tpu.ops import yolo as jyolo
from bcnn_tpu.types import Mode as JaxMode

from bcnn_tpu_torch import Session, bridge, learner, ops, replay
from bcnn_tpu_torch.compile import (
    _grad_split,
    build_grad_routing,
    execute,
)
from bcnn_tpu_torch.data import device_augment as tda
from bcnn_tpu_torch.graph import Net
from bcnn_tpu_torch.models import yolov3_tiny
from bcnn_tpu_torch.ops import yolo as tyolo
from bcnn_tpu_torch.types import (
    Activation,
    FillerType,
    LayerType,
    LrDecay,
    Mode,
    Optimizer,
)

torch.set_num_threads(1)

BATCH, SIZE, CLASSES = 2, 64, 4
ANCHORS = [10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319]


# ------------------------------------------------------------- learner #


def _small_pair():
    """The same two-conv net (one with BN) built in both packages."""
    nets = []
    for cls, mode in ((JaxNet, JaxMode.TRAIN), (Net, Mode.TRAIN)):
        net = cls(mode)
        net.set_input_shape(6, 6, 2, 2)
        net.add_convolutional_layer(4, 3, 1, 1, 1, 1, FillerType.XAVIER,
                                    Activation.LRELU, 0, "input", "c1")
        net.add_convolutional_layer(3, 1, 1, 0, 1, 0, FillerType.XAVIER,
                                    Activation.NONE, 0, "c1", "c2")
        nets.append(net)
    return nets


LEARNER_CASES = {
    "sgd_decay": (Optimizer.SGD, LrDecay.CONSTANT, {}),
    "adam": (Optimizer.ADAM, LrDecay.CONSTANT, {}),
    "step": (Optimizer.SGD, LrDecay.STEP, dict(scale=0.5, step=2)),
    "inv": (Optimizer.SGD, LrDecay.INV, dict(gamma=0.1, power=0.75)),
    "exp": (Optimizer.SGD, LrDecay.EXP, dict(gamma=0.9)),
    "poly": (Optimizer.ADAM, LrDecay.POLY, dict(power=2.0, max_batches=10)),
    "sigmoid": (Optimizer.SGD, LrDecay.SIGMOID, dict(gamma=-0.5, step=2)),
}


@pytest.mark.parametrize("case", list(LEARNER_CASES))
def test_apply_updates_matches_bcnn_tpu(case):
    opt, decay_type, policy = LEARNER_CASES[case]
    jnet, net = _small_pair()
    for n in (jnet, net):
        if opt == Optimizer.ADAM:
            n.set_adam_optimizer(0.05, 0.85, 0.99)
        else:
            n.set_sgd_optimizer(0.05, 0.8)
        n.set_weight_regularizer(0.01)
        n.set_learning_rate_policy(decay_type, **policy)
    rng = np.random.RandomState(len(case))
    jp, _ = jax_init_params(jnet, 0)
    jp = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32))
          for k, v in jp.items()}
    jo = jlearner.init_opt_state(jnet, jp)
    tp = bridge.tensors_from_numpy(
        net, {k: np.asarray(v) for k, v in jp.items()})
    to = learner.init_opt_state(net, tp)
    scales0 = tp["input_scales"].clone()
    assert set(to["velocity"]) == set(jo["velocity"])
    assert set(to["adam_m"]) == set(jo["adam_m"])
    for _ in range(3):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in jp.items()}
        jp, jo = jlearner.apply_updates(
            jnet, jp, {k: jnp.asarray(v) for k, v in g.items()}, jo)
        tg = bridge.tensors_from_numpy(net, g)
        tp, to = learner.apply_updates(net, tp, tg, to)
        got = bridge.params_to_numpy(net, tp)
        for k in got:
            np.testing.assert_allclose(got[k], np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert to["seen"] == int(jo["seen"])
        for name in ("velocity", "adam_m", "adam_v"):
            got = bridge.params_to_numpy(net, to[name])
            for k in got:
                np.testing.assert_allclose(
                    got[k], np.asarray(jo[name][k]), rtol=1e-5, atol=1e-7)
    # non-trainable BN scales never move
    assert torch.equal(tp["input_scales"], scales0)


@pytest.mark.parametrize("decay_type", list(LrDecay))
def test_learning_rate_matches_bcnn_tpu(decay_type):
    jnet, net = _small_pair()
    for n in (jnet, net):
        n.set_learning_rate_policy(decay_type, gamma=0.3, scale=0.7,
                                   power=1.5, max_batches=20, step=3)
    for it in range(12):
        ref = float(jlearner.learning_rate(jnet.learner, jnp.int32(it)))
        got = float(learner.learning_rate(net.learner, it))
        np.testing.assert_allclose(got, ref, rtol=1e-6)


# ------------------------------------------------------------------ BN #


def test_bn_train_matches_reference_backward():
    """Forward, the reference's hand-written backward and the running
    stats against jax.vjp of bcnn_tpu's _bn_train_ref. Channel 3 has a
    variance far below 1e-5, where the backward's eps 1e-5 (the forward
    uses 1e-6) changes dx by about 3x against autograd's."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 4, 5, 3) * 2 + 0.5).astype(np.float32)
    x[:, 3] = (rng.randn(2, 5, 3) * 1e-4).astype(np.float32)
    scales = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    biases = rng.randn(4).astype(np.float32)
    rmean = rng.randn(4).astype(np.float32)
    rvar = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    xj = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    yj, vjp = jax.vjp(jnorm._bn_train_ref, xj, jnp.asarray(scales),
                      jnp.asarray(biases))
    dxj, dsj, dbj = vjp(jnp.asarray(np.transpose(g, (0, 2, 3, 1))))
    _, nmj, nvj = jnorm.batch_norm(xj, jnp.asarray(scales),
                                   jnp.asarray(biases), jnp.asarray(rmean),
                                   jnp.asarray(rvar), training=True)

    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(scales).requires_grad_()
    bt = torch.from_numpy(biases).requires_grad_()
    y, nm, nv = ops.batch_norm_train(xt, st, bt, torch.from_numpy(rmean),
                                     torch.from_numpy(rvar))
    assert not nm.requires_grad and not nv.requires_grad
    y.backward(torch.from_numpy(g))

    def nchw(a):
        return np.transpose(np.asarray(a), (0, 3, 1, 2))

    np.testing.assert_allclose(y.detach().numpy(), nchw(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), nchw(dxj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(dsj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(dbj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nm.numpy(), np.asarray(nmj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(nv.numpy(), np.asarray(nvj), rtol=1e-5,
                               atol=1e-7)

    # not autograd's gradient of the forward: off by the eps quirk
    xa = torch.from_numpy(x).requires_grad_()
    m = xa.mean((0, 2, 3), keepdim=True)
    v = (xa * xa).mean((0, 2, 3), keepdim=True) - m * m
    ((xa - m) * torch.rsqrt(v + 1e-6) * st.detach().reshape(1, -1, 1, 1)
     ).backward(torch.from_numpy(g))
    ratio = xa.grad[:, 3].abs().sum() / xt.grad[:, 3].abs().sum()
    assert ratio > 2.0


# --------------------------------------------------------------- YOLO #


def _delta_case():
    """A 4x4 head of 4 classes and (N, 250) labels: two truths on one
    slot (classes merge), a truth whose best anchor another head owns, a
    zero x mid-list that ends the truths, and a truth after it."""
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 27, 4, 4) * 2).astype(np.float32)
    lab = np.zeros((2, 50, 5), np.float32)
    lab[0, 0] = [0.30, 0.30, 0.10, 0.12, 0]
    lab[0, 1] = [0.31, 0.32, 0.11, 0.13, 2]  # same cell and anchor
    lab[0, 2] = [0.60, 0.70, 0.90, 0.90, 1]  # best anchor 3: not owned
    lab[0, 3] = [0.80, 0.20, 0.30, 0.35, 3]
    lab[1, 0] = [0.55, 0.45, 0.20, 0.25, 1]
    lab[1, 1] = [0.00, 0.40, 0.20, 0.20, 2]  # x == 0 ends the truths
    lab[1, 2] = [0.70, 0.70, 0.20, 0.20, 3]  # never read
    param = dict(num=3, classes=4, coords=4, total=6, mask=[0, 1, 2],
                 anchors=[float(a) for a in ANCHORS], net_w=64, net_h=64)
    return x, lab.reshape(2, 250), param


def test_yolo_train_deltas_match_bcnn_tpu():
    x, lab, p = _delta_case()
    xj = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    ref = np.asarray(jax.jit(lambda y, t: jyolo.yolo_train_deltas(
        y, t, p, 64, 64))(jyolo.yolo_head(xj, 3, 4), jnp.asarray(lab)))
    ref = np.transpose(ref, (0, 3, 1, 2))
    loop = jax.jit(lambda y, t: jyolo._yolo_train_deltas_loop(
        y, t, p, 64, 64))(jyolo.yolo_head(xj, 3, 4), jnp.asarray(lab))
    loop = np.transpose(np.asarray(loop), (0, 3, 1, 2))
    got = tyolo.yolo_train_deltas(
        tyolo.yolo_head(torch.from_numpy(x), 3, 4), torch.from_numpy(lab),
        p, 64, 64).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, loop, rtol=1e-5, atol=1e-6)
    # the shared slot carries both truths' classes: cell (1, 1), anchor 0
    row = got[0, 0:9, 1, 1]
    assert row[5] < 0 and row[7] < 0  # out - 1 on classes 0 and 2
    assert row[6] > 0 and row[8] > 0
    # the truth after the terminator wrote nothing at its cell (2, 2)
    assert np.all(got[1, :, 2, 2][[0, 1, 2, 3, 9, 10, 11, 12]] == 0)


def test_yolo_surrogate_gradient_is_delta():
    x, lab, p = _delta_case()
    xt = torch.from_numpy(x).requires_grad_()
    y, (sur, cost) = tyolo.yolo_forward(xt, torch.from_numpy(lab), p,
                                        Mode.TRAIN)
    sur.backward()
    delta = tyolo.yolo_train_deltas(y.detach(), torch.from_numpy(lab), p,
                                    64, 64)
    assert torch.equal(xt.grad, delta)
    jcost = jax.jit(lambda a, t: jyolo.yolo_forward(
        a, t, p, JaxMode.TRAIN, 2)[1][1])(
        jnp.asarray(np.transpose(x, (0, 2, 3, 1))), jnp.asarray(lab))
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-5)
    y2, aux = tyolo.yolo_forward(xt, None, p, Mode.TRAIN)
    assert aux is None and torch.equal(y2, y)


# --------------------------------------------------------------- conv #


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_conv_gradients_match_bcnn_tpu(k, stride, pad):
    rng = np.random.RandomState(k + stride)
    x = rng.randn(2, 5, 9, 8).astype(np.float32)
    w = (rng.randn(6, 5, k, k) * 0.3).astype(np.float32)
    xj = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    wj = jnp.asarray(np.transpose(w, (2, 3, 1, 0)))
    yj, vjp = jax.vjp(lambda a, b: jops.conv2d(a, b, stride, pad), xj, wj)
    g = rng.randn(*yj.shape).astype(np.float32)
    dxj, dwj = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = ops.conv2d(xt, wt, stride, pad)
    y.backward(torch.from_numpy(np.transpose(g, (0, 3, 1, 2)).copy()))
    np.testing.assert_allclose(
        xt.grad.numpy(), np.transpose(np.asarray(dxj), (0, 3, 1, 2)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        wt.grad.numpy(), np.transpose(np.asarray(dwj), (3, 2, 0, 1)),
        rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ routing #


@pytest.mark.parametrize("flags", [(True, False), (False, True),
                                   (False, True, False), (False, False)])
def test_grad_split_combines_like_bcnn_tpu(flags):
    rng = np.random.RandomState(len(flags))
    x = rng.randn(3, 4).astype(np.float32)
    gs = [rng.randn(3, 4).astype(np.float32) for _ in flags]
    _, vjp = jax.vjp(lambda a: jax_grad_split(flags, a), jnp.asarray(x))
    (ref,) = vjp(tuple(jnp.asarray(g) for g in gs))
    xt = torch.from_numpy(x).requires_grad_()
    outs = _grad_split(flags, xt)
    sum((o * torch.from_numpy(g)).sum() for o, g in zip(outs, gs)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=1e-6)


def _bn_stats(specs, seed=0):
    rng = np.random.RandomState(seed)
    return {
        t.key: rng.uniform(
            *((0.5, 1.5) if t.key.endswith("_run_var") else (-0.1, 0.1)),
            t.mem_shape,
        ).astype(np.float32)
        for t in specs
    }


def _det_labels(rng, n=BATCH, boxes=4):
    lab = np.zeros((n, 50, 5), np.float32)
    for i in range(n):
        for t in range(boxes):
            lab[i, t] = [rng.uniform(0.15, 0.85), rng.uniform(0.15, 0.85),
                         rng.uniform(0.1, 0.5), rng.uniform(0.1, 0.5),
                         rng.randint(CLASSES)]
    return lab.reshape(n, 250)


def _pool_choice(net, values):
    """The input each max-pool window picks, per pool node, from the
    pool inputs `values` (tensor index -> NCHW tensor)."""
    out = []
    for node in net.nodes:
        if node.type != LayerType.MAXPOOL:
            continue
        v, p = values[node.src[0]], node.param
        d = net.tensors[node.dst[0]]
        pad_h = max(0, (d.h - 1) * p["stride"] + p["size"] - v.shape[2])
        pad_w = max(0, (d.w - 1) * p["stride"] + p["size"] - v.shape[3])
        v = F.pad(v, (0, pad_w, 0, pad_h), value=float("-inf"))
        out.append(v.unfold(2, p["size"], p["stride"]).unfold(
            3, p["size"], p["stride"]).flatten(-2).argmax(-1))
    return out


def same_pool_choice(tiny, jparams, jstate, tparams, tstate, batch):
    """Whether every max-pool window of the TRAIN forward picks the same
    input in bcnn_tpu (on jparams/jstate) and in the port (on
    tparams/tstate); batch holds numpy "input" (NCHW) and "label"."""
    net = tiny[1]
    jvals = {
        s: torch.from_numpy(np.transpose(np.asarray(v), (0, 3, 1, 2)).copy())
        for s, v in tiny[4](jparams, jstate, batch).items()
    }
    with torch.no_grad():
        tex = execute(net, tparams, tstate,
                      {k: torch.from_numpy(np.array(v))
                       for k, v in batch.items()},
                      Mode.TRAIN)
    return all(torch.equal(a, b) for a, b in zip(
        _pool_choice(net, jvals), _pool_choice(net, tex.values)))


@pytest.fixture(scope="module")
def tiny():
    """YOLOv3-tiny TRAIN at 64 px in both packages, JAX's weights."""
    jnet = jax_tiny(BATCH, SIZE, SIZE, CLASSES, mode=JaxMode.TRAIN)
    jp, _ = jax_init_params(jnet, 0)
    params_np = {k: np.asarray(v) for k, v in jp.items()}
    state_np = _bn_stats(jnet.state_specs())
    net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES, mode=Mode.TRAIN)
    srcs = [n.src[0] for n in jnet.nodes if n.type == LayerType.MAXPOOL]

    @jax.jit
    def pool_inputs(p, s, batch):
        ex = jax_execute(jnet, p, s, batch, JaxMode.TRAIN)
        return {i: ex.values[i] for i in srcs}

    return jnet, net, params_np, state_np, pool_inputs


def test_grad_routing_matches_bcnn_tpu(tiny):
    jnet, net = tiny[:2]
    route = build_grad_routing(net)
    assert route == jax_routing(jnet)
    # lid14 (made by node 13) feeds the conv lid15, which overwrites,
    # and the route concat lid18, which accumulates
    idx = net.get_tensor_index_by_name("lid14")
    assert route == {(idx, 13): [(14, True), (17, False)]}


def _net_grads(tiny, routing):
    """The port's gradients of the TRAIN surrogate in every parameter,
    held to jax.grad's; numpy, in the JAX layout."""
    jnet, net, params_np, state_np = tiny[:4]
    jnet.ref_grad_routing = net.ref_grad_routing = routing
    try:
        rng = np.random.RandomState(3)
        x = (rng.rand(BATCH, 3, SIZE, SIZE) * 2 - 1).astype(np.float32)
        lab = _det_labels(rng)
        batch_j = {"input": jnp.asarray(x), "label": jnp.asarray(lab)}
        ref = jax.jit(jax.grad(lambda p: jax_execute(
            jnet, p, {k: jnp.asarray(v) for k, v in state_np.items()},
            batch_j, JaxMode.TRAIN).surrogate))(
            {k: jnp.asarray(v) for k, v in params_np.items()})
        params, state = bridge.params_from_numpy(net, params_np, state_np)
        xt, lt = torch.from_numpy(x), torch.from_numpy(lab)
        assert same_pool_choice(tiny, params_np, state_np, params, state,
                                {"input": x, "label": lab})
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        execute(net, leaves, state, {"input": xt, "label": lt},
                Mode.TRAIN).surrogate.backward()
        got = bridge.params_to_numpy(
            net, {k: v.grad for k, v in leaves.items()})
        for k, g in got.items():
            r = np.asarray(ref[k])
            np.testing.assert_allclose(g, r, rtol=0,
                                       atol=1e-3 * np.abs(r).max(),
                                       err_msg=k)
        return got
    finally:
        jnet.ref_grad_routing = net.ref_grad_routing = True


@pytest.mark.parametrize("routing", [True, False])
def test_net_gradients_match_jax_grad(tiny, routing):
    """Gradients of the TRAIN surrogate in every parameter against
    jax.grad, with the reference's routing (which drops the second
    head's gradient into lid14 and everything below it) and without."""
    _net_grads(tiny, routing)


def test_routing_drops_the_second_head_gradient(tiny):
    """With the reference's routing, the trunk below lid14 sees only the
    first head: its gradients differ from plain autograd's sum."""
    routed = _net_grads(tiny, True)
    summed = _net_grads(tiny, False)
    for k in ("lid13_w", "lid8_w", "input_w"):
        assert np.abs(routed[k] - summed[k]).max() > 1e-2 * np.abs(
            summed[k]).max()
    # the second head's own layers are untouched by the routing
    np.testing.assert_allclose(routed["lid22_w"], summed["lid22_w"],
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------- the slice whole #

AUG = dict(rotation_range=20.0, range_shift_x=6, range_shift_y=6,
           min_scale=0.9, max_scale=1.1, random_fliph=1, min_contrast=0.8,
           max_contrast=1.2, min_brightness=-30, max_brightness=30)
STEPS = 3


def _step_params(rng):
    return {
        "theta": np.deg2rad(rng.uniform(-10, 10, BATCH)),
        "scale": rng.uniform(0.9, 1.1, BATCH),
        "tx": rng.uniform(-3, 3, BATCH),
        "ty": rng.uniform(-3, 3, BATCH),
        "contrast": rng.uniform(0.8, 1.2, BATCH),
        "brightness": rng.uniform(-30, 30, BATCH),
        "flip": np.asarray([1.0, 0.0]),
    }


def test_augmented_train_steps_match_bcnn_tpu(tiny, monkeypatch):
    """Three steps of Session.train_on_batch with device_augment
    (rotation, shift, scale, flip, contrast, brightness) against
    bcnn_tpu: its _augment_one / transform_boxes on the same params,
    then its make_train_step. Losses, parameters and running stats."""
    jnet, net, params_np, state_np = tiny[:4]
    rng = np.random.RandomState(1)
    x = (rng.rand(BATCH, 3, SIZE, SIZE) * 255).astype(np.uint8)
    lab = _det_labels(rng)
    draws = [
        {k: np.asarray(v, np.float32) for k, v in _step_params(rng).items()}
        for _ in range(STEPS)
    ]

    # bcnn_tpu: augment on the given params, then the bare train step
    kw = jda._geo_kwargs(AUG)
    aug_one = jax.vmap(functools.partial(jda._augment_one, **kw))
    jstep = jax_make_train_step(jnet)
    jp = {k: jnp.asarray(v) for k, v in params_np.items()}
    js = {k: jnp.asarray(v) for k, v in state_np.items()}
    jo = jlearner.init_opt_state(jnet, jp)
    xj = jnp.asarray(np.transpose(x, (0, 2, 3, 1)), jnp.float32)
    ref_losses, ref_steps = [], []
    for p in draws:
        pj = {k: jnp.asarray(v) for k, v in p.items()}
        xa = (aug_one(xj, pj) - 127.5) * (1 / 127.5)
        la = jda.transform_boxes(jnp.asarray(lab), pj, SIZE, SIZE)
        batch = {"input": jnp.transpose(xa, (0, 3, 1, 2)), "label": la}
        ref_steps.append((
            {k: np.asarray(v) for k, v in jp.items()},
            {k: np.asarray(v) for k, v in js.items()},
            {k: np.asarray(v) for k, v in batch.items()},
        ))
        jp, js, jo, loss = jstep(jp, js, jo, batch, jax.random.PRNGKey(0))
        ref_losses.append(float(loss))

    # the port, through its public entry point
    net.device_augment = AUG
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(
        net, params_np, state_np)
    sess.compile_net()
    queue = list(draws)
    monkeypatch.setattr(tda, "sample_params", lambda *a: {
        k: torch.from_numpy(v) for k, v in queue.pop(0).items()})
    losses = []
    for jparams, jstate, batch in ref_steps:
        assert same_pool_choice(tiny, jparams, jstate, sess.params,
                                sess.state, batch)
        loss = sess.train_on_batch(x, lab)
        assert loss.dim() == 0 and loss.device.type == "cpu"
        losses.append(float(loss))
    assert not queue  # one draw per step
    assert sess.opt_state["seen"] == STEPS * BATCH

    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert len(set(ref_losses)) == STEPS  # the weights moved between steps
    got = sess.params
    for k, v in bridge.params_to_numpy(net, got).items():
        r, r0 = np.asarray(jp[k]), params_np[k]
        np.testing.assert_allclose(
            v - r0, r - r0, rtol=0, atol=1e-3 * np.abs(r - r0).max(),
            err_msg=k)
    for k, v in bridge.params_to_numpy(net, sess.state).items():
        np.testing.assert_allclose(v, np.asarray(js[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# ------------------------------------------------------------ session #


def test_session_train_api(tiny):
    net, params_np, state_np = tiny[1:4]
    net.device_augment = None
    sess = Session(net, 3, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(
        net, params_np, state_np)
    sess.compile_net()
    assert sess.opt_state["seen"] == 0
    assert set(sess.opt_state["velocity"]) == {
        t.key for t in net.param_specs() if t.trainable}
    with pytest.raises(RuntimeError, match="loader"):
        sess.train_on_batch()  # no data loader set

    rng = np.random.RandomState(2)
    x = (rng.rand(BATCH, 3, SIZE, SIZE) * 255).astype(np.uint8)
    lab = _det_labels(rng)
    seen_dtypes = []
    from bcnn_tpu_torch.compile import make_train_step

    real = make_train_step(net)

    def spy(params, state, opt_state, batch, gen):
        seen_dtypes.append(batch["input"].dtype)
        assert isinstance(gen, torch.Generator)
        return real(params, state, opt_state, batch, gen)

    sess._train_step = spy
    before = {k: v.clone() for k, v in sess.state.items()}
    loss = sess.train_on_batch(x, lab)
    assert seen_dtypes == [torch.uint8]  # cast on the device, not before
    assert torch.isfinite(loss) and float(loss) > 0
    assert any(not torch.equal(before[k], sess.state[k]) for k in before)

    # predict_on_batch in TRAIN runs VALID: running stats stay
    frozen = {k: v.clone() for k, v in sess.state.items()}
    (y,), vloss = sess.predict_on_batch(x.astype(np.float32) / 255, label=lab)
    assert tuple(y.shape) == (BATCH, 27, 4, 4) and float(vloss) == 0.0
    assert all(torch.equal(frozen[k], sess.state[k]) for k in frozen)
    sess.set_mode(Mode.PREDICT)
    assert net.mode == Mode.PREDICT
    sess.set_mode(Mode.TRAIN)


def test_opt_state_bridge_round_trip(tiny):
    jnet, net, params_np = tiny[:3]
    rng = np.random.RandomState(4)
    jo = jlearner.init_opt_state(
        jnet, {k: jnp.asarray(v) for k, v in params_np.items()})
    jo = dict(jo, seen=jnp.int32(6), velocity={
        k: jnp.asarray(rng.randn(*v.shape).astype(np.float32))
        for k, v in jo["velocity"].items()})
    to = bridge.opt_state_from_numpy(net, jax.tree.map(np.asarray, jo))
    assert to["seen"] == 6 and to["adam_m"] == {}
    back = bridge.params_to_numpy(net, to["velocity"])
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(jo["velocity"][k]))
    assert dataclasses.asdict(net.learner)["decay"] == 0.0005


# ------------------------------------------------ F3: fp32 vs float64 #


def test_fp32_update_of_a_seeded_bn_net_against_float64():
    """The CPU half of F3 (tools/f3_float64.py): YOLOv3-tiny with He-scaled
    seeded weights (chip_smoke.py phase 9's) at batch 4, 160 px, whose
    loss is the no-object delta of nearly every cell, so the gradient
    reaching the BN convs is nearly uniform and their backward cancels.
    The port's fp32 update on the CPU, against the float64 one: its worst
    tensor lands 1.32e-3 of its largest entry away (lid4_b; measured),
    above the 1e-3 a card-vs-CPU check asks of the two devices together,
    and of the order F3 measured at batch 32, 416 px (CPU 3.5e-3, card
    3.8e-3: so chip_smoke.BN_UPDATE_TOL is 1e-2). Held within twice the
    measured error, every tensor moving."""
    net = yolov3_tiny(4, 160, 160, 80, mode=Mode.TRAIN)
    params, state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0))
    rng = np.random.RandomState(9)
    x = torch.from_numpy((rng.rand(4, 3, 160, 160) * 2 - 1).astype(
        np.float32))
    lab = torch.from_numpy(_det_labels(rng, 4))
    u64, u32 = (replay.sgd_update(net, params, state,
                                  {"input": x, "label": lab}, dtype)[0]
                for dtype in (torch.float64, torch.float32))
    errs = {k: float((u32[k] - v).abs().max() / v.abs().max())
            for k, v in u64.items() if v.abs().max() > 0}
    assert len(errs) == len(u64)
    worst = max(errs.values())
    assert worst <= 2 * 1.32e-3, sorted(errs.items(), key=lambda kv: -kv[1])
