"""Training through the shortcut (ELTWISE) layer in the port, against
bcnn_tpu on the CPU: a small Darknet cfg with two shortcuts, two
stride-2 convs, a route, an upsample and two YOLO heads at 64 px
(tests/test_torch_int8_layout.SHORTCUT_CFG), in fp32 under both
gradient routings and at bf16 + act16; the strided add's gradients on
unequal shapes; the routing tables of full YOLOv3 and ResNet-18; and a
training step of full YOLOv3 (examples/yolo/yolov3.cfg at 96 px, batch
2) with its remat and accum_steps forms.

Tolerances are those of tests/test_torch_train.py (gradients within
1e-3 of each tensor's largest; losses rtol 1e-4; updates within 1e-3 of
each tensor's largest update; running stats rtol 1e-4, atol 1e-5), with
its check that every max-pool window picks the same input in both
forwards (these nets have no max-pool: the check holds trivially), and,
at bf16, tests/test_torch_train_bf16.py's per-tensor gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcnn_tpu as bt
from bcnn_tpu import config as jconfig
from bcnn_tpu import learner as jlearner
from bcnn_tpu.compile import build_grad_routing as jax_routing
from bcnn_tpu.compile import execute as jax_execute
from bcnn_tpu.compile import make_train_step as jax_make_train_step
from bcnn_tpu.models import resnet18 as jax_resnet18
from bcnn_tpu.models import yolov3 as jax_yolov3
from bcnn_tpu.ops import misc as jmisc

from bcnn_tpu_torch import Net, Session, bridge, replay
from bcnn_tpu_torch import config as tconfig
from bcnn_tpu_torch.compile import (build_grad_routing, execute,
                                    make_train_step)
from bcnn_tpu_torch.learner import init_opt_state
from bcnn_tpu_torch.models import resnet18, yolov3
from bcnn_tpu_torch.ops import eltwise_add
from bcnn_tpu_torch.types import LayerType, Mode
from tests.test_torch_int8_layout import SHORTCUT_CFG, darknet_parse
from tests.test_torch_train import _pool_choice
from tests.test_torch_train_bf16 import (COS_GAP, NOISE_RATIO, RMS_GAP,
                                         grad_gaps)

torch.set_num_threads(1)

BATCH, SIZE, CLASSES = 2, 64, 2
GRAD_TOL, LOSS_RTOL, UPDATE_TOL = 1e-3, 1e-4, 1e-3


def det_labels(rng, n=BATCH, boxes=4, classes=CLASSES):
    lab = np.zeros((n, 50, 5), np.float32)
    for i in range(n):
        for t in range(boxes):
            lab[i, t] = [rng.uniform(0.15, 0.85), rng.uniform(0.15, 0.85),
                         rng.uniform(0.1, 0.5), rng.uniform(0.1, 0.5),
                         rng.randint(classes)]
    return lab.reshape(n, 250)


def train_pair(tmp_path, text, seed=3, residual_scale=0.5, bf16=False):
    """(bcnn_tpu's net, the port's, params_np, state_np) from Darknet cfg
    `text` in TRAIN, He-scaled weights from `seed`."""
    cfg = tmp_path / "net.cfg"
    cfg.write_text(text)
    jnet = darknet_parse(jconfig, bt.Net(bt.Mode.TRAIN), str(cfg))
    net = darknet_parse(tconfig, Net(Mode.TRAIN), str(cfg))
    if bf16:
        jnet.compute_dtype = jnet.train_act_dtype = jnp.bfloat16
        net.compute_dtype = net.train_act_dtype = torch.bfloat16
    p_np, s_np = bridge.he_numpy_weights(net, seed,
                                         residual_scale=residual_scale)
    return jnet, net, p_np, s_np


def jax_grads(jnet, p_np, s_np, x, lab):
    return jax.jit(jax.grad(lambda p: jax_execute(
        jnet, p, {k: jnp.asarray(v) for k, v in s_np.items()},
        {"input": jnp.asarray(x), "label": jnp.asarray(lab)},
        bt.Mode.TRAIN).surrogate))(
        {k: jnp.asarray(v) for k, v in p_np.items()})


def port_grads(net, p_np, s_np, x, lab):
    """(gradients in bcnn_tpu's layout, the executor)."""
    params, state = bridge.params_from_numpy(net, p_np, s_np)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    ex = execute(net, leaves, state, {"input": torch.from_numpy(x),
                                      "label": torch.from_numpy(lab)},
                 Mode.TRAIN)
    ex.surrogate.backward()
    return bridge.params_to_numpy(
        net, {k: v.grad for k, v in leaves.items()}), ex


def same_pool_choice(jnet, net, p_np, s_np, ex, x, lab):
    srcs = [n.src[0] for n in net.nodes if n.type == LayerType.MAXPOOL]
    jex = jax_execute(jnet, {k: jnp.asarray(v) for k, v in p_np.items()},
                      {k: jnp.asarray(v) for k, v in s_np.items()},
                      {"input": jnp.asarray(x), "label": jnp.asarray(lab)},
                      bt.Mode.TRAIN)
    jv = {i: torch.from_numpy(np.transpose(np.asarray(jex.values[i]),
                                           (0, 3, 1, 2)).copy())
          for i in srcs}
    tv = {i: ex.values[i].detach() for i in srcs}
    return all(torch.equal(a, b) for a, b in zip(_pool_choice(net, jv),
                                                 _pool_choice(net, tv)))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(5)
    x = (rng.rand(BATCH, 3, SIZE, SIZE) * 2 - 1).astype(np.float32)
    return x, det_labels(rng)


def test_shortcut_routing_table(tmp_path):
    """Each shortcut's from=-3 source feeds a conv (which overwrites its
    gradient) and the add (which accumulates): both packages route it."""
    jnet, net, _, _ = train_pair(tmp_path, SHORTCUT_CFG)
    route = build_grad_routing(net)
    assert route == jax_routing(jnet)
    adds = [i for i, n in enumerate(net.nodes)
            if n.type == LayerType.ELTWISE]
    assert len(adds) == 2
    for i in adds:
        src = net.nodes[i].src[1]  # the from=-3 source
        (rec,) = [v for k, v in route.items() if k[0] == src]
        assert rec[0][1] and (i, False) in rec


@pytest.mark.parametrize("routing", [True, False], ids=["ref", "autograd"])
def test_shortcut_gradients_match_jax_grad(tmp_path, batch, routing):
    """The gradient of every parameter of the shortcut net against
    jax.grad, with the reference's routing (the skip gradient dropped
    where a conv also reads the source) and with autograd's sum."""
    jnet, net, p_np, s_np = train_pair(tmp_path, SHORTCUT_CFG)
    jnet.ref_grad_routing = net.ref_grad_routing = routing
    x, lab = batch
    ref = jax_grads(jnet, p_np, s_np, x, lab)
    got, ex = port_grads(net, p_np, s_np, x, lab)
    assert same_pool_choice(jnet, net, p_np, s_np, ex, x, lab)
    assert set(got) == set(ref)
    for k, g in got.items():
        r = np.asarray(ref[k])
        assert np.abs(r).max() > 0, k
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=k)


def test_routing_drops_the_skip_gradient(tmp_path, batch):
    """Under the reference's routing the layers below the first shortcut
    see its conv's gradient only, so they differ from autograd's sum;
    the second head's layers, above both adds, do not."""
    _, net, p_np, s_np = train_pair(tmp_path, SHORTCUT_CFG)
    x, lab = batch
    routed, _ = port_grads(net, p_np, s_np, x, lab)
    net.ref_grad_routing = False
    summed, _ = port_grads(net, p_np, s_np, x, lab)
    for k in ("lid0_w", "lid1_w"):
        assert np.abs(routed[k] - summed[k]).max() > 1e-2 * np.abs(
            summed[k]).max(), k
    last = net.tensors[[n for n in net.nodes
                        if n.type == LayerType.CONV2D][-1].src[1]].key
    np.testing.assert_allclose(routed[last], summed[last], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("routing", [True, False], ids=["ref", "autograd"])
def test_shortcut_sgd_step_matches_bcnn_tpu(tmp_path, batch, routing):
    """One Session.train_on_batch step against bcnn_tpu's
    make_train_step: the loss, every parameter's update, the running
    stats."""
    jnet, net, p_np, s_np = train_pair(tmp_path, SHORTCUT_CFG)
    jnet.ref_grad_routing = net.ref_grad_routing = routing
    x, lab = batch
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    js = {k: jnp.asarray(v) for k, v in s_np.items()}
    jo = jlearner.init_opt_state(jnet, jp)
    jp, js, _, jloss = jax_make_train_step(jnet)(
        jp, js, jo, {"input": jnp.asarray(x), "label": jnp.asarray(lab)},
        jax.random.PRNGKey(0))
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(net, p_np, s_np)
    sess.compile_net()
    loss = float(sess.train_on_batch(x, lab))
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    moved = 0
    for k, v in bridge.params_to_numpy(net, sess.params).items():
        r, r0 = np.asarray(jp[k]), p_np[k]
        moved += int(np.abs(r - r0).max() > 0)
        np.testing.assert_allclose(
            v - r0, r - r0, rtol=0,
            atol=UPDATE_TOL * np.abs(r - r0).max(), err_msg=k)
    assert moved >= 20
    for k, v in bridge.params_to_numpy(net, sess.state).items():
        np.testing.assert_allclose(v, np.asarray(js[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_shortcut_bf16_gradients_match_bcnn_tpu(tmp_path, batch):
    """bf16 + act16 through the shortcuts: every parameter's gradient
    against bcnn_tpu's bf16 one under tests/test_torch_train_bf16.py's
    per-tensor gate (bcnn_tpu's bf16-to-fp32 gap as the noise where its
    own gate fails), the adds' outputs stored in bf16."""
    jnet, net, p_np, s_np = train_pair(tmp_path, SHORTCUT_CFG, bf16=True)
    x, lab = batch
    ref = jax_grads(jnet, p_np, s_np, x, lab)
    jnet.compute_dtype = jnet.train_act_dtype = None
    ref32 = jax_grads(jnet, p_np, s_np, x, lab)
    got, ex = port_grads(net, p_np, s_np, x, lab)
    for n in net.nodes:
        if n.type == LayerType.ELTWISE:
            assert ex.values[n.dst[0]].dtype == torch.bfloat16
    assert all(g.dtype == np.float32 for g in got.values())
    gaps = grad_gaps(ref, got)
    noise = grad_gaps(ref32, {k: np.asarray(v) for k, v in ref.items()})
    assert len(gaps) == len(noise) >= 20
    clean = [k for k, (c, r) in noise.items() if c <= 0.01 and r < 0.5]
    for k, (cos_gap, rms_gap) in gaps.items():
        if k in clean:
            assert cos_gap <= COS_GAP, f"{k}: 1 - cosine {cos_gap:.3g}"
            assert rms_gap < RMS_GAP, f"{k}: max|d| {rms_gap:.3g} rms"
        else:
            assert cos_gap <= NOISE_RATIO * noise[k][0], k
            assert rms_gap <= NOISE_RATIO * noise[k][1], k


ELTWISE_GRAD_CASES = {
    "src1_half": ((2, 4, 8, 8), (2, 4, 4, 4)),
    "src1_double": ((2, 4, 4, 4), (2, 4, 8, 8)),
    "fewer_channels": ((2, 6, 6, 6), (2, 3, 3, 3)),
    "more_channels": ((2, 3, 9, 9), (2, 5, 3, 3)),
}


@pytest.mark.parametrize("case", list(ELTWISE_GRAD_CASES))
def test_strided_eltwise_gradients_match_jax_grad(case):
    """x0 gets the whole gradient, x1 only its strided subset, as
    jax.grad of bcnn_tpu.ops.misc.eltwise_add gives them."""
    s0, s1 = ELTWISE_GRAD_CASES[case]
    stride = (max(1, s0[3] // s1[3]), max(1, s1[3] // s0[3]))
    min_dim = (min(s0[1], s1[1]), min(s0[2], s1[2]), min(s0[3], s1[3]))
    rng = np.random.RandomState(len(case))
    a, b = rng.randn(*s0).astype(np.float32), rng.randn(*s1).astype(
        np.float32)
    g = rng.randn(*s0).astype(np.float32)
    nhwc = (0, 2, 3, 1)
    ja, jb = jax.grad(lambda u, v: jnp.sum(
        jmisc.eltwise_add(u, v, stride, min_dim) * g.transpose(nhwc)),
        (0, 1))(jnp.asarray(a.transpose(nhwc)), jnp.asarray(b.transpose(
            nhwc)))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    torch.sum(eltwise_add(ta, tb, stride, min_dim) * torch.from_numpy(
        g)).backward()
    np.testing.assert_array_equal(ta.grad.numpy(),
                                  np.asarray(ja).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(tb.grad.numpy(),
                                  np.asarray(jb).transpose(0, 3, 1, 2))
    assert (tb.grad == 0).any() or stride[1] == 1 and s1[1] <= s0[1]


@pytest.mark.parametrize("which", ["yolov3_416", "resnet18"])
def test_full_routing_tables_match_bcnn_tpu(which):
    """The routing table of full YOLOv3 at 416 px (23 shortcuts, three
    heads) and of ResNet-18: equal to bcnn_tpu's. No forward runs."""
    if which == "yolov3_416":
        jnet = jax_yolov3(1, 416, 416, 80, mode=bt.Mode.TRAIN)
        net = yolov3(1, 416, 416, 80, mode=Mode.TRAIN)
        n_adds, n_routed = 23, 23
    else:
        jnet = jax_resnet18(1, 1000, bt.Mode.TRAIN)
        net = resnet18(1, 1000, Mode.TRAIN)
        n_adds, n_routed = 8, 5  # a projection's add reads no shared skip
    route = build_grad_routing(net)
    assert route == jax_routing(jnet)
    adds = {i for i, n in enumerate(net.nodes)
            if n.type == LayerType.ELTWISE}
    assert len(adds) == n_adds
    routed_adds = {pos for rec in route.values() for pos, ov in rec
                   if pos in adds}
    assert len(routed_adds) == n_routed


@pytest.fixture(scope="module")
def full():
    """Full YOLOv3 (examples/yolo/yolov3.cfg: 75 convs, 23 shortcuts,
    three heads) in TRAIN at 96 px, batch 2, 2 classes, in both
    packages; He-scaled weights, each residual branch's BN scales times
    0.1, as phase 10 of chip_smoke.py seeds them."""
    jnet = jax_yolov3(BATCH, 96, 96, CLASSES, mode=bt.Mode.TRAIN)
    net = yolov3(BATCH, 96, 96, CLASSES, mode=Mode.TRAIN)
    p_np, s_np = bridge.he_numpy_weights(net, 0, residual_scale=0.1)
    return jnet, net, p_np, s_np


def f64_update(net, p_np, s_np, x, lab):
    """The parameters after one SGD step whose gradients the port takes
    in float64 (`replay.sgd_update`: the update itself in float32, from
    a fresh optimizer state), in bcnn_tpu's layout: the step's exact
    update, to within the update's own float32 rounding."""
    params, state = bridge.params_from_numpy(net, p_np, s_np)
    update, _ = replay.sgd_update(net, params, state,
                                  {"input": x, "label": lab}, torch.float64)
    return bridge.params_to_numpy(
        net, {k: v + update.get(k, 0) for k, v in params.items()})


def assert_updates(net, p_np, s_np, x, lab, params, jparams, exact=None):
    """Every parameter's update in the port's step (`params`, after one
    step from p_np) within UPDATE_TOL of its largest entry of the float64
    step's update (`f64_update`, or `exact`, the parameters after a
    float64 step given by the caller), and within UPDATE_TOL of
    bcnn_tpu's (`jparams`), or twice bcnn_tpu's own distance to the
    float64 update where that is wider. A float32 spacing of the
    parameter's largest entry is the floor of both: an update may fall
    below the parameter's own rounding (a layer whose gradient the
    routing has faded, whose update is then its weight decay)."""
    if exact is None:
        exact = f64_update(net, p_np, s_np, x, lab)
    for k, v in bridge.params_to_numpy(net, params).items():
        r0 = p_np[k]
        du, du_j, du_64 = v - r0, np.asarray(jparams[k]) - r0, exact[k] - r0
        floor = np.spacing(np.abs(r0).max())
        np.testing.assert_allclose(
            du, du_64, rtol=0,
            atol=max(UPDATE_TOL * np.abs(du_64).max(), floor), err_msg=k)
        np.testing.assert_allclose(
            du, du_j, rtol=0,
            atol=max(UPDATE_TOL * np.abs(du_j).max(), floor,
                     2 * np.abs(du_j - du_64).max()), err_msg=k)


def test_full_yolov3_step_matches_bcnn_tpu(full):
    """One SGD step of full YOLOv3 through Session against bcnn_tpu's
    make_train_step: the loss, the running stats, and every parameter's
    update (`assert_updates`): bcnn_tpu's jitted fp32 step on the CPU
    comes up to 2% of the largest gradient away from float64 in the
    96 px net's last head (lid91_w; the port's fp32 gradients stay within
    6e-6 of it), its sums being taken in another order."""
    jnet, net, p_np, s_np = full
    rng = np.random.RandomState(7)
    x = (rng.rand(BATCH, 3, 96, 96) * 2 - 1).astype(np.float32)
    lab = det_labels(rng)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    js = {k: jnp.asarray(v) for k, v in s_np.items()}
    jp, js, _, jloss = jax_make_train_step(jnet)(
        jp, js, jlearner.init_opt_state(jnet, jp),
        {"input": jnp.asarray(x), "label": jnp.asarray(lab)},
        jax.random.PRNGKey(0))
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(net, p_np, s_np)
    sess.compile_net()
    np.testing.assert_allclose(float(sess.train_on_batch(x, lab)),
                               float(jloss), rtol=LOSS_RTOL)
    assert_updates(net, p_np, s_np, x, lab, sess.params, jp)
    for k, v in bridge.params_to_numpy(net, sess.state).items():
        np.testing.assert_allclose(v, np.asarray(js[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_full_yolov3_step_forms(full):
    """On full YOLOv3: remat gives the plain step's update, and
    accum_steps=2 runs (two microbatches, one update: finite, every
    trainable parameter moved)."""
    _, net, p_np, s_np = full
    rng = np.random.RandomState(8)
    batch = {"input": torch.from_numpy(
        (rng.rand(BATCH, 3, 96, 96) * 2 - 1).astype(np.float32)),
        "label": torch.from_numpy(det_labels(rng))}

    def run(**kw):
        params, state = bridge.params_from_numpy(net, p_np, s_np)
        opt = init_opt_state(net, params)
        out = make_train_step(net, **kw)(params, state, opt, batch)
        return out[0], float(out[3])

    plain, l0 = run()
    remat, l1 = run(remat=True)
    accum, l2 = run(accum_steps=2)
    assert l1 == pytest.approx(l0, rel=1e-6)
    assert np.isfinite(l2) and l2 > 0
    start = bridge.tensors_from_numpy(net, p_np)
    heads = {net.tensors[n.src[1]].key for i, n in enumerate(net.nodes)
             if i + 1 < len(net.nodes)
             and net.nodes[i + 1].type == LayerType.YOLOV3}
    assert len(heads) == 3
    for k, v in plain.items():
        torch.testing.assert_close(remat[k], v, rtol=0, atol=0)
        assert torch.isfinite(accum[k]).all()
        if k in heads:
            assert not torch.equal(accum[k], start[k]), k
