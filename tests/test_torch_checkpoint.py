"""Full-state checkpoints of the port (`bcnn_tpu_torch.checkpoint`,
`Session.save_checkpoint` / `load_checkpoint`), the counterparts of
tests/test_checkpoint.py, on the CPU: resume bit-exact in the port (SGD
and Adam), the optimizer state kept, the file in `bcnn_tpu`'s format
and layouts, a checkpoint of either package resumed by the other, and
net.qat's ranges.

Crossing packages, each side's next three updates from the checkpoint
are held to the other's with the rule of
tests/test_torch_train_shortcut.assert_updates: within 1e-3 of the
update's largest entry, or one float32 spacing of the parameter's
largest entry (the two packages sum in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcnn_tpu as bt
import bcnn_tpu_torch as tt
from bcnn_tpu_torch import Session, bridge, checkpoint
from bcnn_tpu_torch.models import lenet_mnist
from tests.test_torch_qat import qat_net, task_batch

torch.set_num_threads(1)

UPDATE_TOL = 1e-3
BATCH = 4


def lenet_batch(rng, n=8):
    """tests/test_checkpoint.py's separable batch."""
    lab = rng.randint(0, 10, n)
    x = rng.randn(n, 1, 28, 28).astype(np.float32) * 0.1
    for i, c in enumerate(lab):
        x[i, 0, c:c + 8, c:c + 8] += 1.0
    y = np.zeros((n, 10, 1, 1), np.float32)
    y[np.arange(n), lab] = 1.0
    return x, y


def lenet_session(adam, seed=0):
    net = lenet_mnist(8)
    if adam:
        net.set_adam_optimizer(0.003)
    return Session(net, seed, device="cpu").compile_net()


@pytest.mark.parametrize("adam", [False, True], ids=["sgd", "adam"])
def test_checkpoint_resume_bitexact(tmp_path, adam):
    rng = np.random.RandomState(0)
    batches = [lenet_batch(rng) for _ in range(6)]
    s1 = lenet_session(adam)
    for x, y in batches[:3]:
        s1.train_on_batch(x, y)
    ckpt = str(tmp_path / "ck.npz")
    s1.save_checkpoint(ckpt)
    for x, y in batches[3:]:
        s1.train_on_batch(x, y)

    s2 = lenet_session(adam, seed=1)  # other initial weights
    s2.load_checkpoint(ckpt)
    assert s2._step_count == 3
    for x, y in batches[3:]:
        s2.train_on_batch(x, y)
    for k in s1.params:
        assert torch.equal(s1.params[k], s2.params[k]), k
    for k in s1.state:
        assert torch.equal(s1.state[k], s2.state[k]), k
    assert s1.opt_state["seen"] == s2.opt_state["seen"] == 48
    assert s2._step_count == 6
    if adam:
        assert s1.opt_state["adam_m"]
        for k in s1.opt_state["adam_v"]:
            assert torch.equal(s1.opt_state["adam_v"][k],
                               s2.opt_state["adam_v"][k]), k


def test_checkpoint_keeps_opt_state(tmp_path):
    s = lenet_session(False)
    x, y = lenet_batch(np.random.RandomState(1))
    s.train_on_batch(x, y)
    p = str(tmp_path / "c.npz")
    s.save_checkpoint(p)
    params, state, opt, extra = checkpoint.load_checkpoint(s.net, p, "cpu")
    assert opt["seen"] == 8 and isinstance(opt["seen"], int)
    assert extra["step_count"] == 1
    assert set(params) == set(s.params)
    assert any("run_mean" in k for k in state)
    assert opt["adam_m"] == {} and opt["adam_v"] == {}
    for k, v in s.opt_state["velocity"].items():
        assert torch.equal(opt["velocity"][k], v), k
    # the file itself: bcnn_tpu's keys, dtypes and (HWIO) layouts
    flat, meta = checkpoint.read_npz(p)
    assert meta == {"version": 1, "extra": {"step_count": 1}}
    assert flat["opt/seen"].dtype == np.int32 and flat["opt/seen"] == 8
    jnet = bt.models.lenet_mnist(8)
    for t in jnet.param_specs():
        assert flat[f"params/{t.key}"].shape == tuple(
            bt.compile.init_params(jnet, 0)[0][t.key].shape), t.key


def bn_dw_fc_net(pkg, adam=False):
    """A BN conv, a depthwise layer, a 1x1 BN conv, an FC, softmax and a
    euclidean cost (12x12x3), in either package."""
    net = pkg.Net(pkg.Mode.TRAIN)
    net.set_input_shape(12, 12, 3, BATCH)
    if adam:
        net.set_adam_optimizer(0.01)
    else:
        net.set_sgd_optimizer(0.02, 0.9)
        net.set_weight_regularizer(0.0005)
    X, A = pkg.FillerType.XAVIER, pkg.Activation
    net.add_convolutional_layer(8, 3, 1, 1, 1, 1, X, A.LRELU, 0, "input",
                                "c1")
    net.add_depthwise_conv_layer(3, 2, 1, 0, X, A.RELU, "c1", "dw")
    net.add_convolutional_layer(6, 1, 1, 0, 1, 1, X, A.LRELU, 0, "dw", "c2")
    net.add_fullc_layer(4, X, A.NONE, 0, "c2", "fc")
    net.add_softmax_layer("fc", "sm")
    net.add_cost_layer(pkg.Loss.EUCLIDEAN, pkg.Metric.SSE, 1.0, "sm",
                       "label", "cost")
    return net


def assert_same_updates(net, p0, port_params, jax_params):
    """Each parameter's update from p0 (bcnn_tpu's layout) in the port
    within UPDATE_TOL of bcnn_tpu's largest entry, or a float32 spacing
    of the parameter's largest entry; every trainable one moved."""
    trainable = {t.key for t in net.param_specs() if t.trainable}
    for k, v in port_params.items():
        du, du_j = v - p0[k], np.asarray(jax_params[k]) - p0[k]
        assert (np.abs(du_j).max() > 0) == (k in trainable), k
        np.testing.assert_allclose(
            du, du_j, rtol=0,
            atol=max(UPDATE_TOL * np.abs(du_j).max(),
                     np.spacing(np.abs(p0[k]).max())), err_msg=k)


@pytest.mark.parametrize("adam", [False, True], ids=["sgd", "adam"])
@pytest.mark.parametrize("first", ["bcnn_tpu", "port"])
def test_checkpoint_crosses_packages(tmp_path, first, adam):
    """One package trains 2 steps and saves; the other loads the file
    (the same params, running stats, optimizer buffers and seen), then
    both take the same 3 steps."""
    jnet, net = bn_dw_fc_net(bt, adam), bn_dw_fc_net(tt, adam)
    p_np, s_np = bridge.he_numpy_weights(net, 3)
    rng = np.random.RandomState(4)
    batches = [task_batch(rng, BATCH) for _ in range(5)]
    js = bt.Session(jnet, 0).compile_net()
    js.params = {k: jnp.asarray(v) for k, v in p_np.items()}
    js.state = {k: jnp.asarray(v) for k, v in s_np.items()}
    ts = Session(net, 0, device="cpu").compile_net()
    ts.params, ts.state = bridge.params_from_numpy(net, p_np, s_np)
    ts.opt_state = tt.learner.init_opt_state(net, ts.params)
    saver, loader = (js, ts) if first == "bcnn_tpu" else (ts, js)
    for x, y in batches[:2]:
        saver.train_on_batch(x, y)
    path = str(tmp_path / "ck.npz")
    saver.save_checkpoint(path)
    loader.load_checkpoint(path)
    assert int(np.asarray(loader.opt_state["seen"])) == 2 * BATCH
    assert loader._step_count == 2

    jp = {k: np.asarray(v) for k, v in js.params.items()}
    tp = bridge.params_to_numpy(net, ts.params)
    for k in jp:  # the file moves every float exactly
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    for name in ("velocity", "adam_m", "adam_v"):
        jb = js.opt_state[name]
        tb = bridge.params_to_numpy(net, ts.opt_state[name])
        assert set(tb) == set(jb), name
        for k in jb:
            np.testing.assert_array_equal(tb[k], np.asarray(jb[k]))
    p0 = dict(jp)
    for x, y in batches[2:]:
        js.train_on_batch(x, y)
        ts.train_on_batch(x, y)
    assert_same_updates(net, p0, bridge.params_to_numpy(net, ts.params),
                        js.params)
    for k in s_np:
        np.testing.assert_allclose(ts.state[k].numpy(),
                                   np.asarray(js.state[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert int(np.asarray(js.opt_state["seen"])) == ts.opt_state["seen"]


def test_qat_ranges_round_trip(tmp_path):
    """net.qat's "qat_amax/<idx>" ranges go into the file under state/
    and come back as the port's 0-d tensors, and training resumes on
    them bit for bit."""
    net = qat_net(tt, BATCH)
    s1 = Session(net, 0, device="cpu").compile_net()
    rng = np.random.RandomState(5)
    batches = [task_batch(rng, BATCH) for _ in range(3)]
    s1.train_on_batch(*batches[0])
    ranges = {k: v.clone() for k, v in s1.state.items()
              if k.startswith("qat_amax/")}
    assert ranges and all(float(v) > 0 for v in ranges.values())
    path = str(tmp_path / "q.npz")
    s1.save_checkpoint(path)
    flat, _ = checkpoint.read_npz(path)
    assert {f"state/{k}" for k in ranges} <= set(flat)
    s2 = Session(qat_net(tt, BATCH), 1, device="cpu").compile_net()
    s2.load_checkpoint(path)
    for k, v in ranges.items():
        assert s2.state[k].shape == () and torch.equal(s2.state[k], v), k
    for b in batches[1:]:
        s1.train_on_batch(*b)
        s2.train_on_batch(*b)
    for k in s1.state:
        assert torch.equal(s1.state[k], s2.state[k]), k
    for k in s1.params:
        assert torch.equal(s1.params[k], s2.params[k]), k


def test_predict_session_loads_a_training_checkpoint(tmp_path):
    """A PREDICT session takes the weights of a TRAIN one's checkpoint
    and keeps no optimizer state; its outputs equal the trainer's."""
    s1 = lenet_session(False)
    x, y = lenet_batch(np.random.RandomState(6))
    s1.train_on_batch(x, y)
    path = str(tmp_path / "w.npz")
    s1.save_checkpoint(path)
    s2 = Session(lenet_mnist(8, tt.Mode.PREDICT), 0,
                 device="cpu").compile_net()
    s2.load_checkpoint(path)
    assert s2.opt_state["seen"] == 8  # taken, as bcnn_tpu takes it
    (a,), _ = s1.predict_on_batch(x)
    (b,), _ = s2.predict_on_batch(x)
    assert torch.equal(a, b)
    assert all(v.device.type == "cpu" for v in s2.params.values())
