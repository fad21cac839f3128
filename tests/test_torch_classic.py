"""The classic example nets (`models.classic`: LeNet on MNIST, the CIFAR-10
convnet and its ResNet-style variant) and ResNet-18 (`models.resnet18`)
in the port against bcnn_tpu on the CPU: the graphs, `Net.resize` on
every model builder, and one SGD step of each through
`Session.train_on_batch`, on the same numpy-seeded weights
(`bridge.he_numpy_weights`) and batch (of 2, or 4 where CLASSIC says
why); ResNet-18 resized to 64 px with 10 classes.

Tolerances are tests/test_torch_train.py's: the loss rtol 1e-4; each
parameter's update within 1e-3 of its largest entry, against the step's
float64 update and against bcnn_tpu's, or within twice bcnn_tpu's own
distance to the float64 update where that is wider
(tests/test_torch_train_shortcut.assert_updates); running stats rtol
1e-4, atol 1e-5; every max-pool window picks the same input in both
forwards."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcnn_tpu as bt
import bcnn_tpu.models as jmodels
from bcnn_tpu import learner as jlearner
from bcnn_tpu.compile import make_train_step as jax_make_train_step

import bcnn_tpu_torch.models as tmodels
from bcnn_tpu_torch import Session, bridge
from bcnn_tpu_torch.graph import BuildError
from bcnn_tpu_torch.types import Mode
from tests.test_torch_config import assert_same_graph
from tests.test_torch_train_shortcut import (assert_updates, port_grads,
                                             same_pool_choice)

torch.set_num_threads(1)

BATCH = 2
LOSS_RTOL, UPDATE_TOL = 1e-4, 1e-3

# name -> (batch, builder args after it, input size after any resize).
# LeNet and the CIFAR convnet run at batch 4: their standalone BN on a
# 1x1 FC output normalizes a batch of two to +-1 whatever the input, and
# the reference's backward through it is then mostly cancellation (the
# port's fp32 step lands 0.8% and bcnn_tpu's 1.9% of the largest update
# away from float64 on LeNet's first conv at batch 2; 1.3e-5 and 3.5e-5
# at batch 4)
CLASSIC = {
    "lenet_mnist": (4, (), None),
    "cifar10_convnet": (4, (), None),
    "cifar10_resnet": (BATCH, (), None),
    "resnet18": (BATCH, (10,), 64),
}


def build(name, mode):
    """(bcnn_tpu's net, the port's) of model `name` in `mode`, resized
    where CLASSIC says so."""
    batch, args, size = CLASSIC[name]
    jnet = getattr(jmodels, name)(batch, *args, mode=bt.Mode(int(mode)))
    net = getattr(tmodels, name)(batch, *args, mode=mode)
    if size is not None:
        jnet.resize(size, size)
        net.resize(size, size)
    return jnet, net


@pytest.mark.parametrize("mode", list(Mode), ids=lambda m: m.name)
@pytest.mark.parametrize("name", list(CLASSIC))
def test_graph_matches_bcnn_tpu(name, mode):
    assert_same_graph(*build(name, mode))


def batch_of(net, seed):
    rng = np.random.RandomState(seed)
    t, n = net.tensors[0], net.batch_size
    x = (rng.rand(n, t.c, t.h, t.w) * 2 - 1).astype(np.float32)
    lab = np.zeros((n, net.tensor("softmax").c), np.float32)
    lab[np.arange(n), rng.randint(lab.shape[1], size=n)] = 1.0
    return x, lab


@pytest.mark.parametrize("name", list(CLASSIC))
def test_train_step_matches_bcnn_tpu(name):
    """One SGD step (the recipe's optimizer, decay and rate policy)
    through Session.train_on_batch against bcnn_tpu's make_train_step:
    the reported error count, every parameter's update, the running
    stats."""
    jnet, net = build(name, Mode.TRAIN)
    p_np, s_np = bridge.he_numpy_weights(net, 0)
    x, lab = batch_of(net, 1)
    _, ex = port_grads(net, p_np, s_np, x, lab)
    assert same_pool_choice(jnet, net, p_np, s_np, ex, x, lab)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    jp, js, _, jloss = jax_make_train_step(jnet)(
        jp, {k: jnp.asarray(v) for k, v in s_np.items()},
        jlearner.init_opt_state(jnet, jp),
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


def test_resnet18_resized_serves_as_bcnn_tpu():
    """ResNet-18 built at 224 and resized to 64 px: PREDICT forward of
    its logits and softmax against bcnn_tpu's on the same weights."""
    jnet, net = build("resnet18", Mode.PREDICT)
    p_np, s_np = bridge.he_numpy_weights(net, 2)
    js = bt.Session(jnet, 0).compile_net()
    js.params = {k: jnp.asarray(v) for k, v in p_np.items()}
    js.state = {k: jnp.asarray(v) for k, v in s_np.items()}
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(net, p_np, s_np)
    sess.compile_net()
    x, _ = batch_of(net, 3)
    got, _ = sess.predict_on_batch(x, outputs=["fc", "softmax"])
    want, _ = js.predict_on_batch(x, outputs=["fc", "softmax"])
    assert tuple(got[0].shape) == (BATCH, 10, 1, 1)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())


RESIZE = {
    "yolov3_tiny": lambda pkg: pkg.yolov3_tiny(2, 416, 416, 4),
    "yolov3": lambda pkg: pkg.yolov3(1, 416, 416, 3),
    "mobilenet_v1": lambda pkg: pkg.mobilenet_v1(1, 10, width_mult=0.25),
    "resnet18": lambda pkg: pkg.resnet18(1, 10),
    "lenet_mnist": lambda pkg: pkg.lenet_mnist(2),
    "cifar10_convnet": lambda pkg: pkg.cifar10_convnet(2),
    "cifar10_resnet": lambda pkg: pkg.cifar10_resnet(2),
}


@pytest.mark.parametrize("size,batch", [(96, None), (160, 3)])
@pytest.mark.parametrize("name", list(RESIZE))
def test_resize_shapes_match_bcnn_tpu(name, size, batch):
    """Net.resize on every model builder: the new shapes of every tensor
    (and the eltwise strides), or, where an FC's input size would change,
    BuildError in both packages."""
    jnet, net = RESIZE[name](jmodels), RESIZE[name](tmodels)
    try:
        jnet.resize(size, size, batch_size=batch)
    except Exception as e:  # noqa: BLE001 -- the port must raise alike
        with pytest.raises(BuildError, match=re.escape(str(e))):
            net.resize(size, size, batch_size=batch)
        assert name in ("lenet_mnist", "cifar10_convnet")
        return
    assert net.resize(size, size, batch_size=batch) is net
    assert_same_graph(jnet, net)
    assert net.tensors[0].h == size
    if batch is not None:
        assert net.batch_size == batch == net.tensors[0].n


def test_num_threads():
    """Net.set_num_threads caps the host kernels' pool; the session
    reports it, as bcnn_tpu's does."""
    net, jnet = tmodels.lenet_mnist(2), jmodels.lenet_mnist(2)
    sess, js = Session(net, 0, device="cpu"), bt.Session(jnet, 0)
    assert sess.get_num_threads() == js.get_num_threads() == 1
    net.set_num_threads(3)
    jnet.set_num_threads(3)
    assert sess.get_num_threads() == js.get_num_threads() == 3
    net.set_num_threads(0)
    assert sess.get_num_threads() == 1
