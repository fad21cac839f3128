"""The port's C-style API (`bcnn_tpu_torch.capi`), the counterparts of
tests/test_capi.py, on the CPU: the reference mnist example's
create_network (examples/mnist/mnist_example.c:30-55) builds and trains;
the split-phase step (bcnn_forward, bcnn_backward, bcnn_update) equals
the fused one and, on the same weights, bcnn_tpu.capi's split-phase
step. Tolerance against bcnn_tpu: rtol 1e-5, atol 1e-6 (the sums are
taken in another order), as tests/test_capi.py holds its two steps."""

import numpy as np
import pytest
import torch

from bcnn_tpu import capi as jcapi

from bcnn_tpu_torch import bridge, capi
from bcnn_tpu_torch.capi import *  # noqa: F403

torch.set_num_threads(1)


def test_reference_style_program():
    net = bcnn_init_net(BCNN_MODE_TRAIN, device="cpu")  # noqa: F405
    bcnn_set_input_shape(net, 28, 28, 1, 16)  # noqa: F405
    bcnn_add_convolutional_layer(  # noqa: F405
        net, 32, 3, 1, 1, 1, 0, BCNN_FILLER_XAVIER, BCNN_ACT_RELU, 0,  # noqa
        "input", "conv1",
    )
    bcnn_add_batchnorm_layer(net, "conv1", "bn1")  # noqa: F405
    bcnn_add_maxpool_layer(  # noqa: F405
        net, 2, 2, BCNN_PADDING_SAME, "bn1", "pool1"  # noqa: F405
    )
    bcnn_add_fullc_layer(  # noqa: F405
        net, 10, BCNN_FILLER_XAVIER, BCNN_ACT_RELU, 0, "pool1", "fc2"  # noqa
    )
    bcnn_add_softmax_layer(net, "fc2", "softmax")  # noqa: F405
    bcnn_add_cost_layer(  # noqa: F405
        net, BCNN_LOSS_EUCLIDEAN, BCNN_METRIC_ERROR_RATE, 1.0,  # noqa: F405
        "softmax", "label", "cost",
    )
    bcnn_set_sgd_optimizer(net, 0.003, 0.9)  # noqa: F405
    bcnn_set_learning_rate_policy(  # noqa: F405
        net, BCNN_LR_DECAY_SIGMOID, 0.00002, 0.0, 0.0, 50000, 40000  # noqa
    )
    bcnn_set_weight_regularizer(net, 0.0005)  # noqa: F405
    bcnn_augment_data_with_shift(net, 5, 5)  # noqa: F405
    bcnn_augment_data_with_rotation(net, 30.0)  # noqa: F405
    bcnn_compile_net(net)  # noqa: F405
    assert net.device.type == "cpu"
    assert bcnn_get_batch_size(net) == 16  # noqa: F405
    assert net.net.data_aug["rotation_range"] == 30.0

    x = np.random.RandomState(0).randn(16, 1, 28, 28).astype(np.float32)
    y = np.zeros((16, 10, 1, 1), np.float32)
    y[:, 3] = 1
    loss = net.train_on_batch(x, y)
    assert np.isfinite(float(loss))
    bcnn_set_mode(net, BCNN_MODE_VALID)  # noqa: F405
    outs, err = net.predict_on_batch(x, y)
    assert np.isfinite(float(err))
    w = bcnn_get_tensor_by_name(net, "input_w")  # noqa: F405
    assert w.shape == (32, 1, 3, 3)
    bcnn_end_net(net)  # noqa: F405


def test_the_surface_is_bcnn_tpus():
    """The same 52 functions and BCNN_* names as bcnn_tpu.capi."""
    names = {n for n in dir(jcapi) if n.startswith(("bcnn_", "BCNN_"))}
    assert len([n for n in names if n.startswith("bcnn_")]) == 52
    assert names == {n for n in dir(capi) if n.startswith(("bcnn_",
                                                           "BCNN_"))}


def build(api, **kw):
    net = api.bcnn_init_net(api.BCNN_MODE_TRAIN, **kw)
    api.bcnn_set_input_shape(net, 8, 8, 1, 4)
    api.bcnn_add_convolutional_layer(
        net, 4, 3, 1, 1, 1, 0, api.BCNN_FILLER_XAVIER, api.BCNN_ACT_RELU, 0,
        "input", "c")
    api.bcnn_add_fullc_layer(net, 3, api.BCNN_FILLER_XAVIER,
                             api.BCNN_ACT_NONE, 0, "c", "f")
    api.bcnn_add_softmax_layer(net, "f", "s")
    api.bcnn_add_cost_layer(net, api.BCNN_LOSS_EUCLIDEAN, api.BCNN_METRIC_SSE,
                            1.0, "s", "label", "cost")
    api.bcnn_set_sgd_optimizer(net, 0.01, 0.9)
    api.bcnn_compile_net(net)
    return net


@pytest.fixture
def batch():
    x = np.random.RandomState(1).randn(4, 1, 8, 8).astype(np.float32)
    y = np.zeros((4, 3, 1, 1), np.float32)
    y[:, 1] = 1
    return x, y


def test_split_phase_matches_fused_step(batch):
    """forward + backward + update equals train_on_batch, bit for bit on
    one device."""
    x, y = batch
    net1, net2 = build(capi, device="cpu"), build(capi, device="cpu")
    net1.train_on_batch(x, y)
    loss = net2.forward(x, y)
    assert np.isfinite(float(loss))
    bcnn_backward(net2)  # noqa: F405
    bcnn_update(net2)  # noqa: F405
    s_val = bcnn_get_tensor_by_name(net2, "s")  # noqa: F405
    assert isinstance(s_val, np.ndarray) and s_val.shape == (4, 3, 1, 1)
    np.testing.assert_allclose(s_val.reshape(4, 3).sum(1), 1.0, rtol=1e-4)
    for k in net1.params:
        assert torch.equal(net1.params[k], net2.params[k]), k


def test_split_phase_matches_bcnn_tpu(batch):
    """The split-phase step of both packages from bcnn_tpu's initial
    weights: the activations after forward() and the params after
    update()."""
    x, y = batch
    jnet, tnet = build(jcapi), build(capi, device="cpu")
    tnet.params, tnet.state = bridge.params_from_numpy(
        tnet.net, {k: np.asarray(v) for k, v in jnet.params.items()},
        {k: np.asarray(v) for k, v in jnet.state.items()})
    for api, net in ((jcapi, jnet), (capi, tnet)):
        net.forward(x, y)
        api.bcnn_backward(net)
        api.bcnn_update(net)
    for name in ("c", "f", "s"):
        np.testing.assert_allclose(
            capi.bcnn_get_tensor_by_name(tnet, name),
            jcapi.bcnn_get_tensor_by_name(jnet, name), rtol=1e-5, atol=1e-6,
            err_msg=name)
    got = bridge.params_to_numpy(tnet.net, tnet.params)
    for k, v in jnet.params.items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
