"""Activations of the port against bcnn_tpu: forward values and, through
autograd, the gradient at the kinks, where JAX's differs from PyTorch's
own (RELU 0.5 at 0, ABS 1 at 0, CLAMP 0.5 at 0 and at 1); and the bf16
forms the act_dtype path takes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnn_tpu.ops.activations import apply_activation as jax_act
from bcnn_tpu.types import Activation as JaxActivation

from bcnn_tpu_torch.ops.activations import apply_activation, sigmoid
from bcnn_tpu_torch.types import Activation

torch.set_num_threads(1)

X = [-1.0, 0.0, 1.0, 0.5]
ACTS = ["RELU", "ABS", "CLAMP", "LRELU", "NONE", "TANH", "RAMP", "SOFTPLUS",
        "LOGISTIC"]


@pytest.mark.parametrize("name", ACTS)
def test_value_and_gradient_match_jax(name):
    x = np.array(X, np.float32)
    want_y = np.asarray(jax_act(jnp.asarray(x), JaxActivation[name]))
    want_g = np.asarray(jax.grad(
        lambda v: jnp.sum(jax_act(v, JaxActivation[name])))(jnp.asarray(x)))
    t = torch.tensor(X, requires_grad=True)
    y = apply_activation(t, Activation[name])
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), want_g, rtol=1e-6)


def test_kink_gradients_are_jaxs():
    grads = {}
    for name in ("RELU", "ABS", "CLAMP"):
        t = torch.tensor([0.0, 1.0], requires_grad=True)
        apply_activation(t, Activation[name]).sum().backward()
        grads[name] = t.grad.tolist()
    assert grads == {"RELU": [0.5, 1.0], "ABS": [1.0, 1.0],
                     "CLAMP": [0.5, 0.5]}


def test_bf16_forms_round_as_xla():
    """LRELU's 0.1 rounds to bf16 before the product, and the logistic
    function rounds each of its steps, as XLA evaluates them on bf16."""
    v = np.random.RandomState(0).randn(4096).astype(np.float32) * 4
    xb = jnp.asarray(v).astype(jnp.bfloat16)
    tb = torch.from_numpy(v).to(torch.bfloat16)
    for name in ("LRELU", "LOGISTIC"):
        want = np.asarray(jax_act(xb, JaxActivation[name]).astype(
            jnp.float32))
        got = apply_activation(tb, Activation[name])
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(
        sigmoid(tb).float().numpy(),
        np.asarray(jax.nn.sigmoid(xb).astype(jnp.float32)))
