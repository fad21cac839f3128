"""Activation functions, as `bcnn_tpu.ops.activations.apply_activation`
computes them (bcnn_activation_layer.c:90-163): LRELU has slope 0.1 and
RAMP is x*(x>0) + 0.1*x. PRELU is not ported yet."""

from __future__ import annotations

import torch

from ..types import Activation


def apply_activation(x: torch.Tensor, act: Activation) -> torch.Tensor:
    if act == Activation.NONE:
        return x
    if act == Activation.TANH:
        return torch.tanh(x)
    if act == Activation.RELU:
        return torch.relu(x)
    if act == Activation.LRELU:
        return torch.where(x > 0, x, 0.1 * x)
    if act == Activation.RAMP:
        return x * (x > 0) + 0.1 * x
    if act == Activation.SOFTPLUS:
        # logaddexp(x, 0), as jnp.logaddexp(x, 0.0)
        return torch.logaddexp(x, torch.zeros_like(x))
    if act == Activation.ABS:
        return torch.abs(x)
    if act == Activation.CLAMP:
        return torch.clamp(x, 0.0, 1.0)
    if act == Activation.LOGISTIC:
        return torch.sigmoid(x)
    if act == Activation.PRELU:
        raise NotImplementedError("PRELU is not ported to bcnn_tpu_torch yet")
    raise ValueError(f"unknown activation {act}")
