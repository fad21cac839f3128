"""Activation functions, as `bcnn_tpu.ops.activations.apply_activation`
computes them (bcnn_activation_layer.c:90-163): LRELU has slope 0.1 and
RAMP is x*(x>0) + 0.1*x.

PRELU takes per-channel slopes and the reference's backward, which reads
the activation's OUTPUT y (bcnn_backward_activation_cpu:211-222, the
in-place update; `bcnn_tpu/ops/activations.py:36-55`):
    d slope[c] = sum dy * y * (y < 0),   dx = dy * (y > 0 ? 1 : slope[c])

Where a gradient is recorded, RELU, ABS and CLAMP take JAX's gradient at
their kinks (`bcnn_tpu/ops/activations.py:67-78`: `jnp.maximum` splits a
tie, `jnp.abs` takes the + side, `jnp.clip` is a max then a min), not
PyTorch's: RELU 0.5 at 0 (PyTorch 0), ABS 1 at 0 (PyTorch 0), CLAMP 0.5
at 0 and at 1 (PyTorch 1).

MISH and SWISH, which bcnn_tpu lacks, are `F.mish`, x *
tanh(softplus(x)), and `F.silu`, x * logistic(x), with PyTorch's
autograd; on a bf16 x each is taken in fp32 and rounded once.

A constant meets x in x's dtype (`weak`): JAX rounds the 0.1 of LRELU to
bf16 before it multiplies a bf16 x, where PyTorch would multiply by the
fp32 0.1.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..types import Activation


# fp32, and float64 (tools/f3_float64.py's reference run): computed as
# they are, with no rounding to a narrower dtype between steps
WIDE = (torch.float32, torch.float64)
# LRELU's slope, the reference's (`ops/bn_act.py` and K6 take it too)
LRELU_SLOPE = 0.1


def weak(v: float, x: torch.Tensor):
    """v as a constant that rounds to x's dtype first, as a weak-typed
    Python number does in JAX: the float itself for an fp32 x, else a 0-d
    CPU tensor of x's dtype (made once)."""
    return v if x.dtype in WIDE else _weak_tensor(v, x.dtype)


@functools.lru_cache(maxsize=None)
def _weak_tensor(v: float, dtype: torch.dtype) -> torch.Tensor:
    # made outside inference mode even when first asked for inside it: an
    # inference tensor cannot be saved for a later training backward
    with torch.inference_mode(False):
        return torch.tensor(v, dtype=dtype)


def in_f32(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) taken in fp32 and rounded to x's dtype once, as XLA takes a
    transcendental on a bf16 operand. (PyTorch's CPU kernels may round a
    bf16 rsqrt twice, after the sqrt and after the reciprocal.)"""
    if x.dtype in WIDE:
        return fn(x)
    return fn(x.to(torch.float32)).to(x.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic function. On bf16, as XLA expands `jax.nn.sigmoid`:
    1 / (1 + exp(-x)) with each step rounded to bf16 (`torch.sigmoid`
    rounds once, and differs in a third of the values)."""
    if x.dtype in WIDE:
        return torch.sigmoid(x)

    def r(t):  # round to x's dtype, carry on in fp32
        return t.to(x.dtype).to(torch.float32)

    e = r(torch.exp(-x.to(torch.float32)))
    return (1.0 / r(e + 1.0)).to(x.dtype)


class _KinkGrad(torch.autograd.Function):
    """y = fn(x) with dy/dx = slope(x), both given per activation."""

    @staticmethod
    def forward(ctx, x, act):
        ctx.save_for_backward(x)
        ctx.act = act
        return _FORWARD[act](x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _SLOPE[ctx.act](x).to(g.dtype), None


class _PreluRef(torch.autograd.Function):
    """y = x where x > 0, else slope * x, with the reference's backward
    on y. s: the slopes, shaped to broadcast over x's channel axis."""

    @staticmethod
    def forward(ctx, x, s):
        y = torch.where(x > 0, x, s * x)
        ctx.save_for_backward(y, s)
        return y

    @staticmethod
    def backward(ctx, g):
        y, s = ctx.saved_tensors
        ds = None
        if ctx.needs_input_grad[1]:
            dims = tuple(i for i in range(y.dim()) if s.shape[i] == 1)
            ds = torch.sum(g * y * (y < 0), dim=dims, keepdim=True)
        return g * torch.where(y > 0, 1.0, s), ds


def _relu_slope(x):
    return torch.where(x > 0, 1.0, torch.where(x == 0, 0.5, 0.0))


def _abs_slope(x):
    return torch.where(x >= 0, 1.0, -1.0)


def _clamp_slope(x):
    inside = (x > 0) & (x < 1)
    return torch.where(inside, 1.0, torch.where((x == 0) | (x == 1), 0.5, 0.0))


_FORWARD = {
    Activation.RELU: torch.relu,
    Activation.ABS: torch.abs,
    Activation.CLAMP: lambda x: torch.clamp(x, 0.0, 1.0),
}
_SLOPE = {
    Activation.RELU: _relu_slope,
    Activation.ABS: _abs_slope,
    Activation.CLAMP: _clamp_slope,
}


def apply_activation(x: torch.Tensor, act: Activation,
                     slopes: torch.Tensor = None) -> torch.Tensor:
    """slopes: PRELU's per-channel slopes (C,), over dim 1 of x."""
    if act == Activation.NONE:
        return x
    if act in _FORWARD:
        if torch.is_grad_enabled() and x.requires_grad:
            return _KinkGrad.apply(x, act)
        return _FORWARD[act](x)
    if act == Activation.TANH:
        return torch.tanh(x)
    if act == Activation.LRELU:
        return torch.where(x > 0, x, weak(LRELU_SLOPE, x) * x)
    if act == Activation.RAMP:
        return x * (x > 0) + weak(0.1, x) * x
    if act == Activation.SOFTPLUS:
        # logaddexp(x, 0), as jnp.logaddexp(x, 0.0)
        return torch.logaddexp(x, torch.zeros_like(x))
    if act == Activation.LOGISTIC:
        return sigmoid(x)
    if act == Activation.MISH:
        return F.mish(x)
    if act == Activation.SWISH:
        return F.silu(x)
    if act == Activation.PRELU:
        if slopes is None:
            raise ValueError("PReLU needs slopes")
        shape = [1] * x.dim()
        shape[1] = -1
        return _PreluRef.apply(x, slopes.reshape(shape))
    raise ValueError(f"unknown activation {act}")
