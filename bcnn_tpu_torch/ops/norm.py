"""Batch normalization, as `bcnn_tpu.ops.norm.batch_norm` computes it
(bcnn_batchnorm_layer.c:147-245), on NCHW tensors.

PREDICT/VALID, in x's dtype (bf16 on the act_dtype path: every
per-channel tensor is cast to it, as bcnn_tpu/ops/norm.py:119-122 and
its executor do):
  unfolded: (x - run_mean) * rsqrt(run_var + 1e-6) * scales + biases
  folded:   x * scales + biases   (constants folded at weight load,
                                   bcnn_net.c:1281-1292)

TRAIN (`batch_norm_train`): batch mean and biased variance
mean(x^2) - mean^2 over (N, H, W), eps 1e-6, then scale and shift; the
running stats become 0.9*run + 0.1*batch, outside autograd. The backward
is the reference's hand-written rule (bcnn_backward_batchnorm_cpu,
:263-299), NOT the gradient of the forward:
  - it normalizes with eps 1e-5 (:278, :293) where the forward used 1e-6;
  - the d(var) term is scaled by -0.5/(var^1.5 + 1e-5) (bcnn_varnorm,
    bcnn_mat.c:692-696): eps added to var^1.5, not to var;
  - the d(mean) term has no variance-path contribution.

Frozen stats (`frozen=True`, net.bn_frozen_stats; bcnn_tpu/ops/norm.py:
80-116): TRAIN normalizes with the step-start running stats, detached,
as constants (eps 1e-6), and autograd takes the plain gradient of that;
the running stats are still updated from the batch stats.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .activations import in_f32, weak

EPS = 1e-6
EPS_BWD = 1e-5  # the reference backward's eps (bcnn_batchnorm_layer.c:278)
RUN_MOMENTUM = 0.9
_AXES = (0, 2, 3)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def batch_norm(
    x: torch.Tensor,
    scales: torch.Tensor,
    biases: torch.Tensor,
    run_mean: torch.Tensor,
    run_var: torch.Tensor,
    folded: bool = False,
    affine_fp32: bool = False,
) -> torch.Tensor:
    """x: NCHW; the other tensors are per channel (C,). affine_fp32 keeps
    scales and biases fp32, so that a bf16 x is promoted where it meets
    them (bcnn_tpu's standalone BN layer, which does not cast them)."""
    run_mean, run_var = run_mean.to(x.dtype), run_var.to(x.dtype)
    if not affine_fp32:
        scales, biases = scales.to(x.dtype), biases.to(x.dtype)
    if folded:
        return x * _per_channel(scales) + _per_channel(biases)
    x_norm = (x - _per_channel(run_mean)) * in_f32(
        torch.rsqrt, _per_channel(run_var) + weak(EPS, x)
    )
    return x_norm * _per_channel(scales) + _per_channel(biases)


def _batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = torch.mean(x, dim=_AXES)
    var = torch.mean(torch.square(x), dim=_AXES) - torch.square(mean)
    return mean, var


class _BnTrainRef(torch.autograd.Function):
    """TRAIN normalize + scale + shift with the reference's backward.
    Returns (y, batch mean, batch var); the stats carry no gradient."""

    @staticmethod
    def forward(ctx, x, scales, biases):
        mean, var = _batch_stats(x)
        x_norm = (x - _per_channel(mean)) * torch.rsqrt(_per_channel(var) + EPS)
        ctx.save_for_backward(x, mean, var, x_norm, scales)
        ctx.mark_non_differentiable(mean, var)
        y = x_norm * _per_channel(scales) + _per_channel(biases)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, mean, var, x_norm, scales = ctx.saved_tensors
        n = x.shape[0] * x.shape[2] * x.shape[3]  # b * wxh
        dbias = torch.sum(g, dim=_AXES)
        dscale = (
            torch.sum(g * x_norm, dim=_AXES)
            if ctx.needs_input_grad[1] else None
        )
        dyh = g * _per_channel(scales)
        inv = 1.0 / torch.sqrt(var + EPS_BWD)  # NOT the forward's eps
        xc = x - _per_channel(mean)
        mean_diff = torch.sum(dyh, dim=_AXES) * (-inv)
        var_diff = torch.sum(dyh * xc, dim=_AXES) * (
            -0.5 / (var * torch.sqrt(var) + EPS_BWD)  # bcnn_varnorm
        )
        dx = (
            dyh * _per_channel(inv)
            + _per_channel(var_diff) * 2.0 * xc / n
            + _per_channel(mean_diff) / n
        )
        return dx, dscale, dbias


def batch_norm_train(
    x: torch.Tensor,
    scales: torch.Tensor,
    biases: torch.Tensor,
    run_mean: torch.Tensor,
    run_var: torch.Tensor,
    frozen: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: NCHW. Returns (y, new_run_mean, new_run_var); the new stats
    carry no gradient."""
    if frozen:
        with torch.no_grad():
            mean, var = _batch_stats(x)
        rm, rv = _per_channel(run_mean.detach()), _per_channel(run_var.detach())
        y = ((x - rm) * torch.rsqrt(rv + EPS) * _per_channel(scales)
             + _per_channel(biases))
    else:
        y, mean, var = _BnTrainRef.apply(x, scales, biases)
    new_mean = RUN_MOMENTUM * run_mean + (1.0 - RUN_MOMENTUM) * mean
    new_var = RUN_MOMENTUM * run_var + (1.0 - RUN_MOMENTUM) * var
    return y, new_mean, new_var
