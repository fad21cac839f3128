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

Data parallel (`reduce`, `parallel.Mesh.all_reduce`): each rank holds a
stripe of the batch, and the statistics are those of the global batch,
as GSPMD makes them under a mesh (`bcnn_tpu/parallel/mesh.py:11-13`).
The forward sums (sum x, sum x^2, count) per channel over the rank's
stripe in fp32 and all-reduces them in one buffer, keeping the
mean(x^2) - mean^2 form (the count rides in fp32: exact up to 2^24
elements a channel, and a power-of-two multiple beyond); the backward
all-reduces (sum dyh, sum dyh * xc) the same way and divides by the
global count. Every rank makes the same calls in the same order. This
is not `nn.SyncBatchNorm`, whose eps and backward are not bcnn's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..profiling import span
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
    with span("bcnn.build.bn_consts"):
        run_mean, run_var = run_mean.to(x.dtype), run_var.to(x.dtype)
        if not affine_fp32:
            scales, biases = scales.to(x.dtype), biases.to(x.dtype)
        if not folded:
            inv = in_f32(torch.rsqrt, _per_channel(run_var) + weak(EPS, x))
    if folded:
        return x * _per_channel(scales) + _per_channel(biases)
    x_norm = (x - _per_channel(run_mean)) * inv
    return x_norm * _per_channel(scales) + _per_channel(biases)


Reduce = Optional[Callable[[torch.Tensor], None]]


def _batch_stats(x: torch.Tensor, reduce: Reduce = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """(mean, var, count) over (N, H, W); with `reduce` (an in-place SUM
    all-reduce over the ranks) those of the global batch, each sum taken
    in fp32 (float64 for a float64 x) and the mean and mean of squares
    rounded to x's dtype, as torch.mean rounds them."""
    if reduce is None:
        mean = torch.mean(x, dim=_AXES)
        var = torch.mean(torch.square(x), dim=_AXES) - torch.square(mean)
        return mean, var, float(x.shape[0] * x.shape[2] * x.shape[3])
    acc = torch.promote_types(x.dtype, torch.float32)
    n = torch.full((1,), x.shape[0] * x.shape[2] * x.shape[3], dtype=acc,
                   device=x.device)
    buf = torch.cat([torch.sum(x, dim=_AXES, dtype=acc),
                     torch.sum(torch.square(x), dim=_AXES, dtype=acc), n])
    reduce(buf)
    c = x.shape[1]
    count = buf[2 * c:]
    mean = (buf[:c] / count).to(x.dtype)
    var = (buf[c:2 * c] / count).to(x.dtype) - torch.square(mean)
    return mean, var, count


class _BnTrainRef(torch.autograd.Function):
    """TRAIN normalize + scale + shift with the reference's backward.
    Returns (y, batch mean, batch var); the stats carry no gradient."""

    @staticmethod
    def forward(ctx, x, scales, biases, reduce=None):
        mean, var, count = _batch_stats(x, reduce)
        x_norm = (x - _per_channel(mean)) * torch.rsqrt(_per_channel(var) + EPS)
        ctx.save_for_backward(x, mean, var, x_norm, scales)
        ctx.reduce, ctx.count = reduce, count
        ctx.mark_non_differentiable(mean, var)
        y = x_norm * _per_channel(scales) + _per_channel(biases)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, mean, var, x_norm, scales = ctx.saved_tensors
        n = ctx.count  # b * wxh, of the global batch under a mesh
        dbias = torch.sum(g, dim=_AXES)
        dscale = (
            torch.sum(g * x_norm, dim=_AXES)
            if ctx.needs_input_grad[1] else None
        )
        dyh = g * _per_channel(scales)
        inv = 1.0 / torch.sqrt(var + EPS_BWD)  # NOT the forward's eps
        xc = x - _per_channel(mean)
        s_dyh, s_dyh_xc = torch.sum(dyh, dim=_AXES), torch.sum(dyh * xc,
                                                               dim=_AXES)
        if ctx.reduce is not None:
            c = s_dyh.shape[0]
            buf = torch.cat([s_dyh, s_dyh_xc])
            ctx.reduce(buf)
            s_dyh, s_dyh_xc = buf[:c], buf[c:]
        mean_diff = s_dyh * (-inv)
        var_diff = s_dyh_xc * (
            -0.5 / (var * torch.sqrt(var) + EPS_BWD)  # bcnn_varnorm
        )
        dx = (
            dyh * _per_channel(inv)
            + _per_channel(var_diff) * 2.0 * xc / n
            + _per_channel(mean_diff) / n
        ).to(x.dtype)  # a mesh's count is an fp32 tensor
        return dx, dscale, dbias, None


def batch_norm_train(
    x: torch.Tensor,
    scales: torch.Tensor,
    biases: torch.Tensor,
    run_mean: torch.Tensor,
    run_var: torch.Tensor,
    frozen: bool = False,
    reduce: Reduce = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: NCHW. Returns (y, new_run_mean, new_run_var); the new stats
    carry no gradient. reduce: the mesh's in-place SUM all-reduce, for
    the global batch's statistics (module docstring)."""
    if frozen:
        with torch.no_grad():
            mean, var, _ = _batch_stats(x, reduce)
        rm, rv = _per_channel(run_mean.detach()), _per_channel(run_var.detach())
        y = ((x - rm) * torch.rsqrt(rv + EPS) * _per_channel(scales)
             + _per_channel(biases))
    else:
        y, mean, var = _BnTrainRef.apply(x, scales, biases, reduce)
    new_mean = RUN_MOMENTUM * run_mean + (1.0 - RUN_MOMENTUM) * mean
    new_var = RUN_MOMENTUM * run_var + (1.0 - RUN_MOMENTUM) * var
    return y, new_mean, new_var
