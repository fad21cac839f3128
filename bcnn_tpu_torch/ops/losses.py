"""Cost layer math, as `bcnn_tpu.ops.losses` computes it: the euclidean
surrogate and the evaluation metrics (src/layers/bcnn_cost_layer.c).

  - The training gradient into src is scale * (x - label)
    (bcnn_euclidean_loss_forward :111-128, _backward :130-140), realized
    as the surrogate scale * 0.5 * sum((x - label)^2), whose autograd
    gradient is exactly that.
  - The REPORTED value is the metric of bcnn_compute_error (:142-245):
    ERROR_RATE counts top-1 mismatches in the batch, SSE sums squared
    errors, MSE divides that by c*h*w, LOGLOSS sums -log(p) over positive
    labels, DICE sums the thresholded Sorensen-Dice terms with the
    reference's integer per-sample sums; CRPS returns SSE, as the
    reference does (it computes a temporary and discards it).

Inputs are flat (N, c*h*w) in NCHW element order, the executor's own
layout, so argmax and label indexing match the reference exactly.
"""

from __future__ import annotations

import torch

from ..types import Metric


def euclidean_surrogate(x: torch.Tensor, label: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Differentiable surrogate; d/dx == scale * (x - label)."""
    diff = x - label.detach()
    return 0.5 * scale * torch.sum(diff * diff)


def huber(x: torch.Tensor, label: torch.Tensor, hdelta: float = 1.0):
    """Huber loss (bcnn_huber_loss, bcnn_cost_layer.c:93-109; present but
    unused in the reference). Returns (error, grad) with its piecewise
    forms: e^2 inside |e| <= delta, 2*delta*|e| - delta^2 outside with a
    clipped +-1 gradient."""
    e = x - label
    inside = torch.abs(e) <= hdelta
    err = torch.sum(torch.where(
        inside, e * e, 2.0 * hdelta * torch.abs(e) - hdelta * hdelta))
    return err, torch.where(inside, e, torch.sign(e))


def compute_metric(x: torch.Tensor, label: torch.Tensor,
                   metric: Metric) -> torch.Tensor:
    """x, label: (N, F) flat NCHW order. Returns the 0-d float32 value
    the reference stores in the cost layer's dst data[0]."""
    if metric == Metric.ERROR_RATE:
        # the first maximum on ties, as jnp.argmax takes it
        j_best = torch.argmax(x, dim=1, keepdim=True)
        picked = torch.gather(label, 1, j_best)[:, 0]
        return torch.sum(picked == 0.0).to(torch.float32)
    if metric in (Metric.SSE, Metric.CRPS):
        d = x - label
        return torch.sum(d * d)
    if metric == Metric.MSE:
        d = x - label
        return torch.sum(d * d) / x.shape[1]
    if metric == Metric.LOGLOSS:
        p = torch.clamp(x, 1e-8, 1.0 - 1e-8)
        return torch.sum(torch.where(label > 0.0, -torch.log(p),
                                     torch.zeros_like(p)))
    if metric == Metric.DICE:
        pred = (x > 0.5).to(torch.float32)
        # the reference accumulates the per-sample sums into ints
        # (bcnn_cost_layer.c:225-236)
        n = torch.sum(label * pred, dim=1).to(torch.int32)
        d = torch.sum(label + pred, dim=1).to(torch.int32)
        return torch.sum((2.0 * n + 1.0) / (d + 1.0))
    raise ValueError(f"unknown metric {metric}")
