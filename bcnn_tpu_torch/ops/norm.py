"""Batch normalization in PREDICT/VALID, as `bcnn_tpu.ops.norm.batch_norm`
computes it outside training (bcnn_batchnorm_layer.c:147-245):

  unfolded: (x - run_mean) * rsqrt(run_var + 1e-6) * scales + biases
  folded:   x * scales + biases   (constants folded at weight load,
                                   bcnn_net.c:1281-1292)

The TRAIN branch, with the reference's hand-written backward, comes with
the training slice.
"""

from __future__ import annotations

import torch

EPS = 1e-6


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def batch_norm(
    x: torch.Tensor,
    scales: torch.Tensor,
    biases: torch.Tensor,
    run_mean: torch.Tensor,
    run_var: torch.Tensor,
    folded: bool = False,
) -> torch.Tensor:
    """x: NCHW; the other tensors are per channel (C,)."""
    if folded:
        return x * _per_channel(scales) + _per_channel(biases)
    x_norm = (x - _per_channel(run_mean)) * torch.rsqrt(
        _per_channel(run_var) + EPS
    )
    return x_norm * _per_channel(scales) + _per_channel(biases)
