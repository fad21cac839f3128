"""The lifted structured similarity loss (Song et al. 2015), as
`bcnn_tpu.ops.lifted_struct` computes it
(src/layers/bcnn_lifted_structure_loss.c:16-319):

  - squared distances D^2 = |xi|^2 + |xj|^2 - 2 xi.xj over the batch
    (:57-91), D = sqrt(max(D^2, 1e-20));
  - a pair is of one class when the first positive entries of their
    one-hot label rows agree (:96-122; a row with none is class -1);
  - for every positive pair (i, j), i < j:
        J_ij = log(sum_{k neg of i} e^(margin - D_ik)
                   + sum_{k neg of j} e^(margin - D_jk)) + D_ij,
    margin 1 (:128-220);
  - loss = sum max(0, J)^2 / P, P the count of positive pairs (at least
    1) (:281); the gradient is scale / P * d(sum J^2)/dx (:300-318), the
    analytic gradient, which autograd of the surrogate gives.

`torch.maximum` splits the gradient at a tie, as `jnp.maximum` does.
"""

from __future__ import annotations

import torch

MARGIN = 1.0


def lifted_struct_surrogate(x: torch.Tensor, label: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """x: (B, K) embeddings; label: (B, L) one-hot. Returns the
    differentiable scale * loss (the loss is surrogate / scale)."""
    b = x.shape[0]
    sq = torch.sum(torch.square(x), dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * x @ x.T
    d = torch.sqrt(torch.maximum(d2, torch.tensor(1e-20, dtype=x.dtype,
                                                  device=x.device)))
    pos = label > 0
    cls = torch.where(pos.any(dim=1), torch.argmax(pos.to(torch.int32),
                                                   dim=1), -1)
    same = cls[:, None] == cls[None, :]
    e = torch.where(same, 0.0, torch.exp(MARGIN - d))
    row = torch.sum(e, dim=1)
    upper = torch.triu(torch.ones((b, b), dtype=torch.bool,
                                  device=x.device), diagonal=1)
    pos_pair = same & upper
    j_mat = torch.log(torch.maximum(
        row[:, None] + row[None, :],
        torch.tensor(1e-30, dtype=x.dtype, device=x.device))) + d
    hinged = torch.maximum(j_mat, torch.zeros((), dtype=x.dtype,
                                              device=x.device))
    total = torch.sum(torch.where(pos_pair, torch.square(hinged), 0.0))
    p = torch.clamp(torch.sum(pos_pair), min=1)
    return scale * total / p
