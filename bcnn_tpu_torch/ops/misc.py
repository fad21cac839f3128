"""Dropout, channel concat, the eltwise add with its stride broadcast,
the nearest-neighbour upsample and LRN, as `bcnn_tpu.ops.misc` computes
them (bcnn_dropout_layer.c:82-110, bcnn_concat_layer.c,
bcnn_eltwise_layer.c:111-135, bcnn_upsample_layer.c:86-110,
bcnn_lrn_layer.c:106-155), on NCHW tensors. Concat, the add and the
upsample keep a channels-last tensor channels-last without a copy of
their own: an int8 (or int32) one of the int8 flow, and a bf16 one of
the executor's channels-last inference layout. Autograd
differentiates each as the JAX package's autodiff does: the add gives
x0 the whole gradient and x1 its strided subset."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .activations import weak


def dropout_mask(shape, rate: float, device,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """The keep mask of inverted dropout: uniform draws in [0, 1) on
    `device` from `generator` (one on that device; None: torch's default)
    kept where >= rate, as `bcnn_tpu.ops.misc.dropout` keeps them. The
    JAX package draws with threefry and PyTorch with philox, so the two
    masks differ: a parity check hands one package's mask to the
    other."""
    return torch.rand(shape, generator=generator, device=device) >= rate


def dropout(x: torch.Tensor, scale: float, keep: torch.Tensor
            ) -> torch.Tensor:
    """Inverted dropout with a given keep mask: x * scale where kept, 0
    elsewhere (scale = 1 / (1 - rate), in x's dtype)."""
    return torch.where(keep, x * weak(scale, x), 0.0)


def concat_channels(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concat on the channel axis, dim 1 of NCHW."""
    return torch.cat(list(xs), dim=1)


def eltwise_add(
    x0: torch.Tensor,
    x1: torch.Tensor,
    stride: Tuple[int, int],
    min_dim: Tuple[int, int, int],
) -> torch.Tensor:
    """Add with stride broadcast (bcnn_eltwise_layer.c:111-135 and
    bcnn_axpy_strided, bcnn_mat.c:159-178):

      dst = copy(x0)
      dst[b, c, j*s0, i*s0] += x1[b, c, j*s1, i*s1]
        for c < min_c, j < min_h, i < min_w

    over the whole batch, the semantics `bcnn_tpu` chose: the
    reference's equal-stride fast path adds batch item 0 only
    (bcnn_eltwise_layer.c:119-121), an indexing bug. Equal shapes are a
    plain add. The result takes x0's memory format (`clone` and an
    elementwise add keep it)."""
    min_c, min_h, min_w = min_dim
    s0, s1 = stride
    if s0 == 1 and s1 == 1 and x0.shape == x1.shape:
        return x0 + x1
    out = x0.clone()
    out[:, :min_c, : min_h * s0 : s0, : min_w * s0 : s0] += x1[
        :, :min_c, : min_h * s1 : s1, : min_w * s1 : s1
    ]
    return out


def upsample_nn(x: torch.Tensor, size: int) -> torch.Tensor:
    """Nearest-neighbour upsample by `size` on H and W. An int8 x (the
    int8 flow) and a channels-last float x are expanded on their NHWC
    view, one pass that writes channels-last (an int8 x whatever its
    strides say at H = W = 1); `repeat_interleave` writes NCHW, as the
    other float paths keep."""
    if x.dim() == 4 and (x.dtype == torch.int8 or (
            not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))):
        nhwc = x.permute(0, 2, 3, 1)
        n, h, w, c = nhwc.shape
        y = nhwc[:, :, None, :, None, :].expand(n, h, size, w, size, c)
        # written out, not a view: at H = W = 1 the reshape of the
        # expansion alone would be one with zero strides
        return y.contiguous().view(n, h * size, w * size, c).permute(
            0, 3, 1, 2)
    return x.repeat_interleave(size, dim=2).repeat_interleave(size, dim=3)


def lrn(x: torch.Tensor, local_size: int, alpha: float, beta: float,
        k: float) -> torch.Tensor:
    """Cross-channel local response normalization with the reference's
    quirky window (bcnn_lrn_layer.c:106-155), in `bcnn_tpu.ops.misc.lrn`'s
    exact order of adds and subtracts: with a = alpha / local_size,
    hh = local_size // 2, hl = (local_size - 1) // 2,
      norm[0] = k + a * (((0 + sq[0]) + sq[1]) + ... + sq[hh - 1])
      norm[c] = norm[c-1] (- a*sq[c - hl - 1] once c >= m)
                          (+ a*sq[c + hh] while c < C - hh)
    with m = max(1, min(1 + hl, C - hh)), the subtract before the add;
    y = x * norm^(-beta). A remove index below 0 (C smaller than the
    window) resolves as JAX's static indexing does: C is added once, then
    it is clamped to [0, C-1]. The JAX package runs the recurrence as a
    `lax.scan`, a TPU compile workaround; here it is a plain loop over the
    channels. A closed cumsum form would re-associate the sums, and with
    k = 0 (the reference's builder drops k) the -beta power amplifies
    that. Autograd differentiates the loop."""
    cdim = x.shape[1]
    a = weak(alpha / local_size, x)
    hh, hl = local_size // 2, (local_size - 1) // 2
    sq = torch.square(x)
    head = torch.zeros_like(sq[:, 0])
    for c in range(min(hh, cdim)):
        head = head + sq[:, c]
    norm = [weak(k, x) + a * head]
    m = max(1, min(1 + hl, cdim - hh))
    for c in range(1, cdim):
        cur = norm[-1]
        if c >= m:
            r = c - hl - 1
            if r < 0:
                r = min(max(r + cdim, 0), cdim - 1)
            cur = cur - a * sq[:, r]
        if c < cdim - hh:
            cur = cur + a * sq[:, min(c + hh, cdim - 1)]
        norm.append(cur)
    return x * torch.pow(torch.stack(norm, dim=1), -beta)
