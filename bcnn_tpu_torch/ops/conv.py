"""fp32 convolution, the counterpart of `bcnn_tpu.ops.conv.conv2d` on its
fp32 path (`lax.conv_general_dilated` at Precision.HIGHEST).

The JAX package leaves the conv to XLA, outside any Pallas kernel, so the
port leaves it to `F.conv2d`. On the GPU that is cuDNN, which by default
runs fp32 convs in TF32 (about three decimal digits); the call turns TF32
off so the fp32 path keeps the repo's 1e-4 detection tolerance.

Layouts: activations NCHW, weights OIHW. Output size (h + 2p - k)/s + 1,
as the builder computes it (bcnn_conv_layer.c:126-135).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(
    x: torch.Tensor, w: torch.Tensor, stride: int, pad: int, groups: int = 1
) -> torch.Tensor:
    """x: (N,C,H,W), w: (O,C//groups,k,k) -> (N,O,H',W'), in fp32."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(
        enabled=cudnn.enabled,
        benchmark=cudnn.benchmark,
        deterministic=cudnn.deterministic,
        allow_tf32=False,
    ):
        return F.conv2d(x, w, None, stride, pad, 1, groups)
