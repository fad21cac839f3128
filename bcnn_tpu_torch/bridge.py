"""Hand weights from the JAX package to the port.

`bcnn_tpu` and the port draw their weights from different generators, so
a parity check makes them once, with `bcnn_tpu`, and passes them over as
numpy arrays keyed by `TensorSpec.key` (`np.asarray` of `Session.params`
and `Session.state`). Conv weights are HWIO there and OIHW here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .graph import Net
from .types import LayerType


def params_from_numpy(
    net: Net,
    params_np: Mapping[str, np.ndarray],
    state_np: Mapping[str, np.ndarray],
    device="cpu",
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, state) of `net` as float32 tensors on `device`."""
    conv_w = {
        net.tensors[n.src[1]].key
        for n in net.nodes
        if n.type == LayerType.CONV2D
    }

    def convert(specs, arrays):
        out = {}
        for t in specs:
            a = np.asarray(arrays[t.key], np.float32)
            if t.key in conv_w:
                a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            if a.shape != t.mem_shape:
                raise ValueError(
                    f"{t.key}: shape {a.shape}, expected {t.mem_shape}"
                )
            # np.array copies: arrays taken from JAX are read-only
            out[t.key] = torch.from_numpy(np.array(a, order="C")).to(device)
        return out

    return (
        convert(net.param_specs(), params_np),
        convert(net.state_specs(), state_np),
    )
