"""Debugging aids, the port of `bcnn_tpu.debug`: NaN and Inf checks and
a host-side finiteness check of nested dicts.

`bcnn_tpu` sets `jax_debug_nans` / `jax_debug_infs`, which check every
primitive. The port checks at node granularity: with a check on, the
executor (`compile._Executor.run`) looks at every floating-point tensor
a node wrote, after the node, and raises FloatingPointError naming the
node's position, its layer type and the tensor. A node of several ops
(a conv and its BN, activation and requantize) is checked once, on what
it wrote; an intermediate NaN that the node's last op removes goes
unseen. A check reads its result on the host, so it waits for the card
after every node. Off (the default), the executor reads the flags once a
pass and checks nothing.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.utils._pytree import keystr, tree_flatten_with_path

# the executor reads these once a pass
CHECKS: Dict[str, bool] = {"nan": False, "inf": False}


def enable_nan_checks(enable: bool = True):
    """Every node's floating-point outputs checked for NaN."""
    CHECKS["nan"] = bool(enable)


def enable_inf_checks(enable: bool = True):
    """Every node's floating-point outputs checked for +-Inf."""
    CHECKS["inf"] = bool(enable)


def check_node(pos: int, node, net, values: Dict[int, torch.Tensor],
               nan: bool, inf: bool) -> None:
    """Raise FloatingPointError if a tensor node `pos` wrote holds a NaN
    (with `nan`) or an Inf (with `inf`)."""
    for d in node.dst:
        v = values.get(d)
        if v is None or not v.is_floating_point():
            continue
        for on, kind, bad in ((nan, "NaN", torch.isnan),
                              (inf, "Inf", torch.isinf)):
            if on and bool(bad(v).any()):
                raise FloatingPointError(
                    f"{kind} in tensor '{net.tensors[d].name}', written by "
                    f"node {pos} ({node.type.name})")


def check_pytree_finite(tree: Any, name: str = "tree"):
    """Host-side check that every leaf (tensor, array or number) of nested
    dicts, lists and tuples is finite; returns the tree, else raises
    FloatingPointError listing the bad leaves by path."""
    bad = []
    for path, leaf in tree_flatten_with_path(tree)[0]:
        a = (leaf.detach().float().cpu().numpy()
             if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
        if a.dtype.kind in "fc" and not np.isfinite(a).all():
            bad.append((keystr(path), a.dtype, a.shape))
    if bad:
        raise FloatingPointError(f"non-finite leaves in {name}: {bad}")
    return tree
