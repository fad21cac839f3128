"""Full training-state checkpoints, the port of `bcnn_tpu.checkpoint`
(`bcnn_tpu/checkpoint.py:22-57, 102-119`) in its `.npz` format.

The reference saves weights only (`bcnn_save_weights`); a checkpoint
holds what resuming needs: the params, the state (BN running stats and,
with net.qat, the "qat_amax/<idx>" ranges), the optimizer state and the
session's step count, in one `.npz`:

    params/<key>, state/<key>          float32 arrays
    opt/velocity/<key>, opt/adam_m/<key>, opt/adam_v/<key>
    opt/seen                           int32, 0-d (samples seen)
    __meta__                           JSON {"version": 1, "extra": {...}}

The arrays are in `bcnn_tpu`'s layouts: conv and depthwise weights HWIO,
deconv weights (k, k, O, C), with their optimizer buffers
(`bridge.params_to_numpy`), so a checkpoint written by either package
resumes in the other. Loading needs the net, to turn them back into the
port's layouts and check their shapes (`bridge.tensors_from_numpy`).

A state key holds a "/" ("qat_amax/<idx>"): the port reads the keys
under "state/" as they are written, flat. `bcnn_tpu` nests such a key
on load (`_unflatten`), and so does not find QAT ranges in a checkpoint
of either package. The orbax variants of `bcnn_tpu.checkpoint` (a JAX
library) have no counterpart.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import bridge
from .graph import Net

FORMAT_VERSION = 1
OPT_BUFFERS = ("velocity", "adam_m", "adam_v")


def save_checkpoint(
    net: Net,
    path: str,
    params: Dict[str, torch.Tensor],
    state: Dict[str, torch.Tensor],
    opt_state: Optional[Dict[str, Any]],
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write params, state, the optimizer state (None: none) and `extra`
    (JSON) to `path` (np.savez: ".npz" is added where it is missing)."""
    flat: Dict[str, np.ndarray] = {}
    for prefix, tree in (("params", params), ("state", state)):
        for k, v in bridge.params_to_numpy(net, tree).items():
            flat[f"{prefix}/{k}"] = v
    if opt_state is not None:
        flat["opt/seen"] = np.asarray(int(opt_state["seen"]), np.int32)
        for name in OPT_BUFFERS:
            for k, v in bridge.params_to_numpy(net,
                                               opt_state[name]).items():
                flat[f"opt/{name}/{k}"] = v
    meta = dict(version=FORMAT_VERSION, extra=extra or {})
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                     dtype=np.uint8)
    np.savez(path, **flat)


def read_npz(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """The file's arrays by key, and its meta."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__meta__").tobytes()).decode())
    return flat, meta


def _under(flat: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


def load_checkpoint(
    net: Net, path: str, device="cuda"
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor],
           Dict[str, Any], Dict[str, Any]]:
    """(params, state, opt_state, extra) of the checkpoint at `path`, a
    file of either package: tensors on `device` in the port's layouts;
    opt_state {} where the file has none, else {"seen": int, "velocity",
    "adam_m", "adam_v"}, a buffer dict empty where the file has none of
    its keys (as `bcnn_tpu/checkpoint.py:114-119` restores it)."""
    flat, meta = read_npz(path)
    params_np, state_np = _under(flat, "params"), _under(flat, "state")
    params = bridge.tensors_from_numpy(net, params_np, device)
    qat = {k: v for k, v in state_np.items() if k.startswith("qat_amax/")}
    state = bridge.tensors_from_numpy(
        net, {k: v for k, v in state_np.items() if k not in qat}, device)
    state.update({k: torch.tensor(float(v), dtype=torch.float32,
                                  device=device) for k, v in qat.items()})
    opt_np = _under(flat, "opt")
    opt: Dict[str, Any] = {}
    if opt_np:
        opt = bridge.opt_state_from_numpy(
            net, {"seen": opt_np.get("seen", 0),
                  **{name: _under(opt_np, name) for name in OPT_BUFFERS}},
            device)
    return params, state, opt, meta.get("extra", {})
