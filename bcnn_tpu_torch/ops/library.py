"""The hand-written kernels K1-K6 as `torch.library` custom ops, in the
`bcnn_tpu_torch` namespace: `yolo_decode` (K1), `row_shift` (K2, both
modes), `depthwise` (K3), `conv_int8` (K4), `grouped_int8` (K5),
`bn_act` (K6).

Each op is one node of a traced or exported graph (`torch.export`,
`deploy.py`) and dispatches on its tensors' device: the CUDA
implementation launches the kernel (the launcher of its module: the
plan, the workspace, `kernels.check`) and raises on what the kernel
does not take; the CPU implementation is the plain
version; the fake implementation gives the real op's shape, dtype and
strides, so a program traced with fake tensors lays its tensors out as
the kernel does (K4 and K5 write int8 channels-last). A program traced
on the CPU therefore holds the op where the kernel runs, and replaying
it on the card launches the kernel.

The ops are registered through `torch.library.Library.impl`, which puts
a Python function straight into the dispatcher, when the kernel modules
are imported (`bcnn_tpu_torch.ops` imports them all); nothing is built
then (`kernels.py` builds at the first CUDA launch). The public wrappers
(`decode_fused`, `row_shift`, `col_shift`, `depthwise_fused`,
`conv_int8_fused`, `grouped_int8_fused`, `bn_act`) call the ops on both
devices.
K3's, K4's and K5's flop formulas are registered with
`torch.utils.flop_counter`, so that `FlopCounterMode`
(`profiling.memory_report`) counts their work as it counts aten's convs.

`register` wraps each CUDA implementation with the port's one launch
counter: a call that returns with an output counts one launch under the
op's name (`launches("conv_int8")`; `reset_launches()` sets them all to
0). A call that raises counts none, nor one whose outputs are empty:
every launcher returns those without a launch. K2's row and column
modes count under `row_shift`. A launcher may count its launches by
kind as well (`count_kind`; K6 by activation: `launches("bn_act",
"MISH")`), beside the op's total.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "bcnn_tpu_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")
_LAUNCHES: Dict[str, int] = {}
_KINDS: Dict[str, Dict[str, int]] = {}


def launches(name: str, kind: Optional[str] = None) -> int:
    """Kernel launches of op `name` since the last `reset_launches`; with
    `kind`, those its launcher counted under that kind."""
    if kind is None:
        return _LAUNCHES[name]
    return _KINDS.get(name, {}).get(kind, 0)


def count_kind(name: str, kind: str) -> None:
    """One launch of op `name` counted under `kind` (its launcher calls
    this once a launch; `_counted` counts the total)."""
    kinds = _KINDS.setdefault(name, {})
    kinds[kind] = kinds.get(kind, 0) + 1


def reset_launches() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
    _KINDS.clear()


def _counted(name: str, cuda: Callable) -> Callable:
    def launch(*args, **kwargs):
        out = cuda(*args, **kwargs)
        if any(t.numel() for t in (out if isinstance(out, tuple)
                                   else (out,))):
            _LAUNCHES[name] += 1
        return out

    return launch


def register(
    name: str,
    schema: str,
    cpu: Callable,
    cuda: Callable,
    fake: Callable,
    flops: Optional[Callable] = None,
) -> torch._ops.OpOverload:
    """Define `bcnn_tpu_torch::<name>` with `schema` (the arguments and
    results, e.g. "(Tensor x, int k) -> Tensor"), its CPU, CUDA and fake
    implementations and, where given, its flop formula (called with the
    tensors' shapes and `out_shape`); returns the op's overload. The CUDA
    implementation counts its launches (`launches(name)`)."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LAUNCHES[name] = 0
    _LIB.impl(name, _counted(name, cuda), "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    packet = getattr(getattr(torch.ops, NAMESPACE), name)
    if flops is not None:
        register_flop_formula(packet)(flops)
    return packet.default


def check_devices(what: str, *ts: Optional[torch.Tensor]) -> None:
    """A wrapper's tensors (None skipped) all on the CPU or all on one CUDA
    device, else ValueError: the op would dispatch another device's
    tensors (meta, or a CPU tensor beside CUDA ones) where no kernel of
    the port runs."""
    devs = {t.device for t in ts if t is not None}
    if len(devs) > 1 or any(d.type not in ("cpu", "cuda") for d in devs):
        raise ValueError(f"{what}: unsupported devices "
                         + ", ".join(str(t.device) for t in ts
                                     if t is not None))
