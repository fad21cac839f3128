"""The routes' yardstick: the bytes a request's concatenations must move,
and the share of their roofline that `torch.cat`'s copies reach.

A route (`compile._Executor._concat` → `ops/misc.concat_channels`, one
`torch.cat` on the channels) of two or more layers must read each input
once and write the output once, at the cell's storage type (bf16: 2
bytes, fp32: 4); a route of one layer needs no copy, so its bound is 0.
The bound is those bytes over the card's memory rate
(`roofline.PEAK_BYTES`); the time is that of the `CatArrayBatchedCopy`
kernels (torch's cat of two or more tensors on the card) in the traced
requests. torch copies a cat of one tensor as a device-to-device
memcpy, which the trace lists among the copies, not the kernels: the
single-layer routes' copies are outside this share.
"""

from __future__ import annotations

from typing import List, Optional

from benchmark import readers, roofline
from benchmark.roofline_k6 import ESIZE

KERNEL = "CatArrayBatchedCopy"


def route_bytes(layers: List, batch: int, esize: int) -> List[int]:
    """Bytes each route of two or more layers moves at `batch`, in cfg
    order, from the reference's shapes."""
    out = []
    for l in layers:
        if l.kind == "route" and len(l.srcs) > 1:
            c, h, w = l.shape
            out.append(2 * batch * c * h * w * esize)
    return out


def route_roofline_pct(run) -> Optional[float]:
    """A request's route bound over the device time of the cat kernels a
    request in the traced stretch, in %; None where the cell's storage
    type is not bf16 or fp32 or the trace has no cat kernel."""
    tr = readers.traced(run)
    esize = ESIZE.get(run.cell["precision"])
    if tr is None or esize is None:
        return None
    cat = [d for name, _, d in tr.kernels if KERNEL in name]
    if not cat:
        return None
    cfg, ref = run.cell["cfg"], run.cell["ref"]
    layers = ref.build(cfg["cfg_path"], cfg["input_size"])
    sizes = route_bytes(layers, run.cell["batch"], esize)
    return 100.0 * sum(sizes) / roofline.PEAK_BYTES * len(tr.requests) / \
        sum(cat)
