"""K6's yardstick: the bytes of a request's batch-norm epilogues, and
K6's share of its roofline.

K6 (`csrc/bn_act.cu`) reads each batch-norm conv's output once and
writes the result once, at the cell's storage type (bf16: 2 bytes, fp32:
4), and reads the conv's four fp32 vectors (scale, shift, mean, var).
Its bound is those bytes over the card's memory rate
(`roofline.PEAK_BYTES`); its operations (a few a value, three
transcendentals for Mish) are not counted.
"""

from __future__ import annotations

from typing import List, Optional

from benchmark import readers, roofline

ESIZE = {"bf16": 2, "fp32": 4}  # the storage types K6 runs on
KERNEL = "bn_act_kernel"


def bn_conv_bytes(ref, layers: List, batch: int, esize: int) -> List[int]:
    """Bytes K6 moves for each batch-norm conv at `batch`, in cfg order,
    by the cell's reference `ref` (`harness.REFERENCE`)."""
    out = []
    for i in ref.conv_layers(layers):
        if int(layers[i].opts.get("batch_normalize", 0)):
            o, oh, ow = layers[i].shape
            out.append(2 * batch * o * oh * ow * esize + 4 * 4 * o)
    return out


def k6_roofline_pct(run) -> Optional[float]:
    """A request's K6 bound over K6's device time a request in the traced
    stretch, in %; None where the cell's storage type is not K6's or K6
    did not run exactly one launch a batch-norm conv a request."""
    tr = readers.traced(run)
    esize = ESIZE.get(run.cell["precision"])
    if tr is None or esize is None:
        return None
    cfg, ref = run.cell["cfg"], run.cell["ref"]
    layers = ref.build(cfg["cfg_path"], cfg["input_size"])
    sizes = bn_conv_bytes(ref, layers, run.cell["batch"], esize)
    k6 = [d for name, _, d in tr.kernels if KERNEL in name]
    n = len(tr.requests)
    if not k6 or len(k6) != len(sizes) * n:
        return None
    return 100.0 * sum(sizes) / roofline.PEAK_BYTES * n / sum(k6)
