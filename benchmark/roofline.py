"""Operations, bytes and peaks: the yardstick of the per-layer metrics.

A conv's operations are 2 x multiply-adds: 2 * N * O * H_out * W_out *
C * k * k, from the cfg's shapes, whatever kernel runs it. Its bytes are
each input, weight and output byte counted once: the int8 flow reads x
and w as int8 and writes int8 where the plan routes the output as codes,
float32 otherwise (the heads), and reads its float32 vectors (the
dequantize scale and bias, and batch norm's scale, mean and 1/sqrt(var)).

Peaks: one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, dense:
989 TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s fp32 outside the tensor
cores, 3.35 TB/s of HBM bandwidth; at the 700 W power limit.
"""

from __future__ import annotations

from typing import Dict, List

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12


def conv_ops(ref, layers: List, batch: int) -> List[int]:
    """Operations of each conv at `batch`, in cfg order, by the cell's
    reference `ref` (`harness.REFERENCE`)."""
    return [ref.conv_ops(layers, i, batch) for i in ref.conv_layers(layers)]


def int8_conv_bytes(ref, layers: List, batch: int,
                    flow: Dict[int, float]) -> List[int]:
    out = []
    for i in ref.conv_layers(layers):
        c, h, w = layers[i].in_shape
        o, oh, ow = layers[i].shape
        k = int(layers[i].opts["size"])
        vecs = 5 if int(layers[i].opts.get("batch_normalize", 0)) else 2
        out.append(batch * c * h * w + o * c * k * k
                   + batch * o * oh * ow * (1 if i in flow else 4)
                   + 4 * vecs * o)
    return out


def int8_conv_bound_s(ref, layers: List, batch: int,
                      flow: Dict[int, float]) -> float:
    """The least time of a request's int8 convs: the sum over convs of
    max(bytes / HBM peak, operations / int8 peak)."""
    return sum(max(b / PEAK_BYTES, o / PEAK_OPS["int8"]) for o, b in zip(
        conv_ops(ref, layers, batch),
        int8_conv_bytes(ref, layers, batch, flow)))
