"""The plain reference of the YOLOv3 configurations: Darknet's YOLOv3
layers (`darknet`) and its detection rule (`detect`), under the names a
configuration's reference provides (`harness.REFERENCE`)."""

from benchmark.reference.darknet import (  # noqa: F401
    Quant, build, calibrate, conv_layers, conv_ops, forward, heads,
    make_weights, watch_tensors)
from benchmark.reference.detect import (  # noqa: F401
    NMS_THRESH, decode, detections)
