"""bcnn_tpu_torch: the port of bcnn-tpu to PyTorch and CUDA (NVIDIA
Hopper).

It sits beside the JAX package `bcnn_tpu`, which stays the reference,
and mirrors its module names. It imports torch and never JAX. So far it
runs three paths in fp32: YOLOv3-tiny detection serving (PREDICT), the
YOLOv3-tiny training step (TRAIN, SGD or Adam) with on-device
augmentation, rotation included, and MobileNet-v1 classification
serving (PREDICT). Its hand-written CUDA kernels, the YOLO decode
(`csrc/yolo_decode.cu`), the shear shift along rows or columns
(`csrc/row_shift.cu`) and
the fused depthwise conv (`csrc/depthwise.cu`), are built with nvcc at
first CUDA use into `_build/`.
"""

from .api import Session
from .graph import Net, Node, TensorKind, TensorSpec
from .types import (
    Activation,
    FillerType,
    LayerType,
    LoaderType,
    LogLevel,
    Loss,
    LrDecay,
    Metric,
    Mode,
    Optimizer,
    Padding,
    Status,
)
