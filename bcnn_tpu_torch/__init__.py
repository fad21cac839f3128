"""bcnn_tpu_torch: the port of bcnn-tpu to PyTorch and CUDA (NVIDIA
Hopper).

It sits beside the JAX package `bcnn_tpu`, which stays the reference,
and mirrors its module names. It imports torch and never JAX. So far it
runs the YOLOv3-tiny fp32 detection serving path (PREDICT), with the YOLO
decode as a hand-written CUDA kernel (`csrc/yolo_decode.cu`), built with
nvcc at first CUDA use into `_build/`.
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
