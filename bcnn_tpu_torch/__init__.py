"""bcnn_tpu_torch: the port of bcnn-tpu to PyTorch and CUDA (NVIDIA
Hopper).

It sits beside the JAX package `bcnn_tpu`, which stays the reference,
and mirrors its module names. It imports torch and never JAX. It runs:
- detection serving (PREDICT) of YOLOv3-tiny and of full YOLOv3 (built
  from examples/yolo/yolov3.cfg, its 23 shortcut adds included) in
  fp32, bf16 and int8 (PTQ, int8 activations between layers), on both
  detection branches, and the host-exact `Session.yolo_get_detections`;
- MobileNet-v1 classification serving in fp32 and bf16, and its
  training;
- the YOLOv3-tiny training step in fp32 and bf16, SGD or Adam, with
  on-device augmentation, in every form of `bcnn_tpu`'s step;
- training from files: the host image ops (`bip`, on the repo's native
  C++ built at first use), the five data loaders, raw records and the
  prefetch pipelines (`data`), the cost and activation layers, and the
  `bcnn-cl` CLI (`cli`);
- Darknet `.cfg` / `.conf` parsing (`config`), `.bcnnmodel` and Darknet
  `.weights` files (`serialization`), detection metrics (`metrics_det`).
It deploys: `deploy` exports the serving programs with `torch.export`
(`Session.export_serving`, `bcnn-cl export`); `checkpoint` writes and
reads `bcnn_tpu`'s full-state `.npz` (`Session.save_checkpoint`); `log`,
`debug`, `profiling` and `capi` (the reference's C-style names) are
ported too.
Its hand-written CUDA kernels, the YOLO decode (`csrc/yolo_decode.cu`),
the shear shift along rows or columns (`csrc/row_shift.cu`), the fused
depthwise conv (`csrc/depthwise.cu`), the int8 conv
(`csrc/conv_int8.cu`) and the int8 grouped conv (`csrc/grouped_int8.cu`),
are `torch.library` ops (`ops.library`), built with nvcc at first CUDA
use into `_build/`, where the native host library (`native/*.cpp`, g++)
goes too.
"""

from .api import Session
from .config import load_net
from .graph import Learner, Net, Node, TensorKind, TensorSpec
from .serialization import load_weights, save_weights
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
