"""YOLOv4 (Bochkovskiy, Wang and Liao, arXiv:2004.10934), parsed from
AlexeyAB's cfg/yolov4.cfg: CSPDarknet53 with Mish, SPP, PANet and three
heads at strides 8, 16 and 32 whose box centres are scaled
(`scale_x_y` 1.2, 1.1, 1.05)."""

from __future__ import annotations

import os

from ..graph import Net
from ..types import Mode
from .darknet import darknet_net

# the benchmark's frozen copy of the cfg
CFG = os.path.join(os.path.dirname(__file__), "..", "..", "benchmark",
                   "configs", "yolov4-608.cfg")


def yolov4(
    batch_size: int = 1,
    width: int = 608,
    height: int = 608,
    classes: int = 80,
    mode: Mode = Mode.PREDICT,
    cfg_path: str = None,
) -> Net:
    """Full YOLOv4: 162 layers (110 convs, 72 of them batch norm and
    Mish, 35 batch norm and leaky, 3 linear heads; 23 shortcuts, 21
    routes, SPP's three centred max-pools, 2 upsamples, 3 [yolo] heads),
    with the loader's lid<N> names. `classes` rewrites the heads as
    `models.yolov3` does; `cfg_path` points at another copy of the cfg
    (default: the benchmark's frozen one)."""
    return darknet_net("yolov4", cfg_path or CFG, batch_size, width,
                       height, classes, mode)
