"""YOLOv7 (Wang, Bochkovskiy and Liao, arXiv:2207.02696), the deploy net
of cfg/deploy/yolov7.yaml (github.com/WongKinYiu/yolov7) in the Darknet
dialect: E-ELAN blocks of 1x1 and 3x3 convs whose outputs are
concatenated (no residual add), MP down-sampling blocks, SPPCSPC, a PAN
neck, every conv batch norm and SiLU (Darknet's swish), and three heads
at strides 8, 16 and 32 that decode with `scale_x_y` 2 and
`new_coords`."""

from __future__ import annotations

import os

from ..graph import Net
from ..types import Mode
from .darknet import darknet_net

# the benchmark's frozen copy of the cfg
CFG = os.path.join(os.path.dirname(__file__), "..", "..", "benchmark",
                   "configs", "yolov7-640.cfg")


def yolov7(
    batch_size: int = 1,
    width: int = 640,
    height: int = 640,
    classes: int = 80,
    mode: Mode = Mode.PREDICT,
    cfg_path: str = None,
) -> Net:
    """YOLOv7: 143 layers (92 convs, 89 of them batch norm and SWISH, 3
    linear heads whose logistic the [yolo] heads take; 38 routes, 21 of
    them from one layer; 8 max-pools, the 5 MP blocks' 2x2 and
    SPPCSPC's three centred ones; 2 upsamples; 3 [yolo] heads), with the
    loader's lid<N> names. `classes` rewrites the heads as
    `models.yolov3` does; `cfg_path` points at another copy of the cfg
    (default: the benchmark's frozen one)."""
    return darknet_net("yolov7", cfg_path or CFG, batch_size, width,
                       height, classes, mode)
