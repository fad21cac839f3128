"""YOLOv3-tiny, transcribed from examples/yolo/yolov3-tiny.cfg, and full
YOLOv3, parsed from examples/yolo/yolov3.cfg, as
`bcnn_tpu.models.yolov3` builds them.

Darknet section indices in the comments match the cfg, so tensor names
are the lid<N> names the config loader would produce, and a Darknet
.weights file loads into either net.
"""

from __future__ import annotations

import os

from ..graph import Net
from ..types import Activation, FillerType, Mode, Padding
from .darknet import darknet_net

ANCHORS = [10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319]


def yolov3_tiny(
    batch_size: int = 1,
    width: int = 416,
    height: int = 416,
    classes: int = 80,
    mode: Mode = Mode.PREDICT,
) -> Net:
    net = Net(mode)
    net.set_input_shape(width, height, 3, batch_size)
    if mode != Mode.PREDICT:
        net.set_sgd_optimizer(learning_rate=0.001, momentum=0.9)
        net.set_weight_regularizer(0.0005)
    anchors = [float(a) for a in ANCHORS]
    X, F, L = FillerType.XAVIER, Activation.LRELU, Activation.NONE

    def conv(n, k, s, p, bn, act, src, dst):
        net.add_convolutional_layer(n, k, s, p, 1, bn, X, act, 0, src, dst)

    conv(16, 3, 1, 1, 1, F, "input", "lid1")          # 1
    net.add_maxpool_layer(2, 2, Padding.SAME, "lid1", "lid2")   # 2
    conv(32, 3, 1, 1, 1, F, "lid2", "lid3")           # 3
    net.add_maxpool_layer(2, 2, Padding.SAME, "lid3", "lid4")   # 4
    conv(64, 3, 1, 1, 1, F, "lid4", "lid5")           # 5
    net.add_maxpool_layer(2, 2, Padding.SAME, "lid5", "lid6")   # 6
    conv(128, 3, 1, 1, 1, F, "lid6", "lid7")          # 7
    net.add_maxpool_layer(2, 2, Padding.SAME, "lid7", "lid8")   # 8
    conv(256, 3, 1, 1, 1, F, "lid8", "lid9")          # 9 (route target)
    net.add_maxpool_layer(2, 2, Padding.SAME, "lid9", "lid10")  # 10
    conv(512, 3, 1, 1, 1, F, "lid10", "lid11")        # 11
    net.add_maxpool_layer(2, 1, Padding.SAME, "lid11", "lid12")  # 12 (s1!)
    conv(1024, 3, 1, 1, 1, F, "lid12", "lid13")       # 13
    conv(256, 1, 1, 0, 1, F, "lid13", "lid14")        # 14 (route -4 target)
    conv(512, 3, 1, 1, 1, F, "lid14", "lid15")        # 15
    n_out = 3 * (classes + 5)
    conv(n_out, 1, 1, 0, 0, L, "lid15", "lid16")      # 16
    net.add_yolo_layer(
        3, classes, 4, 6, [3, 4, 5], anchors, "lid16", "lid17"
    )                                                  # 17 (13x13 head)
    net.add_concat_layer(["lid14"], "lid18")          # 18 [route] -4
    conv(128, 1, 1, 0, 1, F, "lid18", "lid19")        # 19
    net.add_upsample_layer(2, "lid19", "lid20")       # 20
    net.add_concat_layer(["lid20", "lid9"], "lid21")  # 21 [route] -1,8
    conv(256, 3, 1, 1, 1, F, "lid21", "lid22")        # 22
    conv(n_out, 1, 1, 0, 0, L, "lid22", "lid23")      # 23
    net.add_yolo_layer(
        3, classes, 4, 6, [0, 1, 2], anchors, "lid23", "lid24"
    )                                                  # 24 (26x26 head)
    return net


def yolov3(
    batch_size: int = 1,
    width: int = 608,
    height: int = 608,
    classes: int = 80,
    mode: Mode = Mode.PREDICT,
    cfg_path: str = None,
) -> Net:
    """Full YOLOv3 (Darknet-53 backbone, 75 convs, 23 shortcuts, three
    heads at strides 32, 16 and 8), built by parsing examples/yolo/
    yolov3.cfg, so its tensors carry the loader's lid<N> names. `classes`
    rewrites the [yolo] sections and the filter counts of the convs
    before them (Darknet's recipe edit); `cfg_path` points at another
    copy of the cfg."""
    cfg = cfg_path or os.path.join(
        os.path.dirname(__file__), "..", "..", "examples", "yolo",
        "yolov3.cfg",
    )
    return darknet_net("yolov3", cfg, batch_size, width, height, classes,
                       mode)
