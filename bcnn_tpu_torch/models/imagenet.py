"""MobileNet-v1 at 224x224, as `bcnn_tpu.models.imagenet.mobilenet_v1`
builds it: one of the reference's examples/inference_benchmark targets.
ResNet-18's training needs the eltwise layer's backward, which is not
ported yet."""

from __future__ import annotations

from ..graph import Net
from ..types import Activation, FillerType, Loss, Metric, Mode

X = FillerType.XAVIER
R = Activation.RELU
N = Activation.NONE


def mobilenet_v1(
    batch_size: int = 1,
    classes: int = 1000,
    mode: Mode = Mode.PREDICT,
    width_mult: float = 1.0,
) -> Net:
    """Standard MobileNet-v1: conv s2 + 13 depthwise-separable blocks
    (DEPTHWISE_CONV2D + 1x1 CONV2D with BN), global avgpool, FC,
    softmax; outside PREDICT, SGD (lr 0.01, momentum 0.9) and a euclidean
    cost layer with the ERROR_RATE metric."""
    net = Net(mode)
    net.set_input_shape(224, 224, 3, batch_size)
    if mode != Mode.PREDICT:
        net.set_sgd_optimizer(0.01, 0.9)

    def c(ch):
        return max(8, int(ch * width_mult))

    net.add_convolutional_layer(
        c(32), 3, 2, 1, 1, 1, X, R, 0, "input", "conv1"
    )
    cfg = [  # (out_channels, stride of the depthwise)
        (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
        (1024, 1),
    ]
    prev = "conv1"
    for i, (ch, s) in enumerate(cfg, 1):
        dw, pw = f"dw{i}", f"pw{i}"
        net.add_depthwise_conv_layer(3, s, 1, 0, X, R, prev, dw)
        net.add_convolutional_layer(c(ch), 1, 1, 0, 1, 1, X, R, 0, dw, pw)
        prev = pw
    net.add_avgpool_layer(prev, "avgpool")
    net.add_fullc_layer(classes, X, N, 0, "avgpool", "fc")
    net.add_softmax_layer("fc", "softmax")
    if mode != Mode.PREDICT:
        net.add_cost_layer(
            Loss.EUCLIDEAN, Metric.ERROR_RATE, 1.0, "softmax", "label", "cost"
        )
    return net
