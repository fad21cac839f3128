"""MobileNet-v1 and ResNet-18 at 224x224, as `bcnn_tpu.models.imagenet`
builds them: the reference's examples/inference_benchmark targets."""

from __future__ import annotations

from ..graph import Net
from ..types import Activation, FillerType, Loss, Metric, Mode, Padding

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


def resnet18(
    batch_size: int = 1, classes: int = 1000, mode: Mode = Mode.PREDICT
) -> Net:
    """Standard ResNet-18: a 7x7 stride-2 BN conv stem, a 3x3 stride-2
    max-pool with CAFFE padding (112 -> 56), four stages of two basic
    blocks (64, 128, 256, 512 channels; 3x3 BN convs, eltwise add +
    ReLU), each later stage entered at stride 2 through a 1x1 stride-2
    projection; global avgpool, FC, softmax; outside PREDICT, SGD (lr
    0.01, momentum 0.9) and a euclidean cost with the ERROR_RATE
    metric."""
    net = Net(mode)
    net.set_input_shape(224, 224, 3, batch_size)
    if mode != Mode.PREDICT:
        net.set_sgd_optimizer(0.01, 0.9)

    def conv(n, src, dst, act=R, stride=1, size=3, pad=1):
        net.add_convolutional_layer(
            n, size, stride, pad, 1, 1, X, act, 0, src, dst
        )

    conv(64, "input", "stem", stride=2, size=7, pad=3)
    net.add_maxpool_layer(3, 2, Padding.CAFFE, "stem", "pool1")
    prev = "pool1"
    for stage, ch in enumerate((64, 128, 256, 512), 1):
        for b in range(2):
            stride = 2 if (stage > 1 and b == 0) else 1
            a, c2, out = f"s{stage}b{b}a", f"s{stage}b{b}b", f"s{stage}b{b}"
            conv(ch, prev, a, stride=stride)
            conv(ch, a, c2, act=N)
            if stage > 1 and b == 0:
                proj = f"s{stage}proj"
                conv(ch, prev, proj, act=N, stride=stride, size=1, pad=0)
                net.add_eltwise_layer(R, proj, c2, out)
            else:
                net.add_eltwise_layer(R, prev, c2, out)
            prev = out
    net.add_avgpool_layer(prev, "avgpool")
    net.add_fullc_layer(classes, X, N, 0, "avgpool", "fc")
    net.add_softmax_layer("fc", "softmax")
    if mode != Mode.PREDICT:
        net.add_cost_layer(
            Loss.EUCLIDEAN, Metric.ERROR_RATE, 1.0, "softmax", "label", "cost"
        )
    return net
