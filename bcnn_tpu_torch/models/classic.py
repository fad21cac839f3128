"""The MNIST and CIFAR-10 example nets, as `bcnn_tpu.models.classic`
transcribes them from the reference's examples: LeNet on MNIST
(examples/mnist/mnist_example.c:30-55 and its solver :130-145), the plain
CIFAR-10 convnet (examples/cifar10/cifar10_example.c:33-63) and its
ResNet-style variant with eltwise shortcuts (:66-130)."""

from __future__ import annotations

from ..graph import Net
from ..types import Activation, FillerType, Loss, LrDecay, Metric, Mode, Padding

X = FillerType.XAVIER
R = Activation.RELU
N = Activation.NONE


def _cost(net: Net, src: str):
    net.add_softmax_layer(src, "softmax")
    net.add_cost_layer(
        Loss.EUCLIDEAN, Metric.ERROR_RATE, 1.0, "softmax", "label", "cost"
    )


def lenet_mnist(batch_size: int = 16, mode: Mode = Mode.TRAIN) -> Net:
    """Two 3x3 conv + standalone BN + 2x2 max-pool stages, FC 256 with
    BN, FC 10, softmax, euclidean cost; SGD lr 0.003, momentum 0.9,
    SIGMOID decay, weight decay 0.0005."""
    net = Net(mode)
    net.set_input_shape(28, 28, 1, batch_size)
    if mode != Mode.PREDICT:
        net.set_sgd_optimizer(learning_rate=0.003, momentum=0.9)
        net.set_learning_rate_policy(
            LrDecay.SIGMOID, gamma=0.00002, max_batches=50000, step=40000
        )
        net.set_weight_regularizer(0.0005)
    net.add_convolutional_layer(32, 3, 1, 1, 1, 0, X, R, 0, "input", "conv1")
    net.add_batchnorm_layer("conv1", "bn1")
    net.add_maxpool_layer(2, 2, Padding.SAME, "bn1", "pool1")
    net.add_convolutional_layer(32, 3, 1, 1, 1, 0, X, R, 0, "pool1", "conv2")
    net.add_batchnorm_layer("conv2", "bn2")
    net.add_maxpool_layer(2, 2, Padding.SAME, "bn2", "pool2")
    net.add_fullc_layer(256, X, R, 0, "pool2", "fc1")
    net.add_batchnorm_layer("fc1", "bn3")
    net.add_fullc_layer(10, X, R, 0, "bn3", "fc2")
    _cost(net, "fc2")
    return net


def _cifar_net(batch_size: int, mode: Mode):
    net = Net(mode)
    net.set_input_shape(32, 32, 3, batch_size)
    if mode != Mode.PREDICT:
        net.set_sgd_optimizer(learning_rate=0.003, momentum=0.9)
        net.set_weight_regularizer(0.0005)

    def conv(n, src, dst, act=R, stride=1, size=3, pad=1):
        net.add_convolutional_layer(
            n, size, stride, pad, 1, 1, X, act, 0, src, dst
        )

    return net, conv


def cifar10_convnet(batch_size: int = 128, mode: Mode = Mode.TRAIN) -> Net:
    """Two stages of three 3x3 BN convs and a 2x2 max-pool, FC 512 with a
    standalone BN, FC 10, softmax, euclidean cost; SGD lr 0.003, momentum
    0.9, weight decay 0.0005."""
    net, conv = _cifar_net(batch_size, mode)
    conv(32, "input", "conv1_1")
    conv(32, "conv1_1", "conv1_2")
    conv(32, "conv1_2", "conv1_3")
    net.add_maxpool_layer(2, 2, Padding.SAME, "conv1_3", "pool1")
    conv(64, "pool1", "conv2_1")
    conv(64, "conv2_1", "conv2_2")
    conv(64, "conv2_2", "conv2_3")
    net.add_maxpool_layer(2, 2, Padding.SAME, "conv2_3", "pool2")
    net.add_fullc_layer(512, X, R, 0, "pool2", "fc1")
    net.add_batchnorm_layer("fc1", "bn3")
    net.add_fullc_layer(10, X, R, 0, "bn3", "fc2")
    _cost(net, "fc2")
    return net


def cifar10_resnet(batch_size: int = 32, mode: Mode = Mode.TRAIN) -> Net:
    """A 64-channel stem and three stages of two residual blocks (3x3 BN
    convs, eltwise add + ReLU), the second and third entered at stride 2
    with a 1x1 stride-2 projection shortcut; global avgpool, FC 10,
    softmax, euclidean cost."""
    net, conv = _cifar_net(batch_size, mode)
    conv(64, "input", "conv1")
    conv(64, "conv1", "conv1_1")
    conv(64, "conv1_1", "conv1_2", act=N)
    net.add_eltwise_layer(R, "conv1", "conv1_2", "conv1_add1")
    conv(64, "conv1_add1", "conv1_3")
    conv(64, "conv1_3", "conv1_4", act=N)
    net.add_eltwise_layer(R, "conv1_add1", "conv1_4", "conv1_add2")
    prev = "conv1_add2"
    for stage, ch in ((2, 128), (3, 256)):
        s = f"conv{stage}"
        conv(ch, prev, f"{s}_1", stride=2)
        conv(ch, f"{s}_1", f"{s}_2", act=N)
        conv(ch, prev, f"{s}_res1", act=N, stride=2, size=1, pad=0)
        net.add_eltwise_layer(R, f"{s}_res1", f"{s}_2", f"{s}_add1")
        conv(ch, f"{s}_add1", f"{s}_3")
        conv(ch, f"{s}_3", f"{s}_4", act=N)
        net.add_eltwise_layer(R, f"{s}_add1", f"{s}_4", f"{s}_add2")
        prev = f"{s}_add2"
    net.add_avgpool_layer(prev, "avgpool")
    net.add_fullc_layer(10, X, N, 0, "avgpool", "fc")
    _cost(net, "fc")
    return net
