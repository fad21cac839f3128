"""Programmatic model builders. Each returns a built Net."""

from .classic import cifar10_convnet, cifar10_resnet, lenet_mnist
from .imagenet import mobilenet_v1, resnet18
from .yolov3 import yolov3, yolov3_tiny
from .yolov4 import yolov4
from .yolov7 import yolov7
