"""Programmatic model builders. Each returns a built Net."""

from .imagenet import mobilenet_v1
from .yolov3 import yolov3, yolov3_tiny
