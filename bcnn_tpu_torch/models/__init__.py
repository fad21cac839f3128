"""Programmatic model builders. Each returns a built Net."""

from .yolov3 import yolov3_tiny
