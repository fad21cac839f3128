"""The yardstick: conv operations against Darknet's published totals and
hand counts, and the int8 conv bound."""

import json

import pytest

from benchmark import harness, roofline
from benchmark.reference import darknet

# the Darknet site's table (pjreddie.com/darknet/yolo): billions of
# floating point operations an image at 416 x 416, 2 x multiply-adds
PUBLISHED = {"yolov3-416": 65.86e9}


def ref_of(config):
    """The plain reference that the configuration names."""
    cfg = json.loads(
        (harness.HERE / "configs" / f"{config}.json").read_text())
    return harness.load_reference(config, cfg["reference"])


def layers_of(config):
    return ref_of(config).build(
        str(harness.HERE / "configs" / f"{config}.cfg"), 416)


@pytest.mark.parametrize("config", sorted(PUBLISHED))
def test_conv_operations_match_darknets_totals(config):
    total = sum(roofline.conv_ops(ref_of(config), layers_of(config), 1))
    assert abs(total / PUBLISHED[config] - 1) < 0.01


@pytest.mark.parametrize("config, conv, ops", [
    # 2 * O * H * W * C * k * k
    ("yolov3-416", 0, 2 * 32 * 416 * 416 * 3 * 3 * 3),
    ("yolov3-416", 1, 2 * 64 * 208 * 208 * 32 * 3 * 3),
    ("yolov3-416", 74, 2 * 255 * 52 * 52 * 256),
    ("yolov3-416", 53, 2 * 1024 * 13 * 13 * 512 * 3 * 3),
    ("yolov3-416", 58, 2 * 255 * 13 * 13 * 1024),
])
def test_conv_operations_equal_hand_counts(config, conv, ops):
    ref, layers = ref_of(config), layers_of(config)
    assert roofline.conv_ops(ref, layers, 1)[conv] == ops
    assert roofline.conv_ops(ref, layers, 8)[conv] == 8 * ops


def test_the_int8_bound_counts_each_byte_once():
    layers = layers_of("yolov3-416")
    # one scale for every tensor: the largest flow plan
    flow = darknet.plan_flow(
        layers, {t: 1.0 for t in darknet.watch_tensors(layers)})
    b = roofline.int8_conv_bytes(ref_of("yolov3-416"), layers, 8, flow)
    # conv 0: x (8, 3, 416, 416) int8, w (32, 3, 3, 3), out (8, 32, 416,
    # 416) int8, five float32 vectors of 32
    assert b[0] == 8 * 3 * 416 * 416 + 32 * 27 + 8 * 32 * 416 * 416 \
        + 5 * 128
    # a head writes float32 and has two vectors (scale, bias)
    assert b[74] == 8 * 256 * 52 * 52 + 255 * 256 + 8 * 255 * 52 * 52 * 4 \
        + 2 * 4 * 255
    t = roofline.int8_conv_bound_s(ref_of("yolov3-416"), layers, 8, flow)
    assert 0 < t < 1e-2
