"""Detectors read from a Darknet cfg: the loop that `models.yolov3` and
`models.yolov4` share."""

from __future__ import annotations

import os

from ..graph import Net
from ..types import Mode


def darknet_net(name: str, cfg: str, batch_size: int, width: int,
                height: int, classes: int, mode: Mode) -> Net:
    """The net of Darknet cfg `cfg` (model `name`, for the error) at the
    given input and batch, its layers built in the Darknet dialect (fmt
    1: lid<N> names, Darknet's max-pool), so that a Darknet .weights file
    loads into it. `classes` other than 80 rewrites the [yolo] sections
    and the filter counts of the convs before them (Darknet's recipe
    edit)."""
    from ..config import add_sections, net_set_param, parse_ini

    if not os.path.exists(cfg):
        raise FileNotFoundError(
            f"{name} recipe not found at {cfg}; pass cfg_path= pointing at "
            f"a {name}.cfg"
        )
    sections = parse_ini(cfg)
    net = Net(mode)
    for k, v in sections[0].keys:
        net_set_param(net, k, v)
    net.set_input_shape(width, height, 3, batch_size)

    if classes != 80:
        for i, sec in enumerate(sections):
            if sec.name == "[yolo]":
                masks = [v for k, v in sec.keys if k in ("mask",
                                                         "anchors_mask")]
                n_out = len(masks[0].split(",")) * (classes + 5)
                sec.keys = [
                    (k, str(classes) if k == "classes" else v)
                    for k, v in sec.keys
                ]
                prev = sections[i - 1]
                prev.keys = [
                    (k, str(n_out) if k == "filters" else v)
                    for k, v in prev.keys
                ]
    add_sections(net, sections, fmt=1)
    return net
