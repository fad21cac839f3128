"""The system under test: the port (`bcnn_tpu_torch`) built for one cell.

This is the only file of the benchmark that imports the port. It builds
the net of the cell's configuration through the port's own entry, the
builder of `bcnn_tpu_torch.models` that the configuration's `"program"`
key names (called with the configuration's frozen Darknet cfg),
hands it the benchmark's seeded weights, sets the cell's precision the
way a user of the port does (bf16: `net.compute_dtype` and
`net.act_dtype`; int8: the port's absmax PTQ, `ops.quant.calibrate` and
`quantize_weights`, on the benchmark's calibration batch), and serves
through `Session.detect_on_batch`.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


class Served:
    """One cell's session. `detect(x)` is the timed entry: a host batch
    in, detections on the host out. `heads(x)` reads the raw YOLO heads
    of a batch through the same session and executor, for the check."""

    def __init__(self, config: Dict, cell: Dict, weights: List[Dict],
                 calib: np.ndarray, device):
        from bcnn_tpu_torch import Mode, Session, models
        from bcnn_tpu_torch.types import LayerType

        size, batch = config["input_size"], cell["batch"]
        build = getattr(models, config["program"], None)
        if not callable(build):
            raise ValueError(f"unknown program {config['program']!r}: not "
                             "a builder of bcnn_tpu_torch.models")
        net = build(batch, size, size, config["classes"], Mode.PREDICT,
                    cfg_path=config["cfg_path"])
        self.net = net
        self.sess = Session(net, 0, device=device).compile_net()
        convs = [n for n in net.nodes if n.type == LayerType.CONV2D]
        if len(convs) != len(weights):
            raise ValueError(f"{len(convs)} convs in the program, "
                             f"{len(weights)} in the cfg")
        key = lambda n, i: net.tensors[n.src[i]].key  # noqa: E731
        for node, wt in zip(convs, weights):
            p, s = self.sess.params, self.sess.state
            if tuple(p[key(node, 1)].shape) != tuple(wt["w"].shape):
                raise ValueError(f"conv {key(node, 1)}: program "
                                 f"{tuple(p[key(node, 1)].shape)}, cfg "
                                 f"{tuple(wt['w'].shape)}")
            p[key(node, 1)] = wt["w"].clone()
            if node.param.get("batch_norm"):
                p[key(node, 2)] = wt["shift"].clone()
                s[key(node, 3)] = wt["mean"].clone()
                s[key(node, 4)] = wt["var"].clone()
                p[key(node, 5)] = wt["scale"].clone()
            else:
                p[key(node, 2)] = wt["bias"].clone()
        prec = cell["precision"]
        if prec == "bf16":
            net.compute_dtype = net.act_dtype = torch.bfloat16
        elif prec == "int8":
            from bcnn_tpu_torch.ops.quant import calibrate, quantize_weights

            net.quant = {
                "act_scales": calibrate(net, self.sess.params,
                                        self.sess.state, [calib]),
                "weights": quantize_weights(net, self.sess.params),
            }
        elif prec != "fp32":
            raise ValueError(f"unknown precision {prec!r}")
        self.head_names = [net.tensors[n.src[0]].name for n in net.nodes
                           if n.type == LayerType.YOLOV3]
        d = cell["detect"]
        self.thresh, self.max_dets = d["thresh"], d["max_dets"]

    def detect(self, x: np.ndarray):
        boxes, scores, obj = self.sess.detect_on_batch(
            x, thresh=self.thresh, max_dets=self.max_dets)
        return boxes.cpu(), scores.cpu(), obj.cpu()

    def heads(self, x: np.ndarray) -> List[torch.Tensor]:
        outs, _ = self.sess.predict_on_batch(x, outputs=self.head_names)
        return [o.float() for o in outs]

    def free(self):
        self.sess = self.net = None


def build_kernels(device) -> None:
    """Build (first run in a checkout) or load the port's CUDA library."""
    if torch.device(device).type == "cuda":
        from bcnn_tpu_torch import kernels

        kernels.library()
