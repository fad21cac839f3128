"""A configuration names its plain reference and its port builder: a toy
configuration, its cell and its reference come in as new files alone
and run through the harness; an unknown reference or builder raises,
naming it. (That every reference module loads nothing of the port:
`test_bm_harness.test_the_reference_loads_nothing_of_the_port`.)"""

import contextlib
import json
import os
import time
import uuid

import pytest
import torch

from benchmark import harness
from benchmark.program import Served

torch.set_num_threads(1)

SIZE = 64
TOY_CFG = """[net]
width=64
height=64
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask=0,1,2
anchors=10,14, 23,27, 37,58
classes=2
num=3
"""
# YOLOv3's reference with every decoded box moved right by OFFSET: a
# check that reads it passes the toy program, one that reads YOLOv3's
# does not
TOY_REFERENCE = '''"""YOLOv3's reference, every decoded box moved right."""
import torch

from benchmark.reference import detect
from benchmark.reference.darknet import (
    Quant, build, calibrate, conv_layers, conv_ops, forward, heads,
    make_weights, watch_tensors)
from benchmark.reference.detect import NMS_THRESH

OFFSET = 0.25
CALLS = []


def _moved(boxes):
    return boxes + torch.tensor([OFFSET, 0.0, 0.0, 0.0], device=boxes.device)


def decode(raws, params, net_w, net_h):
    CALLS.append("decode")
    boxes, objl, clsl = detect.decode(raws, params, net_w, net_h)
    return _moved(boxes), objl, clsl


def detections(raws, params, net_w, net_h, max_dets, thresh, dtype=None):
    boxes, scores, obj = detect.detections(raws, params, net_w, net_h,
                                           max_dets, thresh, dtype)
    return _moved(boxes), scores, obj
'''


def toy_workload(tag):
    return {"config": tag, "entry": "Session.detect_on_batch",
            "precision": "fp32", "loop": "closed", "batch": 2, "pool": 2,
            "warmup": 1, "detect": {"thresh": 0.5, "max_dets": 100},
            "trace_skip": 0, "trace_requests": 2,
            "check": {"requests": 2, "block": 2,
                      "limits": {"heads": 1e-4, "dets": 1e-4, "select": 0},
                      "margins": {"sigmoid": 1e-6, "exp": 1e-6}},
            "chips": 1, "why": "a toy configuration of the tests"}


@contextlib.contextmanager
def toy(**config):
    """A configuration, its cfg, its cell and its reference module, all
    named `tag`, written as new files and removed afterwards. config:
    keys over the configuration's (a key set to None is left out)."""
    tag = "_t" + uuid.uuid4().hex[:8]
    cfg = {"name": tag, "cfg": f"{tag}.cfg", "program": "yolov3",
           "reference": tag, "input_size": SIZE, "classes": 2}
    cfg.update(config)
    cfg = {k: v for k, v in cfg.items() if v is not None}
    files = {harness.HERE / "configs" / f"{tag}.cfg": TOY_CFG,
             harness.HERE / "configs" / f"{tag}.json": json.dumps(cfg),
             harness.HERE / "workloads" / f"{tag}.json":
                 json.dumps(toy_workload(tag)),
             harness.HERE / "reference" / f"{tag}.py": TOY_REFERENCE}
    try:
        for path, text in files.items():
            path.write_text(text)
        yield tag, list(files)
    finally:
        for path in files:
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)
        cache = harness.HERE / "reference" / "__pycache__"
        for path in cache.glob(f"{tag}.*"):
            os.remove(path)


def toy_served(name):
    """A stand-in for `program.Served` whose program is the reference
    module `name` at float32: its heads and its detections."""

    class Plain:
        def __init__(self, config, cell, weights, calib, device):
            self.ref = harness.load_reference(cell["config"], name)
            self.layers = self.ref.build(config["cfg_path"],
                                         config["input_size"])
            self.weights, self.cell = weights, cell
            self.params = [p for _, p in self.ref.heads(self.layers)]

        def heads(self, x):
            with torch.no_grad():
                return self.ref.forward(self.layers, self.weights,
                                        torch.as_tensor(x), None)

        def detect(self, x):
            d, size = self.cell["detect"], self.cell["cfg"]["input_size"]
            return self.ref.detections(self.heads(x), self.params, size,
                                       size, d["max_dets"], d["thresh"])

        def free(self):
            pass

    return Plain


def run(tag, factory):
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    return harness.run_cell(tag, 2**31 + 23, 0.3, False, time.perf_counter(),
                            device="cpu", served_factory=factory, bench=bench)


def test_a_configuration_added_as_files_runs_its_own_reference():
    with toy() as (tag, files):
        out = run(tag, toy_served(tag))
        calls = len(harness.load_cell(tag)["ref"].CALLS)
        # the same program judged by the reference YOLOv3's
        # configuration names
        (harness.HERE / "configs" / f"{tag}.json").write_text(json.dumps(
            dict(json.loads((harness.HERE / "configs" / f"{tag}.json")
                            .read_text()), reference="yolov3")))
        other = run(tag, toy_served(tag))
    assert out["correct"] is True, out["check"]
    assert out["check"]["dets"]["value"] < 1e-6
    assert calls >= 2  # the check decoded through the toy reference
    assert other["correct"] is False
    assert other["check"]["dets"]["value"] > other["check"]["dets"]["limit"]
    assert not any(p.exists() for p in files)


@pytest.mark.parametrize("reference", ["_no_such_reference", "darknet",
                                       "../harness", 7, None])
def test_a_configuration_without_a_sound_reference_raises(reference):
    """An unknown module, one that lacks a name of the interface, a path
    out of benchmark/reference/, a value that names no module, and no
    key at all: each raises, naming the configuration."""
    with toy(reference=reference) as (tag, _):
        with pytest.raises(ValueError, match=tag) as e:
            harness.load_cell(tag)
    if reference is not None:
        assert repr(reference) in str(e.value)


def test_an_unknown_program_raises_naming_it():
    with toy(program="_no_such_builder") as (tag, _):
        cell = harness.load_cell(tag)
    with pytest.raises(ValueError, match="_no_such_builder"):
        Served(cell["cfg"], cell, [], None, "cpu")
