"""The port's framework-free modules (types, graph, models, initializers)
held to bcnn_tpu's: the port carries its own copies because every
bcnn_tpu module imports JAX when it is loaded."""

import math

import numpy as np
import pytest
import torch

import bcnn_tpu.types as jtypes
from bcnn_tpu.compile import init_params as jax_init_params
from bcnn_tpu.models import yolov3_tiny as jax_tiny

import bcnn_tpu_torch.types as ttypes
from bcnn_tpu_torch.compile import init_params
from bcnn_tpu_torch.graph import Net, TensorKind
from bcnn_tpu_torch.initializers import Filler
from bcnn_tpu_torch.models import yolov3_tiny
from bcnn_tpu_torch.types import FillerType, LayerType, Mode

torch.set_num_threads(1)

ENUMS = [
    "Status", "Mode", "LoaderType", "LrDecay", "LayerType", "Activation",
    "Loss", "Metric", "Padding", "Optimizer", "LogLevel", "FillerType",
]


@pytest.mark.parametrize("name", ENUMS)
def test_enums_match_bcnn_tpu(name):
    ref, port = getattr(jtypes, name), getattr(ttypes, name)
    assert [(m.name, m.value) for m in port] == [
        (m.name, m.value) for m in ref
    ]


def test_detection_max_boxes_matches():
    assert ttypes.DETECTION_MAX_BOXES == jtypes.DETECTION_MAX_BOXES


def _conv_weight_keys(net):
    return {
        net.tensors[n.src[1]].key
        for n in net.nodes
        if n.type == LayerType.CONV2D
    }


@pytest.mark.parametrize(
    "batch,size,classes", [(1, 416, 80), (2, 88, 4), (1, 64, 4)]
)
def test_yolov3_tiny_graph_matches_bcnn_tpu(batch, size, classes):
    ref = jax_tiny(batch, size, size, classes, mode=jtypes.Mode.PREDICT)
    port = yolov3_tiny(batch, size, size, classes)
    conv_w = _conv_weight_keys(port)
    assert len(port.tensors) == len(ref.tensors)
    for r, p in zip(ref.tensors, port.tensors):
        assert (p.name, p.key, int(p.kind), p.shape) == (
            r.name, r.key, int(r.kind), r.shape
        )
        if p.key in conv_w:  # HWIO there, OIHW here
            kh, kw, ci, co = r.mem_shape
            assert p.mem_shape == (co, ci, kh, kw)
        else:
            assert p.mem_shape == r.mem_shape
        if r.filler is None:
            assert p.filler is None
        else:
            assert (int(p.filler.type), p.filler.range, p.filler.value) == (
                int(r.filler.type), r.filler.range, r.filler.value
            )
    assert len(port.nodes) == len(ref.nodes)
    for r, p in zip(ref.nodes, port.nodes):
        assert (int(p.type), p.src, p.dst) == (int(r.type), r.src, r.dst)
        assert p.param == r.param
    assert port.batch_size == ref.batch_size


def test_init_params_keys_shapes_and_seed():
    port = yolov3_tiny(1, 64, 64, 4)
    ref = jax_tiny(1, 64, 64, 4, mode=jtypes.Mode.PREDICT)
    jp, js = jax_init_params(ref, 0)
    p1, s1 = init_params(port, seed=3)
    p2, _ = init_params(port, seed=3)
    p3, _ = init_params(port, seed=4)
    conv_w = _conv_weight_keys(port)
    assert set(p1) == set(jp) and set(s1) == set(js)
    for k, v in p1.items():
        shape = np.asarray(jp[k]).shape
        if k in conv_w:
            shape = (shape[3], shape[2], shape[0], shape[1])
        assert tuple(v.shape) == shape and v.dtype == torch.float32
        assert torch.equal(v, p2[k])  # same seed, same weights
    assert all(float(v.abs().sum()) == 0 for v in s1.values())
    assert not torch.equal(p1["input_w"], p3["input_w"])
    assert torch.equal(p1["input_scales"], torch.ones(16))


@pytest.mark.parametrize("ftype", [FillerType.XAVIER, FillerType.MSRA])
def test_filler_distributions(ftype):
    fan_in = 27.0
    v = Filler(type=ftype, range=fan_in)(
        torch.Generator().manual_seed(0), (64, 3, 3, 3, 8)
    )
    if ftype == FillerType.XAVIER:  # uniform(-sqrt(3/range), +sqrt(3/range))
        bound = math.sqrt(3.0 / fan_in)
        assert float(v.abs().max()) <= bound
        assert float(v.abs().max()) > 0.95 * bound
        std = bound / math.sqrt(3.0)
    else:  # normal(0, sqrt(2/range))
        std = math.sqrt(2.0 / fan_in)
    assert abs(float(v.std()) - std) < 0.05 * std
    assert abs(float(v.mean())) < 0.05 * std


def test_fixed_filler_and_training_mode_refused():
    v = Filler(type=FillerType.FIXED, value=1.5)(torch.Generator(), (3,))
    assert torch.equal(v, torch.full((3,), 1.5))
    with pytest.raises(NotImplementedError):
        yolov3_tiny(1, 64, 64, 4, mode=Mode.TRAIN)


def test_duplicate_keys_and_reverse_lookup():
    net = Net()
    net.set_input_shape(8, 8, 3, 1)
    net.add_convolutional_layer(
        4, 3, 1, 1, 1, 0, FillerType.XAVIER, ttypes.Activation.RELU, 0,
        "input", "c"
    )
    net.add_convolutional_layer(
        4, 3, 1, 1, 1, 0, FillerType.XAVIER, ttypes.Activation.RELU, 0,
        "c", "c"
    )
    net.add_convolutional_layer(
        4, 3, 1, 1, 1, 0, FillerType.XAVIER, ttypes.Activation.RELU, 0,
        "c", "d"
    )
    keys = [t.key for t in net.tensors if t.kind == TensorKind.PARAM]
    assert len(keys) == len(set(keys))
    assert net.get_tensor_index_by_name("c") == net.nodes[1].dst[0]
