"""The port's framework-free modules (types, graph, models, initializers)
held to bcnn_tpu's: the port carries its own copies because every
bcnn_tpu module imports JAX when it is loaded."""

import math

import numpy as np
import pytest
import torch

import dataclasses

import bcnn_tpu.types as jtypes
from bcnn_tpu.compile import init_params as jax_init_params
from bcnn_tpu.graph import Learner as JaxLearner
from bcnn_tpu.graph import Net as JaxNet
from bcnn_tpu.models import yolov3_tiny as jax_tiny

import bcnn_tpu_torch.types as ttypes
from bcnn_tpu_torch.compile import init_params, make_train_step
from bcnn_tpu_torch.graph import Learner, Net, TensorKind
from bcnn_tpu_torch.initializers import Filler
from bcnn_tpu_torch.models import yolov3_tiny
from bcnn_tpu_torch.types import FillerType, LayerType, Mode

torch.set_num_threads(1)

ENUMS = [
    "Status", "Mode", "LoaderType", "LrDecay", "LayerType", "Activation",
    "Loss", "Metric", "Padding", "Optimizer", "LogLevel", "FillerType",
]


# the port's members that bcnn_tpu lacks: Mish and Swish, for Darknet cfgs
# (YOLOv4, YOLOv7)
PORT_ONLY = {"Activation": [("MISH", 10), ("SWISH", 11)]}


@pytest.mark.parametrize("name", ENUMS)
def test_enums_match_bcnn_tpu(name):
    ref, port = getattr(jtypes, name), getattr(ttypes, name)
    assert [(m.name, m.value) for m in port] == [
        (m.name, m.value) for m in ref
    ] + PORT_ONLY.get(name, [])


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
    """TRAIN builds, and the training step takes remat and gradient
    accumulation; what it refuses is a batch that accum_steps does not
    divide (given or read from the net), as bcnn_tpu does."""
    v = Filler(type=FillerType.FIXED, value=1.5)(torch.Generator(), (3,))
    assert torch.equal(v, torch.full((3,), 1.5))
    net = yolov3_tiny(2, 64, 64, 4, mode=Mode.TRAIN)
    assert callable(make_train_step(net, remat=True))
    assert callable(make_train_step(net, accum_steps=2))
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(net, accum_steps=3)
    net.accum_steps = 3
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(net)


OPT_FIELDS = ("trainable", "weight_decay", "adam_capable", "batch_div_one",
              "grad_div_batch")


def _learner_fields(ln):
    return {k: (int(v) if isinstance(v, int) else v)
            for k, v in dataclasses.asdict(ln).items()}


@pytest.mark.parametrize("mode", [Mode.TRAIN, Mode.VALID, Mode.PREDICT])
def test_yolov3_tiny_optimizer_metadata_matches_bcnn_tpu(mode):
    ref = jax_tiny(2, 96, 96, 4, mode=jtypes.Mode(int(mode)))
    port = yolov3_tiny(2, 96, 96, 4, mode=mode)
    for r, p in zip(ref.tensors, port.tensors):
        assert [getattr(p, f) for f in OPT_FIELDS] == [
            getattr(r, f) for f in OPT_FIELDS
        ], p.name
    if mode == Mode.PREDICT:
        assert port.learner is None and ref.learner is None
    else:
        assert _learner_fields(port.learner) == _learner_fields(ref.learner)
        assert port.learner.base_learning_rate == 0.001
        assert port.learner.momentum == 0.9
        assert port.learner.decay == 0.0005


def test_learner_defaults_and_setters_match_bcnn_tpu():
    assert _learner_fields(Learner()) == _learner_fields(JaxLearner())
    ref, port = JaxNet(jtypes.Mode.TRAIN), Net(Mode.TRAIN)
    assert _learner_fields(port.learner) == _learner_fields(ref.learner)
    calls = [
        ("set_adam_optimizer", (0.01, 0.8, 0.99)),
        ("set_learning_rate_policy", (ttypes.LrDecay.POLY, 0.1, 0.5, 2.0,
                                      100, 7)),
        ("set_weight_regularizer", (0.001,)),
        ("set_sgd_optimizer", (0.05, 0.7)),
    ]
    for name, args in calls:
        getattr(ref, name)(*args)
        getattr(port, name)(*args)
        assert _learner_fields(port.learner) == _learner_fields(ref.learner)
    port.set_mode(Mode.VALID)
    assert port.mode == Mode.VALID


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
