"""The executor's activation layout (`compile.channels_last_layout`), on
the CPU: the choice as a pure function of the net, the mode, the dtypes,
int8 quantization, the device type and the executor's kind; and, with
the choice forced through that function (the card's path, run here),
every activation of YOLOv3-tiny and YOLOv4 held channels-last, the
conversions counted by `compile.layout_counts`, what callers read NCHW,
and the values those of the NCHW run. The card runs the path for real in
tests/test_torch_cuda.py. Imports no JAX."""

import numpy as np
import pytest
import torch

from bcnn_tpu_torch import Session, bridge
from bcnn_tpu_torch import compile as C
from bcnn_tpu_torch import ops
from bcnn_tpu_torch.models import (mobilenet_v1, resnet18, yolov3,
                                   yolov3_tiny, yolov4)
from bcnn_tpu_torch.types import LayerType, Mode

torch.set_num_threads(1)

BF16 = torch.bfloat16
CL = torch.channels_last

NETS = {
    "yolov3": lambda mode: yolov3(1, 96, 96, 4, mode=mode),
    "yolov3_tiny": lambda mode: yolov3_tiny(2, 64, 64, 4, mode=mode),
    "yolov4": lambda mode: yolov4(1, 64, 64, 4, mode=mode),
    "mobilenet_v1": lambda mode: mobilenet_v1(2, 10, mode=mode,
                                              width_mult=0.25),
    "resnet18": lambda mode: resnet18(2, 10, mode=mode),
}


def _net(name, mode=Mode.PREDICT, dtype=BF16, act=BF16):
    net = NETS[name](mode)
    net.compute_dtype = dtype
    if mode == Mode.TRAIN:
        net.train_act_dtype = act
    else:
        net.act_dtype = act
    return net


@pytest.mark.parametrize("name", ["yolov3", "yolov3_tiny", "yolov4"])
def test_channels_last_for_the_yolos_at_bf16_predict_on_cuda(name):
    assert C.channels_last_layout(_net(name), Mode.PREDICT, "cuda")


# (net, mode, compute dtype, activation dtype, int8, device, plain)
NCHW_CASES = {
    "train": ("yolov3_tiny", Mode.TRAIN, BF16, BF16, False, "cuda", True),
    "valid": ("yolov3_tiny", Mode.VALID, BF16, BF16, False, "cuda", True),
    "fp32": ("yolov3_tiny", Mode.PREDICT, None, None, False, "cuda", True),
    "act_only": ("yolov3_tiny", Mode.PREDICT, None, BF16, False, "cuda",
                 True),
    "compute_only": ("yolov4", Mode.PREDICT, BF16, None, False, "cuda",
                     True),
    "int8": ("yolov3", Mode.PREDICT, BF16, BF16, True, "cuda", True),
    "mobilenet_v1": ("mobilenet_v1", Mode.PREDICT, BF16, BF16, False,
                     "cuda", True),
    "resnet18": ("resnet18", Mode.PREDICT, BF16, BF16, False, "cuda", True),
    "cpu": ("yolov4", Mode.PREDICT, BF16, BF16, False, "cpu", True),
    "model_axis": ("yolov3", Mode.PREDICT, BF16, BF16, False, "cuda",
                   False),
}


@pytest.mark.parametrize("case", sorted(NCHW_CASES))
def test_nchw_everywhere_else(case):
    """TRAIN and VALID, fp32 or half-bf16 nets, int8 (net.quant),
    MobileNet-v1 (K3's depthwise) and ResNet-18 (the FC, avgpool), a CPU
    session and the model axis's executors keep NCHW."""
    name, mode, dtype, act, int8, dev, plain = NCHW_CASES[case]
    net = _net(name, mode, dtype, act)
    if int8:
        net.quant = {"weights": {}, "act_scales": {}}
    assert not C.channels_last_layout(net, mode, dev, plain=plain)
    # the same net with the one setting undone picks channels-last,
    # where it is a YOLO net
    if name.startswith("yolo"):
        net2 = _net(name)
        assert C.channels_last_layout(net2, Mode.PREDICT, "cuda")


def test_executor_asks_once_with_its_device_and_kind(monkeypatch):
    """Each executor asks the pure function once, with its parameters'
    device type and whether it is the plain executor (a subclass, as
    the model axis's, is not)."""
    net = _net("yolov3_tiny")
    p, s = bridge.params_from_numpy(net, *bridge.he_numpy_weights(net, 0))
    asked = []
    monkeypatch.setattr(C, "channels_last_layout",
                        lambda n, m, d, plain=True: asked.append(
                            (n is net, m, d, plain)) or False)

    class Sub(C._Executor):
        pass

    assert not C._Executor(net, p, s, Mode.PREDICT).channels_last
    assert not Sub(net, p, s, Mode.PREDICT).channels_last
    assert asked == [(True, Mode.PREDICT, "cpu", True),
                     (True, Mode.PREDICT, "cpu", False)]


def _seeded(net):
    return bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0, residual_scale=0.1))


def _heads(net):
    return [n.src[0] for n in net.nodes if n.type == LayerType.YOLOV3]


@pytest.mark.parametrize("name", ["yolov3_tiny", "yolov4"])
def test_forced_channels_last_holds_every_activation_so(monkeypatch, name):
    """The card's path on the CPU (the choice forced): every activation
    channels-last but the input, the YOLO heads' inputs (made NCHW once
    each) and the YOLO outputs; one conversion in (the input, at the
    first conv's bf16 cast), one out a head; what `output_value` hands
    out contiguous NCHW, with the NCHW run's values (within bf16's
    rounding, the convs' sums taken in another order)."""
    net = _net(name)
    p, s = _seeded(net)
    x = torch.rand(net.tensors[0].n, 3, net.tensors[0].h, net.tensors[0].w,
                   generator=torch.Generator().manual_seed(5))
    heads = _heads(net)
    with torch.inference_mode():
        want = C.execute(net, p, s, {"input": x}, Mode.PREDICT)
        assert not want.channels_last
        monkeypatch.setattr(C, "channels_last_layout",
                            lambda *a, **k: True)
        C.reset_layout_counts()
        got = C.execute(net, p, s, {"input": x}, Mode.PREDICT)
        counts = C.layout_counts()
        outs = {i: C.output_value(got, i) for i in want.values}
    assert got.channels_last
    assert counts == {"executors": 1, "nodes": len(net.nodes),
                      "to_channels_last": 1, "to_nchw": len(heads)}
    yolo_out = {n.dst[0] for n in net.nodes if n.type == LayerType.YOLOV3}
    for i, v in got.values.items():
        if i == 0 or i in heads or i in yolo_out:
            assert v.is_contiguous(), net.tensors[i].name
        else:
            assert v.is_contiguous(memory_format=CL), net.tensors[i].name
            assert not v.is_contiguous(), net.tensors[i].name
    for i, v in want.values.items():
        o = outs[i]
        assert o.is_contiguous() and o.dtype == v.dtype and o.shape == v.shape
        ref = v.float()
        torch.testing.assert_close(
            o.float(), ref, rtol=0,
            atol=2.0**-5 * float(ref.abs().max().clamp_min(1e-30)))


def test_forced_channels_last_detects_as_nchw(monkeypatch):
    """The detection program on the forced path reads NCHW heads and
    gives the NCHW run's detections."""
    net = _net("yolov3_tiny")
    p, s = _seeded(net)
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = p, s
    sess.compile_net()
    x = np.random.RandomState(1).rand(2, 3, 64, 64).astype(np.float32)
    want = sess.detect_on_batch(x, 0.3, 30)
    monkeypatch.setattr(C, "channels_last_layout", lambda *a, **k: True)
    C.reset_layout_counts()
    got = sess.detect_on_batch(x, 0.3, 30)
    assert C.layout_counts()["executors"] == 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2.0**-6, atol=2.0**-6)


def test_layout_counts_reset():
    C._LAYOUT_COUNTS["nodes"] += 3
    C.reset_layout_counts()
    assert C.layout_counts() == dict.fromkeys(
        ("executors", "nodes", "to_channels_last", "to_nchw"), 0)


@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_upsample_keeps_channels_last(dtype, size):
    """A channels-last float x is upsampled in one pass into a
    channels-last output; an NCHW one stays NCHW; the values are
    `repeat_interleave`'s."""
    x = torch.randn(2, 8, 5, 7).to(dtype)
    want = x.repeat_interleave(size, 2).repeat_interleave(size, 3)
    y = ops.upsample_nn(x.contiguous(memory_format=CL), size)
    assert y.is_contiguous(memory_format=CL) and not y.is_contiguous()
    assert torch.equal(y, want)
    assert ops.upsample_nn(x, size).is_contiguous()


def test_bf16_conv_casts_channels_last():
    """`channels_last` casts x and the weight to bf16 channels-last (one
    pass each) and the conv writes channels-last, with the NCHW conv's
    values."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 12, 12, generator=g)
    w = torch.randn(16, 3, 3, 3, generator=g)
    want = ops.conv2d(x, w, 1, 1, 1, BF16, BF16)
    got = ops.conv2d(x, w, 1, 1, 1, BF16, BF16, channels_last=True)
    assert got.is_contiguous(memory_format=CL) and not got.is_contiguous()
    assert want.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-7,
                               atol=2.0**-7)
