"""The int8 program's channels-last flow on the CPU: every int8 activation
of YOLOv3-tiny's int8 program, of a Darknet cfg with two shortcuts (the
int8 eltwise add) and of MobileNet-v1's (K5's depthwise layers, the FC
on K4), is held channels-last (logical NCHW, NHWC in
memory), the layout K4 reads and writes, down to H = W = 1; the quant
weights are held (O, k, k, C) in memory from the start and the repack
round-trips; K4's plain path on channels-last
inputs equals the NCHW result bit for bit; the pass-through ops (maxpool,
upsample, concat) keep the layout with equal values; and no layout copy
runs on the path. Imports no JAX."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bcnn_tpu_torch import Net, Session, bridge, config, ops
from bcnn_tpu_torch.compile import execute
from bcnn_tpu_torch.models import mobilenet_v1, yolov3_tiny
from bcnn_tpu_torch.ops import conv_int8 as k4
from bcnn_tpu_torch.ops import grouped_int8 as k5
from bcnn_tpu_torch.ops import pool as pool_ops
from bcnn_tpu_torch.ops.quant import (ptq_synthetic, quantize_tensor,
                                      quantize_weights)
from bcnn_tpu_torch.types import Activation, Mode

torch.set_num_threads(1)

CL = torch.channels_last
aten = torch.ops.aten


def int8_cl(shape, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    return x.contiguous(memory_format=CL)


class LayoutCopies(TorchDispatchMode):
    """Records every copy of a 4-d tensor into the same dtype (clone,
    _to_copy, copy_): a change of layout, or a copy for nothing. Calls
    inside K4's and K5's wrappers are left out (on the CPU they run the
    plain versions; on the card one kernel each)."""

    COPIES = (aten.clone.default, aten._to_copy.default, aten.copy_.default)

    def __init__(self):
        super().__init__()
        self.copies, self.inside = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        src = args[0] if args else None
        if (not self.inside and func in self.COPIES
                and isinstance(src, torch.Tensor) and src.dim() == 4
                and isinstance(out, torch.Tensor) and out.dtype == src.dtype):
            self.copies.append((str(func), tuple(src.shape), src.stride(),
                                out.stride()))
        return out


@pytest.fixture(scope="module")
def int8_net():
    """YOLOv3-tiny at 64 px, batch 2, after ptq_synthetic on the CPU."""
    net = yolov3_tiny(2, 64, 64, 4)
    sess = Session(net, 0, device="cpu").compile_net()
    ptq_synthetic(net, sess)
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 3, 64, 64).astype(
        np.float32))
    return net, sess, x


def run(net, sess, x, bf16):
    net.compute_dtype = net.act_dtype = torch.bfloat16 if bf16 else None
    try:
        with torch.inference_mode():
            return execute(net, sess.params, sess.state, {"input": x},
                           Mode.PREDICT)
    finally:
        net.compute_dtype = net.act_dtype = None


def assert_int8_flow_channels_last(net, sess, x, bf16):
    ex = run(net, sess, x, bf16)
    int8 = {i: v for i, v in ex.values.items() if v.dtype == torch.int8}
    assert set(int8) == set(ex.int8_flow) and len(int8) >= 10
    for i, v in int8.items():
        assert v.dim() == 4 and not v.is_contiguous(), net.tensors[i].name
        assert v.is_contiguous(memory_format=CL), net.tensors[i].name
    # the heads leave K4 in fp32, NCHW, as their readers take them
    for node in net.nodes:
        if node.type.name == "YOLOV3":
            assert ex.values[node.src[0]].is_contiguous()
    return ex


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_every_int8_flow_tensor_is_channels_last(int8_net, bf16):
    assert_int8_flow_channels_last(*int8_net, bf16)


def assert_no_layout_copy(net, sess, x, bf16, monkeypatch):
    mode = LayoutCopies()
    fused, grouped = k4.conv_int8_fused, k5.grouped_int8_fused
    calls = {"K4": 0, "K5": 0}

    def counted(x, w, *args, **kw):
        # what the card takes: channels-last x and w, never a copy (an
        # FC's (N, K, 1, 1) view is both layouts at once)
        assert x.is_contiguous(memory_format=CL)
        assert not x.is_contiguous() or x.shape[2:] == (1, 1)
        assert w.is_contiguous(memory_format=CL)
        calls["K4"] += 1
        mode.inside += 1
        try:
            return fused(x, w, *args, **kw)
        finally:
            mode.inside -= 1

    def counted_k5(x, w, *args, **kw):
        # channels-last x and the (k, k, O, C/G) weight, as made once
        assert x.is_contiguous(memory_format=CL) and not x.is_contiguous()
        assert k5.is_grouped_weight(w)
        calls["K5"] += 1
        mode.inside += 1
        try:
            return grouped(x, w, *args, **kw)
        finally:
            mode.inside -= 1

    monkeypatch.setattr(k4, "conv_int8_fused", counted)
    monkeypatch.setattr(k5, "grouped_int8_fused", counted_k5)
    with mode:
        run(net, sess, x, bf16)
    assert mode.copies == []
    return calls


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_no_layout_copy_on_the_int8_path(int8_net, bf16, monkeypatch):
    """A request copies no 4-d tensor into its own dtype outside K4, and
    every K4 call gets the channels-last x and w the card takes: the
    input is quantized straight into channels-last, every pass-through
    keeps it, and the quant weights are held so from the start."""
    assert_no_layout_copy(*int8_net, bf16, monkeypatch)


# a Darknet cfg with two shortcuts ([shortcut], the eltwise add), two
# stride-2 convs, a route, an upsample and two heads (2 classes)
SHORTCUT_CFG = """[net]
width=64
height=64
channels=3
batch=2

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-3
activation=linear

[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=32
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-3
activation=linear

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask = 3,4,5
anchors = 10,14,  23,27,  37,58,  81,82,  135,169,  344,319
classes=2
num=6

[route]
layers = -3

[convolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers = -1, 4

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[convolutional]
size=1
stride=1
pad=1
filters=21
activation=linear

[yolo]
mask = 0,1,2
anchors = 10,14,  23,27,  37,58,  81,82,  135,169,  344,319
classes=2
num=6
"""


def darknet_parse(pkg_config, net, path):
    """parse_ini + add_layer in the Darknet dialect (fmt 1), the loop of
    `load_net` for a .weights model, with `pkg_config` the config module
    of either package."""
    sections = pkg_config.parse_ini(path)
    for k, v in sections[0].keys:
        pkg_config.net_set_param(net, k, v)
    for i in range(1, len(sections)):
        lp = pkg_config.LayerParam()
        for k, v in sections[i].keys:
            pkg_config.layer_param_set(lp, i, k, v, 1)
        if lp.src_id is None:
            lp.src_id = [f"lid{i - 1}"]
        if lp.dst_id is None:
            lp.dst_id = f"lid{i}"
        pkg_config.add_layer(net, sections[i].name, lp)
    return net


def shortcut_net(path, mode=Mode.PREDICT):
    """SHORTCUT_CFG written to `path` and built by the port."""
    path.write_text(SHORTCUT_CFG)
    return darknet_parse(config, Net(mode), str(path))


@pytest.fixture(scope="module")
def shortcut_int8(tmp_path_factory):
    """SHORTCUT_CFG at 64 px, batch 2, He-scaled weights, after
    ptq_synthetic on the CPU."""
    net = shortcut_net(tmp_path_factory.mktemp("cfg") / "shortcut.cfg")
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 3, residual_scale=0.5))
    sess.compile_net()
    ptq_synthetic(net, sess)
    x = torch.from_numpy(np.random.RandomState(4).rand(2, 3, 64, 64).astype(
        np.float32))
    return net, sess, x


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_shortcut_int8_flow_is_channels_last(shortcut_int8, bf16):
    """Both shortcuts add two channels-last int8 tensors and write one,
    which feeds a conv and the next shortcut or the route."""
    net = shortcut_int8[0]
    ex = assert_int8_flow_channels_last(*shortcut_int8, bf16)
    adds = [n for n in net.nodes if n.type.name == "ELTWISE"]
    assert len(adds) == 2
    for node in adds:
        for i in node.src + node.dst:
            assert ex.values[i].dtype == torch.int8, net.tensors[i].name


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_no_layout_copy_on_the_shortcut_int8_path(shortcut_int8, bf16,
                                                  monkeypatch):
    assert_no_layout_copy(*shortcut_int8, bf16, monkeypatch)


@pytest.fixture(scope="module")
def mobilenet_int8():
    """MobileNet-v1 at width 0.25, 224 px, batch 2, He-scaled weights,
    after ptq_synthetic on the CPU."""
    net = mobilenet_v1(2, 10, width_mult=0.25)
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 5))
    sess.compile_net()
    ptq_synthetic(net, sess)
    x = torch.from_numpy(np.random.RandomState(6).rand(
        2, 3, 224, 224).astype(np.float32))
    return net, sess, x


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_no_layout_copy_on_the_mobilenet_int8_path(mobilenet_int8, bf16,
                                                   monkeypatch):
    """MobileNet-v1's int8 request: every int8 tensor channels-last, the
    13 depthwise layers on K5 with the weight in its layout since the
    quant dict was made, the 14 convs and the FC on K4 (the FC over a
    view of the pooled x), and no layout copy anywhere. The plan routes
    the average pool's output as int8 for the FC, but the pool writes
    fp32, as in bcnn_tpu, and the FC quantizes it."""
    net = mobilenet_int8[0]
    ex = run(*mobilenet_int8, bf16)
    pooled = {n.dst[0] for n in net.nodes if n.type.name == "AVGPOOL"}
    int8 = {i for i, v in ex.values.items() if v.dtype == torch.int8}
    assert int8 == set(ex.int8_flow) - pooled and len(int8) == 26
    for i in int8:
        v = ex.values[i]
        assert v.is_contiguous(memory_format=CL) and not v.is_contiguous()
    calls = assert_no_layout_copy(*mobilenet_int8, bf16, monkeypatch)
    assert calls == {"K4": 15, "K5": 13}


def test_strided_int8_add_keeps_channels_last():
    """The stride-broadcast path (unequal shapes) adds into a copy of x0
    and keeps its layout."""
    a, b = int8_cl((2, 8, 4, 4), 1), int8_cl((2, 4, 8, 8), 2)
    y = ops.eltwise_add(a.to(torch.int32), b.to(torch.int32), (1, 2),
                        (4, 4, 4))
    assert y.is_contiguous(memory_format=CL) and y.dtype == torch.int32
    want = a.to(torch.int32).contiguous()
    want[:, :4] += b.to(torch.int32)[:, :, ::2, ::2]
    assert torch.equal(y, want)


def test_weight_repack_round_trips_and_is_made_once():
    gen = torch.Generator().manual_seed(0)
    w = torch.randint(-127, 128, (8, 16, 3, 3), generator=gen,
                      dtype=torch.int8)
    cl = k4.channels_last_weight(w)
    assert k4.channels_last_weight(cl) is cl  # held so: no second copy
    assert cl.is_contiguous(memory_format=CL) and torch.equal(cl, w)
    # in memory: (O, k, k, C), k in (r, s, c) order
    mem = torch.as_strided(cl, (cl.numel(),), (1,))
    assert torch.equal(mem, w.permute(0, 2, 3, 1).reshape(-1))
    assert torch.equal(cl.contiguous(), w)  # and back
    one = torch.randint(-127, 128, (8, 16, 1, 1), dtype=torch.int8)
    assert k4.channels_last_weight(one) is one  # 1x1: already (O, 1, 1, C)


@pytest.mark.parametrize("shape", [
    (2, 3, 11, 9, 16, 3, 1, 1),     # lid1's C = 3
    (1, 16, 8, 8, 24, 3, 2, 1),     # stride 2
    (2, 32, 5, 7, 255, 1, 1, 0),    # a head, fp32 out
    (1, 48, 6, 6, 40, 3, 1, 0),     # pad 0, K % 32 = 16
])
def test_k4_plain_path_on_channels_last_equals_nchw(shape):
    """K4's CPU path on the channels-last x and the repacked weight
    equals the plain version on the NCHW tensors, bit for bit, in
    the int8 and the fp32 form."""
    n, c, h, w, o, k, stride, pad = shape
    gen = torch.Generator().manual_seed(c * o)
    x = torch.randint(-127, 128, (n, c, h, w), generator=gen,
                      dtype=torch.int8)
    wt = torch.randint(-127, 128, (o, c, k, k), generator=gen,
                       dtype=torch.int8)
    d = torch.rand(o, generator=gen) * 1e-3
    b = torch.randn(o, generator=gen)
    bn = dict(scale=torch.rand(o, generator=gen) + 0.5,
              mean=torch.randn(o, generator=gen) * 0.1,
              inv=torch.rand(o, generator=gen) + 0.5)
    xc, wc = x.contiguous(memory_format=CL), k4.channels_last_weight(wt)
    for kw in (dict(act=Activation.LRELU, s_out=0.05, **bn),
               dict(act=Activation.NONE)):
        want = k4.conv_int8_fused_ref(x, wt, d, b, stride, pad, **kw)
        got = k4.conv_int8_fused(xc, wc, d, b, stride, pad, **kw)
        assert torch.equal(got, want)
        assert got.is_contiguous(
            memory_format=CL if "s_out" in kw else torch.contiguous_format)


PASS_THROUGH = {
    "maxpool_2s2": lambda x: pool_ops.maxpool(x, 2, 2, 7, 7),
    "maxpool_2s1_pad": lambda x: pool_ops.maxpool(x, 2, 1, 13, 13),
    "upsample_2": lambda x: ops.upsample_nn(x, 2),
    "upsample_3": lambda x: ops.upsample_nn(x, 3),
    "upsample_2_from_1x1": lambda x: ops.upsample_nn(
        x[:, :, :1, :1].contiguous(), 2),  # NCHW and NHWC strides both
    "concat_two": lambda x: ops.concat_channels([x, x[:, :5]]),
    "concat_one": lambda x: ops.concat_channels([x]),
}


@pytest.mark.parametrize("name", sorted(PASS_THROUGH))
def test_pass_through_ops_keep_channels_last(name):
    x = int8_cl((2, 16, 13, 13), 7)
    got = PASS_THROUGH[name](x)
    want = PASS_THROUGH[name](x.contiguous())  # the NCHW tensor
    assert got.dtype == torch.int8
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(got, want)


def test_upsample_keeps_nchw_on_the_float_paths():
    """The fp32 and bf16 paths stay NCHW: upsample of an NCHW tensor is
    the NCHW repeat it was."""
    x = torch.randn(2, 5, 4, 3)
    y = ops.upsample_nn(x, 2)
    assert y.is_contiguous()
    assert torch.equal(y, x.repeat_interleave(2, 2).repeat_interleave(2, 3))


def test_quantize_writes_the_requested_layout():
    """quantize_tensor writes a 4-d tensor channels-last, whatever x's
    layout, with the values of the NCHW quantize; other ranks as they
    are."""
    x = torch.randn(2, 8, 5, 6)
    q = quantize_tensor(x, 0.02)
    assert q.is_contiguous(memory_format=CL) and not q.is_contiguous()
    want = torch.clamp(torch.round(x / 0.02), -127, 127).to(torch.int8)
    assert torch.equal(q, want)
    assert torch.equal(quantize_tensor(x.contiguous(memory_format=CL), 0.02),
                       want)
    v = torch.randn(3, 7)
    assert quantize_tensor(v, 0.02).is_contiguous()


def test_quant_weights_are_held_channels_last():
    """quantize_weights and quant_from_numpy hold a conv's q (O, C, k, k)
    channels-last, (O, k, k, C) in memory, with the OIHW values: K4 reads
    it as it is, and no request repacks."""
    net = yolov3_tiny(1, 32, 32, 4)
    sess = Session(net, 0, device="cpu").compile_net()
    quant = quantize_weights(net, sess.params)
    assert len(quant) == 13
    for key, e in quant.items():
        q = e["q"]
        assert q.is_contiguous(memory_format=CL), key
        assert k4.channels_last_weight(q) is q
    rng = np.random.RandomState(0)
    hwio = {k: rng.randint(-127, 128, tuple(e["q"].permute(2, 3, 1, 0).shape)
                           ).astype(np.int8) for k, e in quant.items()}
    port = bridge.quant_from_numpy(net, {
        "act_scales": {}, "weights": {
            k: {"q": q, "scale": np.ones(q.shape[-1], np.float32)}
            for k, q in hwio.items()}})
    for key, q in hwio.items():
        got = port["weights"][key]["q"]
        assert got.is_contiguous(memory_format=CL), key
        np.testing.assert_array_equal(got.numpy(), q.transpose(3, 2, 0, 1))


def test_int8_flow_stays_channels_last_down_to_one_pixel():
    """At 32 px the 13x13 route of 416 px is 1 x 1, where NCHW and NHWC
    strides both hold: the upsample after it still writes channels-last,
    so the concat and the conv after them get what the card takes."""
    net = yolov3_tiny(2, 32, 32, 4)
    sess = Session(net, 0, device="cpu").compile_net()
    ptq_synthetic(net, sess)
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 3, 32, 32).astype(
        np.float32))
    ex = run(net, sess, x, True)
    int8 = {i: v for i, v in ex.values.items() if v.dtype == torch.int8}
    assert set(int8) == set(ex.int8_flow) and len(int8) >= 10
    assert any(v.shape[2:] == (1, 1) for v in int8.values())
    for i, v in int8.items():
        assert v.is_contiguous(memory_format=CL), net.tensors[i].name
        assert 0 not in v.stride(), net.tensors[i].name
