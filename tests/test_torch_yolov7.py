"""YOLOv7 in the port (`models.yolov7`, read from the benchmark's frozen
`benchmark/configs/yolov7-640.cfg`) held to the benchmark's plain
reference (`benchmark/reference/yolov7.py`) on the CPU, and the pieces it
brought: Swish (`Activation.SWISH`, the port's own), the heads'
`new_coords`, the head conv's logistic that a new_coords head takes, and
the paths that raise on new_coords. Imports no JAX."""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import check
from benchmark.reference import yolov7 as ref
from bcnn_tpu_torch import Net, Session, config, ops
from bcnn_tpu_torch.compile import _int8_mish, make_detect_fn
from bcnn_tpu_torch.graph import TensorKind
from bcnn_tpu_torch.models import yolov3, yolov4, yolov7
from bcnn_tpu_torch.ops import bn_act, yolo
from bcnn_tpu_torch.ops.yolo_decode import decode_fused, decode_grid_ref
from bcnn_tpu_torch.types import Activation, LayerType, Mode

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "benchmark", "configs")
CFG = os.path.join(CONFIGS, "yolov7-640.cfg")
CELL = os.path.join(ROOT, "benchmark", "workloads",
                    "yolov7-640.detect-bf16.b64.json")
SIZE, BATCH = 64, 2
# fp32: the port's convs and the reference's sum in their own orders
# through 92 convs (measured 1.4e-6 of the heads' norm)
FP32_TOL = 2e-5
# bf16: the port stores every layer's output in bf16 (a relative rounding
# of 2^-9 each) through 143 layers, each swish layer growing a
# perturbation a little (`ref.make_weights`); measured 0.019 here, 0.017-
# 0.025 on other seeds at 64 and 96 px
BF16_TOL = 0.05
# fp32 detections: the same kept rows; boxes, objectness and scores from
# heads 1.4e-6 apart (measured: boxes within 5.3e-5, each within 1e-4 of
# itself; objectness and scores within 2.7e-6)
DET_TOL = dict(rtol=1e-4, atol=1e-5)


def test_the_cfg_builds_yolov7():
    net = yolov7(64, 640, 640, 80, Mode.PREDICT, cfg_path=CFG)
    types = [n.type for n in net.nodes]
    counts = {t: types.count(t) for t in set(types)}
    assert len(net.nodes) == 143
    assert counts == {LayerType.CONV2D: 92, LayerType.CONCAT: 38,
                      LayerType.MAXPOOL: 8, LayerType.UPSAMPLE: 2,
                      LayerType.YOLOV3: 3}
    convs = [n.param for n in net.nodes if n.type == LayerType.CONV2D]
    acts = [p["activation"] for p in convs]
    assert (acts.count(Activation.SWISH), acts.count(Activation.NONE)) \
        == (89, 3)
    assert all(p["batch_norm"] == (p["activation"] == Activation.SWISH)
               for p in convs)
    routes = [len(n.src) for n in net.nodes if n.type == LayerType.CONCAT]
    assert sorted(routes) == [1] * 21 + [2] * 6 + [3] * 2 + [4] * 5 \
        + [6] * 4
    heads = [n for n in net.nodes if n.type == LayerType.YOLOV3]
    assert [net.tensors[n.dst[0]].shape for n in heads] == [
        (64, 255, s, s) for s in (80, 40, 20)]
    assert [(n.param["scale_x_y"], n.param["new_coords"]) for n in heads] \
        == [(2.0, 1)] * 3
    assert [n.param["mask"] for n in heads] == [[0, 1, 2], [3, 4, 5],
                                                [6, 7, 8]]
    pools = [n.param for n in net.nodes if n.type == LayerType.MAXPOOL]
    assert [(p["size"], p["stride"], p.get("darknet_padding"))
            for p in pools] == [(2, 2, None)] * 3 + [
        (5, 1, 4), (9, 1, 8), (13, 1, 12)] + [(2, 2, None)] * 2
    n_params = sum(int(np.prod(t.shape)) for t in net.tensors
                   if t.kind == TensorKind.PARAM)
    assert abs(n_params / 36.93e6 - 1) < 0.0005


def test_the_cfg_and_the_reference_agree_on_the_layers():
    layers = ref.build(CFG, 640)
    net = yolov7(1, 640, 640, 80, cfg_path=CFG)
    assert [(l.kind) for l in layers] == [
        {"CONV2D": "conv", "CONCAT": "route", "MAXPOOL": "maxpool",
         "UPSAMPLE": "upsample", "YOLOV3": "yolo"}[n.type.name]
        for n in net.nodes]
    assert [l.shape for l in layers] == [
        net.tensors[n.dst[0]].shape[1:] for n in net.nodes]
    data = lambda n: n.src[:1] if n.type == LayerType.CONV2D else n.src  # noqa: E731
    assert [[net.tensors[s].name for s in data(n)] for n in net.nodes] == [
        [f"lid{s + 1}" if s >= 0 else "input" for s in l.srcs]
        for l in layers]
    ops_ = sum(ref.conv_ops(layers, i, 1) for i in ref.conv_layers(layers))
    assert abs(ops_ / 104.5e9 - 1) < 0.001  # the paper's 104.7 G


@pytest.fixture(scope="module")
def served():
    """The port at SIZE, batch BATCH, with the reference's seeded weights
    (as `benchmark/program.Served` loads them), and the reference's
    layers, weights and an input."""
    layers = ref.build(CFG, SIZE)
    weights = ref.make_weights(layers, 24, "cpu")
    net = yolov7(BATCH, SIZE, SIZE, 80, Mode.PREDICT, cfg_path=CFG)
    sess = Session(net, 0, device="cpu").compile_net()
    convs = [n for n in net.nodes if n.type == LayerType.CONV2D]
    key = lambda n, i: net.tensors[n.src[i]].key  # noqa: E731
    for node, wt in zip(convs, weights):
        sess.params[key(node, 1)] = wt["w"].clone()
        if node.param.get("batch_norm"):
            sess.params[key(node, 2)] = wt["shift"].clone()
            sess.state[key(node, 3)] = wt["mean"].clone()
            sess.state[key(node, 4)] = wt["var"].clone()
            sess.params[key(node, 5)] = wt["scale"].clone()
        else:
            sess.params[key(node, 2)] = wt["bias"].clone()
    x = torch.rand(BATCH, 3, SIZE, SIZE,
                   generator=torch.Generator().manual_seed(4))
    heads = [net.tensors[n.src[0]].name for n in net.nodes
             if n.type == LayerType.YOLOV3]
    yield net, sess, layers, weights, x, heads
    net.compute_dtype = net.act_dtype = None


def _gaps(outs, want):
    return [float((o.float() - r).norm() / r.norm())
            for o, r in zip(outs, want)]


def _bf16(net):
    net.compute_dtype = net.act_dtype = torch.bfloat16


def test_the_port_agrees_with_the_reference(served):
    net, sess, layers, weights, x, heads = served
    want = ref.forward(layers, weights, x)
    outs, _ = sess.predict_on_batch(x.numpy(), outputs=heads)
    assert max(_gaps(outs, want)) < FP32_TOL
    _bf16(net)
    try:
        outs, _ = sess.predict_on_batch(x.numpy(), outputs=heads)
    finally:
        net.compute_dtype = net.act_dtype = None
    assert all(o.dtype == torch.bfloat16 for o in outs)
    assert max(_gaps(outs, want)) < BF16_TOL


def test_detections_equal_the_references(served):
    """detect_on_batch in fp32 against the reference's rule on the
    reference's heads: the same kept rows, their boxes, objectness and
    scores."""
    net, sess, layers, weights, x, heads = served
    params = [p for _, p in ref.heads(layers)]
    want = ref.detections(ref.forward(layers, weights, x), params, SIZE,
                          SIZE, 100, 0.5)
    got = sess.detect_on_batch(x.numpy(), thresh=0.5, max_dets=100)
    kept = want[2] > 0
    assert kept.sum() > 20 and torch.equal(got[2] > 0, kept)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **DET_TOL)


def test_bf16_detections_pass_the_cells_check(served):
    """detect_on_batch in bf16 against the reference's decode of the
    program's own bf16 heads, as the cell's check judges a request: the
    kept rows within the cell's `dets` limit, no choice the rule does
    not allow within the cell's margins."""
    net, sess, layers, weights, x, heads = served
    cell = json.loads(open(CELL).read())
    params = [p for _, p in ref.heads(layers)]
    _bf16(net)
    try:
        got = sess.detect_on_batch(x.numpy(), thresh=0.5, max_dets=100)
        outs, _ = sess.predict_on_batch(x.numpy(), outputs=heads)
    finally:
        net.compute_dtype = net.act_dtype = None
    assert int((got[2] > 0).sum()) > 20
    gap, faults = check.det_numbers(
        ref, got, [o.float() for o in outs], params, SIZE, SIZE, 100, 0.5,
        cell["check"]["margins"])
    assert gap <= cell["check"]["limits"]["dets"] and faults == 0


def _head_param(**kw):
    return dict(dict(num=3, classes=2, total=9, mask=[0, 1, 2],
                     anchors=[12, 16, 19, 36, 40, 28, 36, 75, 76, 55, 72,
                              146, 142, 110, 192, 243, 459, 401],
                     scale_x_y=2.0, new_coords=1), **kw)


def test_new_coords_decode_equals_the_hand_formula():
    """device_detect_topk, the host decode and the reference's decode on
    two new_coords heads: x = (col + 2 sigmoid(tx) - 0.5) / W, likewise
    y, w = 4 sigmoid(tw)^2 anchor_w / net_w, likewise h, in float64; and
    the node's output, the logistic of every channel."""
    gen = torch.Generator().manual_seed(7)
    raws = [3 * torch.randn(1, 21, 4, 5, generator=gen),
            3 * torch.randn(1, 21, 2, 3, generator=gen)]
    for r in raws:  # every objectness kept, boxes too small to overlap
        r.view(1, 3, 7, -1)[:, :, 4] = 10.0
        r.view(1, 3, 7, -1)[:, :, 2:4] = -6.0 + r.view(1, 3, 7, -1)[
            :, :, 2:4] / 3
    params = [_head_param(), _head_param(mask=[3, 4, 5])]
    boxes, _, obj = yolo.device_detect_topk(raws, params, 64, 48,
                                            max_dets=200, thresh=0.5)
    hand, host = [], []
    for raw, p in zip(raws, params):
        _, _, h, w = raw.shape
        t = raw.double().reshape(3, 7, h, w).permute(2, 3, 0, 1)
        col = torch.arange(w, dtype=torch.float64).reshape(1, w, 1)
        row = torch.arange(h, dtype=torch.float64).reshape(h, 1, 1)
        aw = torch.tensor([p["anchors"][2 * m] for m in p["mask"]],
                          dtype=torch.float64)
        ah = torch.tensor([p["anchors"][2 * m + 1] for m in p["mask"]],
                          dtype=torch.float64)
        s = torch.sigmoid(t)
        hand.append(torch.stack([
            (col + 2 * s[..., 0] - 0.5) / w, (row + 2 * s[..., 1] - 0.5) / h,
            4 * s[..., 2] ** 2 * aw / 64, 4 * s[..., 3] ** 2 * ah / 48,
        ], -1).reshape(-1, 4))
        y, _ = yolo.yolo_forward(raw, None, p, Mode.PREDICT)
        assert torch.equal(y, torch.sigmoid(raw))
        host += yolo.decode_layer(y[0].permute(1, 2, 0).numpy(), p, 64, 48,
                                  0.5)
    hand = torch.cat(hand)
    # every candidate kept, in objectness order with ties by index: the
    # rows are the candidates in order (equal logits, no overlaps)
    assert int((obj > 0).sum()) == hand.shape[0] == len(host) == 78
    torch.testing.assert_close(boxes[0, :78].double(), hand, rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(
        torch.tensor([[d[k] for k in "xywh"] for d in host],
                     dtype=torch.float64), hand, rtol=1e-6, atol=1e-7)
    rb, _, _ = ref.decode(raws, params, 64, 48)
    torch.testing.assert_close(rb[0].double(), hand, rtol=1e-6, atol=1e-7)


def test_heads_that_mix_new_coords_raise():
    raw = torch.randn(1, 21, 2, 2)
    with pytest.raises(ValueError, match="new_coords"):
        yolo.device_detect_topk([raw, raw], [_head_param(), _head_param(
            new_coords=0)], 64, 64)


def test_paths_without_new_coords_raise():
    """K1, its plain version, the decode-everything detection and the
    training deltas have no new_coords: they raise."""
    p = _head_param(scale_x_y=1.0)
    raw = torch.randn(1, 21, 4, 4)
    with pytest.raises(ValueError, match="new_coords"):
        decode_fused(raw, p, 64, 64)
    with pytest.raises(ValueError, match="new_coords"):
        decode_grid_ref(raw, p, 64, 64)
    label = torch.zeros(1, 250)
    label[0, :5] = torch.tensor([0.5, 0.5, 0.2, 0.2, 1.0])
    with pytest.raises(ValueError, match="new_coords"):
        yolo.yolo_forward(raw, label, dict(p, net_w=64, net_h=64),
                          Mode.TRAIN)
    net = yolov7(1, SIZE, SIZE, 80, cfg_path=CFG)
    sess = Session(net, 0, device="cpu").compile_net()
    x = torch.zeros(1, 3, SIZE, SIZE)
    for use_pallas in (False, True):
        with pytest.raises(ValueError, match="scale_x_y"):
            make_detect_fn(net, 0.5, 100, use_pallas, topk_first=False)(
                sess.params, sess.state, {"input": x})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_swish_is_torchs_and_darknets(dtype):
    """SWISH (bcnn_tpu has none) is F.silu, value and gradient, and
    Darknet's x * logistic(x)."""
    x = torch.cat([torch.linspace(-90, 90, 1801, dtype=dtype),
                   torch.tensor([0.0, -0.0, 1e-30], dtype=dtype)])
    x.requires_grad_(True)
    y = ops.apply_activation(x, Activation.SWISH)
    (g,) = torch.autograd.grad(y.sum(), x)
    x2 = x.detach().clone().requires_grad_(True)
    y2 = F.silu(x2)
    (g2,) = torch.autograd.grad(y2.sum(), x2)
    assert torch.equal(y, y2) and torch.equal(g, g2)
    x3 = x.detach().clone().requires_grad_(True)
    y3 = ref.swish(x3)
    (g3,) = torch.autograd.grad(y3.sum(), x3)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else {}
    torch.testing.assert_close(y, y3, **tol)
    torch.testing.assert_close(g, g3, **tol)


def test_swish_in_the_parser_and_in_k6():
    """`swish` and `new_coords` parse in both dialects; K6 computes BN
    and SWISH, on the CPU as the plain ops; int8 serving's guard lets a
    CPU tensor through (it raises on the card)."""
    lp = config.LayerParam()
    for fmt in (0, 1):
        config.layer_param_set(lp, 3, "activation", "swish", fmt)
        assert lp.a == Activation.SWISH
        config.layer_param_set(lp, 3, "new_coords", "1", fmt)
        assert lp.new_coords == 1
    x = 4 * torch.randn(2, 16, 5, 5, dtype=torch.bfloat16)
    assert bn_act.computes(x, Activation.SWISH)
    assert not bn_act.takes(x, Activation.SWISH)  # a CPU tensor
    vecs = (torch.rand(16) + 0.5, torch.randn(16), torch.randn(16),
            torch.rand(16) + 0.5)
    for xs in (x, x.contiguous(memory_format=torch.channels_last)):
        got = bn_act.bn_act(xs, *vecs, False, Activation.SWISH)
        want = F.silu(ops.batch_norm(xs, *vecs, folded=False).float()).to(
            torch.bfloat16)
        assert torch.equal(got, want) and got.stride() == xs.stride()
    _int8_mish(Activation.SWISH, x)


def _cfg(tmp_path, act, new_coords):
    text = ("[net]\nwidth=32\nheight=32\nchannels=3\n"
            "[convolutional]\nfilters=21\nsize=1\nstride=1\npad=1\n"
            f"activation={act}\n"
            "[yolo]\nmask=0,1,2\nanchors=1,2,3,4,5,6\nclasses=2\nnum=3\n"
            + (f"new_coords={new_coords}\n" if new_coords is not None
               else ""))
    path = tmp_path / "t.cfg"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("act, new_coords, want", [
    ("logistic", 1, Activation.NONE),    # the head takes the logistic
    ("logistic", 0, Activation.RELU),    # bcnn's fallback, as before
    ("logistic", None, Activation.RELU),
    ("linear", 1, Activation.NONE),
    ("swish", 1, Activation.SWISH),
])
def test_a_new_coords_head_takes_its_convs_logistic(tmp_path, act,
                                                    new_coords, want):
    """The Darknet loader builds a `logistic` conv linear only where a
    [yolo] with new_coords=1 follows it; anywhere else `logistic` keeps
    the reference's fallback to RELU."""
    sections = config.parse_ini(_cfg(tmp_path, act, new_coords))
    net = Net(Mode.PREDICT)
    for k, v in sections[0].keys:
        config.net_set_param(net, k, v)
    net.set_input_shape(32, 32, 3, 1)
    config.add_sections(net, sections, fmt=1)
    conv, head = net.nodes
    assert conv.param["activation"] == want
    assert bool(head.param.get("new_coords")) == bool(new_coords)


@pytest.mark.parametrize("name", ["yolov3-416", "yolov4-608", "yolov7-640"])
def test_no_activation_of_the_frozen_cfgs_falls_back_to_relu(name):
    """Every `activation=` of the benchmark's three cfgs is a name the
    parser knows, except a head conv's `logistic` that a new_coords head
    takes; the built nets hold no RELU conv."""
    path = os.path.join(CONFIGS, f"{name}.cfg")
    sections = config.parse_ini(path)
    for i, sec in enumerate(sections):
        act = dict(sec.keys).get("activation")
        if act is not None:
            assert (act in config._ACTIVATIONS
                    or config._head_takes_logistic(sections, i)), (i, act)
    build = {"yolov3-416": yolov3, "yolov4-608": yolov4,
             "yolov7-640": yolov7}[name]
    net = build(1, 64, 64, 80, Mode.PREDICT, cfg_path=path)
    assert Activation.RELU not in [n.param["activation"] for n in net.nodes
                                   if n.type == LayerType.CONV2D]
