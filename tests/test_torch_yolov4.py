"""Full YOLOv4 in the port (`models.yolov4`, read from the benchmark's
frozen `benchmark/configs/yolov4-608.cfg`) held to the benchmark's plain
reference (`benchmark/reference/yolov4.py`) on the CPU, and the pieces it
brought: Mish (`Activation.MISH`, the port's own), Darknet's centred
max-pool, the heads' `scale_x_y`, and the paths that raise on it.
Imports no JAX."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import yolov4 as ref
from bcnn_tpu_torch import Net, Session, config, ops
from bcnn_tpu_torch.compile import make_detect_fn
from bcnn_tpu_torch.graph import TensorKind
from bcnn_tpu_torch.models import yolov3_tiny, yolov4
from bcnn_tpu_torch.ops import bn_act, yolo
from bcnn_tpu_torch.ops.yolo_decode import decode_fused, decode_grid_ref
from bcnn_tpu_torch.types import Activation, LayerType, Mode

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "benchmark", "configs", "yolov4-608.cfg")
TINY_CFG = os.path.join(ROOT, "examples", "yolo", "yolov3-tiny.cfg")
SIZE, BATCH = 64, 2
# fp32: the port's convs and the reference's sum in their own orders
# through 110 convs (measured 2e-6 of the heads' norm)
FP32_TOL = 2e-5
# bf16: the port stores every layer's output in bf16 (a relative rounding
# of 2^-9 each) through 162 layers (measured 0.031-0.039)
BF16_TOL = 0.06


def test_the_cfg_builds_yolov4():
    net = yolov4(64, 608, 608, 80, Mode.PREDICT, cfg_path=CFG)
    types = [n.type for n in net.nodes]
    counts = {t: types.count(t) for t in set(types)}
    assert len(net.nodes) == 162
    assert counts == {LayerType.CONV2D: 110, LayerType.ELTWISE: 23,
                      LayerType.CONCAT: 21, LayerType.MAXPOOL: 3,
                      LayerType.UPSAMPLE: 2, LayerType.YOLOV3: 3}
    convs = [n.param for n in net.nodes if n.type == LayerType.CONV2D]
    acts = [p["activation"] for p in convs]
    assert acts[:72] == [Activation.MISH] * 72  # the backbone
    assert (acts.count(Activation.LRELU), acts.count(Activation.NONE)) \
        == (35, 3)
    assert all(p["batch_norm"] == (p["activation"] != Activation.NONE)
               for p in convs)
    heads = [n for n in net.nodes if n.type == LayerType.YOLOV3]
    assert [net.tensors[n.dst[0]].shape for n in heads] == [
        (64, 255, s, s) for s in (76, 38, 19)]
    assert [n.param["scale_x_y"] for n in heads] == [1.2, 1.1, 1.05]
    pools = [n.param for n in net.nodes if n.type == LayerType.MAXPOOL]
    assert [(p["size"], p["stride"], p["darknet_padding"]) for p in pools] \
        == [(5, 1, 4), (9, 1, 8), (13, 1, 12)]
    n_params = sum(int(np.prod(t.shape)) for t in net.tensors
                   if t.kind in (TensorKind.PARAM, TensorKind.STATE))
    assert abs(n_params / 64.4e6 - 1) < 0.001


def test_the_cfg_and_the_reference_agree_on_the_layers():
    layers = ref.build(CFG, 608)
    net = yolov4(1, 608, 608, 80, cfg_path=CFG)
    assert [(l.kind) for l in layers] == [
        {"CONV2D": "conv", "ELTWISE": "shortcut", "CONCAT": "route",
         "MAXPOOL": "maxpool", "UPSAMPLE": "upsample",
         "YOLOV3": "yolo"}[n.type.name] for n in net.nodes]
    assert [l.shape for l in layers] == [
        net.tensors[n.dst[0]].shape[1:] for n in net.nodes]
    ops_ = sum(ref.conv_ops(layers, i, 1) for i in ref.conv_layers(layers))
    assert abs(ops_ / 128.5e9 - 1) < 0.01  # the darknet README's BFLOPs


@pytest.fixture(scope="module")
def served():
    """The port at SIZE, batch BATCH, with the reference's seeded weights
    (as `benchmark/program.Served` loads them), and the reference's
    layers, weights and an input."""
    layers = ref.build(CFG, SIZE)
    weights = ref.make_weights(layers, 24, "cpu")
    net = yolov4(BATCH, SIZE, SIZE, 80, Mode.PREDICT, cfg_path=CFG)
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


def test_the_port_agrees_with_the_reference(served):
    net, sess, layers, weights, x, heads = served
    want = ref.forward(layers, weights, x)
    outs, _ = sess.predict_on_batch(x.numpy(), outputs=heads)
    assert max(_gaps(outs, want)) < FP32_TOL
    net.compute_dtype = net.act_dtype = torch.bfloat16
    try:
        outs, _ = sess.predict_on_batch(x.numpy(), outputs=heads)
    finally:
        net.compute_dtype = net.act_dtype = None
    assert all(o.dtype == torch.bfloat16 for o in outs)
    assert max(_gaps(outs, want)) < BF16_TOL


def test_detections_equal_the_references(served):
    """detect_on_batch against the reference's rule on the reference's
    heads: the same kept rows, their boxes, objectness and scores."""
    net, sess, layers, weights, x, heads = served
    params = [p for _, p in ref.heads(layers)]
    want = ref.detections(ref.forward(layers, weights, x), params, SIZE,
                          SIZE, 100, 0.5)
    got = sess.detect_on_batch(x.numpy(), thresh=0.5, max_dets=100)
    kept = want[2] > 0
    assert kept.sum() > 20 and torch.equal(got[2] > 0, kept)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def _brute_pool(x, size, stride, padding):
    """Darknet's forward_maxpool_layer, loop by loop."""
    n, c, h, w = x.shape
    oh = (h + padding - size) // stride + 1
    ow = (w + padding - size) // stride + 1
    off = -(padding // 2)
    out = torch.empty(n, c, oh, ow)
    for i in range(oh):
        for j in range(ow):
            best = torch.full((n, c), -float("inf"))
            for a in range(size):
                for b in range(size):
                    r, q = off + i * stride + a, off + j * stride + b
                    if 0 <= r < h and 0 <= q < w:
                        best = torch.maximum(best, x[:, :, r, q])
            out[:, :, i, j] = best
    return out


@pytest.mark.parametrize("size", [2, 5, 9, 13])
@pytest.mark.parametrize("stride", [1, 2])
def test_darknet_max_pool_equals_a_loop(size, stride):
    """The cfg's [maxpool] in the Darknet dialect (padding size - 1, the
    window from i*stride - padding/2) through the graph's shapes and the
    executor's op, on odd and even sizes, and the reference's pool."""
    x = torch.randn(2, 3, 11, 8, generator=torch.Generator().manual_seed(
        size * stride))
    net = Net(Mode.PREDICT)
    net.set_input_shape(8, 11, 3, 2)
    lp = config.LayerParam(size=size, stride=stride, src_id=["input"],
                           dst_id="p")
    config.add_layer(net, "[maxpool]", lp, fmt=1)
    (node,) = net.nodes
    d = net.tensors[node.dst[0]]
    want = _brute_pool(x, size, stride, size - 1)
    assert (d.h, d.w) == want.shape[2:]
    got = ops.maxpool(x, size, stride, d.h, d.w,
                      node.param.get("darknet_padding", 0) // 2)
    assert torch.equal(got, want)
    layer = ref.Layer("maxpool", {"size": str(size), "stride": str(stride)})
    assert torch.equal(ref._maxpool(x, layer), want)


def test_tiny_yolov3_pools_are_unchanged_in_the_darknet_dialect():
    """yolov3-tiny.cfg read in the Darknet dialect builds the size-2
    pools of the programmatic net (lid12: size 2, stride 1): the same
    params and shapes, no Darknet padding, the same values."""
    net = Net(Mode.PREDICT)
    sections = config.parse_ini(TINY_CFG)
    for k, v in sections[0].keys:
        config.net_set_param(net, k, v)
    net.set_input_shape(416, 416, 3, 1)
    config.add_sections(net, sections, fmt=1)
    tiny = yolov3_tiny(1, 416, 416, 80)
    pools = [(n.param, net.tensors[n.dst[0]].shape) for n in net.nodes
             if n.type == LayerType.MAXPOOL]
    assert pools == [(n.param, tiny.tensors[n.dst[0]].shape)
                     for n in tiny.nodes if n.type == LayerType.MAXPOOL]
    assert len(pools) == 6 and pools[-1][1] == (1, 512, 13, 13)
    x = torch.randn(1, 3, 13, 13)
    assert torch.equal(ops.maxpool(x, 2, 1, 13, 13),
                       _brute_pool(x, 2, 1, 1))


def _head_param(scale):
    return dict(num=3, classes=2, total=9, mask=[0, 1, 2],
                anchors=[12, 16, 19, 36, 40, 28, 36, 75, 76, 55, 72, 146,
                         142, 110, 192, 243, 459, 401],
                scale_x_y=scale)


def test_scale_x_y_in_the_decode_equals_the_hand_formula():
    """device_detect_topk's boxes on two heads scaled 1.2 and 1.05: x =
    (col + sigmoid(tx) * s - (s - 1) / 2) / W, likewise y, in float64;
    and the reference's decode of the same heads."""
    gen = torch.Generator().manual_seed(7)
    raws = [3 * torch.randn(1, 21, 4, 5, generator=gen),
            3 * torch.randn(1, 21, 2, 3, generator=gen)]
    for r in raws:  # every objectness kept, boxes too small to overlap
        r.view(1, 3, 7, -1)[:, :, 4] = 10.0
        r.view(1, 3, 7, -1)[:, :, 2:4] = -10.0
    params = [_head_param(1.2), dict(_head_param(1.05), mask=[3, 4, 5])]
    boxes, _, obj = yolo.device_detect_topk(raws, params, 64, 64,
                                            max_dets=200, thresh=0.5)
    hand = []
    for raw, p in zip(raws, params):
        _, _, h, w = raw.shape
        t = raw.double().reshape(3, 7, h, w).permute(2, 3, 0, 1)
        s = p["scale_x_y"]
        col = torch.arange(w, dtype=torch.float64).reshape(1, w, 1)
        row = torch.arange(h, dtype=torch.float64).reshape(h, 1, 1)
        bx = (col + torch.sigmoid(t[..., 0]) * s - (s - 1) / 2) / w
        by = (row + torch.sigmoid(t[..., 1]) * s - (s - 1) / 2) / h
        hand.append(torch.stack([bx, by], -1).reshape(-1, 2))
    hand = torch.cat(hand)
    # every candidate kept, in objectness order with ties by index: the
    # rows are the candidates in order (equal logits, no overlaps)
    assert int((obj > 0).sum()) == hand.shape[0] == 78
    torch.testing.assert_close(boxes[0, :78, :2].double(), hand,
                               rtol=0, atol=1e-6)
    rb, _, _ = ref.decode(raws, params, 64, 64)
    torch.testing.assert_close(rb[0, :, :2].double(), hand, rtol=0,
                               atol=1e-6)


def test_unscaled_paths_raise_on_scale_x_y():
    """K1, its plain version, the decode-everything detection and the
    training deltas have no scale_x_y: they raise. The host decode takes
    it (since YOLOv7's heads): x = (col + y * s - (s - 1) / 2) / W."""
    p = _head_param(1.1)
    raw = torch.randn(1, 21, 4, 4)
    with pytest.raises(ValueError, match="scale_x_y"):
        decode_fused(raw, p, 64, 64)
    with pytest.raises(ValueError, match="scale_x_y"):
        decode_grid_ref(raw, p, 64, 64)
    y = np.full((4, 4, 21), 0.25, np.float32)
    y[..., 4::7] = 0.9  # every objectness above the threshold
    dets = yolo.decode_layer(y, p, 64, 64, 0.5)
    assert len(dets) == 48
    for i, d in enumerate(dets):
        row, col = divmod(i // 3, 4)
        assert d["x"] == pytest.approx((col + 0.25 * 1.1 - 0.05) / 4)
        assert d["y"] == pytest.approx((row + 0.25 * 1.1 - 0.05) / 4)
    label = torch.zeros(1, 250)
    label[0, :5] = torch.tensor([0.5, 0.5, 0.2, 0.2, 1.0])
    with pytest.raises(ValueError, match="scale_x_y"):
        yolo.yolo_forward(raw, label, dict(p, net_w=64, net_h=64),
                          Mode.TRAIN)
    net = yolov4(1, SIZE, SIZE, 80, cfg_path=CFG)
    sess = Session(net, 0, device="cpu").compile_net()
    x = np.zeros((1, 3, SIZE, SIZE), np.float32)
    for use_pallas in (False, True):
        with pytest.raises(ValueError, match="scale_x_y"):
            make_detect_fn(net, 0.5, 100, use_pallas, topk_first=False)(
                sess.params, sess.state, {"input": torch.as_tensor(x)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mish_is_torchs_and_darknets(dtype):
    """MISH (bcnn_tpu has none) is F.mish, value and gradient, and
    Darknet's x * tanh(softplus(x)) with its softplus cut at 20."""
    x = torch.cat([torch.linspace(-40, 40, 801, dtype=dtype),
                   torch.tensor([-20.0, 20.0, 0.0, -0.0], dtype=dtype)])
    x.requires_grad_(True)
    y = ops.apply_activation(x, Activation.MISH)
    (g,) = torch.autograd.grad(y.sum(), x)
    x2 = x.detach().clone().requires_grad_(True)
    y2 = F.mish(x2)
    (g2,) = torch.autograd.grad(y2.sum(), x2)
    assert torch.equal(y, y2) and torch.equal(g, g2)
    x3 = x.detach().clone().requires_grad_(True)
    y3 = ref.mish(x3)
    (g3,) = torch.autograd.grad(y3.sum(), x3)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else {}
    torch.testing.assert_close(y, y3, **tol)
    torch.testing.assert_close(g, g3, **tol)


def test_mish_in_the_parser_and_in_k6():
    lp = config.LayerParam()
    for fmt in (0, 1):
        config.layer_param_set(lp, 3, "activation", "mish", fmt)
        assert lp.a == Activation.MISH
        config.layer_param_set(lp, 3, "activation", "logistic", fmt)
        assert lp.a == Activation.RELU  # any other unknown name, as bcnn
        config.layer_param_set(lp, 3, "scale_x_y", "1.05", fmt)
        assert lp.scale_x_y == 1.05
    x = 4 * torch.randn(2, 3, 5, 5, dtype=torch.bfloat16)
    assert bn_act.computes(x, Activation.MISH)
    assert not bn_act.takes(x, Activation.MISH)  # a CPU tensor
    vecs = (torch.rand(3) + 0.5, torch.randn(3), torch.randn(3),
            torch.rand(3) + 0.5)
    got = bn_act.bn_act(x, *vecs, False, Activation.MISH)
    want = F.mish(ops.batch_norm(x, *vecs, folded=False).float()).to(
        torch.bfloat16)
    assert torch.equal(got, want)
