"""The band plan of the port's spatial parallelism
(`bcnn_tpu_torch.parallel.model_axis.plan_bands`) and each band layer's
rows, held to a one-device run of the same layers on the CPU.

For each net, height and count of model ranks D: the plan cuts every
band tensor into D non-empty contiguous bands in rank order, and at
YOLOv3-tiny's 416 px on 2 ranks it cuts at multiples of the net's
stride (13 rows as 7 + 6, the input as 224 + 192), so that no stride-2
pool needs a halo. Then every band node of the net is run on each
rank's rows as the spatial executor runs it (its conv, depthwise and
deconv windows with their halos and crops, the max-pool and upsample
windows), its input rows read from the one-device run's whole tensors
in place of the other ranks, and its output held to that run's rows of
the node's output: fp32 within rtol 1e-5 (atol 1e-6; a conv's sum over
fewer input rows may take another order), the int8 flow bit for bit.
The YOLO layer's deltas of a band of grid rows are the whole head's
rows, bit for bit. No JAX here: the one-device run is the port's,
which the other tests hold to bcnn_tpu.
"""

import numpy as np
import pytest
import torch

from bcnn_tpu_torch import Mode, bridge
from bcnn_tpu_torch.compile import _data_srcs, _Executor, execute
from bcnn_tpu_torch.graph import Net
from bcnn_tpu_torch.models import (cifar10_convnet, lenet_mnist,
                                   mobilenet_v1, yolov3_tiny)
from bcnn_tpu_torch.ops import quant, yolo
from bcnn_tpu_torch.parallel import model_axis as ma
from bcnn_tpu_torch.types import Activation, FillerType, LayerType, Padding

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def deconv_net(h=24):
    """A conv of stride 2, a deconv (k 4, s 2, p 1), dropout, a max pool of
    size 3 and stride 2, the size-2 stride-1 pool and an upsample: the
    layers YOLOv3-tiny, LeNet and MobileNet do not have."""
    A = Activation
    net = Net(Mode.PREDICT)
    net.set_input_shape(h, h, 3, 2)
    net.add_convolutional_layer(8, 3, 2, 1, 1, 0, FillerType.XAVIER, A.RELU,
                                0, "input", "c1")
    net.add_deconvolutional_layer(6, 4, 2, 1, FillerType.XAVIER, A.LRELU,
                                  "c1", "d1")
    net.add_dropout_layer(0.2, "d1")
    net.add_maxpool_layer(3, 2, Padding.SAME, "d1", "p1")
    net.add_maxpool_layer(2, 1, Padding.SAME, "p1", "p2")
    net.add_upsample_layer(2, "p2", "u1")
    net.add_convolutional_layer(4, 3, 1, 1, 1, 0, FillerType.XAVIER,
                                A.LRELU, 0, "u1", "c2")
    return net


def build(name):
    if name == "lenet":
        return lenet_mnist(2, mode=Mode.PREDICT)
    if name == "cifar":
        return cifar10_convnet(batch_size=2, mode=Mode.PREDICT)
    if name.startswith("tiny"):
        size = int(name[4:].split("_")[0])
        return yolov3_tiny(1 if size > 96 else 2, size, size, 4,
                           mode=Mode.PREDICT)
    if name == "mobilenet":
        net = mobilenet_v1(2, 10, Mode.PREDICT, width_mult=0.25)
        net.resize(96, 96)
        return net
    if name == "deconv":
        return deconv_net()
    raise ValueError(name)


CASES = [("lenet", 2), ("lenet", 3), ("lenet", 4), ("cifar", 2),
         ("cifar", 4), ("tiny96", 2), ("tiny96", 4), ("tiny96_int8", 2),
         ("tiny96_int8", 4), ("tiny416", 2), ("mobilenet", 3),
         ("mobilenet", 4), ("deconv", 2), ("deconv", 3)]


class _Recorder(_Executor):
    """The one-device run, each node's data inputs and outputs kept as
    the node saw them (an in-place node overwrites its input)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.log = []

    def _dispatch(self, fn, node):
        ins = {s: self.values[s] for s in _data_srcs(node)}
        fn(node)
        self.log.append((ins, {d: self.values[d] for d in node.dst
                               if d in self.values}))


class _Rank:
    """This rank of D, for the spatial executor: collectives never run
    (the simulated fetch reads the whole tensors)."""

    def __init__(self, rank, size):
        self.rank, self.size, self.axis = rank, size, "model"

    def all_reduce(self, t, op="sum"):
        raise AssertionError("no collective in the simulation")


class _Sim(ma._SpatialExecutor):
    """One rank's spatial executor whose halo rows and whole tensors come
    from the one-device run's (`whole`), in place of the other ranks."""

    def __init__(self, net, params, state, plan, rank, whole):
        r = _Rank(rank, plan.d)
        super().__init__(net, params, state, Mode.PREDICT, None, plan, r, r,
                         None)
        self.whole_of = whole

    def _fetch(self, idx, need_of, zero_pad):
        a, b = need_of(self.height.rank)
        x = self.whole_of[idx]
        h = x.shape[2]
        parts = []
        shape = (x.shape[0], x.shape[1], 0, x.shape[3])
        if zero_pad and a < 0:
            parts.append(x.new_zeros(shape[:2] + (-a,) + shape[3:]))
        parts.append(x[:, :, max(a, 0):min(b, h)])
        if zero_pad and b > h:
            parts.append(x.new_zeros(shape[:2] + (b - h,) + shape[3:]))
        return ma._layout(torch.cat(parts, dim=2))

    def _as(self, idx, want):
        x = self.whole_of[idx]
        if want == "whole":
            return x
        lo, hi = self.band_of(idx)
        return ma._layout(x[:, :, lo:hi])


def one_device(name):
    net = build(name.replace("_int8", ""))
    p, s = bridge.params_from_numpy(net, *bridge.he_numpy_weights(net, 5))
    x = np.random.RandomState(1).rand(net.batch_size, net.tensors[0].c,
                                      net.tensors[0].h,
                                      net.tensors[0].w).astype(np.float32)
    if name.endswith("_int8"):
        net.quant = {
            "act_scales": quant.calibrate(net, p, s, [x]),
            "weights": quant.quantize_weights(net, p)}
    ex = _Recorder(net, p, s, Mode.PREDICT)
    ex.values[0] = torch.from_numpy(x)
    with torch.inference_mode():
        ex.run()
    return net, p, s, ex


@pytest.mark.parametrize("name,d", CASES)
def test_plan_partitions_every_band_tensor(name, d):
    net = build(name.replace("_int8", ""))
    plan = ma.plan_bands(net, d)
    heights = {net.tensors[t].h for i, n in enumerate(net.nodes)
               if plan.node_band[i] for t in list(_data_srcs(n)) + n.dst}
    assert heights and plan.hmin == min(heights) >= d
    for h in heights:
        bands = plan.bands(h)
        assert len(bands) == d and bands[0][0] == 0 and bands[-1][1] == h
        for (lo, hi), (lo2, _) in zip(bands, bands[1:]):
            assert lo < hi == lo2
        assert bands[-1][0] < bands[-1][1]
    for i, n in enumerate(net.nodes):
        if not plan.node_band[i]:
            srcs = [net.tensors[s] for s in _data_srcs(n)]
            assert (n.type not in ma._BAND_TYPES
                    or any(t.h < d for t in srcs + [net.tensors[t]
                                                    for t in n.dst])
                    or n.type in (LayerType.ELTWISE,
                                  LayerType.TRANSPOSE_CONV2D))


def test_plan_keeps_yolov3_tiny_strides_aligned():
    """At 416 px on 2 ranks: 13 rows 7 + 6, every stage at 2^k times
    that, so each stride-2 pool reads exactly its own rows."""
    net = build("tiny416")
    plan = ma.plan_bands(net, 2)
    assert plan.bands(13) == [(0, 7), (7, 13)]
    assert plan.bands(416) == [(0, 224), (224, 416)]
    for n in net.nodes:
        if n.type == LayerType.MAXPOOL and n.param["stride"] == 2:
            out = plan.bands(net.tensors[n.dst[0]].h)
            src = plan.bands(net.tensors[n.src[0]].h)
            assert [(2 * a, 2 * b) for a, b in out] == src


@pytest.mark.parametrize("name,d", CASES)
def test_band_layers_match_one_device(name, d):
    """Every band node on every rank's rows equals the one-device run's
    rows of its output."""
    net, p, s, ref = one_device(name)
    plan = ma.plan_bands(net, d)
    checked = set()
    for r in range(d):
        for i, (node, (ins, outs)) in enumerate(zip(net.nodes, ref.log)):
            if not plan.node_band[i]:
                continue
            sim = _Sim(net, p, s, plan, r, ins)
            for t in ins:
                sim.values[t] = sim._as(t, "band")
                sim.form[t] = "band"
            sim.pos = i
            fn = getattr(sim, f"_{node.type.name.lower()}")
            with torch.inference_mode():
                sim._dispatch(fn, node)
            for dst, want in outs.items():
                lo, hi = sim.band_of(dst)
                got = sim.values[dst]
                want = want[:, :, lo:hi]
                assert got.shape == want.shape, (i, node.type)
                if want.dtype == torch.int8 or node.type in (
                        LayerType.MAXPOOL, LayerType.UPSAMPLE):
                    assert torch.equal(got, want), (i, node.type, r)
                else:
                    np.testing.assert_allclose(
                        got.float().numpy(), want.float().numpy(),
                        rtol=RTOL, atol=ATOL, err_msg=f"{i} {node.type} {r}")
            checked.add(node.type)
    assert LayerType.CONV2D in checked or name == "mobilenet"
    if name.startswith("tiny"):  # 4 ranks: the 3-row stage runs whole
        assert {LayerType.MAXPOOL, LayerType.YOLOV3} <= checked
        assert d > 2 or LayerType.UPSAMPLE in checked
    if name == "deconv":
        assert {LayerType.TRANSPOSE_CONV2D, LayerType.MAXPOOL,
                LayerType.UPSAMPLE} <= checked


@pytest.mark.parametrize("d", [2, 3, 4])
def test_yolo_deltas_of_a_band_are_the_heads_rows(d):
    """`yolo_train_deltas(rows=(lo, H))` of each band of a 13-row head,
    truths on every band's cells and two on one cell, joined: the whole
    head's deltas bit for bit; the bands' sums of the cost add up to
    the whole one's within rounding."""
    net = yolov3_tiny(2, 416, 416, 4)
    node = next(n for n in net.nodes if n.type == LayerType.YOLOV3)
    prm = dict(node.param, net_w=416, net_h=416)
    rng = np.random.RandomState(4)
    h = net.tensors[node.src[0]].h
    x = torch.from_numpy(rng.randn(2, net.tensors[node.src[0]].c, h, h)
                         .astype(np.float32))
    y = yolo.yolo_head(x, prm["num"], prm["classes"])
    lab = np.zeros((2, 250), np.float32)
    for i in range(2):
        for t in range(8):
            lab[i, 5 * t:5 * t + 5] = [rng.uniform(.05, .95),
                                       (t + .5) / 8, rng.uniform(.05, .5),
                                       rng.uniform(.05, .5), rng.randint(4)]
        lab[i, 40:45] = lab[i, 35:40]  # a second truth on a cell
    lab = torch.from_numpy(lab)
    whole = yolo.yolo_train_deltas(y, lab, prm, 416, 416)
    plan = ma.plan_bands(net, d)
    parts = [yolo.yolo_train_deltas(y[:, :, lo:hi], lab, prm, 416, 416,
                                    rows=(lo, h))
             for lo, hi in plan.bands(h)]
    assert torch.equal(torch.cat(parts, dim=2), whole)
    np.testing.assert_allclose(
        sum(float(torch.sum(p * p)) for p in parts),
        float(torch.sum(whole * whole)), rtol=1e-6)


def test_plan_and_windows_numbers():
    """The windows' arithmetic at the edges: a 3x3 stride-2 pad-1 conv's
    first kept output sits after the pad's rows; a 1x1 conv needs its
    own rows only; the deconv's input rows are those that add in."""
    assert ma.conv_window(0, 4, 3, 2, 1) == (-2, 8, 1)
    assert ma.conv_window(4, 7, 1, 1, 0) == (4, 7, 0)
    assert ma.conv_window(3, 5, 3, 1, 1) == (2, 6, 1)
    assert ma.pool_window(7, 13, 2, 1) == (7, 14)
    assert ma.upsample_window(3, 9, 2) == (1, 5)
    assert ma.deconv_window(4, 8, 4, 2, 1) == (1, 5)
