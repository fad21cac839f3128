"""Full YOLOv3 and the shortcut layer through bcnn_tpu and through the
port, on the same numpy-seeded weights and inputs.

- `models.yolov3` builds the graph `bcnn_tpu` builds from
  examples/yolo/yolov3.cfg; at 96 px, 2 classes, full depth and the cfg's
  widths, with weights loaded from a Darknet `.weights` file that
  `bcnn_tpu` wrote, its three heads agree at rtol 1e-4, atol 1e-5; both
  detection branches over the three heads and the host-exact
  `yolo_get_detections` agree.
- A small Darknet cfg with two shortcuts, two stride-2 convs, a route,
  an upsample and two heads: fp32, bf16 (heads within 2^-5 of their
  largest value) and int8 (every int8 tensor within 1 LSB, the flow plan
  and the calibration equal).
- `ops.misc.eltwise_add`'s stride broadcast on unequal shapes;
  `metrics_det` and `map_eval` over a stub loader.

Weights are He-scaled (`bridge.he_numpy_weights`) with each residual
branch's BN scales times 0.1, so that 23 residual adds keep the
activations O(1) (with gain 1 the heads reach 2e5 and fp32 rounding
alone exceeds the tolerance)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcnn_tpu as bt
from bcnn_tpu import config as jconfig
from bcnn_tpu import metrics_det as jmet
from bcnn_tpu.compile import execute as jax_execute
from bcnn_tpu.models import yolov3 as jax_yolov3
from bcnn_tpu.ops import misc as jmisc
from bcnn_tpu.ops import quant as jq
from bcnn_tpu.ops import yolo as jyolo
from bcnn_tpu.serialization import save_weights_darknet as jax_save_darknet

from bcnn_tpu_torch import Net, Session, bridge
from bcnn_tpu_torch import config as tconfig
from bcnn_tpu_torch import metrics_det as tmet
from bcnn_tpu_torch.compile import _Executor, execute
from bcnn_tpu_torch.models import yolov3
from bcnn_tpu_torch.ops import eltwise_add
from bcnn_tpu_torch.ops import quant as tq
from bcnn_tpu_torch.ops import yolo as tyolo
from bcnn_tpu_torch.types import LayerType, Mode
from tests.test_torch_config import assert_same_graph
from tests.test_torch_int8_layout import SHORTCUT_CFG, darknet_parse
from tests.test_torch_quant import nchw, to_torch

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
SIZE, CLASSES = 96, 2
RESIDUAL = 0.1
HEAD_TOL = 2.0**-5  # bf16 heads, of the largest value
CAL_RTOL = 1e-6


def heads_of(net):
    return [net.tensors[n.src[0]].name for n in net.nodes
            if n.type == LayerType.YOLOV3]


# ------------------------------------------------------------ the graph #


@pytest.mark.parametrize("batch,size,classes", [(1, 416, 80), (2, 96, 2),
                                                (1, 128, 4)])
def test_yolov3_graph_matches_bcnn_tpu(batch, size, classes):
    ref = jax_yolov3(batch, size, size, classes)
    port = yolov3(batch, size, size, classes)
    assert_same_graph(ref, port)
    yolo = [n for n in port.nodes if n.type == LayerType.YOLOV3]
    assert [n.param["classes"] for n in yolo] == [classes] * 3
    assert [port.tensors[n.dst[0]].h for n in yolo] == [
        size // 32, size // 16, size // 8]


def test_yolov3_cfg_path(tmp_path):
    cfg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "yolo", "yolov3.cfg")
    copy = tmp_path / "mine.cfg"
    copy.write_text(open(cfg).read())
    assert_same_graph(jax_yolov3(1, 64, 64, 3),
                      yolov3(1, 64, 64, 3, cfg_path=str(copy)))
    with pytest.raises(FileNotFoundError, match="cfg_path"):
        yolov3(cfg_path=str(tmp_path / "absent.cfg"))


# ------------------------------------------- full YOLOv3 via .weights #


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """Full YOLOv3 at 96 px, batch 2, 2 classes, both packages loaded
    from one Darknet .weights file that bcnn_tpu wrote."""
    jnet = jax_yolov3(2, SIZE, SIZE, CLASSES)
    net = yolov3(2, SIZE, SIZE, CLASSES)
    p_np, s_np = bridge.he_numpy_weights(net, 0, residual_scale=RESIDUAL)
    path = str(tmp_path_factory.mktemp("yolov3") / "yolov3.weights")
    jax_save_darknet(jnet, p_np, s_np, path)
    js = bt.Session(jnet, 0).compile_net().load_weights(path)
    ts = Session(net, 0, device="cpu").compile_net().load_weights(path)
    assert jnet.bn_folded and net.bn_folded
    x = np.random.RandomState(1).rand(2, 3, SIZE, SIZE).astype(np.float32)
    return js, ts, x


def test_full_yolov3_heads_match_bcnn_tpu(full):
    js, ts, x = full
    names = heads_of(ts.net)
    assert len(names) == 3
    ref, _ = js.predict_on_batch(x, outputs=names)
    out, _ = ts.predict_on_batch(x, outputs=names)
    for name, o, r in zip(names, out, ref):
        r = np.asarray(r)
        assert o.shape == r.shape and r.std() > 0.5, name
        np.testing.assert_allclose(o.numpy(), r, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("topk_first,use_pallas",
                         [(True, None), (False, False), (False, True)])
def test_full_yolov3_detect_over_three_heads(full, topk_first, use_pallas):
    """Both branches pick candidates from all three heads, as
    bcnn_tpu's do; on the CPU use_pallas runs K1's plain version."""
    js, ts, x = full
    ref = js.detect_on_batch(x, thresh=0.5, max_dets=30, use_pallas=False,
                             topk_first=topk_first)
    out = ts.detect_on_batch(x, thresh=0.5, max_dets=30,
                             use_pallas=use_pallas, topk_first=topk_first)
    ro = np.asarray(ref[2])
    for row in ro:  # the ranking must not hinge on fp32 rounding
        alive = np.sort(row[row > 0])
        assert alive.size > 3 and np.diff(alive).min() > ATOL
    np.testing.assert_array_equal(out[2].numpy() > 0, ro > 0)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("w,h,relative", [(96, 96, 1), (640, 480, 1),
                                          (300, 500, 0)])
def test_yolo_get_detections_matches_bcnn_tpu(full, w, h, relative):
    js, ts, x = full
    ref = js.yolo_get_detections(x, w, h, SIZE, SIZE, 0.6, relative, 1)
    got = ts.yolo_get_detections(x, w, h, SIZE, SIZE, 0.6, relative, 1)
    assert len(got) == len(ref) > 3
    assert sum(d["objectness"] == 0 for d in ref) > 0  # NMS kept slots
    for g, r in zip(got, ref):
        assert (g["objectness"] == 0) == (r["objectness"] == 0)
        assert g["num_classes"] == r["num_classes"] == CLASSES
        for k in ("x", "y", "w", "h", "objectness"):
            np.testing.assert_allclose(g[k], r[k], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g["prob"], r["prob"], rtol=RTOL,
                                   atol=ATOL)


def test_host_decode_and_nms_equal_bcnn_tpus():
    """decode_layer, correct_region_boxes and nms_obj on one host array:
    the same numpy code, the same results."""
    rng = np.random.RandomState(5)
    num, classes = 3, 4
    y = rng.normal(0, 2, (5, 7, num * (5 + classes))).astype(np.float32)
    y5 = y.reshape(5, 7, num, 5 + classes)
    y5[..., [0, 1, 4]] = 1 / (1 + np.exp(-y5[..., [0, 1, 4]]))
    y5[..., 5:] = 1 / (1 + np.exp(-y5[..., 5:]))
    prm = dict(num=num, classes=classes, mask=[3, 4, 5],
               anchors=[float(a) for a in range(1, 13)])
    ref = jyolo.decode_layer(y, prm, 64, 48, 0.3)
    got = tyolo.decode_layer(y, prm, 64, 48, 0.3)
    assert len(got) == len(ref) > 10
    for boxes in ((400, 300, 64, 48, 1), (300, 400, 64, 48, 0)):
        for g, r in zip(got, ref):
            assert (tyolo.correct_region_boxes(g["x"], g["y"], g["w"],
                                               g["h"], *boxes)
                    == jyolo.correct_region_boxes(r["x"], r["y"], r["w"],
                                                  r["h"], *boxes))
    ref, got = jyolo.nms_obj(ref, 0.3), tyolo.nms_obj(got, 0.3)
    assert sum(d["objectness"] == 0 for d in got) > 0
    for g, r in zip(got, ref):
        assert {k: v for k, v in g.items() if k != "prob"} == {
            k: v for k, v in r.items() if k != "prob"}
        np.testing.assert_array_equal(g["prob"], r["prob"])
    a, b = (0.5, 0.5, 0.2, 0.3), (0.55, 0.45, 0.3, 0.1)
    assert tyolo._box_iou_np(a, b) == jyolo._box_iou_np(a, b)


# ------------------------------------------------------ a shortcut net #



def shortcut_pair(tmp_path, bf16=False, quant=False):
    cfg = tmp_path / "shortcut.cfg"
    cfg.write_text(SHORTCUT_CFG)
    jnet = darknet_parse(jconfig, bt.Net(bt.Mode.PREDICT), str(cfg))
    net = darknet_parse(tconfig, Net(Mode.PREDICT), str(cfg))
    if bf16:
        jnet.compute_dtype = jnet.act_dtype = jnp.bfloat16
        net.compute_dtype = net.act_dtype = torch.bfloat16
    p_np, s_np = bridge.he_numpy_weights(net, 3, residual_scale=0.5)
    js = bt.Session(jnet, 0).compile_net()
    js.params = {k: jnp.asarray(v) for k, v in p_np.items()}
    js.state = {k: jnp.asarray(v) for k, v in s_np.items()}
    ts = Session(net, 0, device="cpu")
    ts.params, ts.state = bridge.params_from_numpy(net, p_np, s_np)
    ts.compile_net()
    if quant:  # ptq_synthetic sets the running variances to 1
        jq.ptq_synthetic(jnet, js)
        _, ts.state = bridge.params_from_numpy(
            net, p_np, {k: np.asarray(v) for k, v in js.state.items()})
        net.quant = bridge.quant_from_numpy(net, jnet.quant)
    x = np.random.RandomState(2).rand(2, 3, 64, 64).astype(np.float32)
    return js, ts, x


def test_shortcut_net_graph(tmp_path):
    js, ts, _ = shortcut_pair(tmp_path)
    assert_same_graph(js.net, ts.net)
    types = [n.type for n in ts.net.nodes]
    assert types.count(LayerType.ELTWISE) == 2
    assert types.count(LayerType.YOLOV3) == 2


def _head_names(net):
    return heads_of(net) + [net.tensors[n.dst[0]].name for n in net.nodes
                            if n.type == LayerType.ELTWISE]


def test_shortcut_net_fp32(tmp_path):
    js, ts, x = shortcut_pair(tmp_path)
    names = _head_names(ts.net)
    ref, _ = js.predict_on_batch(x, outputs=names)
    out, _ = ts.predict_on_batch(x, outputs=names)
    for name, o, r in zip(names, out, ref):
        r = np.asarray(r)
        assert r.std() > 0.1, name
        np.testing.assert_allclose(o.numpy(), r, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_shortcut_net_bf16(tmp_path):
    js, ts, x = shortcut_pair(tmp_path, bf16=True)
    names = _head_names(ts.net)
    ref, _ = js.predict_on_batch(x, outputs=names)
    out, _ = ts.predict_on_batch(x, outputs=names)
    ex = execute(ts.net, ts.params, ts.state, {"input": torch.from_numpy(x)},
                 Mode.PREDICT)
    for node in ts.net.nodes:
        if node.type == LayerType.ELTWISE:
            assert ex.values[node.dst[0]].dtype == torch.bfloat16
    for name, o, r in zip(names, out, ref):
        o, r = o.float().numpy(), np.asarray(r, np.float32)
        assert r.std() > 0.1, name
        assert np.abs(o - r).max() <= HEAD_TOL * np.abs(r).max(), name


@pytest.fixture
def int8_pair(tmp_path):
    return shortcut_pair(tmp_path, quant=True)


def test_shortcut_watch_and_plan_equal(int8_pair):
    """Both shortcuts' inputs are watched, and the flow plan puts them
    on one shared scale, equal to bcnn_tpu's plan."""
    js, ts, _ = int8_pair
    net = ts.net
    assert tq.watch_tensors(net) == jq.watch_tensors(js.net)
    plan = tq.plan_int8_flow(net, net.quant)
    assert plan == jq.plan_int8_flow(js.net, js.net.quant)
    for node in net.nodes:
        if node.type == LayerType.ELTWISE:
            a, b = node.src
            assert a in plan and b in plan and plan[a] == plan[b]
            assert node.dst[0] in plan  # feeds a conv and a shortcut


@pytest.mark.parametrize("method", ["absmax", "percentile", "kl"])
def test_shortcut_calibrate_matches_bcnn_tpu(tmp_path, method):
    """Calibration of the float net: the shortcuts' inputs are observed
    alike (percentile within 1e-5: XLA's 99.9 / 100, as
    tests/test_torch_quant.py says)."""
    js, ts, x = shortcut_pair(tmp_path)
    kw = dict(method=method, kl_bins=256)
    ref = jq.calibrate(js.net, js.params, js.state, [x], **kw)
    got = tq.calibrate(ts.net, ts.params, ts.state, [x], **kw)
    assert set(got) == set(ref)
    rtol = 1e-5 if method == "percentile" else CAL_RTOL
    for i in ref:
        assert got[i] == pytest.approx(float(ref[i]), rel=rtol), i


def test_shortcut_ptq_synthetic_matches_bcnn_tpu(tmp_path):
    js, ts, _ = shortcut_pair(tmp_path)
    ref = jq.ptq_synthetic(js.net, js)
    got = tq.ptq_synthetic(ts.net, ts)
    assert set(got["act_scales"]) == set(ref["act_scales"])
    for i, s in ref["act_scales"].items():
        assert got["act_scales"][i] == pytest.approx(float(s), rel=CAL_RTOL)
    want = bridge.quant_from_numpy(ts.net, ref)["weights"]
    assert set(got["weights"]) == set(want)
    for k, e in want.items():
        assert torch.equal(got["weights"][k]["q"], e["q"]), k
        assert torch.equal(got["weights"][k]["scale"], e["scale"]), k


def test_shortcut_int8_tensors_within_one_lsb(int8_pair):
    """Each node of the port fed bcnn_tpu's own inputs: every int8 tensor
    within 1 LSB (the shortcuts' shared-scale adds among them, held
    channels-last), every other output to fp32 rounding."""
    js, ts, x = int8_pair
    jex = jax_execute(js.net, js.params, js.state, {"input": jnp.asarray(x)},
                      bt.Mode.PREDICT, None)
    ex = _Executor(ts.net, ts.params, ts.state, Mode.PREDICT)
    assert ex.int8_flow == jex.int8_flow
    n_int8 = n_add = 0
    for node in ts.net.nodes:
        for s in node.src:
            if ts.net.tensors[s].key is None:
                v = to_torch(jex.values[s])
                if v.dtype == torch.int8:
                    v = v.contiguous(memory_format=torch.channels_last)
                ex.values[s] = v
        getattr(ex, f"_{node.type.name.lower()}")(node)
        got, want = ex.values[node.dst[0]], jex.values[node.dst[0]]
        name = ts.net.tensors[node.dst[0]].name
        if want.dtype == jnp.int8:
            n_int8 += 1
            n_add += node.type == LayerType.ELTWISE
            assert got.dtype == torch.int8, name
            assert got.is_contiguous(memory_format=torch.channels_last), name
            d = np.abs(got.numpy().astype(np.int32) - nchw(want))
            assert d.max() <= 1, name
            assert (d > 0).mean() < 1e-3, name
        else:
            np.testing.assert_allclose(got.float().numpy(), nchw(want),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    assert n_int8 == len(ex.int8_flow) and n_add == 2


def test_shortcut_int8_heads_end_to_end(int8_pair):
    js, ts, x = int8_pair
    names = heads_of(ts.net)
    ref, _ = js.predict_on_batch(x, outputs=names)
    out, _ = ts.predict_on_batch(x, outputs=names)
    for name, o, r in zip(names, out, ref):
        o, r = o.float().numpy(), np.asarray(r, np.float32)
        assert r.std() > 0.1, name
        assert np.abs(o - r).max() <= HEAD_TOL * np.abs(r).max(), name


def test_eltwise_in_train_raises(tmp_path):
    """Ported since: the shortcut net trains, its step's loss and updates
    bcnn_tpu's (rtol 1e-4; each update within 1e-3 of its largest
    entry), the shortcut layer's gradient routed as bcnn_tpu routes it
    (tests/test_torch_train_shortcut.py holds every form)."""
    import jax

    from bcnn_tpu import learner as jlearner
    from bcnn_tpu.compile import make_train_step as jax_make_train_step

    cfg = tmp_path / "shortcut.cfg"
    cfg.write_text(SHORTCUT_CFG)
    jnet = darknet_parse(jconfig, bt.Net(bt.Mode.TRAIN), str(cfg))
    net = darknet_parse(tconfig, Net(Mode.TRAIN), str(cfg))
    p_np, s_np = bridge.he_numpy_weights(net, 3, residual_scale=0.5)
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(net, p_np, s_np)
    sess.compile_net()
    lab = np.zeros((2, 250), np.float32)
    lab[:, :5] = [0.5, 0.5, 0.3, 0.4, 1]
    x = np.random.RandomState(4).rand(2, 3, 64, 64).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    jp, _, _, jloss = jax_make_train_step(jnet)(
        jp, {k: jnp.asarray(v) for k, v in s_np.items()},
        jlearner.init_opt_state(jnet, jp),
        {"input": jnp.asarray(x), "label": jnp.asarray(lab)},
        jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(sess.train_on_batch(x, lab)),
                               float(jloss), rtol=1e-4)
    for k, v in bridge.params_to_numpy(net, sess.params).items():
        r, r0 = np.asarray(jp[k]), p_np[k]
        np.testing.assert_allclose(v - r0, r - r0, rtol=0,
                                   atol=1e-3 * np.abs(r - r0).max(),
                                   err_msg=k)


# ------------------------------------------------ eltwise stride rule #

ELTWISE_CASES = {
    "equal": ((2, 4, 6, 6), (2, 4, 6, 6)),
    "src1_half": ((2, 4, 8, 8), (2, 4, 4, 4)),
    "src1_double": ((2, 4, 4, 4), (2, 4, 8, 8)),
    "fewer_channels": ((2, 6, 6, 6), (2, 3, 6, 6)),
    "more_channels_odd": ((1, 3, 7, 7), (1, 5, 3, 3)),
    "stride3": ((2, 2, 9, 9), (2, 4, 3, 3)),
}


def _eltwise_graph(s0, s1):
    net = Net(Mode.PREDICT)
    net.set_input_shape(s0[3], s0[2], s0[1], s0[0])
    net.add_input(s1[3], s1[2], s1[1], "other")
    net.add_eltwise_layer(0, "input", "other", "sum")
    return net.nodes[-1].param


@pytest.mark.parametrize("case", list(ELTWISE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_eltwise_add_stride_broadcast_matches_bcnn_tpu(case, dtype):
    s0, s1 = ELTWISE_CASES[case]
    p = _eltwise_graph(s0, s1)
    ref_p = bt.Net(bt.Mode.PREDICT)
    ref_p.set_input_shape(s0[3], s0[2], s0[1], s0[0])
    ref_p.add_input(s1[3], s1[2], s1[1], "other")
    ref_p.add_eltwise_layer(0, "input", "other", "sum")
    assert p == ref_p.nodes[-1].param
    rng = np.random.RandomState(7)
    a = rng.randint(-127, 128, s0).astype(dtype)
    b = rng.randint(-127, 128, s1).astype(dtype)
    want = jmisc.eltwise_add(jnp.asarray(a.transpose(0, 2, 3, 1)),
                             jnp.asarray(b.transpose(0, 2, 3, 1)),
                             p["stride"], p["min_dim"])
    ta = torch.from_numpy(a).contiguous(memory_format=torch.channels_last)
    got = eltwise_add(ta, torch.from_numpy(b), p["stride"], p["min_dim"])
    np.testing.assert_array_equal(got.numpy(), nchw(want))
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert np.array_equal(ta.numpy(), a)  # x0 is not written


# ------------------------------------------------------------ metrics #


def _rows(rng, m, classes, score=True):
    xy = rng.uniform(0.1, 0.9, (m, 2))
    wh = rng.uniform(0.05, 0.4, (m, 2))
    cols = [xy, wh]
    if score:
        cols.append(rng.uniform(0, 1, (m, 1)))
    cols.append(rng.randint(0, classes, (m, 1)))
    return np.concatenate(cols, axis=1)


def test_metric_functions_match_bcnn_tpu():
    rng = np.random.RandomState(11)
    a, b = _rows(rng, 9, 1)[:, :4], _rows(rng, 6, 1)[:, :4]
    np.testing.assert_array_equal(tmet._iou_matrix(a, b),
                                  jmet._iou_matrix(a, b))
    scores = rng.uniform(0, 1, 40)
    matched = rng.uniform(0, 1, 40) > 0.5
    for interp in ("all", "101"):
        for n_gt in (0, 5, 30):
            r = jmet.average_precision(scores, matched, n_gt, interp)
            g = tmet.average_precision(scores, matched, n_gt, interp)
            assert (np.isnan(r) and np.isnan(g)) or g == r
    dets = np.concatenate([a, rng.uniform(0, 1, (9, 1))], axis=1)
    for t in (0.1, 0.5):
        np.testing.assert_array_equal(tmet.match_detections(dets, b, t),
                                      jmet.match_detections(dets, b, t))
    boxes, sc = rng.uniform(0, 1, (12, 4)), rng.uniform(0, 1, (12, 3))
    sc[sc < 0.6] = 0
    np.testing.assert_array_equal(tmet.dets_to_rows(boxes, sc, 0.1),
                                  jmet.dets_to_rows(boxes, sc, 0.1))
    preds = [_rows(rng, m, 3) for m in (5, 0, 8)]
    gts = [_rows(rng, m, 3, score=False) for m in (4, 3, 0)]
    r = jmet.evaluate_detections(preds, gts, 3)
    g = tmet.evaluate_detections(preds, gts, 3)
    assert (g["map50"], g["map"]) == (r["map50"], r["map"])
    np.testing.assert_array_equal(g["ap"], r["ap"])
    np.testing.assert_array_equal(g["n_gt"], r["n_gt"])
    assert tmet.format_map(g) == jmet.format_map(r)


class StubLoader:
    """Hands the same seeded batches to either package: the images and
    (batch, 250) labels, 1-3 boxes an image, the rest zero."""

    def __init__(self, batch, size, classes, seed=0):
        self.rng = np.random.RandomState(seed)
        self.batch, self.size, self.classes = batch, size, classes

    def next_batch(self):
        x = self.rng.rand(self.batch, 3, self.size, self.size).astype(
            np.float32)
        lab = np.zeros((self.batch, 50, 5), np.float32)
        for i in range(self.batch):
            for t in range(self.rng.randint(1, 4)):
                lab[i, t] = [self.rng.uniform(0.2, 0.8),
                             self.rng.uniform(0.2, 0.8),
                             self.rng.uniform(0.1, 0.5),
                             self.rng.uniform(0.1, 0.5),
                             self.rng.randint(self.classes)]
        return x, lab.reshape(self.batch, 250)


def test_map_eval_over_a_stub_loader_matches_bcnn_tpu(full):
    js, ts, _ = full
    js.loader = StubLoader(2, SIZE, CLASSES)
    ts.loader = StubLoader(2, SIZE, CLASSES)
    r = jmet.map_eval(js, num_images=3, thresh=0.3, max_dets=20)
    g = tmet.map_eval(ts, num_images=3, thresh=0.3, max_dets=20)
    assert int(g["n_gt"].sum()) == int(r["n_gt"].sum()) > 0
    np.testing.assert_allclose(g["ap"], r["ap"], rtol=1e-6, atol=1e-9)
    assert tmet._num_classes(ts.net) == jmet._num_classes(js.net) == CLASSES
