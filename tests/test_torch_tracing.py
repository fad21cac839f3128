"""The port's spans (`profiling.span`) on the serving path and its one
launch counter (`ops.library.launches`), on the CPU: YOLOv3-tiny at
64 px, batch 2, fp32 and int8 (K4's plain version).

Under a torch profiler `Session.detect_on_batch` records each span of
the request the number of times the net's nodes and precision give,
nested on the calling thread; with no profiler it enters no
`record_function` at all; the detections are the same bits either way;
an exported forward holds no profiler op."""

import collections
import io

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bcnn_tpu_torch import Session, bridge, compile as tcompile, deploy
from bcnn_tpu_torch import profiling
from bcnn_tpu_torch.models import yolov3_tiny
from bcnn_tpu_torch.ops import library
from bcnn_tpu_torch.ops.quant import ptq_synthetic
from bcnn_tpu_torch.types import LayerType

torch.set_num_threads(1)

SIZE, BATCH, CLASSES = 64, 2, 4


def _session(prec):
    net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES)
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0))
    sess.compile_net()
    if prec == "int8":
        ptq_synthetic(net, sess)
    return net, sess


@pytest.fixture(scope="module", params=["fp32", "int8"])
def served(request):
    net, sess = _session(request.param)
    x = np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(
        np.float32)
    sess.detect_on_batch(x)  # the first call outside any profiler
    return request.param, net, sess, x


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("bcnn.")]
    return out, spans


def _expected(prec, net, topk_first=True):
    """Each span's count in one request, from the net's nodes."""
    want = collections.Counter(
        tcompile._NODE_SPAN[n.type] for n in net.nodes)
    convs = [n for n in net.nodes if n.type == LayerType.CONV2D]
    want.update({"bcnn.detect": 1, "bcnn.upload": 1, "bcnn.execute": 1,
                 "bcnn.heads": 1, "bcnn.select": 1, "bcnn.decode": 1,
                 "bcnn.nms": 1, "bcnn.build.detect_fn": 1,
                 "bcnn.build.nms_order": 1})
    if topk_first:
        want["bcnn.build.candidates"] = 1
    if prec == "int8":
        # the convs' epilogue vectors, and the input's quantize: the
        # int8 flow carries every other conv input as int8
        want.update({"bcnn.build.int8_flow": 1,
                     "bcnn.build.epilogue": len(convs),
                     "bcnn.build.scale": 1})
    else:
        want["bcnn.build.bn_consts"] = sum(
            bool(n.param.get("batch_norm")) for n in convs)
    return want


def test_a_request_records_each_span_its_count(served):
    prec, net, sess, x = served
    _, spans = _traced(lambda: sess.detect_on_batch(x))
    assert collections.Counter(n for n, _, _ in spans) == _expected(prec,
                                                                     net)
    nodes = [n for n, _, _ in spans if n.startswith("bcnn.node.")]
    assert len(nodes) == len(net.nodes)


def test_the_decode_everything_branch_records_its_spans(served):
    prec, net, sess, x = served
    _, spans = _traced(lambda: sess.detect_on_batch(x, topk_first=False))
    assert collections.Counter(n for n, _, _ in spans) == _expected(
        prec, net, topk_first=False)
    (dec,) = [s for s in spans if s[0] == "bcnn.decode"]
    (heads,) = [s for s in spans if s[0] == "bcnn.heads"]
    assert dec[2] <= heads[1]  # decoded before the heads select


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_spans_nest_on_the_calling_thread(served):
    _, _, sess, x = served
    _, spans = _traced(lambda: sess.detect_on_batch(x))
    one = lambda name: [s for s in spans if s[0] == name]  # noqa: E731
    (root,) = one("bcnn.detect")
    (execute,) = one("bcnn.execute")
    (heads,) = one("bcnn.heads")
    assert all(_inside(s, root) for s in spans)
    for s in spans:
        if s[0].startswith("bcnn.node."):
            assert _inside(s, execute), s
        if s[0] in ("bcnn.select", "bcnn.decode", "bcnn.nms",
                    "bcnn.build.candidates", "bcnn.build.nms_order"):
            assert _inside(s, heads), s
        if s[0] in ("bcnn.build.epilogue", "bcnn.build.bn_consts"):
            assert any(_inside(s, n) for n in one("bcnn.node.conv2d")), s
    (nms_order,) = one("bcnn.build.nms_order")
    (nms,) = one("bcnn.nms")
    (cand,) = one("bcnn.build.candidates")
    (decode,) = one("bcnn.decode")
    assert _inside(nms_order, nms) and _inside(cand, decode)
    # the upload and the builds of the request come before the pass
    (upload,) = one("bcnn.upload")
    assert upload[2] <= execute[1]
    assert one("bcnn.build.detect_fn")[0][2] <= upload[1]


class _Counting:
    """Stands in for `record_function`, counting the ranges entered."""

    entered = 0

    def __init__(self, name, args=None):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_without_a_profiler_no_record_function_is_entered(served,
                                                          monkeypatch):
    _, _, sess, x = served
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        _Counting)
    _Counting.entered = 0
    assert not profiling.recording()
    sess.detect_on_batch(x)
    sess.detect_on_batch(x, topk_first=False)
    assert _Counting.entered == 0
    # the same calls under a profiler go through the stand-in
    with profile(activities=[ProfilerActivity.CPU]):
        sess.detect_on_batch(x)
    assert _Counting.entered > len(sess.net.nodes)


def test_a_span_off_is_one_shared_no_op():
    assert not profiling.recording()
    assert profiling.span("bcnn.a") is profiling.span("bcnn.b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        assert isinstance(profiling.span("bcnn.a"),
                          torch.profiler.record_function)
    assert set(tcompile._NODE_SPAN) == set(LayerType)


@pytest.mark.parametrize("topk_first", [True, False])
def test_detections_are_the_same_bits_with_the_profiler_on(served,
                                                           topk_first):
    _, _, sess, x = served
    off = sess.detect_on_batch(x, topk_first=topk_first)
    on, spans = _traced(lambda: sess.detect_on_batch(
        x, topk_first=topk_first))
    assert spans
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("under_profiler", [False, True])
def test_an_exported_forward_holds_no_profiler_op(served, under_profiler):
    prec, net, sess, x = served
    if under_profiler:
        with profile(activities=[ProfilerActivity.CPU]):
            blob = deploy.export_forward(net, sess.params, sess.state)
    else:
        blob = deploy.export_forward(net, sess.params, sess.state)
    ep = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t]


def test_the_launch_counter_counts_calls_that_launch(monkeypatch):
    """One counter an op, in `ops.library`: a CUDA call counts where it
    returns an output with elements (a launcher skips the launch
    otherwise), not where it raises; reset sets every op's to 0."""
    assert {"yolo_decode", "row_shift", "depthwise", "conv_int8",
            "grouped_int8"} <= set(library._LAUNCHES)
    monkeypatch.setitem(library._LAUNCHES, "_t_op", 0)

    def cuda(n, fail=False):
        if fail:
            raise ValueError("refused")
        return torch.zeros(n), torch.zeros(n)

    launch = library._counted("_t_op", cuda)
    launch(3)
    launch(0)
    with pytest.raises(ValueError):
        launch(3, fail=True)
    assert library.launches("_t_op") == 1
    library.reset_launches()
    assert all(v == 0 for v in library._LAUNCHES.values())


def test_the_cpu_launches_no_kernel(served):
    _, _, sess, x = served
    library.reset_launches()
    sess.detect_on_batch(x)
    sess.detect_on_batch(x, topk_first=False, use_pallas=True)
    assert sum(library._LAUNCHES.values()) == 0
