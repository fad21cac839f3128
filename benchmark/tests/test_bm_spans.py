"""The readers of the program's spans (`benchmark/spans.py` and the six
`*.serve` metrics that read it): a synthetic trace with known spans and
idle gaps, and one traced CPU run of each cell on the real program."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans, trace
from bm_cells import small_cell

torch.set_num_threads(2)

A = "yolov3-416.detect-int8.b64"
E = "yolov3-416.detect-bf16.b64"
METRICS = {"idle_upload_ms.serve": 1000.0, "idle_build_ms.serve": 200.0,
           "builds_per_req.serve": 2.0, "idle_exec_ms.serve": 500.0,
           "exec_host_ms.serve": 3800.0, "idle_heads_ms.serve": 400.0}

# one request, seconds from its start: the program's spans, and the
# card's idle gaps with the owner each should go to
REQUEST = [
    ("bcnn.detect", 0.5, 9.5),
    ("bcnn.build.detect_fn", 0.6, 0.8),
    ("bcnn.upload", 1.0, 3.0),
    ("bcnn.execute", 3.2, 7.0),
    ("bcnn.node.conv2d", 3.3, 5.0),
    ("bcnn.build.epilogue", 3.4, 3.6),
    ("bcnn.node.eltwise", 5.0, 7.0),
    ("bcnn.heads", 7.2, 9.0),
    ("bcnn.nms", 8.0, 9.0),
]
GAPS = [
    ((0.65, 0.75), "build"),      # the request's own build
    ((1.5, 2.5), "upload"),
    ((3.45, 3.55), "build"),      # a build inside the pass wins
    ((4.0, 4.5), "execute"),
    ((7.05, 7.15), "detect"),     # in the request, in no phase
    ((8.2, 8.6), "heads"),
    ((9.6, 9.9), None),           # the harness's readback
]
STARTS = (0.0, 12.0)  # two requests, 2 s apart


def _trace(requests=REQUEST, starts=STARTS):
    host, gaps = [], []
    for t0 in starts:
        host.append((trace.REQUEST, t0, 10.0))
        host += [(n, t0 + s, e - s) for n, s, e in requests]
        gaps += [(t0 + a, t0 + b) for (a, b), _ in GAPS]
    gaps.append((10.0, 12.0))  # between the requests
    device, t = [], starts[0]
    for a, b in sorted(gaps):
        device.append((t, a))
        t = b
    device.append((t, starts[-1] + 10.0))
    tr = trace.Trace([(t0, t0 + 10.0) for t0 in starts], device, [], [],
                     host)
    return SimpleNamespace(trace=tr, traced=[{}] * len(starts))


def _read(run):
    return {m: harness.load_reader(m)(run) for m in METRICS}


def test_each_reader_gives_its_known_value():
    got = _read(_trace())
    for m, want in METRICS.items():
        assert got[m] == pytest.approx(want, rel=1e-9), m


def test_every_gap_goes_to_its_owner():
    run = _trace()
    sp = spans.read(run)
    want = {}
    for (a, b), who in GAPS:
        want[who] = want.get(who, 0.0) + 2 * (b - a)
    want[None] += 2.0  # between the requests
    assert sp.idle.keys() == want.keys()
    for who in want:
        assert sp.idle[who] == pytest.approx(want[who], rel=1e-9), who
    # the owners share the card's idle time, no more
    a, b = run.trace.window
    idle = (b - a) - run.trace.busy()
    assert sum(sp.idle.values()) == pytest.approx(idle, rel=1e-9)


def test_a_build_gap_inside_the_pass_is_a_build():
    nested = [s for s in REQUEST if s[0] != "bcnn.build.detect_fn"]
    sp = spans.read(_trace(nested))
    # the detect_fn gap now falls in no phase; the epilogue's stays build
    assert sp.idle["build"] == pytest.approx(2 * 0.1, rel=1e-9)
    assert sp.idle["execute"] == pytest.approx(2 * 0.5, rel=1e-9)


def test_without_the_root_span_every_reader_gives_none():
    no_root = [s for s in REQUEST if s[0] != "bcnn.detect"]
    assert all(v is None for v in _read(_trace(no_root)).values())
    twice = REQUEST + [("bcnn.detect", 9.6, 9.7)]
    assert all(v is None for v in _read(_trace(twice)).values())
    # the parent's program: no span of its own at all
    bare = _trace([])
    assert all(v is None for v in _read(bare).values())


def test_a_missing_phase_reads_none_not_zero():
    no_upload = [s for s in REQUEST if s[0] != "bcnn.upload"]
    got = _read(_trace(no_upload))
    assert got["idle_upload_ms.serve"] is None
    assert got["idle_exec_ms.serve"] == pytest.approx(500.0, rel=1e-9)
    no_builds = [s for s in REQUEST if not s[0].startswith("bcnn.build.")]
    got = _read(_trace(no_builds))
    assert got["idle_build_ms.serve"] is None
    assert got["builds_per_req.serve"] == 0.0


def test_an_untraced_or_partial_run_reads_none():
    run = _trace()
    run.traced = run.traced[:1]
    assert all(v is None for v in _read(run).values())
    assert all(v is None for v in _read(SimpleNamespace(
        trace=None, traced=[])).values())


@pytest.mark.parametrize("cell", [A, E])
def test_a_traced_cpu_run_reports_every_span_metric(cell):
    with small_cell(cell) as (tag, bench):
        out = harness.run_cell(tag, 2**31 + 19, 0.5, True,
                               time.perf_counter(), device="cpu",
                               bench=bench)
    assert out["correct"] is True
    for m in METRICS:
        assert m in out["metrics"], m
        assert out["metrics"][m]["value"] >= 0
    # every build of the path, as PERF.md derives them from the code at
    # 64 px (the card adds K4's plans in A)
    assert out["metrics"]["builds_per_req.serve"]["value"] == (
        103.0 if cell == A else 150.0)
