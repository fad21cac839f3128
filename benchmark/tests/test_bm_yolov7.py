"""The YOLOv7 configuration and its cell on the CPU at a small size, K6's
yardstick on it (`roofline_k6`), and the routes' yardstick
(`roofline_route`): byte counts against hand counts and the share read
from a trace."""

import json
import time

import pytest
import torch

from benchmark import harness, roofline, roofline_k6, roofline_route, trace
from bm_cells import small_cell

torch.set_num_threads(2)

V4 = "yolov4-608.detect-bf16.b64"
V7 = "yolov7-640.detect-bf16.b64"
CAT = ("void at::native::(anonymous namespace)::"
       "CatArrayBatchedCopy_aligned16_contig<c10::BFloat16, unsigned int, "
       "4, 64, 64>")


def run(tag, bench, traced=False, seed=2**31 + 17):
    return harness.run_cell(tag, seed, 0.5, traced, time.perf_counter(),
                            device="cpu", bench=bench)


def test_the_cell_runs_and_passes_its_check():
    with small_cell(V7) as (tag, bench):
        out = run(tag, bench)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"serve_img_per_s", "setup_s"}
    for k, v in out["check"].items():
        assert v["value"] <= v["limit"], k


def test_the_traced_cell_leaves_out_what_a_cpu_trace_lacks():
    """A CPU trace has no K6 launch and no card cat kernel:
    k6_roofline.serve and route_roofline.serve are left out, never made
    up as 0."""
    with small_cell(V7) as (tag, bench):
        out = run(tag, bench, traced=True)
    assert out["correct"] is True
    assert not {"k6_roofline.serve", "route_roofline.serve"} & set(
        out["metrics"])
    assert "builds_per_req.serve" in out["metrics"]


def layers(cell):
    c = harness.load_cell(cell)
    cfg = c["cfg"]
    return c["ref"], c["ref"].build(cfg["cfg_path"], cfg["input_size"])


def _values(convs, size=640):
    return [c * (size // k) ** 2 for c, k in convs]


def test_k6_bytes_of_yolov7_equal_a_hand_count():
    """YOLOv7 at 640, batch 64, bf16: its 89 batch-norm outputs read and
    written once, 2 bytes a value, and four fp32 vectors each: 21.68 GB,
    6.47 ms at the memory's rate."""
    elan = lambda c, s, out: [(c, s)] * 6 + [(out, s)]  # noqa: E731
    mp = lambda c, s: [(c, 2 * s), (c, s), (c, 2 * s)]  # noqa: E731
    helan = lambda c1, c2, s, out: [(c1, s)] * 2 + [(c2, s)] * 4 + [  # noqa: E731
        (out, s)]
    # (channels, stride) of every BN conv: the stem, the backbone's ELAN
    # and MP blocks, SPPCSPC, the PAN and the RepConvs
    convs = ([(32, 1), (64, 2), (64, 2), (128, 4)]
             + elan(64, 4, 256) + mp(128, 4) + elan(128, 8, 512)
             + mp(256, 8) + elan(256, 16, 1024) + mp(512, 16)
             + elan(256, 32, 1024) + [(512, 32)] * 7
             + [(256, 32), (256, 16)] + helan(256, 128, 16, 256)
             + [(128, 16), (128, 8)] + helan(128, 64, 8, 128)
             + mp(128, 8) + helan(256, 128, 16, 256)
             + mp(256, 16) + helan(512, 256, 32, 512)
             + [(256, 8), (512, 16), (1024, 32)])
    assert len(convs) == 89
    hand = sum(2 * 64 * v * 2 + 16 * c
               for v, (c, _) in zip(_values(convs), convs))
    ref, ls = layers(V7)
    got = roofline_k6.bn_conv_bytes(ref, ls, 64, 2)
    assert len(got) == 89 and sum(got) == hand
    assert abs(hand / 21.68e9 - 1) < 0.001
    assert abs(hand / roofline.PEAK_BYTES - 6.47e-3) < 1e-5


def test_route_bytes_of_yolov7_equal_a_hand_count():
    """The 17 routes of two or more layers at 640, batch 64, bf16: each
    output written once and its inputs read once, 6.92 GB, 2.07 ms at the
    memory's rate; the 21 routes of one layer add no bytes."""
    routes = [(256, 4), (256, 8), (512, 8), (512, 16), (1024, 16),
              (1024, 32), (1024, 32),       # the backbone's ELAN and MP
              (2048, 32), (1024, 32),       # SPPCSPC
              (512, 16), (1024, 16), (256, 8), (512, 8),  # PAN, upward
              (512, 16), (1024, 16), (1024, 32), (2048, 32)]  # downward
    hand = sum(2 * 64 * v * 2 for v in _values(routes))
    ref, ls = layers(V7)
    got = roofline_route.route_bytes(ls, 64, 2)
    assert len(got) == 17 and sorted(got) == sorted(
        2 * 64 * v * 2 for v in _values(routes))
    assert sum(got) == hand
    assert abs(hand / 6.92e9 - 1) < 0.001
    assert abs(hand / roofline.PEAK_BYTES - 2.066e-3) < 1e-6
    assert sum(1 for l in ls if l.kind == "route" and len(l.srcs) == 1) \
        == 21


class _Run:
    def __init__(self, cell, kernels, n=2):
        self.cell = harness.load_cell(cell)
        reqs = [(float(i), float(i) + 0.5) for i in range(n)]
        self.trace = trace.Trace(reqs, [], kernels, [])
        self.traced = [{}] * n


@pytest.mark.parametrize("cell", [V4, V7])
def test_route_share_reads_the_traced_launches(cell):
    """Σ bound / Σ cat time over the traced requests, whatever the count
    of cat launches; None without a cat kernel or on a storage type K6's
    bytes do not count."""
    ref, ls = layers(cell)
    bound = sum(roofline_route.route_bytes(ls, 64, 2)) / roofline.PEAK_BYTES
    cat = [(CAT, 0.0, 1e-4)] * 75
    other = [("cudnn_conv", 0.0, 1.0)]
    pct = roofline_route.route_roofline_pct(_Run(cell, cat + other))
    assert pct == pytest.approx(100 * 2 * bound / (75 * 1e-4))
    assert roofline_route.route_roofline_pct(_Run(cell, other)) is None
    assert roofline_route.route_roofline_pct(
        _Run("yolov3-416.detect-int8.b64", cat)) is None


def test_k6_share_reads_yolov7s_launches():
    ref, ls = layers(V7)
    bound = sum(roofline_k6.bn_conv_bytes(ref, ls, 64, 2)) / \
        roofline.PEAK_BYTES
    k6 = [("void bn_act_kernel_nhwc<__nv_bfloat16, false, 11>", 0.0,
           1e-4)] * 178
    pct = roofline_k6.k6_roofline_pct(_Run(V7, k6))
    assert pct == pytest.approx(100 * 2 * bound / (178 * 1e-4))
    assert roofline_k6.k6_roofline_pct(_Run(V7, k6[1:])) is None


def test_the_configuration_files_agree():
    cfg = json.loads((harness.HERE / "configs" / "yolov7-640.json")
                     .read_text())
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = [c for c in bench["configs"] if c["name"] == "yolov7-640"]
    assert entry and entry[0]["reduced"] == cfg["reduced"] == []
    assert entry[0]["source"] == cfg["source"]
    assert entry[0]["file"] == "benchmark/configs/yolov7-640.json"
    cell = [w for w in bench["workloads"] if w["name"] == V7]
    assert cell and cell[0]["config"] == "yolov7-640" \
        and cell[0]["chips"] == 1
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    assert [n for n, m in per_layer.items() if V7 in m["workloads"]] == [
        n for n in per_layer if n != "k4_roofline.serve"]
    assert per_layer["route_roofline.serve"]["workloads"] == [V4, V7]
    ref, ls = layers(V7)
    assert sum(roofline.conv_ops(ref, ls, 1)) == pytest.approx(104.51e9,
                                                               rel=1e-4)
