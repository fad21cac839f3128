"""The YOLOv4 configuration and its cell on the CPU at a small size, and
K6's yardstick (`roofline_k6`): its byte count against a hand count and
its share read from a trace."""

import json
import time

import pytest
import torch

from benchmark import harness, roofline, roofline_k6, trace
from bm_cells import small_cell

torch.set_num_threads(2)

E = "yolov3-416.detect-bf16.b64"
V4 = "yolov4-608.detect-bf16.b64"


def run(tag, bench, traced=False, seed=2**31 + 11):
    return harness.run_cell(tag, seed, 0.5, traced, time.perf_counter(),
                            device="cpu", bench=bench)


def test_the_cell_runs_and_passes_its_check():
    with small_cell(V4) as (tag, bench):
        out = run(tag, bench)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"serve_img_per_s", "setup_s"}
    for k, v in out["check"].items():
        assert v["value"] <= v["limit"], k


def test_the_traced_cell_leaves_out_what_a_cpu_trace_lacks():
    """A CPU trace has no K6 launch: k6_roofline.serve is left out, never
    made up as 0."""
    with small_cell(V4) as (tag, bench):
        out = run(tag, bench, traced=True)
    assert out["correct"] is True
    assert "k6_roofline.serve" not in out["metrics"]
    assert "builds_per_req.serve" in out["metrics"]


def layers(cell):
    c = harness.load_cell(cell)
    cfg = c["cfg"]
    return c["ref"], c["ref"].build(cfg["cfg_path"], cfg["input_size"])


def test_k6_bytes_of_yolov3_equal_a_hand_count():
    """Full YOLOv3 at 416, batch 64, bf16: the 72 batch-norm outputs read
    and written once, 2 bytes a value, and four fp32 vectors each."""
    s = {k: 416 // k for k in (1, 2, 4, 8, 16, 32)}
    sq = lambda k: s[k] * s[k]  # noqa: E731
    # (channels, stride) of every BN conv: Darknet-53, then the neck and
    # the convs before each head
    convs = ([(32, 1), (64, 2)] + [(32, 2), (64, 2)]
             + [(128, 4)] + [(64, 4), (128, 4)] * 2
             + [(256, 8)] + [(128, 8), (256, 8)] * 8
             + [(512, 16)] + [(256, 16), (512, 16)] * 8
             + [(1024, 32)] + [(512, 32), (1024, 32)] * 4
             + [(512, 32), (1024, 32)] * 3 + [(256, 32)]
             + [(256, 16), (512, 16)] * 3 + [(128, 16)]
             + [(128, 8), (256, 8)] * 3)
    assert len(convs) == 72
    hand = sum(2 * 64 * c * sq(k) * 2 + 16 * c for c, k in convs)
    ref, ls = layers(E)
    got = roofline_k6.bn_conv_bytes(ref, ls, 64, 2)
    assert len(got) == 72 and sum(got) == hand
    assert abs(hand / 9.80e9 - 1) < 0.005
    assert abs(hand / roofline.PEAK_BYTES - 2.926e-3) < 1e-5


def test_k6_bytes_of_yolov4():
    """107 batch-norm convs, 112.47 M values an image at 608: 28.79 GB a
    request of 64 in bf16, 8.59 ms at the memory's rate."""
    ref, ls = layers(V4)
    got = roofline_k6.bn_conv_bytes(ref, ls, 64, 2)
    assert len(got) == 107
    assert abs(sum(got) / 28.79e9 - 1) < 0.001
    assert abs(sum(got) / roofline.PEAK_BYTES - 8.59e-3) < 1e-5


class _Run:
    def __init__(self, cell, kernels, n=2):
        self.cell = harness.load_cell(cell)
        reqs = [(float(i), float(i) + 0.5) for i in range(n)]
        self.trace = trace.Trace(reqs, [], kernels, [])
        self.traced = [{}] * n


def test_k6_share_reads_the_traced_launches():
    ref, ls = layers(E)
    bound = sum(roofline_k6.bn_conv_bytes(ref, ls, 64, 2)) / \
        roofline.PEAK_BYTES
    k6 = [("void bn_act_kernel<__nv_bfloat16, false, 5>", 0.0, 5e-5)] * 144
    other = [("cudnn_conv", 0.0, 1.0)]
    pct = roofline_k6.k6_roofline_pct(_Run(E, k6 + other))
    assert pct == pytest.approx(100 * 2 * bound / (144 * 5e-5))
    # a launch too few or too many, or none: nothing to read
    assert roofline_k6.k6_roofline_pct(_Run(E, k6[1:] + other)) is None
    assert roofline_k6.k6_roofline_pct(_Run(E, k6 + k6[:1])) is None
    assert roofline_k6.k6_roofline_pct(_Run(E, other)) is None
    # an int8 cell stores no bf16 or fp32 epilogue
    assert roofline_k6.k6_roofline_pct(
        _Run("yolov3-416.detect-int8.b64", k6)) is None


def test_the_configuration_files_agree():
    cfg = json.loads((harness.HERE / "configs" / "yolov4-608.json")
                     .read_text())
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = [c for c in bench["configs"] if c["name"] == "yolov4-608"]
    assert entry and entry[0]["reduced"] == cfg["reduced"] == []
    assert entry[0]["source"] == cfg["source"]
    ref, ls = layers(V4)
    assert sum(roofline.conv_ops(ref, ls, 1)) == pytest.approx(128.5e9,
                                                               rel=0.01)
