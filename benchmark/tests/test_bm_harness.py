"""The harness on the CPU at small sizes: the result line, the check and
its faults, the data-driven layout, the refusal without a card, the
modules it loads."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from bcnn_tpu_torch.ops import yolo

from benchmark import harness
from benchmark.program import Served
from bm_cells import modules_after, small_cell

torch.set_num_threads(2)

A = "yolov3-416.detect-int8.b64"
E = "yolov3-416.detect-bf16.b64"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(tag, bench, traced=False, factory=None, seed=2**31 + 7):
    return harness.run_cell(tag, seed, 0.5, traced, time.perf_counter(),
                            device="cpu", served_factory=factory,
                            bench=bench)


@pytest.mark.parametrize("cell", [A, E])
def test_result_line_has_the_contract_keys(cell):
    with small_cell(cell) as (tag, bench):
        out = run(tag, bench)
    assert list(out) == KEYS + ["check"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == e2e
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for k, v in out["check"].items():
        assert v["value"] <= v["limit"], k
    json.dumps(out)


@pytest.mark.parametrize("cell", [A, E])
def test_traced_line_has_breakdown_and_window(cell):
    with small_cell(cell) as (tag, bench):
        out = run(tag, bench, traced=True)
    assert list(out) == KEYS + ["breakdown", "check"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["correct"] is True
    # a CPU trace has no device activity: the shares of the card and the
    # launches are left out, never made up as 0
    assert "launches_per_req.serve" not in out["metrics"]
    assert "upload_ms.serve" not in out["metrics"]


class Altered(Served):
    """A served answer altered where it is produced."""

    def detect(self, x):
        boxes, scores, obj = super().detect(x)
        boxes = boxes.clone()
        boxes[0, 0, 0] += 0.25
        return boxes, scores, obj


class HalfBatch(Served):
    """Half of the batch left out: the second half gets no detections."""

    def detect(self, x):
        boxes, scores, obj = super().detect(x)
        h = obj.shape[0] // 2
        scores, obj = scores.clone(), obj.clone()
        scores[h:] = 0
        obj[h:] = 0
        return boxes, scores, obj


class OneDropped(Served):
    """The first kept detection of the first image left out."""

    def detect(self, x):
        boxes, scores, obj = super().detect(x)
        j = int((obj[0] > 0).nonzero()[0])
        scores, obj = scores.clone(), obj.clone()
        scores[0, j] = 0
        obj[0, j] = 0
        return boxes, scores, obj


class BelowThreshold(Served):
    """Candidates under the cell's threshold kept."""

    def detect(self, x):
        boxes, scores, obj = self.sess.detect_on_batch(
            x, thresh=self.thresh - 0.2, max_dets=self.max_dets)
        return boxes.cpu(), scores.cpu(), obj.cpu()


def _no_nms(bsel, valid, nms_thresh):
    return valid


def _bottom_k(v, k):
    """The k smallest objectness logits above the threshold in place of
    the k largest."""
    key = torch.where(v > float("-inf"), -v, float("-inf"))
    _, idx = torch.sort(key, dim=1, descending=True, stable=True)
    return torch.gather(v, 1, idx[:, :k]), idx[:, :k]


# (fault, a patch of the port under it, the cell's detect overrides):
# each at a setting where its fault shows (at 64 px an image has 252
# candidates, about half of them above the threshold)
FAULTS = {
    "altered": (Altered, None, {}, "dets"),
    "half_batch": (HalfBatch, None, {}, "select"),
    "one_dropped": (OneDropped, None, {}, "select"),
    "nms_off": (Served, ("_greedy_nms_mask", _no_nms), {}, "select"),
    "below_threshold": (BelowThreshold, None, {"max_dets": 300}, "select"),
    "bottom_k": (Served, ("_top_k", _bottom_k), {"max_dets": 20}, "select"),
}


@pytest.mark.parametrize("cell", [A, E])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    factory, patch, detect, number = FAULTS[fault]
    if patch is not None:
        monkeypatch.setattr(yolo, *patch)
    src = harness.load_cell(cell)["detect"]
    with small_cell(cell, detect=dict(src, **detect)) as (tag, bench):
        out = run(tag, bench, factory=factory)
    assert out["correct"] is False
    assert out["check"][number]["value"] > out["check"][number]["limit"]


@pytest.mark.parametrize("cell", [A, E])
@pytest.mark.parametrize("detect", [{"max_dets": 300}, {"max_dets": 20}])
def test_the_sound_path_passes_where_the_faults_show(cell, detect):
    src = harness.load_cell(cell)["detect"]
    with small_cell(cell, detect=dict(src, **detect)) as (tag, bench):
        out = run(tag, bench)
    assert out["correct"] is True, out["check"]
    assert out["check"]["select"]["value"] == 0


def test_a_new_cell_and_metric_are_found_by_name():
    """A cell and a per-layer metric added as files, with their entries,
    run with no code edit."""
    mpath = harness.HERE / "metrics" / "_t_requests_seen.py"
    mpath.write_text("def read(run):\n    return float(len(run.requests))\n")
    try:
        with small_cell(E) as (tag, bench):
            bench["per_layer"].append({
                "name": "_t_requests_seen", "unit": "req", "better": "higher",
                "source": "host_clock", "layer": "Serving loop",
                "moves": "serve_img_per_s", "workloads": [tag]})
            out = run(tag, bench, traced=True)
    finally:
        os.remove(mpath)
    assert out["metrics"]["_t_requests_seen"]["value"] == out["attempted"]


def test_without_a_card_it_exits_nonzero_and_prints_nothing():
    p = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", A,
         "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=dict(os.environ,
                                                 CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import time, sys\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark import harness\n"
        "from bm_cells import small_cell\n"
        "for cell in %r:\n"
        "    with small_cell(cell) as (tag, bench):\n"
        "        for traced in (False, True):\n"
        "            harness.run_cell(tag, 3, 0.3, traced,"
        " time.perf_counter(), device='cpu', bench=bench)\n" % ([A, E],))
    mods = modules_after(code)
    assert "bcnn_tpu_torch" in mods  # the program did run
    assert not mods & set(harness.FORBIDDEN)
    # the harness's own check names what it finds
    assert harness.forbidden_modules() == [] or "jax" in sys.modules


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (harness.HERE / "reference").glob("*.py")))
def test_the_reference_loads_nothing_of_the_port(name):
    """Every module under benchmark/reference/, imported alone."""
    mods = modules_after(f"import benchmark.reference.{name}")
    assert not mods & {"bcnn_tpu_torch", *harness.FORBIDDEN}


def test_benchmark_json_names_files_that_exist():
    """Every cell, configuration and metric of BENCHMARK.json has its
    file, and every name keeps to the contract's characters."""
    import re

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for c in bench["configs"]:
        assert name.match(c["name"]) and (harness.ROOT / c["file"]).exists()
    for w in bench["workloads"]:
        assert name.match(w["name"]) and name.match(w["traffic"])
        cell = harness.load_cell(w["name"])
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
        assert os.path.exists(cell["cfg"]["cfg_path"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s"}
