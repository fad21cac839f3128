"""bench_torch.py, the port's benchmark, on the CPU at a small size: its
builders and its measurement in `detect`, `detect_int8` and `train`,
and the keys of its JSON line (`bench.py`'s). The script itself refuses
the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch

torch.set_num_threads(1)

KEYS = {"metric", "value", "unit", "batch", "best_ms", "median_best_ms",
        "median_best_img_s", "n_rounds", "avg_ms", "device"}


@pytest.mark.parametrize("mode", ["detect", "detect_int8"])
def test_bench_line_on_the_cpu(mode):
    rec = bench_torch.run(mode, batch=2, size=64, runs=4, device="cpu")
    line = json.loads(json.dumps(rec))
    assert set(line) == KEYS
    assert line["metric"] == f"yolov3_tiny_64_{mode}"
    assert line["unit"] == "img/s/chip" and line["batch"] == 2
    assert line["n_rounds"] == 2 and line["device"] == "cpu"
    assert line["value"] > 0 and line["best_ms"] <= line["avg_ms"] * 8


def test_detect_int8_runs_the_int8_program():
    fn = bench_torch.build_predict("detect_int8", 2, 64, "cpu")
    boxes, probs, obj = fn()
    assert boxes.shape == (2, 100, 4) and obj.shape == (2, 100)
    assert torch.isfinite(boxes).all()


@pytest.mark.parametrize("act,scan", [("bf16", 1), ("fp32", 1), ("bf16", 2)])
def test_train_line_on_the_cpu(act, scan):
    """BENCH_MODE=train: bench.py's training program and keys (the loss
    added; scan_steps with BENCH_SCAN)."""
    rec = bench_torch.run("train", 2, 64, 4, "cpu", act=act, scan=scan)
    line = json.loads(json.dumps(rec))
    want = KEYS | {"loss"} | ({"scan_steps"} if scan > 1 else set())
    assert set(line) == want
    assert line["metric"] == ("yolov3_tiny_64_train_bf16"
                              + ("_act16" if act == "bf16" else "")
                              + (f"_scan{scan}" if scan > 1 else ""))
    assert line["n_rounds"] == 2 and line["batch"] == 2
    assert line["value"] > 0 and line["loss"] > 0
    if scan > 1:
        assert line["scan_steps"] == scan


def test_train_program_steps_the_weights():
    fn = bench_torch.build_train(2, 64, "cpu", scan=2)
    losses = [float(fn()) for _ in range(3)]
    assert all(np.isfinite(losses)) and len(set(losses)) == 3


def test_script_refuses_the_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", BENCH_MODE="detect",
               BENCH_SIZE="64", BENCH_BATCH="2")
    res = subprocess.run(
        [sys.executable, "bench_torch.py"], capture_output=True, text=True,
        env=env, cwd=os.path.dirname(os.path.abspath(bench_torch.__file__)),
        timeout=300,
    )
    assert res.returncode != 0
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["value"] == 0 and "CUDA is not available" in line["error"]
