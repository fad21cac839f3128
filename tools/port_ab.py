#!/usr/bin/env python3
"""Time the port's fp32 serving and training paths for two checkouts in
turns on one GPU (A, B, B, A), each run in its own process.

    python3 tools/port_ab.py --roots <checkout A> <checkout B>

A checkout is a directory holding `bcnn_tpu_torch/` (for instance a
`git archive` of another commit unpacked under `_checkout/`, which is
gitignored). Each run imports the package from its root and prints one
JSON line: the host-clock median and min of YOLOv3-tiny 416 detect at
batch 8 on both branches (20 requests after 3 warm-ups), MobileNet-v1
224 at batch 64 (20 after 3) and the training step at batch 32 with
rotation augmentation (5 steps after one), all fp32 with weights from
seed 0. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from bcnn_tpu_torch import Mode, Session, bridge
    from bcnn_tpu_torch.models import mobilenet_v1, yolov3_tiny

    if not torch.cuda.is_available():
        raise RuntimeError("port_ab: CUDA is not available")

    def timed(fn, n, warm):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        t = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append(1e3 * (time.perf_counter() - t0))
        return {"median_ms": statistics.median(t), "min_ms": min(t)}

    rng = np.random.RandomState(0)
    out = {"root": root}
    net = yolov3_tiny(8, 416, 416, 80)
    sess = Session(net, 0, device="cuda").compile_net()
    sess.state = {k: torch.full_like(v, 1.0 if "var" in k else 0.0)
                  for k, v in sess.state.items()}
    x = rng.rand(8, 3, 416, 416).astype(np.float32)
    for name, topk in (("detect_topk", True), ("detect_all", False)):
        out[name] = timed(lambda: sess.detect_on_batch(x, topk_first=topk),
                          20, 3)
    net = mobilenet_v1(64, 1000)
    mb = Session(net, 0, device="cuda")
    mb.params, mb.state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0), device="cuda")
    mb.compile_net()
    xm = rng.rand(64, 3, 224, 224).astype(np.float32)
    out["mobilenet"] = timed(
        lambda: mb.predict_on_batch(xm, outputs=["softmax"]), 20, 3)
    net = yolov3_tiny(32, 416, 416, 80, mode=Mode.TRAIN)
    net.device_augment = dict(random_fliph=1, min_contrast=0.8,
                              max_contrast=1.2, min_brightness=-30,
                              max_brightness=30, rotation_range=10.0)
    tr = Session(net, 0, device="cuda").compile_net()
    tr.state = {k: torch.full_like(v, 1.0 if "var" in k else 0.0)
                for k, v in tr.state.items()}
    xt = rng.randint(0, 256, (32, 3, 416, 416)).astype(np.uint8)
    lab = np.zeros((32, 250), np.float32)
    lab[:, :5] = [0.5, 0.5, 0.3, 0.4, 1]
    out["train"] = timed(lambda: tr.train_on_batch(xt, lab), 5, 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", nargs=2, metavar=("A", "B"))
    ap.add_argument("--measure", metavar="ROOT")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)))
        return 0
    a, b = args.roots
    for root in (a, b, b, a):
        res = subprocess.run([sys.executable, __file__, "--measure", root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
