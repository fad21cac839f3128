"""Serving latency over bucketed-batch artifacts on the PyTorch port,
the counterpart of examples/serving_latency.py.

A deployment picks a batch bucket a request class and cares about the
latency distribution at each bucket. This exports YOLOv3-tiny's whole
detection program (forward, top-k-first decode, on-device NMS:
`deploy.export_detect`) once a bucket and precision, loads each
artifact with `deploy.load_exported`, and times `--calls` calls of it
on one input (host clock, each call ended by `torch.cuda.synchronize()`
on the card): p50/p90/p99/min and the img/s at p50. The export, the
load and one warm-up call stay outside the timed window (the first
`torch.export` in a process takes seconds). Each bucket's served output
is compared with the live session's on the same input: bit for bit, or,
at bf16, where the live conv sums in TF32 and the exported one in fp32,
the largest difference and whether the same detection slots are kept.

Usage:
  python examples_torch/serving_latency.py [--mode bf16|int8|both]
      [--buckets 1,8,64,256] [--calls 60] [--size 416] [--device cuda|cpu]
Prints one JSON line a bucket, then a markdown table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def build_session(batch, size, int8, dev, weights=None):
    """YOLOv3-tiny in PREDICT at bf16 compute (as the JAX example), int8
    through ptq_synthetic where asked."""
    import torch

    from bcnn_tpu_torch import Mode, Session
    from bcnn_tpu_torch.models import yolov3_tiny
    from examples_torch._common import seed_weights

    net = yolov3_tiny(batch_size=batch, width=size, height=size,
                      mode=Mode.PREDICT)
    net.compute_dtype = torch.bfloat16
    sess = seed_weights(Session(net, seed=0, device=dev), weights)
    sess.compile_net()
    if int8:
        from bcnn_tpu_torch.ops.quant import ptq_synthetic

        ptq_synthetic(net, sess)
    return net, sess


def _max_abs_err(a, b):
    """The largest |a - b|, equal entries (inf and nan included) 0."""
    import torch

    d = (a - b).abs().nan_to_num(nan=float("inf"))
    d[torch.isclose(a, b, rtol=0, atol=0, equal_nan=True)] = 0
    return float(d.max()) if d.numel() else 0.0


def profile_bucket(batch, size, mode, calls, outdir, dev, weights=None):
    import torch

    from bcnn_tpu_torch.deploy import export_detect, load_exported
    from examples_torch._common import sync

    net, sess = build_session(batch, size, mode == "int8", dev, weights)
    path = os.path.join(outdir, f"detect_{mode}_b{batch}.pt2")
    t0 = time.perf_counter()
    blob = export_detect(net, sess.params, sess.state, path, thresh=0.5,
                         max_dets=100, platforms=(dev.type,))
    t_export = time.perf_counter() - t0
    call = load_exported(blob)
    x = torch.as_tensor(np.random.RandomState(0).rand(
        batch, 3, size, size).astype(np.float32), device=dev)

    out = call(x)  # warm-up
    sync(dev)
    lat = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = call(x)
        sync(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.sort(np.asarray(lat))
    live = sess.detect_on_batch(x, thresh=0.5, max_dets=100)
    same = all(torch.equal(a, b) for a, b in zip(out, live))
    err = max(_max_abs_err(a.float(), b.float()) for a, b in zip(out, live))

    def pct(p):
        return float(np.percentile(lat, p))

    return {
        "mode": mode,
        "batch": batch,
        "artifact_mb": round(len(blob) / 1e6, 1),
        "export_s": round(t_export, 2),
        "p50_ms": round(pct(50), 3),
        "p90_ms": round(pct(90), 3),
        "p99_ms": round(pct(99), 3),
        "min_ms": round(float(lat[0]), 3),
        "img_s_at_p50": round(batch / (pct(50) / 1e3), 1),
        "bit_equal_to_live": same,
        # the live bf16 conv sums in TF32 (`ops/conv.py`), the exported
        # graph keeps no cuDNN flag and sums in fp32 (`deploy.py`)
        "max_abs_err_to_live": err,
        "same_slots_as_live": bool(torch.equal(out[2] > 0, live[2] > 0)),
    }


def main(argv=None, weights=None):
    """Returns the rows (one dict a bucket). `weights`: bcnn_tpu-layout
    numpy dicts in place of the seeded init."""
    from examples_torch._common import add_device, data_dir, device

    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="both",
                    choices=["bf16", "int8", "both"])
    ap.add_argument("--buckets", default="1,8,64,256")
    ap.add_argument("--calls", type=int, default=60)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--outdir", default=None,
                    help="where the artifacts go (default: bcnn_artifacts "
                    "in the temporary directory)")
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)
    outdir = args.outdir or data_dir("bcnn_artifacts")
    os.makedirs(outdir, exist_ok=True)
    buckets = [int(b) for b in args.buckets.split(",")]
    modes = ["bf16", "int8"] if args.mode == "both" else [args.mode]

    rows = []
    for mode in modes:
        for b in buckets:
            row = profile_bucket(b, args.size, mode, args.calls, outdir,
                                 dev, weights)
            print(json.dumps(row), flush=True)
            rows.append(row)

    print(f"\n({dev}) | mode | batch | artifact MB | p50 ms | p90 ms "
          "| p99 ms | min ms | img/s @p50 |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['mode']} | {r['batch']} | {r['artifact_mb']} "
            f"| {r['p50_ms']} | {r['p90_ms']} | {r['p99_ms']} "
            f"| {r['min_ms']} | {r['img_s_at_p50']} |"
        )
    return rows


if __name__ == "__main__":
    main()
