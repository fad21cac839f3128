#!/usr/bin/env python3
"""Where a YOLOv3-tiny detect request of the port spends its time, at
fp32, bf16 and int8, on both detection branches, on one GPU.

    python3 tools/port_host_profile.py [--batch 8] [--size 416]

For each precision (fp32; bf16 as bench.py sets it, compute_dtype =
act_dtype = bf16; int8, bf16 plus ops.quant.ptq_synthetic) and each
branch (top-k-first, decode-everything): 3 warm-up requests, the median
of 10 timed ones (host clock around Session.detect_on_batch on a host
numpy batch, upload and sync included), then torch.profiler over 3 more
requests: the ops by host time, with their call counts and device time.
Weights from seed 0. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bcnn_tpu_torch import Session  # noqa: E402
from bcnn_tpu_torch.models import yolov3_tiny  # noqa: E402
from bcnn_tpu_torch.ops.quant import ptq_synthetic  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=416)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("port_host_profile: CUDA is not available")
    n, size = args.batch, args.size
    x = np.random.RandomState(0).rand(n, 3, size, size).astype(np.float32)
    for label in ("fp32", "bf16", "int8"):
        net = yolov3_tiny(n, size, size, 80)
        if label != "fp32":
            net.compute_dtype = net.act_dtype = torch.bfloat16
        sess = Session(net, 0, device="cuda").compile_net()
        if label == "int8":
            ptq_synthetic(net, sess)
        for topk_first in (True, False):
            def request():
                sess.detect_on_batch(x, topk_first=topk_first)
                torch.cuda.synchronize()

            for _ in range(3):
                request()
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                request()
                times.append(1e3 * (time.perf_counter() - t0))
            branch = "top-k-first" if topk_first else "decode-everything"
            print(f"{label} {branch}, batch {n}, {size} px: median "
                  f"{statistics.median(times):.2f} ms, min {min(times):.2f} "
                  "ms over 10 requests; profile of 3 requests:", flush=True)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    request()
            print(prof.key_averages().table(
                sort_by="self_cpu_time_total", row_limit=14,
                max_name_column_width=50), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
