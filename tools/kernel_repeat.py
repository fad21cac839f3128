#!/usr/bin/env python3
"""Repeat chip_smoke.py's checks of K3 (bcnn_tpu_torch/csrc/depthwise.cu)
and K5 (csrc/grouped_int8.cu) in one process on one GPU, to tell a
kernel's own time from the host's. Each repeat prints the card's clocks
and power draw (nvidia-smi), the host time of one K5 call through its
wrapper at MobileNet-v1's smallest depthwise shape (median and largest
of 200, timed alone on the host clock, the card kept busy), then runs
chip_smoke.check_k3 and check_k5 as the whole script runs them: every
output held to the plain version, then timed warm, cold and by the
profiler. The CUDA-event times hide the host only while one call's host
time stays under the sleep queued before it (card_timing.SLEEP_CYCLES a
call); the profiler's device time never counts it. A summary line a
repeat gives the times a MobileNet-v1 forward (its 13 launches).

    python3 tools/kernel_repeat.py [--repeats 3]

Needs CUDA and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from bcnn_tpu_torch import kernels  # noqa: E402
from bcnn_tpu_torch.ops.grouped_int8 import grouped_int8_fused  # noqa: E402
from tools.card_timing import SLEEP_CYCLES, gpu_line  # noqa: E402

HOST_CALLS = 200


def clocks() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return res.stdout.strip() or f"not read ({res.stderr.strip()[:80]})"


def k5_host_us():
    """(median, largest) host µs of one K5 wrapper call at (64, 1024, 7,
    7), each call timed alone while a sleep keeps the card busy."""
    args, kw = cs.k5_args(cs.K5_MOBILENET[-1], torch.Generator().manual_seed(
        cs.SEED))
    grouped_int8_fused(*args, **kw)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_CALLS * SLEEP_CYCLES)
    times = []
    for _ in range(HOST_CALLS):
        t0 = time.perf_counter()
        grouped_int8_fused(*args, **kw)
        times.append(1e6 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times), max(times)


def per_forward(rows, key):
    return sum(m * r[key] for m, r in zip(cs.K3_PER_FORWARD, rows))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_repeat: CUDA is not available", file=sys.stderr)
        return 1
    print(gpu_line(), torch.__version__, torch.version.cuda, flush=True)
    kernels.library()
    for i in range(a.repeats):
        med, top = k5_host_us()
        print(f"repeat {i}: clocks sm, mem, power, temperature: {clocks()};"
              f" host time of one K5 call: median {med:.1f} us, largest "
              f"{top:.1f} us", flush=True)
        k3 = cs.check_k3()[:len(cs.K3_PER_FORWARD)]
        k5 = cs.check_k5()[:len(cs.K3_PER_FORWARD)]
        print(f"repeat {i} a MobileNet-v1 forward, ms: " + "; ".join(
            f"{name} warm {per_forward(rows, 'ms'):.4f}, cold "
            f"{per_forward(rows, 'cold_ms'):.4f}, device "
            f"{cs.forward_dev_ms(rows)}"
            for name, rows in (("K3", k3), ("K5", k5))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
