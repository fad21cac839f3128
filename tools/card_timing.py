"""The card's kernel timers, shared by chip_smoke.py and the kernel tools
(tools/k1k2_compare.py, k3_compare.py, k4_compare.py, k5_compare.py,
kernel_repeat.py).

  - `cuda_ms(fn)`: warm, the mean device time of many calls queued back
    to back;
  - `cold_ms(fn, flush)`: cold, the median of single calls, each after a
    write of `flush` that empties L2;
  - `device_us(fn)`: the profiler's device time by kernel name, which
    the host's time can never enter;
  - `gpu_line()`: the card's name and power limit, to print beside every
    number.

The CUDA-event timers queue SLEEP_CYCLES on the card before each timed
call, so that the host's launch time stays hidden behind the sleep. The
end-to-end speed of the port is the benchmark's (benchmark/run.py), not
this module's. Importing it touches no CUDA.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

# a write of this many floats between launches empties the 50 MB L2
FLUSH_FLOATS = 64 * 2**20  # 256 MB
# cycles of the sleep queued before each timed call (about 0.5 ms at
# 1.98 GHz): one K5 call takes 90-100 us of host time through its
# wrapper, and a cover of 100 us let the host's time into the CUDA-event
# times (tools/kernel_repeat.py)
SLEEP_CYCLES = 1_000_000


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=200, warmup=10) -> float:
    """Mean device time of fn() in ms, from CUDA events around iters calls
    queued behind a sleep on the card, so that the host's launch time
    does not show between the calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(iters * SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, flush, reps=9) -> float:
    """Median device time of one fn() in ms, each call timed by its own
    events after a write of `flush` (larger than L2), so that it reads
    its inputs from device memory; queued behind a sleep on the card, so
    that the host's launch time does not show."""
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(fn, iters=20):
    """Device time by kernel name (µs summed over iters calls) from
    torch.profiler; empty if the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
    return out
