"""The traced run's records: a `torch.profiler` trace of a fixed stretch
of requests, and the harness's own spans around its calls into the
program.

The profiler runs on a schedule that skips the cell's first
`trace_skip` requests, warms up on one and records the next
`trace_requests`, so every traced run of a cell covers the same count of
requests. Each request is one `bm.request` range in the trace; the
device intervals are the kernels, copies and fills the trace shows on
the card.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
REQUEST = "bm.request"
SCAN = 4000  # host events looked back through for the one at a gap


class Tracer:
    """No-op unless `on`; `span()` wraps one request, `step()` follows
    it."""

    def __init__(self, on: bool, skip: int = 0, n: int = 0):
        self.on, self.events, self.prof = on, None, None
        if not on:
            return
        import torch

        def ready(p):
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                p.export_chrome_trace(path)
                with open(path) as f:
                    self.events = json.load(f)["traceEvents"]
            finally:
                os.remove(path)

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        sched = torch.profiler.schedule(wait=skip, warmup=1, active=n,
                                        repeat=1)
        self.prof = torch.profiler.profile(activities=acts, schedule=sched,
                                           on_trace_ready=ready)
        self.first = skip + 1  # the first request recorded
        self.n = n

    def __enter__(self):
        if self.prof is not None:
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)

    def span(self):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(REQUEST)

    def step(self):
        if self.prof is not None:
            self.prof.step()


@dataclass
class Trace:
    """What a reader reads from the profiled stretch, times in seconds."""

    requests: List[Tuple[float, float]]  # bm.request ranges, trace clock
    device: List[Tuple[float, float]]  # merged device intervals
    kernels: List[Tuple[str, float, float]]  # (name, start, duration)
    copies: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window(self) -> Tuple[float, float]:
        return self.requests[0][0], self.requests[-1][1]

    def busy(self) -> float:
        """Seconds of device activity inside the window."""
        a, b = self.window
        return sum(max(0.0, min(e, b) - max(s, a)) for s, e in self.device
                   if e > a and s < b)

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle stretches of the device inside the window."""
        a, b = self.window
        out, t = [], a
        for s, e in self.device:
            if e <= t or s >= b:
                continue
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < b:
            out.append((t, b))
        return out


def _merge(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(v) for v in out]


def parse(events: List[Dict]) -> Optional[Trace]:
    """The stretch's requests, device activity and host events; None
    where the trace holds no request."""
    reqs, dev, kern, cop, host = [], [], [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s, d = float(ev["ts"]) * 1e-6, float(ev["dur"]) * 1e-6
        if cat == "user_annotation" and name == REQUEST:
            reqs.append((s, s + d))
        if cat in DEVICE_CATS:
            dev.append((s, s + d))
            (kern if cat == "kernel" else cop).append((name, s, d))
        elif cat in HOST_CATS:
            host.append((name, s, d))
    if not reqs:
        return None
    return Trace(sorted(reqs), _merge(dev), kern, cop, host)


def breakdown(tr: Trace, top: int = 10) -> Dict:
    """The device operations that took most time, and the idle time of
    the device by what the host was doing then (the innermost host event
    at each gap's middle)."""
    ops: Dict[str, float] = {}
    for name, _, d in tr.kernels + tr.copies:
        ops[name] = ops.get(name, 0.0) + d
    idle: Dict[str, float] = {}
    host = sorted(tr.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    for a, b in tr.gaps():
        mid = (a + b) / 2
        what = "python"
        j = bisect.bisect_right(starts, mid) - 1
        for h in host[max(0, j - SCAN):j + 1][::-1]:
            if mid <= h[1] + h[2]:
                what = h[0]
                break
        idle[what] = idle.get(what, 0.0) + (b - a)
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": [[k[:120], v] for k, v in order(ops)],
            "idle_gaps": [[k[:120], v] for k, v in order(idle)]}
