"""Arithmetic the metric readers share. A reader returns None where its
run holds nothing to read; a share of a peak or a roofline is never made
up as 0."""

from __future__ import annotations

from typing import Optional


def images_per_s(run) -> Optional[float]:
    t0, t1 = run.window
    n = sum(r["images"] for r in run.requests)
    return n / (t1 - t0) if n and t1 > t0 else None


def traced(run):
    """The trace, if it holds the cell's whole stretch of requests."""
    tr = run.trace
    if tr is None or not run.traced or len(tr.requests) != len(run.traced):
        return None
    return tr


def idle_pct(run) -> Optional[float]:
    """The share of the traced stretch in which nothing ran on the card,
    in %."""
    tr = traced(run)
    if tr is None:
        return None
    a, b = tr.window
    return 100.0 * (1.0 - tr.busy() / (b - a)) if b > a else None


def mfu_pct(run) -> Optional[float]:
    """Conv operations of the traced requests over the stretch at the
    precision's peak, in %."""
    tr = traced(run)
    if tr is None or not run.peak_ops:
        return None
    a, b = tr.window
    return 100.0 * run.ops_per_request * len(tr.requests) / (
        (b - a) * run.peak_ops) if b > a else None


def k4_roofline_pct(run) -> Optional[float]:
    """The int8 convs' bound over K4's device time, over the stretch;
    None unless K4 ran exactly its launches a request."""
    tr = traced(run)
    if tr is None or run.k4_bound_s is None:
        return None
    k4 = [d for name, _, d in tr.kernels if "conv_int8_kernel" in name]
    if not k4 or len(k4) != run.k4_launches * len(tr.requests):
        return None
    return 100.0 * run.k4_bound_s * len(tr.requests) / sum(k4)


def upload_ms(run) -> Optional[float]:
    tr = traced(run)
    if tr is None:
        return None
    up = [d for name, _, d in tr.copies if "HtoD" in name]
    return 1e3 * sum(up) / len(tr.requests) if up else None


def kernels_per_request(run) -> Optional[float]:
    tr = traced(run)
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / len(tr.requests)
