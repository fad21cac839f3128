#!/usr/bin/env python3
"""Smoke run of bcnn_tpu_torch, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from bcnn_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, then serves YOLOv3-tiny
(416x416, 80 classes, batch 8, random weights from a seed) through
Session.detect_on_batch on both detection branches, and checks the
output against the port's CPU run. Any failure exits nonzero. The last
line of stdout is {"ok": true, "device": {...}}; the line before it
lists each kernel with its launches on the served path, its error
against the plain version and both times. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from bcnn_tpu_torch import Session, kernels
from bcnn_tpu_torch.models import yolov3_tiny
from bcnn_tpu_torch.ops.yolo_decode import decode_fused, decode_grid_ref

SEED = 0
BATCH, SIZE, CLASSES = 8, 416, 80
REQUESTS = 3
ANCHORS = [10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319]
# K1 against its plain version: the tolerance tests/test_yolo_pallas.py
# sets for the TPU kernel
K1_RTOL, K1_ATOL = 1e-5, 1e-6
# GPU heads against the CPU port: the repo's fp32 detection tolerance
HEAD_RTOL, HEAD_ATOL = 1e-4, 1e-4


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=200, warmup=10) -> float:
    """Mean device time of fn() in ms, from CUDA events around iters calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def fmt_device(total_us, iters):
    return "not measured" if not total_us else f"{total_us / iters:.1f} us"


def check_k1(shapes):
    """K1 against decode_grid_ref on the card, timed in turns
    (plain, kernel, kernel, plain). Returns per-shape records."""
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    for n, classes, h, w, mask in shapes:
        x = (3 * torch.randn(n, 3 * (5 + classes), h, w, generator=gen)).cuda()
        p = dict(num=3, classes=classes, mask=mask, anchors=ANCHORS)
        before = decode_fused.launches
        got = decode_fused(x, p, SIZE, SIZE)
        want = decode_grid_ref(x, p, SIZE, SIZE)
        torch.cuda.synchronize()
        if decode_fused.launches != before + 1:
            raise RuntimeError("decode_fused did not count its launch")
        err = 0.0
        for g, r in zip(got, want):
            if g.shape != r.shape:
                raise RuntimeError(f"K1 shape {g.shape} != {r.shape}")
            torch.testing.assert_close(g, r, rtol=K1_RTOL, atol=K1_ATOL)
            err = max(err, float((g - r).abs().max()))
        t = [
            cuda_ms(lambda: decode_grid_ref(x, p, SIZE, SIZE)),
            cuda_ms(lambda: decode_fused(x, p, SIZE, SIZE)),
            cuda_ms(lambda: decode_fused(x, p, SIZE, SIZE)),
            cuda_ms(lambda: decode_grid_ref(x, p, SIZE, SIZE)),
        ]
        rows.append(dict(shape=tuple(x.shape), max_abs_err=err,
                         ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2))
        k_dev = device_us(lambda: decode_fused(x, p, SIZE, SIZE))
        p_dev = device_us(lambda: decode_grid_ref(x, p, SIZE, SIZE))
        print(f"K1 {tuple(x.shape)}: max_abs_err {err:.3g}; CUDA-event "
              f"time per call: kernel {rows[-1]['ms']:.4f} ms, plain "
              f"{rows[-1]['plain_ms']:.4f} ms; device time per call "
              f"(profiler): kernel {fmt_device(sum(k_dev.values()), 20)}, "
              f"plain {fmt_device(sum(p_dev.values()), 20)} in "
              f"{len(p_dev)} kernel names")
    return rows


def same_detections(a, b):
    """Both branches keep the same slots with the same objectness; the
    rows (box, scores) kept agree as sets, since candidates whose fp32
    sigmoids tie may take their slots in another order on the other
    branch (top-k on logits vs on sigmoid values)."""
    (b1, s1, o1), (b2, s2, o2) = a, b
    alive = o1 > 0
    if not torch.equal(alive, o2 > 0) or not alive.any():
        raise RuntimeError("the two branches keep different slots")
    torch.testing.assert_close(o1, o2, rtol=K1_RTOL, atol=K1_ATOL)
    for i in range(o1.shape[0]):
        r1 = torch.cat([b1[i], s1[i]], 1)[alive[i]].double()
        r2 = torch.cat([b2[i], s2[i]], 1)[alive[i]].double()
        tol = K1_ATOL + K1_RTOL * r2.abs()[None]
        close = ((r1[:, None] - r2[None]).abs() <= tol).all(-1)
        match = close.double().argmax(1)
        if not close.any(1).all() or match.unique().numel() != len(match):
            raise RuntimeError(f"image {i}: the branches keep other boxes")


def bn_stats(net, seed=SEED):
    """BN running stats from a numpy seed: run_var in [0.5, 1.5],
    run_mean in [-0.1, 0.1] (zero stats would scale each BN by 1000)."""
    rng = np.random.RandomState(seed)
    out = {}
    for t in net.state_specs():
        lo, hi = (0.5, 1.5) if t.key.endswith("_run_var") else (-0.1, 0.1)
        out[t.key] = torch.from_numpy(
            rng.uniform(lo, hi, t.mem_shape).astype(np.float32)
        )
    return out


def serve(sess, batches, topk_first):
    """Answer each batch as one request; returns (outputs, latencies ms)
    with the host clock around the request, upload and sync included."""
    outs, lat = [], []
    for x in batches:
        t0 = time.perf_counter()
        out = sess.detect_on_batch(x, topk_first=topk_first)
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
        outs.append(tuple(o.cpu() for o in out))
    return outs, lat


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    gpu = gpu_line()
    name = torch.cuda.get_device_name(0)
    print(gpu)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    print(f"build + load: {time.perf_counter() - t0:.2f} s")

    # -- phase 3: K1 against its plain version on the card ---------------
    k1 = check_k1([
        (BATCH, CLASSES, 13, 13, [3, 4, 5]),
        (BATCH, CLASSES, 26, 26, [0, 1, 2]),
        (3, 7, 7, 11, [1, 3, 5]),  # ragged: odd grid, partial last block
    ])

    # -- phase 4: serve YOLOv3-tiny at 416 on both branches ---------------
    net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES)
    sess = Session(net, SEED, device="cuda")
    sess.state = bn_stats(net)
    sess.compile_net()
    rng = np.random.RandomState(SEED + 1)
    batches = [rng.rand(BATCH, 3, SIZE, SIZE).astype(np.float32)
               for _ in range(REQUESTS + 1)]  # the first one warms up

    decode_fused.launches = 0
    full, lat_full = serve(sess, batches, topk_first=False)
    k1_launches = decode_fused.launches
    topk, lat_topk = serve(sess, batches, topk_first=True)
    if decode_fused.launches != k1_launches:
        raise RuntimeError("the top-k-first branch launched K1")
    if k1_launches != 2 * len(batches):
        raise RuntimeError(
            f"K1 launched {k1_launches} times for {len(batches)} requests"
        )

    # -- phase 5: outputs ------------------------------------------------
    for a, b in zip(topk, full):
        for t, shape in zip(a + b, [(BATCH, 100, 4), (BATCH, 100, CLASSES),
                                    (BATCH, 100)] * 2):
            if tuple(t.shape) != shape or not torch.isfinite(t).all():
                raise RuntimeError(f"bad detection output {tuple(t.shape)}")
        same_detections(a, b)

    heads = ["lid17", "lid24"]
    gpu_heads, _ = sess.predict_on_batch(batches[1], heads)
    cpu = Session(net, SEED, device="cpu")
    cpu.params = {k: v.cpu() for k, v in sess.params.items()}
    cpu.state = {k: v.cpu() for k, v in sess.state.items()}
    cpu.compile_net()
    cpu_heads, _ = cpu.predict_on_batch(batches[1][:2], heads)
    for g, c in zip(gpu_heads, cpu_heads):
        g = g[:2].cpu()
        if not torch.isfinite(g).all():
            raise RuntimeError("non-finite head")
        torch.testing.assert_close(g, c, rtol=HEAD_RTOL, atol=HEAD_ATOL)
        print(f"head {tuple(g.shape)} GPU vs CPU max_abs_err "
              f"{float((g - c).abs().max()):.3g}")

    # -- phase 6: report -------------------------------------------------
    x = batches[1]
    for label, topk_first, lat in (
        ("decode-everything (K1)", False, lat_full),
        ("top-k-first", True, lat_topk),
    ):
        _, steady = serve(sess, [x] * 20, topk_first)
        med = statistics.median(steady)
        dev = device_us(
            lambda: sess.detect_on_batch(x, topk_first=topk_first), iters=5
        )
        busy = sum(dev.values()) / 5 / 1e3
        print(f"detect_on_batch {label}, batch {BATCH}, {SIZE} px, "
              f"{CLASSES} classes on {gpu}: requests "
              + ", ".join(f"{v:.2f}" for v in lat)
              + f" ms (the first warms up); 20 more: median {med:.2f} ms, "
              f"min {min(steady):.2f} ms; device busy "
              + (f"{busy:.2f} ms per request ({100 * busy / med:.0f}% of "
                 "the median)" if busy else "not measured"))
        for k, us in sorted(dev.items(), key=lambda kv: -kv[1])[:6]:
            print(f"    {us / 5 / 1e3:8.3f} ms  {k[:90]}")
    served = k1[:2]  # the two head shapes the served path gives K1
    print(json.dumps({"kernels": [{
        "name": "yolo_decode",
        "route": "cuda",
        "source": "bcnn_tpu_torch/csrc/yolo_decode.cu",
        "replaces": "bcnn_tpu/ops/yolo_pallas.py:74",
        "launches": k1_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k1),
        "ms": sum(r["ms"] for r in served),
        "plain_ms": sum(r["plain_ms"] for r in served),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
