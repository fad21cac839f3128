"""Benchmark of the PyTorch + CUDA port: YOLOv3-tiny 416x416 inference
and training throughput on one GPU, in the modes of `bench.py` (which
times the JAX package and stays as it is).

    BENCH_MODE=serve python3 bench_torch.py

Prints ONE JSON line with `bench.py`'s keys (metric, value, unit, batch,
best_ms, median_best_ms, median_best_img_s, n_rounds, avg_ms, device;
serve adds the forward_* keys, train the loss and, with a scan,
scan_steps). Modes (BENCH_MODE, default serve):
  forward      bf16 conv inputs and activations (net.compute_dtype and
               net.act_dtype, or fp32 activations with BENCH_PRED_ACT=fp32),
               the two heads summed on the card;
  detect       the same + top-k-first decode and NMS (make_detect_fn);
  int8         forward after ops.quant.ptq_synthetic: int8 weights, int8
               activations between layers, the convs on K4;
  detect_int8  int8 + detection;
  serve        detect_int8, then forward, in one line;
  train        make_train_step on YOLOv3-tiny in TRAIN with bf16 convs
               both ways (net.compute_dtype) and, unless BENCH_ACT=fp32,
               bf16 activations between layers (net.train_act_dtype),
               on one input and one box a image; with BENCH_SCAN=K > 1,
               K steps a call through make_train_scan (per-step time).
BENCH_BATCH (default 1024 for serve, 64 for train, 512 otherwise),
BENCH_SIZE (416), BENCH_RUNS (20). Weights come from seed 0 and the input is drawn on the
card from a seeded generator, uniform in [0, 1). Needs CUDA: on a
machine without it the script raises; the functions take a device for
the CPU tests. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch


def measure(fn, runs, sync):
    """`bench.py`'s protocol: max(2, runs // 4) rounds, each of 4 timed
    single calls and one burst of 8 back-to-back calls (per-call mean);
    returns (best of the round bests, median of the round bests, every
    single-call time), in seconds, host clock around calls that end in
    sync()."""
    times, round_bests = [], []
    burst = 8
    for _ in range(max(2, runs // 4)):
        rb = []
        for _ in range(4):
            t0 = time.perf_counter()
            fn()
            sync()
            dt = time.perf_counter() - t0
            times.append(dt)
            rb.append(dt)
        t0 = time.perf_counter()
        for _ in range(burst):
            fn()
        sync()
        rb.append((time.perf_counter() - t0) / burst)
        round_bests.append(min(rb))
    return min(round_bests), float(np.median(round_bests)), times


def build_predict(mode, batch, size, device):
    """The program of one predict-side mode as a no-argument callable
    (params, state and the input are closed over); the net's attributes
    are those `bench.py` sets for the mode."""
    from bcnn_tpu_torch import Mode, Session
    from bcnn_tpu_torch.compile import execute, make_detect_fn
    from bcnn_tpu_torch.models import yolov3_tiny

    net = yolov3_tiny(batch_size=batch, width=size, height=size,
                      mode=Mode.PREDICT)
    net.compute_dtype = torch.bfloat16
    if os.environ.get("BENCH_PRED_ACT", "bf16") == "bf16":
        net.act_dtype = torch.bfloat16
    sess = Session(net, seed=0, device=device).compile_net()
    if mode in ("int8", "detect_int8"):
        from bcnn_tpu_torch.ops.quant import ptq_synthetic

        ptq_synthetic(net, sess)
    params, state = sess.params, sess.state
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((batch, 3, size, size), generator=gen, device=device)

    if mode in ("detect", "detect_int8"):
        detect = make_detect_fn(net, thresh=0.5, max_dets=100)

        def run():
            with torch.inference_mode():
                return detect(params, state, {"input": x})
    else:
        out_idx = [net.get_tensor_index_by_name("lid17"),
                   net.get_tensor_index_by_name("lid24")]

        def run():
            with torch.inference_mode():
                ex = execute(net, params, state, {"input": x}, Mode.PREDICT)
                return tuple(ex.values[i].sum(dtype=torch.float32)
                             for i in out_idx)
    return run


def _sync_for(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def _device_name(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


METRICS = {
    "forward": "yolov3_tiny_{}_inference",
    "detect": "yolov3_tiny_{}_detect",
    "int8": "yolov3_tiny_{}_int8",
    "detect_int8": "yolov3_tiny_{}_detect_int8",
}


def _timed(mode, batch, size, runs, device):
    """(best, median_best, times) of one predict-side mode after one
    warm-up call."""
    sync = _sync_for(device)
    fn = build_predict(mode, batch, size, device)
    fn()
    sync()
    return measure(fn, runs, sync)


def build_train(batch, size, device, act="bf16", scan=1):
    """`bench.py`'s training program (bench_train, _bench_train_scan) as
    a no-argument callable that runs one step, or `scan` steps through
    make_train_scan, and returns the last loss (a 0-d tensor on the
    device). The input is RandomState(0).rand on the host, uploaded once,
    with the box [0.5, 0.5, 0.25, 0.25, class 1] an image."""
    from bcnn_tpu_torch import Mode, Session
    from bcnn_tpu_torch.compile import make_train_scan, make_train_step
    from bcnn_tpu_torch.models import yolov3_tiny
    from bcnn_tpu_torch.types import DETECTION_MAX_BOXES

    net = yolov3_tiny(batch_size=batch, width=size, height=size,
                      mode=Mode.TRAIN)
    net.compute_dtype = torch.bfloat16
    if act == "bf16":
        net.train_act_dtype = torch.bfloat16
    sess = Session(net, seed=0, device=device).compile_net()
    lead = (scan,) if scan > 1 else ()
    if scan > 1:  # float32 straight from the generator, as bench.py
        x = np.random.default_rng(0).random((scan, batch, 3, size, size),
                                            dtype=np.float32)
    else:
        x = np.random.RandomState(0).rand(batch, 3, size, size).astype(
            np.float32)
    label = np.zeros(lead + (batch, DETECTION_MAX_BOXES * 5), np.float32)
    label[..., 0:5] = [0.5, 0.5, 0.25, 0.25, 1]
    data = {"input": torch.as_tensor(x, device=device),
            "label": torch.as_tensor(label, device=device)}
    gen = torch.Generator().manual_seed(0)
    st = [sess.params, sess.state, sess.opt_state]
    step = make_train_scan(net) if scan > 1 else make_train_step(net)

    def run():
        out = step(*st, data, gen)
        st[:] = out[:3]
        return out[3][-1] if scan > 1 else out[3]

    return run


def run_train(batch, size, runs, device, act="bf16", scan=1):
    """`bench.py`'s train protocol and record: one warm-up call, then
    max(2, runs // 4) rounds, each of two timed calls and (single steps
    only) a burst of 4 back-to-back steps; per-step times, the loss read
    back after each timed call."""
    fn = build_train(batch, size, device, act, scan)
    float(fn())  # warm-up: reading the loss waits for the card
    times, round_bests = [], []
    for _ in range(max(2, runs // 4)):
        rb = []
        for _ in range(3 if scan > 1 else 2):
            t0 = time.perf_counter()
            loss = float(fn())
            dt = (time.perf_counter() - t0) / scan
            times.append(dt)
            rb.append(dt)
        if scan == 1:
            t0 = time.perf_counter()
            for _ in range(4):
                out = fn()
            loss = float(out)
            rb.append((time.perf_counter() - t0) / 4)
        round_bests.append(min(rb))
    best = min(round_bests)
    median_best = float(np.median(round_bests))
    rec = {
        "metric": f"yolov3_tiny_{size}_train_bf16"
        + ("_act16" if act == "bf16" else "")
        + (f"_scan{scan}" if scan > 1 else ""),
        "value": round(batch / best, 1),
        "unit": "img/s/chip",
        "batch": batch,
    }
    if scan > 1:
        rec["scan_steps"] = scan
    rec.update(best_ms=round(best * 1e3, 2),
               median_best_ms=round(median_best * 1e3, 2),
               median_best_img_s=round(batch / median_best, 1),
               n_rounds=len(round_bests),
               avg_ms=round(sum(times) / len(times) * 1e3, 2),
               loss=loss, device=_device_name(device))
    return rec


def run(mode, batch, size, runs, device, act="bf16", scan=1):
    """One mode's measurement as `bench.py`'s JSON record; act and scan
    (BENCH_ACT, BENCH_SCAN) are read by the train mode only."""
    if mode == "train":
        return run_train(batch, size, runs, device, act, scan)
    if mode != "serve" and mode not in METRICS:
        raise ValueError(f"unknown BENCH_MODE {mode!r}")
    best, median_best, times = _timed(
        "detect_int8" if mode == "serve" else mode, batch, size, runs, device)
    rec = {
        "metric": (f"yolov3_tiny_{size}_serve_int8" if mode == "serve"
                   else METRICS[mode].format(size)),
        "value": round(batch / best, 1),
        "unit": "img/s/chip",
        "batch": batch,
        "best_ms": round(best * 1e3, 2),
        "median_best_ms": round(median_best * 1e3, 2),
        "median_best_img_s": round(batch / median_best, 1),
    }
    if mode == "serve":
        fbest, fmedian, _ = _timed("forward", batch, size,
                                   max(8, runs // 2), device)
        rec.update(forward_img_s=round(batch / fbest, 1),
                   forward_best_ms=round(fbest * 1e3, 2),
                   forward_median_best_ms=round(fmedian * 1e3, 2))
    rec.update(n_rounds=max(2, runs // 4),
               avg_ms=round(sum(times) / len(times) * 1e3, 2),
               device=_device_name(device))
    return rec


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch: CUDA is not available")
    mode = os.environ.get("BENCH_MODE", "serve")
    batch = int(os.environ.get(
        "BENCH_BATCH",
        "64" if mode == "train" else "1024" if mode == "serve" else "512",
    ))
    runs = int(os.environ.get("BENCH_RUNS", "20"))
    size = int(os.environ.get("BENCH_SIZE", "416"))
    print(json.dumps(run(mode, batch, size, runs, "cuda",
                         act=os.environ.get("BENCH_ACT", "bf16"),
                         scan=int(os.environ.get("BENCH_SCAN", "1")))))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # still emit one parseable line
        print(json.dumps({
            "metric": "yolov3_tiny_416_inference",
            "value": 0,
            "unit": "img/s/chip",
            "error": f"{type(e).__name__}: {e}"[:300],
        }))
        raise
