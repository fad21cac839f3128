"""End-to-end training throughput on the PyTorch port, the counterpart
of examples/train_throughput.py: loader + augmentation + train step.

A training run must decode, letterbox and augment every image as well
as step. This measures the sustained images/s of the whole loop on a
synthetic detection dataset (`write_dataset`, which train_soak.py uses
too) under four feeds, beside the pure step on one constant batch on
the card (the ceiling):

  sync      the host assembles the PNG batch, then the step runs (the
            reference's loop shape, bcnn_cl.c's train loop)
  prefetch  one worker assembles batch k+1 while the card runs k
            (data.BatchPipeline: pinned copies on a side stream)
  sharded:W W workers with (w, W)-striped loaders, consumed round-robin
            in the sequential batch order (data.ShardedBatchPipeline)
  raw       pre-letterboxed uint8 records (decode and letterbox done
            once, offline): the host only gathers raw pixels, and flip,
            contrast, brightness and normalization run on the card in
            the step (make_train_step(device_augment=...))

Each step's wall time is kept; the report gives the rate over the whole
run and over its last half (a queued feed can pre-buffer enough batches
to flatter a short run's average).

Usage:
  python examples_torch/train_throughput.py [--batch 64] [--steps 24]
      [--size 416] [--src-size 640] [--images 96] [--workers 8]
      [--modes sync,prefetch,sharded,raw] [--act bf16|fp32]
      [--compute bf16|fp32] [--device cuda|cpu]
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


# 8 visually distinct object colors; the class id IS the color (plus a
# shape bit), so a detector can generalize to unseen images — the round-4
# generator put random boxes on pure noise (no pixel evidence), which
# made held-out metrics structurally unlearnable (VERDICT r4 item 1).
_PALETTE = [
    (230, 40, 30), (40, 230, 60), (50, 80, 235), (235, 220, 40),
    (235, 50, 220), (40, 225, 225), (245, 140, 30), (240, 240, 240),
]


def write_dataset(outdir, n, src_w, src_h, seed=0, classes=8,
                  boxes_per_img=(1, 3)):
    """Synthetic LEARNABLE detection data: n PNGs + one list file.
    Dark-noise background, each labeled box drawn as a filled class-
    colored rectangle (even class) or ellipse (odd class) with a small
    brightness jitter. Two calls with different seeds give disjoint
    train/val splits of the same task."""
    from bcnn_tpu_torch import bip

    rng = np.random.RandomState(seed)
    lst = os.path.join(outdir, f"det_n{n}_s{src_w}_seed{seed}.txt")
    if os.path.exists(lst) and len(open(lst).readlines()) == n:
        return lst  # reuse across runs (PNG encode is slow)
    yy, xx = np.mgrid[0:src_h, 0:src_w]
    lines = []
    for i in range(n):
        img = (rng.rand(src_h, src_w, 3) * 110).astype(np.uint8)
        labs = []
        for _ in range(rng.randint(boxes_per_img[0], boxes_per_img[1] + 1)):
            c = rng.randint(classes)
            cx, cy = rng.uniform(0.12, 0.88, 2)
            bw = rng.uniform(0.08, 0.3)
            bh = rng.uniform(0.08, 0.3)
            x0 = (cx - bw / 2) * src_w
            x1 = (cx + bw / 2) * src_w
            y0 = (cy - bh / 2) * src_h
            y1 = (cy + bh / 2) * src_h
            if c % 2 == 0:  # rectangle
                m = (xx >= x0) & (xx < x1) & (yy >= y0) & (yy < y1)
            else:  # ellipse inscribed in the box
                m = (
                    ((xx - cx * src_w) / max(bw * src_w / 2, 1)) ** 2
                    + ((yy - cy * src_h) / max(bh * src_h / 2, 1)) ** 2
                ) <= 1.0
            jit = rng.uniform(0.75, 1.0)
            col = np.array(_PALETTE[c % len(_PALETTE)]) * jit
            img[m] = col.astype(np.uint8)
            labs.append(
                f"{c} {cx:.4f} {cy:.4f} {bw:.4f} {bh:.4f}"
            )
        p = os.path.join(outdir, f"im{i}_s{src_w}_seed{seed}.png")
        bip.write_image(p, img)
        lines.append(f"{p} " + " ".join(labs))
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lst


def main(argv=None, weights=None):
    """Returns the rows, one dict a feed ("feed", "img_s",
    "img_s_steady", "ms_per_step", "efficiency_steady" beside the pure
    step, "losses": each step's). `weights`: bcnn_tpu-layout numpy dicts
    in place of the seeded init."""
    from examples_torch._common import add_device, data_dir, device, \
        seed_weights, sync

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--src-size", type=int, default=640)
    ap.add_argument("--images", type=int, default=96)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--modes", default="sync,prefetch,sharded,raw")
    ap.add_argument("--act", default="bf16", choices=["bf16", "fp32"],
                    help="the activations' dtype between layers")
    ap.add_argument("--compute", default="bf16", choices=["bf16", "fp32"],
                    help="the convs' dtype (the JAX example's: bf16)")
    ap.add_argument("--outdir", default=None,
                    help="the dataset's directory (default: "
                    "bcnn_tpu_det_data in the temporary directory)")
    add_device(ap)
    args = ap.parse_args(argv)
    if args.steps < 4:
        ap.error("--steps must be >= 4 (first two steps are warmup; "
                 "steady state needs at least two timed samples)")
    dev = device(args.device)

    import torch

    from bcnn_tpu_torch import Mode, Session
    from bcnn_tpu_torch.compile import child_generators, make_train_step
    from bcnn_tpu_torch.data import (BatchPipeline, DetectionListLoader,
                                     RawRecordLoader, ShardedBatchPipeline,
                                     records_from_loader)
    from bcnn_tpu_torch.models import yolov3_tiny

    outdir = args.outdir or data_dir("bcnn_tpu_det_data")
    os.makedirs(outdir, exist_ok=True)
    lst = write_dataset(outdir, args.images, args.src_size,
                        int(args.src_size * 0.75))

    def build():
        net = yolov3_tiny(batch_size=args.batch, width=args.size,
                          height=args.size, mode=Mode.TRAIN)
        if args.compute == "bf16":
            net.compute_dtype = torch.bfloat16
        if args.act == "bf16":
            net.train_act_dtype = torch.bfloat16
        return net

    net = build()
    sess = seed_weights(Session(net, seed=0, device=dev), weights)
    sess.compile_net()
    step = make_train_step(net)
    root = torch.Generator().manual_seed(0)

    def on_device(x, y):
        return (torch.as_tensor(x, device=dev),
                torch.as_tensor(y, dtype=torch.float32, device=dev))

    def run_steps(step_fn, batches):
        """Drive the step over a batch iterator, reading each step's loss
        back (each step's time is the point here). Returns (the step
        times in seconds from the third step on, every step's loss)."""
        params, state, opt = sess.params, sess.state, sess.opt_state
        times, losses = [], []
        t_prev = None
        for i, (x, y) in enumerate(batches):
            (gen,) = child_generators(root, 1)
            params, state, opt, loss = step_fn(
                params, state, opt, {"input": x, "label": y}, gen)
            losses.append(float(loss))
            if i >= 1:
                sync(dev)
                now = time.perf_counter()
                if t_prev is not None:
                    times.append(now - t_prev)
                t_prev = now
        sess.params, sess.state, sess.opt_state = params, state, opt
        return times, losses

    def report(feed, run, ceiling=None):
        times, losses = run
        sustained = args.batch * len(times) / sum(times)
        # steady state: the rate over the last half of the run (a sum, not
        # a median: a queued feed's buffered batches arrive at once)
        half = times[len(times) // 2:]
        steady = args.batch * len(half) / sum(half)
        row = {
            "feed": feed,
            "img_s": round(sustained, 1),
            "img_s_steady": round(steady, 1),
            "ms_per_step": round(sum(times) / len(times) * 1e3, 2),
        }
        if ceiling:
            row["efficiency_steady"] = round(steady / ceiling, 3)
        print(json.dumps(row), flush=True)
        row["losses"] = losses
        return row

    def take(it, k):
        for _ in range(k):
            yield next(it)

    rows = []

    # pure step: one constant batch on the card, no host work: the ceiling
    rng = np.random.RandomState(0)
    xc, yc = on_device(
        rng.rand(args.batch, 3, args.size, args.size).astype(np.float32),
        np.zeros((args.batch, 250), np.float32))
    rows.append(report("pure-step", run_steps(
        step, ((xc, yc) for _ in range(args.steps)))))
    ceiling = rows[0]["img_s_steady"]

    modes = args.modes.split(",")
    if "sync" in modes:
        loader = DetectionListLoader(build(), lst)
        rows.append(report("sync", run_steps(
            step, (on_device(*loader.next_batch())
                   for _ in range(args.steps))), ceiling))
        loader.close()

    if "prefetch" in modes:
        pipe = BatchPipeline(DetectionListLoader(build(), lst), depth=2,
                             device=dev)
        try:
            rows.append(report("prefetch", run_steps(
                step, take(iter(pipe), args.steps)), ceiling))
        finally:
            pipe.stop()

    if "sharded" in modes:
        pipe = ShardedBatchPipeline(
            lambda: DetectionListLoader(build(), lst),
            workers=args.workers, depth=2, device=dev,
        ).start()
        # long enough that the workers' prefill (up to workers * (depth
        # + 1) batches) cannot carry the steady-state half
        n_steps = max(args.steps, 4 * args.workers * 3)
        try:
            rows.append(report(f"sharded:{args.workers}", run_steps(
                step, take(iter(pipe), n_steps)), ceiling))
        finally:
            pipe.stop()

    if "raw" in modes:
        rec = os.path.join(outdir, f"train_{args.size}_n{args.images}.bcrd")
        if not os.path.exists(rec):
            # one offline pass: decode and letterbox into raw records
            records_from_loader(DetectionListLoader(build(), lst), rec,
                                args.images)
        aug = {"random_fliph": 1, "min_contrast": 0.8, "max_contrast": 1.2,
               "min_brightness": -30, "max_brightness": 30}
        step_aug = make_train_step(build(), device_augment=aug)
        # host work: one uint8 gather a batch; augmentation and the
        # [-1, 1] normalization run in the step on the card
        pipe = BatchPipeline(RawRecordLoader(build(), rec), depth=2,
                             device=dev)
        try:
            rows.append(report("raw+device-aug", run_steps(
                step_aug, take(iter(pipe), args.steps)), ceiling))
        finally:
            pipe.stop()

    print(f"\n({dev}) | feed | img/s sustained | img/s steady | ms/step "
          "| steady vs pure step |")
    print("|---|---|---|---|---|")
    for r in rows:
        eff = (f"{r['efficiency_steady']:.0%}"
               if "efficiency_steady" in r else "100%")
        print(f"| {r['feed']} | {r['img_s']} | {r['img_s_steady']} "
              f"| {r['ms_per_step']} | {eff} |")
    return rows


if __name__ == "__main__":
    main()
