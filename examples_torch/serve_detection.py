"""A detection serving loop on the PyTorch port, the counterpart of
examples/serve_detection.py.

A background host thread decodes and letterboxes images and copies each
batch to the card (`data.BatchPipeline`: pinned copies on a side
stream), while the card runs the detection program (forward, top-k-first
decode, on-device NMS: `Session.detect_on_batch`); only boxes and scores
come back to the host. bf16 compute by default, as the JAX example
serves; --fp32 serves in fp32.

Usage:
  python examples_torch/serve_detection.py [list.txt] [--batch 16] [--steps 10]
      [--size 416] [--thresh 0.5] [--fp32] [--device cuda|cpu]
where list.txt lines are image paths (the detection-list format is
accepted too). Without a list, 32 synthetic images are written.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def synth_images(n=32, outdir=None):
    """n noise images (240x320) as PNGs and their list file, from
    np.random.RandomState(0) as examples/serve_detection.py draws them."""
    from bcnn_tpu_torch import bip
    from examples_torch._common import data_dir

    outdir = outdir or data_dir("bcnn_serve")
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.RandomState(0)
    paths = []
    for i in range(n):
        img = (rng.rand(240, 320, 3) * 255).astype(np.uint8)
        p = os.path.join(outdir, f"im{i}.png")
        bip.write_image(p, img)
        paths.append(p)
    lst = os.path.join(outdir, "list.txt")
    with open(lst, "w") as f:
        f.writelines(p + "\n" for p in paths)
    return lst


class _DetectionFeed:
    """Minimal loader adapter: images only (no labels), letterboxed."""

    def __init__(self, net, list_path):
        from bcnn_tpu_torch import bip

        self.net = net
        self.bip = bip
        with open(list_path) as f:
            self.paths = [line.split()[0] for line in f if line.strip()]
        self.i = 0

    def next_batch(self):
        t0 = self.net.tensors[0]
        xs = np.empty((self.net.batch_size, t0.c, t0.h, t0.w), np.float32)
        for b in range(self.net.batch_size):
            p = self.paths[self.i % len(self.paths)]
            self.i += 1
            img = self.bip.load_image(p)
            if img.shape[2] == 1:
                img = np.repeat(img, 3, axis=2)
            h, w, _ = img.shape
            if t0.w / w < t0.h / h:
                nw, nh = t0.w, (h * t0.w) // w
            else:
                nh, nw = t0.h, (w * t0.h) // h
            resized = self.bip.resize_bilinear(img, nw, nh)
            canvas = np.full((t0.h, t0.w, 3), 128, np.uint8)
            dx, dy = (t0.w - nw) // 2, (t0.h - nh) // 2
            self.bip.crop_image(resized, -dx, -dy, t0.w, t0.h, out=canvas)
            xs[b] = np.transpose(
                (canvas.astype(np.float32) - 127.5) / 127.5, (2, 0, 1)
            )
        return xs, np.zeros((self.net.batch_size, 1), np.float32)


def main(argv=None, weights=None):
    """Returns {"images", "seconds", "img_s", "detections", "first": the
    warm-up batch's (boxes, scores, objectness) on the host}.
    `weights`: bcnn_tpu-layout numpy dicts in place of the seeded init."""
    from examples_torch._common import add_device, device, seed_weights, \
        sync

    ap = argparse.ArgumentParser()
    ap.add_argument("list", nargs="?", default=None)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--thresh", type=float, default=0.5)
    ap.add_argument("--fp32", action="store_true",
                    help="serve in fp32 (default: bf16 compute)")
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)

    import torch

    from bcnn_tpu_torch import Mode, Session
    from bcnn_tpu_torch.data import BatchPipeline
    from bcnn_tpu_torch.models import yolov3_tiny

    lst = args.list or synth_images()
    net = yolov3_tiny(batch_size=args.batch, width=args.size,
                      height=args.size, mode=Mode.PREDICT)
    if not args.fp32:
        net.compute_dtype = torch.bfloat16
    sess = seed_weights(Session(net, seed=0, device=dev), weights)
    sess.compile_net()

    pipe = BatchPipeline(_DetectionFeed(net, lst), depth=2,
                         device=dev).start()
    it = iter(pipe)
    try:
        x, _ = next(it)  # warm-up
        first = tuple(t.cpu() for t in
                      sess.detect_on_batch(x, thresh=args.thresh))
        t0 = time.time()
        total_dets = 0
        for _ in range(args.steps):
            x, _ = next(it)  # already on the device (BatchPipeline)
            _, _, obj = sess.detect_on_batch(x, thresh=args.thresh)
            total_dets += int((obj > 0).sum())
        sync(dev)
        dt = time.time() - t0
    finally:
        pipe.stop()
    n_imgs = args.steps * args.batch
    print(f"served {n_imgs} images in {dt:.2f}s -> {n_imgs / dt:.0f} img/s "
          f"({total_dets} detections) on {dev}")
    return {"images": n_imgs, "seconds": dt, "img_s": n_imgs / dt,
            "detections": total_dets, "first": first}


if __name__ == "__main__":
    main()
