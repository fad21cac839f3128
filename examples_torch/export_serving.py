"""Deployment walkthrough on the PyTorch port, the counterpart of
examples/export_serving.py: build (or load) a model, export its serving
program as a self-contained `torch.export` artifact (`.pt2`, weights
baked in, the hand-written kernels as `bcnn_tpu_torch` ops in its
graph), then serve it with `deploy.load_exported`: no graph build,
config parse or weight handling at serve time.

Usage:
  python examples_torch/export_serving.py [--detect] [--out model.pt2]
      [--batch 8] [--size 416] [--weights W] [--device cuda|cpu]
Without --detect, exports the yolov3-tiny forward (its two heads); with
it, the whole detection program (forward, decode, on-device NMS). The
served outputs are compared with the live session's on the same input.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def main(argv=None, weights=None):
    """Returns {"out", "mb", "export_s", "load_s", "first_call_s",
    "shapes", "outputs" (the served), "live" (the session's),
    "bit_equal"}. `weights`: bcnn_tpu-layout numpy dicts in place of the
    seeded init."""
    from examples_torch._common import add_device, data_dir, device, \
        seed_weights, sync

    ap = argparse.ArgumentParser()
    ap.add_argument("--detect", action="store_true",
                    help="export the whole detection program")
    ap.add_argument("--out", default=None,
                    help="the artifact (default bcnn_model.pt2 in the "
                    "temporary directory)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--weights", default=None,
                    help=".bcnnmodel or Darknet .weights to bake in")
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)
    out_path = args.out or os.path.join(data_dir("bcnn_export"),
                                        "bcnn_model.pt2")

    import torch

    from bcnn_tpu_torch import Mode, Session
    from bcnn_tpu_torch.deploy import default_outputs, load_exported
    from bcnn_tpu_torch.models import yolov3_tiny

    net = yolov3_tiny(batch_size=args.batch, width=args.size,
                      height=args.size, mode=Mode.PREDICT)
    sess = seed_weights(Session(net, seed=0, device=dev), weights)
    sess.compile_net()
    if args.weights:
        sess.load_weights(args.weights)

    t0 = time.time()
    sess.export_serving(out_path, detect=args.detect, platforms=(dev.type,))
    t_export = time.time() - t0
    mb = os.path.getsize(out_path) / 1e6
    print(f"exported {'detect pipeline' if args.detect else 'forward'} for "
          f"{dev.type} -> {out_path} ({mb:.1f} MB, {t_export:.1f} s)")

    # -- serve side: no Net, Session or config needed --------------------
    t0 = time.time()
    served = load_exported(out_path)
    t_load = time.time() - t0
    x = torch.as_tensor(np.random.RandomState(0).rand(
        args.batch, 3, args.size, args.size).astype(np.float32), device=dev)
    t0 = time.time()
    out = served(x)
    sync(dev)
    t_first = time.time() - t0
    shapes = [tuple(o.shape) for o in out]
    print(f"load {t_load:.2f} s; first call {t_first:.2f} s; outputs: "
          f"{shapes}")

    if args.detect:
        live = sess.detect_on_batch(x, thresh=0.5, max_dets=100)
    else:
        live, _ = sess.predict_on_batch(x, outputs=default_outputs(net))
    same = all(torch.equal(a, b) for a, b in zip(out, live))
    print(f"served outputs {'bit-equal to' if same else 'differ from'} the "
          "live session's")
    return {"out": out_path, "mb": mb, "export_s": t_export,
            "load_s": t_load, "first_call_s": t_first, "shapes": shapes,
            "outputs": out, "live": live, "bit_equal": same}


if __name__ == "__main__":
    main()
