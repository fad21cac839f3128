#!/usr/bin/env python3
"""Where the card's and the CPU's first training update part, held
against a float64 run of the same step (YOLOv3-tiny, or full YOLOv3).

    python3 tools/f3_float64.py
    python3 tools/f3_float64.py --net yolov3
    python3 tools/f3_float64.py --cpu-only --batch 2 --size 64

Rebuilds chip_smoke.py's phase 9 first step: the seeded detection set of
PNGs, a Darknet .weights file of He-scaled YOLOv3-tiny parameters from
the same seed, and the conf on examples/yolo/yolov3-tiny.cfg's layers
(batch 32, 416 px), in a temporary directory; takes the loader's first
batch once, so every run reads the same bytes. Runs that step's forward
and backward from the same weights three times: on the CPU in float64,
on the CPU in float32, and on the card in float32 with TF32 off (the
port's conv turns it off; matmuls keep PyTorch's default, off). Each
run's gradients go through one SGD update (`replay.sgd_update`:
`learner.apply_updates` in float32 from a fresh optimizer state), and
the tool prints:

  - per parameter, the card's and the CPU's error against the float64
    update, as a share of that update's largest entry;
  - per node, from the last to the first (the backward's order), the same
    errors of the gradient reaching the node's output, and of the output
    itself, so the first layer where the card leaves the CPU shows;
  - the max-pool windows that pick another input than in float64, the
    RELU/LRELU units on the other side of their kink, and the YOLO
    deltas that jump (another ignore or anchor choice), per run;
  - each fp32 run's update also against a float64 run that takes that
    run's own kink sides and max-pool picks (`bcnn_tpu_torch.replay`),
    which parts from it by rounding only.

With --net yolov3 the step is instead phase 10's card-vs-CPU step: full
YOLOv3 (examples/yolo/yolov3.cfg, He-scaled seeded weights, each
residual branch's BN scales times 0.1) at batch 2, 416 px, on a seeded
fp32 batch. The last line is one JSON object with the per-parameter
errors. --cpu-only skips the card (a rehearsal at a small --batch and --size);
without it, a machine with no CUDA fails. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from bcnn_tpu_torch import bridge, replay  # noqa: E402
from bcnn_tpu_torch.models import yolov3, yolov3_tiny  # noqa: E402
from bcnn_tpu_torch.serialization import save_weights_darknet  # noqa: E402
from bcnn_tpu_torch.types import LayerType, Mode  # noqa: E402


def run(net, params, state, x, lab, dev, dtype, choices=None):
    """One TRAIN step on `dev` in `dtype` (`replay.sgd_update`, under
    `replay.impose(choices)` if given): (the update of each parameter,
    {node: (output, gradient at it)}, {yolo node: delta}, the choices the
    run made), all on the CPU."""
    outs = {i: n.dst[0] for i, n in enumerate(net.nodes)
            if n.type != LayerType.YOLOV3}
    heads = {i: n.src[0] for i, n in enumerate(net.nodes)
             if n.type == LayerType.YOLOV3}
    made = replay.Choices()
    update, ex = replay.sgd_update(
        net, params, state, {"input": x, "label": lab}, dtype, dev,
        replay.impose(choices) if choices else replay.record(made),
        retain=list(outs.values()) + list(heads.values()))

    def grad(t):
        v = ex.values[t]
        return None if v.grad is None else v.grad.cpu().double()

    nodes = {i: (ex.values[t].detach().cpu().double(), grad(t))
             for i, t in outs.items()}
    deltas = {i: grad(t) for i, t in heads.items()}
    return ({k: v.double() for k, v in update.items()}, nodes, deltas,
            choices or made)


def phase9_step(batch, size):
    """(net, params, state, x, label) of chip_smoke.py phase 9's first
    step: the seeded detection set, the .weights file and the conf
    written into a temporary directory, the loader's first batch."""
    rng = np.random.RandomState(cs.SEED + 9)  # phase 9's draws
    with tempfile.TemporaryDirectory() as tmp:
        lst = cs.write_detection_set(tmp, rng)
        net = yolov3_tiny(cs.TRAIN_BATCH, cs.SIZE, cs.SIZE, cs.CLASSES,
                          mode=Mode.TRAIN)
        p, s = bridge.params_from_numpy(
            net, *bridge.he_numpy_weights(net, cs.SEED))
        weights = os.path.join(tmp, "tiny.weights")
        save_weights_darknet(net, p, s, weights)
        conf = cs.tiny_conf(tmp, lst, weights, batch=batch, size=size)
        sess = cs.conf_session(conf, "cpu")
        xb, yb = sess.loader.next_batch()
    return (sess.net, sess.params, sess.state, torch.from_numpy(xb),
            torch.from_numpy(yb))


def rel(a, ref):
    """max|a - ref| / max|ref| (0 where both are 0)."""
    scale = float(ref.abs().max())
    err = float((a - ref).abs().max())
    return err / scale if scale else err


def jumps(deltas, ref):
    """YOLO deltas that jump against `ref`'s, by head node: by more than
    chip_smoke.DELTA_JUMP plus DELTA_RTOL of their size (another ignore
    or anchor choice)."""
    return {i: int(((deltas[i] - d).abs() > cs.DELTA_JUMP
                    + cs.DELTA_RTOL * d.abs()).sum()) for i, d in ref.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", choices=("tiny", "yolov3"), default="tiny")
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 32 (tiny), 2 (yolov3)")
    ap.add_argument("--size", type=int, default=cs.SIZE)
    ap.add_argument("--cpu-only", action="store_true",
                    help="skip the card (a rehearsal)")
    args = ap.parse_args()
    if not args.cpu_only:
        if not torch.cuda.is_available():
            print("f3_float64: CUDA is not available", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip())

    if args.net == "tiny":
        args.batch = args.batch or cs.TRAIN_BATCH
        net, params, state, x, lab = phase9_step(args.batch, args.size)
    else:
        args.batch = args.batch or 2
        net = yolov3(args.batch, args.size, args.size, cs.CLASSES,
                     mode=Mode.TRAIN)
        params, state = bridge.params_from_numpy(
            net, *bridge.he_numpy_weights(
                net, cs.SEED, residual_scale=cs.RESIDUAL_SCALE))
        rng = np.random.RandomState(cs.SEED + 11)  # phase 10's draws
        x = torch.from_numpy((rng.rand(args.batch, 3, args.size, args.size)
                              * 2 - 1).astype(np.float32))
        lab = torch.from_numpy(cs.det_labels(rng, args.batch))
    print(f"the first step of {args.net}, batch {args.batch}, {args.size} "
          f"px, {cs.CLASSES} classes; torch {torch.__version__}")

    runs = {"f64": run(net, params, state, x, lab, "cpu", torch.float64),
            "cpu": run(net, params, state, x, lab, "cpu", torch.float32)}
    if not args.cpu_only:
        runs["card"] = run(net, params, state, x, lab, "cuda",
                           torch.float32)
    names = [k for k in runs if k != "f64"]
    u64, n64, d64, ch64 = runs["f64"]

    print("choices against float64: max-pool windows that pick another "
          "input, RELU/LRELU units on the other side of their kink, YOLO "
          "deltas that jump (by node, where any)")
    kinked, pooling = replay.kinked_nodes(net), replay.pooling_nodes(net)
    for r in names:
        ch = runs[r][3]
        pools = {i: int((a != b).sum()) for i, a, b in
                 zip(pooling, ch.picks, ch64.picks)}
        kinks = {i: int((a != b).sum()) for i, a, b in
                 zip(kinked, ch.kinks, ch64.kinks)}
        print(f"  {r:5s} pools { {i: n for i, n in pools.items() if n} }  "
              f"kinks { {i: n for i, n in kinks.items() if n} } "
              f"({sum(kinks.values())} units)  yolo "
              f"{jumps(runs[r][2], d64)}")

    print("per node, last to first: error of the gradient at its output "
          "and of the output, as a share of the float64 one's largest "
          "entry")
    print(f"  {'node':>4s} {'type':16s} "
          + "".join(f"{'grad ' + r:>12s}" for r in names)
          + "".join(f"{'out ' + r:>12s}" for r in names))
    for i in sorted(n64, reverse=True):
        v64, g64 = n64[i]
        ge = [rel(runs[r][1][i][1], g64) if g64 is not None else None
              for r in names]
        oe = [rel(runs[r][1][i][0], v64) for r in names]
        print(f"  {i:4d} {net.nodes[i].type.name:16s} "
              + "".join(f"{e:12.3g}" if e is not None else f"{'-':>12s}"
                        for e in ge)
              + "".join(f"{e:12.3g}" for e in oe))

    replays = {}
    for r in names:
        replays[r] = run(net, params, state, x, lab, "cpu", torch.float64,
                         runs[r][3])
        print(f"  {r:5s} against the float64 replay of its choices: yolo "
              f"{jumps(runs[r][2], replays[r][2])}")
    print("per parameter: error of the update against float64, and against "
          "the float64 replay of the run's own choices, as a share of its "
          "largest entry")
    table = {}
    for k, ref in u64.items():
        if not float(ref.abs().max()):
            continue
        table[k] = {r: rel(runs[r][0][k], ref) for r in names}
        table[k].update({f"{r} replay": rel(runs[r][0][k], replays[r][0][k])
                         for r in replays})
    order = sorted(table, key=lambda k: -max(table[k].values()))
    for k in order:
        print(f"  {k:28s} " + "  ".join(f"{r} {e:.3g}"
                                        for r, e in table[k].items()))
    cols = list(next(iter(table.values())))
    worst = {r: max((table[k][r], k) for k in table) for r in cols}
    print("worst: " + "; ".join(f"{r} {e:.3g} in {k}"
                                for r, (e, k) in worst.items()))
    print("median: " + "; ".join(
        f"{r} {statistics.median(table[k][r] for k in table):.3g}"
        for r in cols))
    print(json.dumps({"batch": args.batch, "size": args.size,
                      "update_err_vs_f64": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
