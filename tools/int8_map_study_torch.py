"""int8 detection accuracy through the PyTorch port's serving path: the
counterpart of tools/int8_map_study.py. It loads a trained detector
checkpoint and scores held-out mAP@0.5 for

  fp32            the PREDICT path with bf16 convs (net.compute_dtype),
                  as the JAX study runs it; the stage keeps the JAX
                  study's name, `fp32`, though its convs take bf16
                  inputs (fp32 sums, fp32 activations between layers;
                  --compute fp32 runs them in fp32, and the fine-tune
                  too);
  PTQ int8 x3     absmax / percentile / KL calibration on training
                  batches (ops.quant.calibrate), the int8 activation
                  flow end to end: every conv on the K4 kernel;
  QAT int8        a short fake-quant fine-tune from the checkpoint
                  (net.qat, EMA ranges; SGD with momentum 0.9 at
                  --qat-lr, bf16 compute and activations, a random
                  horizontal flip on the card, make_train_scan with
                  K = 5), frozen by Session.freeze_qat into the same int8
                  serving path; `qat_fp32` scores the fine-tuned weights
                  on the fp32 path (the `qat_` state keys dropped), which
                  tells a fine-tune that hurt the model from a freeze
                  that did,

on the HELD-OUT record set of the learnable synthetic detection task
(examples_torch/train_throughput.write_dataset). The checkpoint may be
either package's `.npz` (`checkpoint.load_checkpoint` reads both).
Prints one JSON line with the JAX study's keys.

Usage (after examples_torch/train_soak.py wrote a checkpoint and the
record sets; --outdir is the soak's):
  python tools/int8_map_study_torch.py --ckpt DIR/ckpt_latest.npz \\
      --outdir DATA [--batch 256] [--qat-steps 150] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

THRESH, MAX_DETS = 0.005, 100
QAT_SCAN = 5


def map50_of(detect_fn, params, state, xb, yb):
    """mAP@0.5 of one detection batch against its record labels ((B,
    50*5) normalized [x, y, w, h, class]; the first x == 0 ends them),
    rounded to 4 places as the JAX study rounds it."""
    import torch

    from bcnn_tpu_torch.metrics_det import dets_to_rows, evaluate_detections

    with torch.inference_mode():
        bx, sc, _ = detect_fn(params, state, {"input": xb})
    bx, sc = bx.float().cpu().numpy(), sc.float().cpu().numpy()
    preds, gts = [], []
    for i in range(bx.shape[0]):
        preds.append(dets_to_rows(bx[i], sc[i]))
        lab = np.asarray(yb[i]).reshape(-1, 5)
        zero = np.nonzero(lab[:, 0] == 0)[0]
        gts.append((lab[: zero[0]] if len(zero) else lab).astype(np.float64))
    res = evaluate_detections(preds, gts, 80, iou_thresholds=(0.5,))
    return round(float(res["map50"]), 4)


def parse(argv=None):
    from examples_torch._common import add_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--outdir", default="/tmp/bcnn_tpu_det_data")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--images", type=int, default=512)
    ap.add_argument("--qat-steps", type=int, default=150)
    ap.add_argument("--qat-batch", type=int, default=64)
    ap.add_argument("--calib-batches", type=int, default=2)
    ap.add_argument("--calib-chunk", type=int, default=32)
    ap.add_argument("--qat-lr", type=float, default=1e-4,
                    help="fine-tune LR; the checkpoint is converged, so "
                         "the default is 10x below the from-scratch 1e-3")
    ap.add_argument("--qat-fliph", type=int, default=1,
                    help="the fine-tune's random horizontal flip (1, as "
                    "the JAX study; 0 makes the fine-tune draw nothing)")
    ap.add_argument("--stages", default="fp32,ptq,qat",
                    help="comma subset of fp32,ptq,qat")
    ap.add_argument("--compute", default="bf16", choices=["bf16", "fp32"],
                    help="the convs' inputs (and the fine-tune's "
                    "activations): bf16 as the JAX study, or fp32")
    add_device(ap)
    return ap.parse_args(argv)


def yolo_net(batch, size, mode, compute="bf16"):
    import torch

    from bcnn_tpu_torch.models import yolov3_tiny

    net = yolov3_tiny(batch_size=batch, width=size, height=size, mode=mode)
    net.compute_dtype = torch.bfloat16 if compute == "bf16" else None
    return net


def main(argv=None, trace=None):
    """Runs the study; returns the printed dict. trace: a dict that gets
    each stage's inputs and products (the eval batch, each method's
    activation scales and int8 weights, the QAT params and quant dict),
    for a caller that holds them to another implementation."""
    import torch

    from bcnn_tpu_torch import Mode, Session
    from bcnn_tpu_torch.checkpoint import load_checkpoint
    from bcnn_tpu_torch.compile import (child_generators, make_detect_fn,
                                        make_train_scan)
    from bcnn_tpu_torch.data import RawRecordLoader
    from bcnn_tpu_torch.ops.quant import calibrate, quantize_weights
    from examples_torch._common import device

    args = parse(argv)
    dev = device(args.device)
    trace = {} if trace is None else trace
    rec = os.path.join(args.outdir, f"soakl_{args.size}_n{args.images}.bcrd")
    erec = os.path.join(args.outdir,
                        f"soakl_eval_{args.size}_n{args.batch}.bcrd")
    for p in (rec, erec):
        if not os.path.exists(p):
            raise SystemExit(f"missing record set {p} (run train_soak first)")

    def tiny(batch, mode):
        return yolo_net(batch, args.size, mode, args.compute)

    params, state, _opt, _extra = load_checkpoint(
        tiny(args.batch, Mode.PREDICT), args.ckpt, dev)

    # batches: held-out eval + training calibration, normalized as in
    # training
    el = RawRecordLoader(tiny(args.batch, Mode.VALID), erec)
    xe_u8, ye = el.next_batch()
    el.close()
    xe = torch.as_tensor((xe_u8.astype(np.float32) - 127.5) / 127.5,
                         device=dev)
    trace["eval"] = (xe_u8, ye)
    # calibration batches stay small: calibrate runs the executor and
    # keeps every watched activation alive; the same image budget,
    # chunked (tools/int8_map_study.py:94-105)
    n_cal = args.calib_batches * args.batch
    tl = RawRecordLoader(tiny(args.calib_chunk, Mode.VALID), rec)
    calib = []
    for _ in range(n_cal // args.calib_chunk):
        xt, _yt = tl.next_batch()
        calib.append((xt.astype(np.float32) - 127.5) / 127.5)
    tl.close()

    results = {}
    stages = set(args.stages.split(","))

    def log(name):
        print(f"{name}: {results[name]}", file=sys.stderr, flush=True)

    net = tiny(args.batch, Mode.PREDICT)
    detect = make_detect_fn(net, thresh=THRESH, max_dets=MAX_DETS)
    if "fp32" in stages:
        results["fp32"] = map50_of(detect, params, state, xe, ye)
        log("fp32")

    trace["ptq"] = {}
    for method in ("absmax", "percentile", "kl") if "ptq" in stages else ():
        netq = tiny(args.batch, Mode.PREDICT)
        netq.quant = {
            "act_scales": calibrate(netq, params, state, calib,
                                    method=method),
            "weights": quantize_weights(netq, params),
        }
        trace["ptq"][method] = netq.quant
        detq = make_detect_fn(netq, thresh=THRESH, max_dets=MAX_DETS)
        results[f"ptq_{method}"] = map50_of(detq, params, state, xe, ye)
        log(f"ptq_{method}")

    if args.qat_steps > 0 and "qat" in stages:
        nett = tiny(args.qat_batch, Mode.TRAIN)
        nett.set_sgd_optimizer(learning_rate=args.qat_lr, momentum=0.9)
        nett.train_act_dtype = nett.compute_dtype
        nett.qat = True
        nett.device_augment = {"random_fliph": int(args.qat_fliph)}
        sess = Session(nett, seed=0, device=dev).compile_net()
        # the trained checkpoint over the QAT-initialized trees
        for k, v in params.items():
            sess.params[k] = v.clone()
        for k, v in state.items():
            if k in sess.state:
                sess.state[k] = v.clone()
        loader = RawRecordLoader(nett, rec)
        scan = make_train_scan(nett)
        p, s, o = sess.params, sess.state, sess.opt_state
        gen = torch.Generator().manual_seed(3)
        for _ in range(max(1, args.qat_steps // QAT_SCAN)):
            xs, ys = zip(*(loader.next_batch() for _ in range(QAT_SCAN)))
            batch = {"input": torch.as_tensor(np.stack(xs), device=dev),
                     "label": torch.as_tensor(np.stack(ys), device=dev)}
            (sub,) = child_generators(gen, 1)
            p, s, o, losses = scan(p, s, o, batch, sub)
        losses.float().cpu()  # the fine-tune's end
        loader.close()
        sess.params, sess.state, sess.opt_state = p, s, o
        quant = sess.freeze_qat()
        netf = tiny(args.batch, Mode.PREDICT)
        netf.quant = quant
        detf = make_detect_fn(netf, thresh=THRESH, max_dets=MAX_DETS)
        pf = dict(p)
        sf = {k: v for k, v in s.items() if not k.startswith("qat_")}
        trace["qat"] = {"params": pf, "state": s, "quant": quant}
        # the fine-tuned weights on the fp32 path: "the fine-tune damaged
        # the model" apart from "the freeze / int8 path damaged it"
        results["qat_fp32"] = map50_of(detect, pf, sf, xe, ye)
        log("qat_fp32")
        results["qat_int8"] = map50_of(detf, pf, sf, xe, ye)
        log("qat_int8")

    out = {
        "study": "int8_detection_map50_held_out",
        "eval_images": int(args.batch),
        "ckpt": args.ckpt,
        **results,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
