"""bcnn-cl for the port: `python -m bcnn_tpu_torch.cli
<train|valid|predict|export> <conf> [model]`, the port of `bcnn_tpu.cli`
(src/cli/bcnn_cl.c).

  - general params from the [net]/[network] section
    (bcnn_cl_load_param :38-102): data_format, input_model,
    output_model, out_pred, eval_test, eval_period, save_model,
    num_pred, source_train/label_train, source_test/label_test, and the
    extension scan_steps (k loader batches a call);
  - train (bcnn_cl_train :104-146): max_batches iterations, a periodic
    eval by mode switch, checkpoints <output_model>_iter<i>.bcnnmodel;
  - predict (bcnn_cl_predict :148-250): num_pred/batch batches; raw
    floats to out_pred, or det_<b>.png with the boxes drawn for a
    detection net; `valid` on a detection list also prints mAP
    (metrics_det.map_eval).

  - export (beyond bcnn-cl, `bcnn_tpu/cli.py:293-342`): the PREDICT
    forward, or with --detect the detection program, as a
    `torch.export` artifact with the weights baked in (`deploy.py`), to
    --out or <output_model>.pt2; `deploy.load_exported` serves it.

It runs on the card unless the caller asks for the CPU
(`main(argv, device="cpu")`).
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .api import Session
from .config import load_net, parse_ini
from .graph import Net
from .serialization import save_weights
from .types import LayerType, LoaderType, Mode

_DATA_FORMATS = {
    "mnist": LoaderType.MNIST,
    "cifar10": LoaderType.CIFAR10,
    "classif": LoaderType.CLASSIFICATION_LIST,
    "classification": LoaderType.CLASSIFICATION_LIST,
    "reg": LoaderType.REGRESSION_LIST,
    "regression": LoaderType.REGRESSION_LIST,
    "detection": LoaderType.DETECTION_LIST,
}


@dataclass
class CliParam:
    """Mirror of bcnn_cl_param with its defaults (bcnn_cl.c:97-101)."""

    data_format: LoaderType = LoaderType.MNIST
    input_model: Optional[str] = None
    output_model: Optional[str] = None
    pred_out: Optional[str] = None
    eval_test: int = 0
    eval_period: int = 100
    save_model: int = 1000
    num_pred: int = 1
    train_input: Optional[str] = None
    path_train_label: Optional[str] = None
    test_input: Optional[str] = None
    path_test_label: Optional[str] = None
    scan_steps: int = 1  # extension: k loader batches a call


def load_cli_param(config_path: str) -> CliParam:
    p = CliParam()
    sections = parse_ini(config_path)
    for k, v in sections[0].keys:
        if k == "data_format":
            if v not in _DATA_FORMATS:
                raise ValueError(f"Invalid data_format {v!r}")
            p.data_format = _DATA_FORMATS[v]
        elif k == "input_model":
            p.input_model = v
        elif k == "output_model":
            p.output_model = v
        elif k == "out_pred":
            p.pred_out = v
        elif k == "eval_test":
            p.eval_test = int(v)
        elif k == "eval_period":
            p.eval_period = int(v)
        elif k == "save_model":
            p.save_model = int(v)
        elif k == "num_pred":
            p.num_pred = int(v)
        elif k == "source_train":
            p.train_input = v
        elif k == "label_train":
            p.path_train_label = v
        elif k == "source_test":
            p.test_input = v
        elif k == "label_test":
            p.path_test_label = v
        elif k == "scan_steps":
            p.scan_steps = int(v)
    p.num_pred = max(p.num_pred, 1)
    p.scan_steps = max(p.scan_steps, 1)
    p.eval_period = p.eval_period if p.eval_period > 0 else 100
    p.save_model = p.save_model if p.save_model > 0 else 1000
    return p


def predict(sess: Session, param: CliParam) -> float:
    """bcnn_cl_predict (bcnn_cl.c:148-250): num_pred/batch batches; raw
    floats to out_pred, or det_<b>.png with the truth boxes (green) and
    the detections (blue) drawn for a detection net."""
    net = sess.net
    err = 0.0
    n = max(1, param.num_pred // net.batch_size)
    is_detection = param.data_format == LoaderType.DETECTION_LIST
    f = (open(param.pred_out, "wt")
         if (param.pred_out and not is_detection) else None)
    try:
        for _ in range(n):
            if is_detection and param.pred_out:
                x, y = sess.loader.next_batch()
                _dump_detections(sess, x, y)
                _, loss = sess.predict_on_batch(x, y)
                err += float(loss)
                continue
            outs, loss = sess.predict_on_batch()
            err += float(loss)
            if f is not None:
                out = outs[0].float().cpu().numpy().reshape(
                    net.batch_size, -1)
                for row in out:
                    f.write(" ".join(f"{v:f}" for v in row) + "\n")
    finally:
        if f:
            f.close()
    return err / param.num_pred


def _draw_box(img, bx, by, bw, bh, color):
    """bcnn_draw_color_box equivalent; img HWC uint8, box relative xywh."""
    hh, ww = img.shape[:2]
    x0 = int(np.clip((bx - bw / 2) * ww, 0, ww - 1))
    x1 = int(np.clip((bx + bw / 2) * ww, 0, ww - 1))
    y0 = int(np.clip((by - bh / 2) * hh, 0, hh - 1))
    y1 = int(np.clip((by + bh / 2) * hh, 0, hh - 1))
    img[y0:y1, x0] = color
    img[y0:y1, x1] = color
    img[y0, x0:x1] = color
    img[y1, x0:x1] = color


def _dump_detections(sess: Session, x, y):
    """det_<b>.png dumps: truth boxes green, detections blue."""
    from . import bip

    net = sess.net
    w, h = net.tensors[0].w, net.tensors[0].h
    for b in range(net.batch_size):
        img = np.clip((x[b] + 1.0) * 127.5, 0, 255).astype(np.uint8)
        img = np.transpose(img, (1, 2, 0))
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        img = np.ascontiguousarray(img)
        for t in range(y.shape[1] // 5):
            bx, by_, bw, bh, _cls = y[b, t * 5: t * 5 + 5]
            if bw <= 0 or bh <= 0:
                continue
            _draw_box(img, bx, by_, bw, bh, (0, 255, 0))
        dets = sess.yolo_get_detections(x, w, h, w, h, thresh=0.5,
                                        batch_item=b)
        for d in dets:
            if d["objectness"] > 0:
                _draw_box(img, d["x"], d["y"], d["w"], d["h"], (0, 0, 255))
        bip.write_image(f"det_{b}.png", img)


def _print_yolo_stats(sess: Session, k: int = 1):
    """One diagnostics line a YOLO layer a TRAIN batch, as the reference
    prints them (bcnn_yolo.c:408-414); with k > 1 the stats of a scan
    come stacked a step."""
    stats = sess.last_yolo_stats
    if stats is None:
        return
    from .ops.yolo import format_yolo_stats

    for step in range(k):
        for layer in stats:
            d = {kk: v[step] for kk, v in layer.items()} if k > 1 else layer
            print(format_yolo_stats(d), file=sys.stderr)
    sess.last_yolo_stats = None


def _log(i, sum_error, param, net, dt, error_valid=None):
    msg = (f"iter-batches= {i} train-error= "
           f"{sum_error / (param.eval_period * net.batch_size):f} ")
    if error_valid is not None:
        msg += f"test-error= {error_valid:f} "
    print(msg + f"training-time= {dt:.3f} sec", file=sys.stderr)


def _eval(sess: Session, param: CliParam):
    if not param.eval_test:
        return None
    sess.set_mode(Mode.VALID)
    error_valid = predict(sess, param)
    sess.set_mode(Mode.TRAIN)
    return error_valid


def train(sess: Session, param: CliParam) -> float:
    """bcnn_cl_train (bcnn_cl.c:104-146): the reference's per-step loop;
    with scan_steps = k > 1 and every boundary aligned with k,
    `_train_scan_loop`."""
    net = sess.net
    nb_iter = net.learner.max_batches
    k = param.scan_steps
    if k > 1:
        if (param.eval_period % k or param.save_model % k or nb_iter % k
                or getattr(net, "remat", False)
                or int(getattr(net, "accum_steps", 1) or 1) > 1):
            print(f"scan_steps={k} needs aligned eval_period/save_model/"
                  "max_batches and no remat/accum_steps; using the "
                  "per-step loop", file=sys.stderr)
        else:
            return _train_scan_loop(sess, param, k)
    sum_error = 0.0
    t0 = time.time()
    for i in range(nb_iter):
        sum_error += float(sess.train_on_batch())
        _print_yolo_stats(sess)
        if i % param.eval_period == 0 and i > 0:
            dt = time.time() - t0
            _log(i, sum_error, param, net, dt, _eval(sess, param))
            t0 = time.time()
            sum_error = 0.0
        if i % param.save_model == 0 and i > 0 and param.output_model:
            save_weights(net, sess.params, sess.state,
                         f"{param.output_model}_iter{i}.bcnnmodel")
    return sum_error / (param.eval_period * net.batch_size)


def _train_scan_loop(sess: Session, param: CliParam, k: int) -> float:
    """k steps a call (Session.train_scan_on_batches), eval and save at
    every aligned boundary, as `bcnn_tpu.cli._train_scan_loop`: after
    exactly i completed steps, where the per-step loop evals after step
    INDEX i (i + 1 steps), so an _iter{i} checkpoint here holds i
    updates."""
    net = sess.net
    nb_iter = net.learner.max_batches
    sum_error = 0.0
    t0 = time.time()
    i = 0
    while i < nb_iter:
        sum_error += float(sess.train_scan_on_batches(k))
        _print_yolo_stats(sess, k)
        i += k
        if i % param.eval_period == 0 and i < nb_iter:
            dt = time.time() - t0
            _log(i, sum_error, param, net, dt, _eval(sess, param))
            t0 = time.time()
            sum_error = 0.0
        if i % param.save_model == 0 and i < nb_iter and param.output_model:
            save_weights(net, sess.params, sess.state,
                         f"{param.output_model}_iter{i}.bcnnmodel")
    return sum_error / (param.eval_period * net.batch_size)


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(prog="bcnn-cl")
    ap.add_argument("mode", choices=["train", "valid", "predict", "export"])
    ap.add_argument("config")
    ap.add_argument("model", nargs="?", default=None)
    ap.add_argument(
        "--out", default=None,
        help="export: artifact path (default <output_model>.pt2)")
    ap.add_argument(
        "--detect", action="store_true",
        help="export: the detection program instead of the forward")
    args = ap.parse_args(argv)
    if args.mode != "export" and (args.out or args.detect):
        ap.error("--out/--detect apply to export mode only")

    mode = {"train": Mode.TRAIN, "valid": Mode.VALID,
            "predict": Mode.PREDICT, "export": Mode.PREDICT}[args.mode]
    param = load_cli_param(args.config)
    net = Net(mode)
    load_net(net, args.config, args.model or param.input_model)
    if mode == Mode.TRAIN and any(n.type == LayerType.YOLOV3
                                  for n in net.nodes):
        # the reference prints the yolo diagnostics of every detection
        # training batch (bcnn_yolo.c:408-414)
        net.yolo_stats = True
    sess = Session(net, 0, device=device)

    if args.mode == "export":
        sess.compile_net()
        out = args.out or (param.output_model or "model") + ".pt2"
        try:
            sess.export_serving(out, detect=args.detect)
        except ValueError as e:
            print(f"export failed: {e}", file=sys.stderr)
            return 1
        print(f"Exported serving artifact to {out}", file=sys.stderr)
        return 0
    sess.set_data_loader(param.data_format, param.train_input,
                         param.path_train_label, param.test_input,
                         param.path_test_label)
    sess.compile_net()

    if mode == Mode.TRAIN:
        err = train(sess, param)
        if param.output_model:
            save_weights(net, sess.params, sess.state, param.output_model)
        print(f"Training ended, final error= {err:f}", file=sys.stderr)
    else:
        err = predict(sess, param)
        print(f"Average error= {err:f}", file=sys.stderr)
        if (args.mode == "valid"
                and param.data_format == LoaderType.DETECTION_LIST):
            # beyond bcnn-cl: mAP over the same num_pred images
            from .metrics_det import format_map, map_eval

            print(format_map(map_eval(sess, num_images=param.num_pred)),
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
