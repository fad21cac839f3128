"""Sustained training soak on the PyTorch port, the counterpart of
examples/train_soak.py: the whole-run number, not the burst number.

It runs the production loop (the reference's bcnn_cl.c:104-146: loop
batches, print the loss, evaluate and checkpoint now and then) for many
steps and reports what a burst of steps cannot show:
  - the whole-run img/s, everything included: the first dispatch's
    warm-up, staging, the eval and checkpoint cadence, a resume;
  - the dispatch-time percentiles over the whole run;
  - the card's memory at every --mem-every dispatches (it must not
    grow);
  - a kill at any instant and `--resume`: checkpoints are written to a
    temporary file and renamed (os.replace), so a SIGKILL leaves the
    last one loadable.

The feed: raw uint8 records (decoded and letterboxed once, offline), K
batches a dispatch trained by one `make_train_scan` call with the
augmentation and normalization on the card (`net.device_augment`;
--rotation adds the three-shear rotation, the K2 kernel). The batches
come through `data.BatchPipeline` (pinned copies on a side stream), and
the loop reads back only the previous dispatch's losses, so the host
stages dispatch k+1 while the card runs dispatch k.

`--feed resident` uploads the record set to the card once and sends a
(K, B) index a dispatch (`make_train_scan_resident`), in a per-epoch
shuffled order (`EpochIndexStream`), or in the stream feed's own order
with --sequential. Checkpoints hold the loader position and the state
of the torch generator every draw comes from (augmentation included), so
a resume continues exactly, on either feed; a stream segment can resume
as a resident one. They are `bcnn_tpu`'s `.npz` (`checkpoint.py`): a
checkpoint written by examples/train_soak.py resumes here with its
params, optimizer state, step and loader position, but its JAX key
cannot be continued, so the augmentation draws after such a resume are
the port's own.

Usage:
  python examples_torch/train_soak.py --steps 5000 --batch 256 --scan 5 \
      --dir DIR --pidfile DIR/pid                # segment 1 (kill it)
  python examples_torch/train_soak.py --steps 5000 --batch 256 --scan 5 \
      --dir DIR --resume [--feed resident]      # finishes
  python examples_torch/train_soak.py --dir DIR --report
All take --device cuda|cpu (default cuda); --deterministic runs cuDNN's
deterministic algorithms (a resume then ends bit-equal to an
uninterrupted run).
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


def log_event(path, ev, **kw):
    kw["ev"] = ev
    kw["t"] = time.time()
    with open(path, "a") as f:
        f.write(json.dumps(kw) + "\n")


def atomic_checkpoint(path, net, params, state, opt_state, extra):
    """A kill can land mid-write: write to a temporary file, then rename
    (atomic on POSIX), so the latest checkpoint is always loadable."""
    from bcnn_tpu_torch.checkpoint import save_checkpoint

    tmp = path + ".tmp.npz"
    save_checkpoint(net, tmp, params, state, opt_state, extra=extra)
    os.replace(tmp, path)


def device_mem(dev):
    """The card's allocated bytes now, their peak and the card's total;
    None on the CPU."""
    import torch

    if dev.type != "cuda":
        return None
    return {"bytes_in_use": int(torch.cuda.memory_allocated(dev)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
            "bytes_limit": int(torch.cuda.mem_get_info(dev)[1])}


def build_net(args, mode):
    import torch

    from bcnn_tpu_torch import Mode
    from bcnn_tpu_torch.models import yolov3_tiny

    net = yolov3_tiny(batch_size=args.batch, width=args.size,
                      height=args.size, mode=Mode.TRAIN if mode == "train"
                      else Mode.VALID)
    net.compute_dtype = torch.bfloat16
    if args.act == "bf16":
        net.train_act_dtype = torch.bfloat16
        net.act_dtype = torch.bfloat16
    return net


def make_records(args):
    """Synthetic detection data -> raw records, train and held-out eval
    (one offline decode + letterbox pass, reused across segments)."""
    from bcnn_tpu_torch.data import DetectionListLoader, records_from_loader
    from examples_torch.train_throughput import write_dataset

    os.makedirs(args.outdir, exist_ok=True)
    rec = os.path.join(args.outdir, f"soakl_{args.size}_n{args.images}.bcrd")
    erec = os.path.join(args.outdir,
                        f"soakl_eval_{args.size}_n{args.batch}.bcrd")
    if not os.path.exists(rec):
        lst = write_dataset(args.outdir, args.images, args.src_size,
                            int(args.src_size * 0.75))
        records_from_loader(
            DetectionListLoader(build_net(args, "valid"), lst), rec,
            args.images)
    if not os.path.exists(erec):
        # a directory of its own: write_dataset reuses a list by (n, source
        # size), and the eval images must not be the training ones
        edir = os.path.join(args.outdir, "eval")
        os.makedirs(edir, exist_ok=True)
        elst = write_dataset(edir, args.batch, args.src_size,
                             int(args.src_size * 0.75), seed=999)
        records_from_loader(
            DetectionListLoader(build_net(args, "valid"), elst), erec,
            args.batch)
    return rec, erec


def _map50(boxes, scores, labels):
    """mAP@0.5 of one detection batch against record labels ((B, 50*5)
    normalized [x, y, w, h, class], the first x == 0 ends them)."""
    from bcnn_tpu_torch.metrics_det import dets_to_rows, evaluate_detections

    preds, gts = [], []
    for i in range(boxes.shape[0]):
        preds.append(dets_to_rows(boxes[i], scores[i]))
        lab = np.asarray(labels[i]).reshape(-1, 5)
        zero = np.nonzero(lab[:, 0] == 0)[0]
        gts.append((lab[: zero[0]] if len(zero) else lab).astype(
            np.float64))
    res = evaluate_detections(preds, gts, 80, iou_thresholds=(0.5,))
    return float(res["map50"])


def _generator_from(extra, seed):
    """The torch generator a checkpoint's draws continue from: its saved
    state, or, for a checkpoint of examples/train_soak.py (a JAX key,
    which torch cannot continue), one seeded from `seed` and that key."""
    import torch

    gen = torch.Generator()
    if "rng_torch" in extra:
        gen.set_state(torch.frombuffer(
            bytearray(bytes.fromhex(extra["rng_torch"])), dtype=torch.uint8))
        return gen
    key = [int(v) for v in np.ravel(extra.get("rng", []))]
    return gen.manual_seed(int(np.random.SeedSequence(
        [seed] + key).generate_state(1)[0]))


def run(args, weights=None):
    """One segment; returns the report over every segment logged in
    args.dir."""
    import torch

    from bcnn_tpu_torch import Mode, Session
    from bcnn_tpu_torch.checkpoint import load_checkpoint
    from bcnn_tpu_torch.compile import (child_generators, execute, get_loss,
                                        make_train_scan)
    from bcnn_tpu_torch.data import BatchPipeline, RawRecordLoader
    from examples_torch._common import device, seed_weights

    dev = device(args.device)
    os.makedirs(args.dir, exist_ok=True)
    logp = os.path.join(args.dir, "soak_log.jsonl")
    ckpt = os.path.join(args.dir, "ckpt_latest.npz")
    if args.pidfile:
        with open(args.pidfile, "w") as f:
            f.write(str(os.getpid()))

    rec, erec = make_records(args)
    aug = {"random_fliph": 1, "min_contrast": 0.8, "max_contrast": 1.2,
           "min_brightness": -30, "max_brightness": 30}
    if args.rotation:
        # box-aware rotation on the card: the three-shear chain (K2)
        aug["rotation_range"] = float(args.rotation)
    net = build_net(args, "train")
    net.device_augment = aug
    sess = seed_weights(Session(net, seed=0, device=dev), weights)
    sess.compile_net()
    params, state, opt = sess.params, sess.state, sess.opt_state

    loader = RawRecordLoader(net, rec)
    gen = torch.Generator().manual_seed(args.seed)
    start_step = 0  # in scan dispatches
    resume_pos = None
    if args.resume:
        if not os.path.exists(ckpt):
            raise SystemExit(f"--resume: no checkpoint at {ckpt}")
        params, state, opt, extra = load_checkpoint(net, ckpt, dev)
        start_step = int(extra["dispatch"])
        gen = _generator_from(extra, args.seed)
        resume_pos = int(extra["loader_pos"])

    eval_batch = None  # staged at the first eval point
    detect_fn = None  # built at the first --eval-map point
    map_batches = None

    K, B = args.scan, args.batch
    n_disp = args.steps // K
    log_event(logp, "seg", start=start_step, target=n_disp,
              batch=B, scan=K, resume=bool(args.resume),
              act=args.act, feed=args.feed, pid=os.getpid())

    pipe = None
    if args.feed == "resident":
        # the records live on the card; a dispatch sends a (K, B) index.
        # Positions are absolute sample counters in both feeds, so a
        # cross-feed resume continues params, optimizer and generator;
        # the sample order is the stream's only with --sequential
        from bcnn_tpu_torch.compile import make_train_scan_resident
        from bcnn_tpu_torch.data import EpochIndexStream

        xa, ya = loader.read_all()
        dataset = {"input": torch.as_tensor(xa, device=dev),
                   "label": torch.as_tensor(ya, device=dev)}
        stream = EpochIndexStream(loader.n, B, seed=args.seed,
                                  shuffle=not args.sequential)
        if resume_pos is not None:
            stream.pos = resume_pos
        rscan = make_train_scan_resident(net)

        def stage():
            return torch.as_tensor(stream.next(K), dtype=torch.int64,
                                   device=dev)

        def dispatch(params, state, opt, staged, sub):
            return rscan(params, state, opt, dataset, staged, sub)

        def get_pos():
            return stream.pos
    else:
        if resume_pos is not None:
            loader._set_pos(resume_pos % loader.n)
        pos0, consumed = loader._get_pos(), [0]
        scan = make_train_scan(net)
        pipe = BatchPipeline(loader, depth=2, device=dev).start()
        batches = iter(pipe)

        def stage():
            xs, ys = zip(*(next(batches) for _ in range(K)))
            consumed[0] += K
            return {"input": torch.stack(xs), "label": torch.stack(ys)}

        def dispatch(params, state, opt, staged, sub):
            return scan(params, state, opt, staged, sub)

        def get_pos():
            # the pipeline's loader runs ahead: count what was consumed
            return (pos0 + consumed[0] * B) % loader.n

    def read(losses):
        return losses.float().cpu().numpy()  # a full sync

    def checkpoint_now(i):
        atomic_checkpoint(ckpt, net, params, state, opt, extra={
            "dispatch": int(i),
            "loader_pos": int(get_pos()),
            "rng_torch": gen.get_state().numpy().tobytes().hex(),
        })

    pending = None  # (dispatch index, losses on the device)
    t_sync_prev = None
    i = start_step
    first = True
    t_loop0 = time.perf_counter()
    try:
        while i < n_disp:
            batch = stage()
            (sub,) = child_generators(gen, 1)
            params, state, opt, losses = dispatch(params, state, opt, batch,
                                                  sub)
            i += 1
            if pending is not None:
                pi, pl = pending
                lv = read(pl)
                now = time.perf_counter()
                if t_sync_prev is not None:
                    log_event(logp, "d", i=pi,
                              dt=round(now - t_sync_prev, 6),
                              loss=round(float(lv.mean()), 4))
                t_sync_prev = now
            pending = (i, losses)
            if first:
                # the first dispatch carries the warm-up; sync it alone
                read(losses)
                t0 = time.perf_counter()
                log_event(logp, "compile", i=i, sec=round(t0 - t_loop0, 3))
                t_sync_prev = t0
                pending = None
                first = False
                m = device_mem(dev)
                if m:
                    log_event(logp, "mem", i=i, **m)

            if i % args.mem_every == 0:
                m = device_mem(dev)
                if m:
                    log_event(logp, "mem", i=i, **m)
            if args.eval_every and i % args.eval_every == 0:
                # drain the pipeline so that eval time is not a step's
                if pending is not None:
                    read(pending[1])
                    log_event(logp, "d", i=pending[0], dt=None, loss=None)
                    pending = None
                te = time.perf_counter()
                if eval_batch is None:
                    el = RawRecordLoader(net, erec)
                    xe, ye = el.next_batch()
                    el.close()
                    eval_batch = {
                        "input": torch.as_tensor(
                            (xe.astype(np.float32) - 127.5) / 127.5,
                            device=dev),
                        "label": torch.as_tensor(ye, device=dev),
                    }
                # the held-out loss in TRAIN mode without an update: the
                # YOLO cost exists in TRAIN mode only, in the reference too
                # (bcnn_yolo.c:250)
                with torch.no_grad():
                    ev = float(get_loss(execute(net, params, state,
                                                eval_batch, Mode.TRAIN, 0)))
                log_event(logp, "eval", i=i, loss=round(ev, 4),
                          sec=round(time.perf_counter() - te, 4))
                t_sync_prev = time.perf_counter()
            if args.eval_map and i % args.eval_map == 0:
                if pending is not None:
                    read(pending[1])
                    log_event(logp, "d", i=pending[0], dt=None, loss=None)
                    pending = None
                tm = time.perf_counter()
                if detect_fn is None:
                    from bcnn_tpu_torch.compile import make_detect_fn

                    # the detection program runs the forward in PREDICT,
                    # so the TRAIN net serves as it is
                    detect_fn = make_detect_fn(net, thresh=0.005,
                                               max_dets=100)
                    map_batches = {}
                    for tag, path in (("val", erec), ("train", rec)):
                        ml = RawRecordLoader(net, path)
                        xm, ym = ml.next_batch()
                        ml.close()
                        map_batches[tag] = ({"input": torch.as_tensor(
                            (xm.astype(np.float32) - 127.5) / 127.5,
                            device=dev)}, ym)
                ent = {}
                for tag, (mb, ym) in map_batches.items():
                    with torch.inference_mode():
                        bx, sc, _o = detect_fn(params, state, mb)
                    ent[tag] = round(_map50(bx.float().cpu().numpy(),
                                            sc.float().cpu().numpy(), ym), 4)
                log_event(logp, "eval_map", i=i, map50_val=ent["val"],
                          map50_train=ent["train"],
                          sec=round(time.perf_counter() - tm, 4))
                t_sync_prev = time.perf_counter()
            if args.ckpt_every and i % args.ckpt_every == 0:
                if pending is not None:
                    read(pending[1])
                    log_event(logp, "d", i=pending[0], dt=None, loss=None)
                    pending = None
                tc = time.perf_counter()
                checkpoint_now(i)
                log_event(logp, "ckpt", i=i,
                          sec=round(time.perf_counter() - tc, 4))
                t_sync_prev = time.perf_counter()

        if pending is not None:
            lv = read(pending[1])
            now = time.perf_counter()
            if t_sync_prev is not None:
                log_event(logp, "d", i=pending[0],
                          dt=round(now - t_sync_prev, 6),
                          loss=round(float(lv.mean()), 4))
    finally:
        if pipe is not None:
            pipe.stop()
    m = device_mem(dev)
    if m:
        log_event(logp, "mem", i=i, **m)
    checkpoint_now(i)
    log_event(logp, "seg_end", i=i)
    out = report(args)
    print(json.dumps(out))
    return out


def report(args):
    """Aggregate soak_log.jsonl across ALL segments (a killed segment has
    no seg_end; its wall time runs to its last logged event)."""
    logp = os.path.join(args.dir, "soak_log.jsonl")
    segs, cur = [], None
    events = [json.loads(ln) for ln in open(logp) if ln.strip()]
    for e in events:
        if e["ev"] == "seg":
            if cur:
                segs.append(cur)
            cur = {"t0": e["t"], "t1": e["t"], "start": e["start"],
                   "batch": e["batch"], "scan": e["scan"], "d": [],
                   "compile_s": 0.0, "eval": [], "ckpt": [], "mem": [],
                   "last": e["start"], "feed": e.get("feed", "stream")}
            continue
        if cur is None:
            continue
        cur["t1"] = e["t"]
        if e["ev"] == "d":
            cur["last"] = max(cur["last"], e["i"])
            if e.get("dt") is not None:
                cur["d"].append(e["dt"])
        elif e["ev"] == "eval":
            cur["eval"].append(e)
        elif e["ev"] == "eval_map":
            cur.setdefault("eval_map", []).append(e)
        elif e["ev"] == "ckpt":
            cur["ckpt"].append(e["sec"])
        elif e["ev"] == "mem":
            cur["mem"].append(e)
        elif e["ev"] == "seg_end":
            cur["last"] = max(cur["last"], e["i"])
    if cur:
        segs.append(cur)
    if not segs:
        raise SystemExit("no segments logged")
    batch, scan = segs[0]["batch"], segs[0]["scan"]
    wall = sum(s["t1"] - s["t0"] for s in segs)
    # useful progress = the final segment's last dispatch: work done
    # between the last checkpoint and a kill is REDONE by --resume, and
    # the whole-run rate must not count it twice (its wall time counts)
    steps = segs[-1]["last"] * scan
    lost = sum(max(0, a["last"] - b["start"])
               for a, b in zip(segs, segs[1:])) * scan
    dts = np.asarray(sum((s["d"] for s in segs), []))
    mems = sum((s["mem"] for s in segs), [])
    evals = sum((s["eval"] for s in segs), [])
    maps = sum((s.get("eval_map", []) for s in segs), [])
    per_step = dts / scan * 1e3
    out = {
        "steps": int(steps),
        "steps_redone_after_kill": int(lost),
        "batch": batch,
        "scan": scan,
        "segments": len(segs),
        "compile_s": [round(e["sec"], 1) for e in events
                      if e["ev"] == "compile" and "sec" in e],
        "wall_s": round(wall, 1),
        "img_s_whole_run": round(steps * batch / wall, 1) if wall else None,
        "img_s_steady": int(round(float(
            batch * scan * len(dts) / dts.sum()))) if len(dts) else None,
        "step_ms_p50": round(float(np.percentile(per_step, 50)), 1)
        if len(dts) else None,
        "step_ms_p90": round(float(np.percentile(per_step, 90)), 1)
        if len(dts) else None,
        "step_ms_p99": round(float(np.percentile(per_step, 99)), 1)
        if len(dts) else None,
        "step_ms_max": round(float(per_step.max()), 1)
        if len(dts) else None,
        "eval_n": len(evals),
        "eval_first_last_loss": [evals[0]["loss"], evals[-1]["loss"]]
        if evals else None,
        # the generalization trajectory (held-out mAP over training):
        # [dispatch, val, train] triples, thinned to <= 20 points
        "map50_trajectory": [
            [e["i"], e["map50_val"], e["map50_train"]]
            for e in maps[:: max(1, len(maps) // 20)]
        ] if maps else None,
        "map50_val_last": maps[-1]["map50_val"] if maps else None,
        "map50_train_last": maps[-1]["map50_train"] if maps else None,
        "ckpt_n": sum(len(s["ckpt"]) for s in segs),
        "ckpt_s_mean": round(float(np.mean(sum((s["ckpt"] for s in segs),
                                               []) or [0])), 2),
        # one entry per segment: a soak that survives kills/feed changes
        # is a sequence of regimes; the aggregate alone hides which
        # regime a bottleneck (or a fix) belongs to
        "per_segment": [
            {
                "feed": s["feed"],
                "dispatch_range": [s["start"], s["last"]],
                "wall_s": round(s["t1"] - s["t0"], 1),
                "d_n": len(s["d"]),
                "step_ms_p50": round(float(np.percentile(
                    np.asarray(s["d"]) / scan * 1e3, 50)), 1)
                if s["d"] else None,
                "step_ms_p90": round(float(np.percentile(
                    np.asarray(s["d"]) / scan * 1e3, 90)), 1)
                if s["d"] else None,
                "img_s_steady": int(round(
                    batch * scan * len(s["d"]) / sum(s["d"])))
                if s["d"] else None,
            }
            for s in segs
        ],
    }
    if mems:
        inuse = [m.get("bytes_in_use") for m in mems
                 if m.get("bytes_in_use") is not None]
        if inuse:
            out["mem_gb_first"] = round(inuse[0] / 2**30, 2)
            out["mem_gb_last"] = round(inuse[-1] / 2**30, 2)
            out["mem_gb_max"] = round(max(inuse) / 2**30, 2)
    return out


def main(argv=None, weights=None):
    """Runs one segment (or, with --report, only aggregates the log) and
    returns the report. `weights`: bcnn_tpu-layout numpy dicts in place
    of the seeded init (a --resume takes the checkpoint's)."""
    from examples_torch._common import add_device, data_dir

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5000,
                    help="total optimizer steps across all segments")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--scan", type=int, default=5)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--src-size", type=int, default=640)
    ap.add_argument("--images", type=int, default=512)
    ap.add_argument("--act", default="bf16", choices=["bf16", "fp32"])
    ap.add_argument("--feed", default="stream",
                    choices=["stream", "resident"],
                    help="stream: uint8 batches staged a dispatch; "
                    "resident: the records uploaded to the card once, a "
                    "dispatch sends a (K, B) index")
    ap.add_argument("--sequential", action="store_true",
                    help="resident feed: the stream's record order "
                    "instead of a per-epoch shuffle")
    ap.add_argument("--eval-every", type=int, default=50,
                    help="eval cadence, in scan dispatches (0 = off)")
    ap.add_argument("--eval-map", type=int, default=0,
                    help="held-out mAP cadence, in scan dispatches "
                    "(0 = off): the detection program on one batch of "
                    "the held-out records and one of the training ones")
    ap.add_argument("--ckpt-every", type=int, default=100,
                    help="checkpoint cadence, in scan dispatches (0 = off)")
    ap.add_argument("--mem-every", type=int, default=50)
    ap.add_argument("--dir", default=None,
                    help="log and checkpoint directory (default: bcnn_soak "
                    "in the temporary directory)")
    ap.add_argument("--outdir", default=None,
                    help="dataset directory (default: bcnn_tpu_det_data in "
                    "the temporary directory)")
    ap.add_argument("--rotation", type=float, default=0.0,
                    help="rotation_range (degrees) of the augmentation on "
                    "the card; 0 = off")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--report", action="store_true",
                    help="aggregate the log and print the summary only")
    ap.add_argument("--pidfile", default="")
    ap.add_argument("--deterministic", action="store_true",
                    help="cuDNN's deterministic algorithms for this run")
    add_device(ap)
    args = ap.parse_args(argv)
    args.dir = args.dir or data_dir("bcnn_soak")
    args.outdir = args.outdir or data_dir("bcnn_tpu_det_data")
    if args.report:
        out = report(args)
        print(json.dumps(out, indent=1))
        return out
    import torch

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled,
                     benchmark=cudnn.benchmark and not args.deterministic,
                     deterministic=cudnn.deterministic or args.deterministic,
                     allow_tf32=cudnn.allow_tf32):
        return run(args, weights)


if __name__ == "__main__":
    main()
