"""YOLOv3-tiny detection example on the PyTorch port, the counterpart of
examples/yolo_example.py (the reference's examples/yolo/yolo_example.cc).

Loads yolov3-tiny (a Darknet .cfg + .weights if given, else the built-in
net with seeded random weights), letterboxes input frames, runs the
timed inference and the host detections (`Session.yolo_get_detections`),
and draws and prints the boxes.

Image mode:
  python examples_torch/yolo_example.py <image> [cfg weights] [--out PATH]
Video mode (yolo_example.cc:219-240's loop): the frames come from a
directory of images, a raw .y4m clip (neither needs cv2), a webcam index
"0"/"1" or a cv2-decodable video file; a prefetch thread decodes and
letterboxes frame N+1 while the card runs frame N; annotated frames are
written with each frame's latency, and the steady frame rate:
  python examples_torch/yolo_example.py video <frames-dir|clip.y4m|0|clip.avi>
      [cfg weights] [--out outdir]
Both take --device cuda|cpu (default cuda) and --thresh (0.5).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

COCO_NAMES = (
    "person bicycle car motorbike aeroplane bus train truck boat "
    "traffic_light fire_hydrant stop_sign parking_meter bench bird cat dog "
    "horse sheep cow elephant bear zebra giraffe backpack umbrella handbag "
    "tie suitcase frisbee skis snowboard sports_ball kite baseball_bat "
    "baseball_glove skateboard surfboard tennis_racket bottle wine_glass "
    "cup fork knife spoon bowl banana apple sandwich orange broccoli carrot "
    "hot_dog pizza donut cake chair sofa pottedplant bed diningtable toilet "
    "tvmonitor laptop mouse remote keyboard cell_phone microwave oven "
    "toaster sink refrigerator book clock vase scissors teddy_bear "
    "hair_drier toothbrush"
).split()


def prepare_frame(img, netw, neth):
    """Letterbox preprocess (yolo_example.cc:21-79): aspect-preserving
    resize centered on a gray canvas, mapped to [-1, 1]."""
    from bcnn_tpu_torch import bip

    h, w, c = img.shape
    if netw / w < neth / h:
        nw, nh = netw, (h * netw) // w
    else:
        nh, nw = neth, (w * neth) // h
    resized = bip.resize_bilinear(img, nw, nh)
    canvas = np.full((neth, netw, 3), 128, np.uint8)
    dx, dy = (netw - nw) // 2, (neth - nh) // 2
    bip.crop_image(resized, -dx, -dy, netw, neth, out=canvas)
    x = (canvas.astype(np.float32) - 127.5) / 127.5
    return np.transpose(x, (2, 0, 1))[None]  # NCHW


def read_y4m_frames(path):
    """Minimal YUV4MPEG2 reader: yields HWC uint8 RGB frames (BT.601)."""
    with open(path, "rb") as f:
        header = f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a y4m file")
        w = h = 0
        for tok in header.split()[1:]:
            if tok[0] == "W":
                w = int(tok[1:])
            elif tok[0] == "H":
                h = int(tok[1:])
            elif tok[0] == "C" and not tok.startswith("C420"):
                raise ValueError(f"only 4:2:0 y4m supported, got {tok}")
        ysz, csz = w * h, (w // 2) * (h // 2)
        while True:
            marker = f.readline()
            if not marker:
                return
            if not marker.startswith(b"FRAME"):
                raise ValueError("bad y4m frame marker")
            raw = f.read(ysz + 2 * csz)
            if len(raw) < ysz + 2 * csz:
                return
            y = np.frombuffer(raw, np.uint8, ysz).reshape(h, w)
            u = np.frombuffer(raw, np.uint8, csz, ysz).reshape(
                h // 2, w // 2
            )
            v = np.frombuffer(raw, np.uint8, csz, ysz + csz).reshape(
                h // 2, w // 2
            )
            u = np.repeat(np.repeat(u, 2, 0), 2, 1).astype(np.float32)
            v = np.repeat(np.repeat(v, 2, 0), 2, 1).astype(np.float32)
            yf = y.astype(np.float32)
            # BT.601 limited-range
            c = 1.164 * (yf - 16.0)
            r = c + 1.596 * (v - 128.0)
            g = c - 0.392 * (u - 128.0) - 0.813 * (v - 128.0)
            b = c + 2.017 * (u - 128.0)
            yield np.clip(
                np.stack([r, g, b], -1), 0, 255
            ).astype(np.uint8)


def read_cv2_frames(source):
    """OpenCV capture source, matching the reference's `open_video`
    dispatch (yolo_example.cc:110-124): source "0"/"1" opens the webcam
    at that device index, anything else is any cv2-decodable video file.
    Yields HWC uint8 RGB frames. Needs cv2; the y4m / frame-dir sources
    carry no such dependency."""
    import cv2

    cap = cv2.VideoCapture(int(source) if source in ("0", "1") else source)
    if not cap.isOpened():
        raise IOError(f"failed to open video source {source!r}")
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            yield frame[..., ::-1].copy()  # cv2 is BGR; the loop wants RGB
    finally:
        cap.release()


def read_dir_frames(path):
    from bcnn_tpu_torch import bip

    names = sorted(
        n for n in os.listdir(path)
        if n.lower().endswith((".png", ".jpg", ".jpeg", ".bmp"))
    )
    for n in names:
        img = bip.load_image(os.path.join(path, n))
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        yield img


def _draw_dets(img, dets, thresh=0.0):
    out = img.copy()
    hh, ww = img.shape[:2]
    for d in dets:
        if d["objectness"] <= thresh:
            continue
        x0 = int(np.clip((d["x"] - d["w"] / 2) * ww, 0, ww - 1))
        x1 = int(np.clip((d["x"] + d["w"] / 2) * ww, 0, ww - 1))
        y0 = int(np.clip((d["y"] - d["h"] / 2) * hh, 0, hh - 1))
        y1 = int(np.clip((d["y"] + d["h"] / 2) * hh, 0, hh - 1))
        out[y0:y1, x0, :] = (0, 0, 255)
        out[y0:y1, x1, :] = (0, 0, 255)
        out[y0, x0:x1, :] = (0, 0, 255)
        out[y1, x0:x1, :] = (0, 0, 255)
    return out


def run_video(source, net, sess, out_dir, thresh=0.5, max_frames=None):
    """The reference's video loop (yolo_example.cc:219-240), pipelined:
    a prefetch thread decodes and letterboxes frame N+1 while the device
    runs frame N. Returns (n_frames, fps, each frame's detections)."""
    import queue
    import threading

    from bcnn_tpu_torch import bip

    netw, neth = net.tensors[0].w, net.tensors[0].h
    if source.endswith(".y4m"):
        frames = read_y4m_frames(source)
    elif os.path.isdir(source):
        frames = read_dir_frames(source)
    else:  # "0"/"1" webcam index or a cv2-decodable video file
        frames = read_cv2_frames(source)
    q = queue.Queue(maxsize=2)  # double buffer

    def producer():
        try:
            for i, img in enumerate(frames):
                if max_frames is not None and i >= max_frames:
                    break
                q.put((i, img, prepare_frame(img, netw, neth)))
        except Exception as e:  # surfaced to the consumer, in order
            q.put(e)
        q.put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    per_frame = []
    t_first = time.time()
    while True:
        item = q.get()
        if item is None:
            break
        if isinstance(item, Exception):
            raise item
        i, img, x = item
        t0 = time.time()
        dets = sess.yolo_get_detections(
            x, img.shape[1], img.shape[0], netw, neth, thresh=thresh
        )
        dt = (time.time() - t0) * 1e3
        kept = [d for d in dets if d["objectness"] > 0]
        per_frame.append(kept)
        bip.write_image(
            os.path.join(out_dir, f"frame_{i:05d}.png"),
            _draw_dets(img, kept),
        )
        print(f"frame {i}: {len(kept)} dets, {dt:.1f} ms")
        if n == 0:
            t_first = time.time()  # the first frame warms up
        n += 1
    wall = time.time() - t_first
    fps = (n - 1) / wall if n > 1 and wall > 0 else 0.0
    print(f"{n} frames, {fps:.1f} FPS (steady-state)")
    return n, fps, per_frame


def build(cfg, weights, dev, seed_weights_np=None):
    """(net, session): the cfg + weights (BN folded), else the built-in
    yolov3-tiny at batch 1, seeded (or `seed_weights_np`, bcnn_tpu-layout
    numpy dicts)."""
    from bcnn_tpu_torch import Mode, Net, Session
    from bcnn_tpu_torch.models import yolov3_tiny
    from examples_torch._common import seed_weights

    if cfg:
        from bcnn_tpu_torch.config import load_net

        net = Net(Mode.PREDICT)
        load_net(net, cfg, weights)
        return net, Session(net, seed=0, device=dev).compile_net()
    print("no cfg/weights given; running built-in net, "
          + ("the weights handed in" if seed_weights_np is not None
             else "random weights"))
    net = yolov3_tiny(batch_size=1, mode=Mode.PREDICT)
    sess = seed_weights(Session(net, seed=0, device=dev), seed_weights_np)
    return net, sess.compile_net()


def main(argv=None, weights=None):
    """Image mode returns {"detections" (kept, objectness > 0),
    "inference_ms", "out"}; video mode {"frames", "fps", "detections"
    (a list a frame)}. `weights`: bcnn_tpu-layout numpy dicts for the
    built-in net."""
    from examples_torch._common import add_device, device

    ap = argparse.ArgumentParser()
    ap.add_argument("args", nargs="+",
                    help="<image> [cfg weights] | video <src> [cfg weights]")
    ap.add_argument("--out", default=None,
                    help="image mode: the drawn image (default "
                    "<image>_dets.png here); video mode: the frames' "
                    "directory (default video_dets)")
    ap.add_argument("--thresh", type=float, default=0.5)
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)

    from bcnn_tpu_torch import bip

    pos = args.args
    if pos[0] == "video":
        if len(pos) < 2:
            ap.error("video mode needs a source")
        cfg, wts = (pos[2], pos[3]) if len(pos) >= 4 else (None, None)
        net, sess = build(cfg, wts, dev, weights)
        n, fps, per_frame = run_video(pos[1], net, sess,
                                      args.out or "video_dets", args.thresh)
        return {"frames": n, "fps": fps, "detections": per_frame}

    img_path = pos[0]
    img = bip.load_image(img_path)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    cfg, wts = (pos[1], pos[2]) if len(pos) >= 3 else (None, None)
    net, sess = build(cfg, wts, dev, weights)
    netw, neth = net.tensors[0].w, net.tensors[0].h

    x = prepare_frame(img, netw, neth)
    # timed inference (run_inference, yolo_example.cc:88-107)
    sess.yolo_get_detections(x, img.shape[1], img.shape[0], netw, neth,
                             thresh=args.thresh)  # warm-up
    t0 = time.time()
    dets = sess.yolo_get_detections(x, img.shape[1], img.shape[0], netw,
                                    neth, thresh=args.thresh)
    ms = (time.time() - t0) * 1e3
    print(f"inference time: {ms:.1f} ms")

    kept = [d for d in dets if d["objectness"] > 0]
    print(f"{len(kept)} detections")
    for d in kept:
        cls = int(np.argmax(d["prob"]))
        name = COCO_NAMES[cls] if cls < len(COCO_NAMES) else str(cls)
        print(
            f"  {name} p={d['prob'][cls]:.3f} "
            f"x={d['x']:.3f} y={d['y']:.3f} w={d['w']:.3f} h={d['h']:.3f}"
        )
    dst = args.out or (os.path.splitext(os.path.basename(img_path))[0]
                       + "_dets.png")
    bip.write_image(dst, _draw_dets(img, kept))
    print(f"wrote {dst}")
    return {"detections": kept, "inference_ms": ms, "out": dst}


if __name__ == "__main__":
    main()
