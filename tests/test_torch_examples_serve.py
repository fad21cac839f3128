"""The port's serving example drivers (examples_torch/: inference_benchmark,
yolo_example, serve_detection, export_serving, serving_latency) against
bcnn_tpu on the CPU, at 64 px and batch <= 2, on bcnn_tpu's weights
handed in (`main(argv, weights=...)`).

Tolerances: fp32 forward outputs and detections within rtol 1e-4, atol
1e-4 of bcnn_tpu's; int8 heads (bcnn_tpu's quant dict carried over,
`bridge.quant_from_numpy`) within 2^-5 of their largest value, as
tests/test_torch_quant.py holds them; a served artifact's outputs
bit-equal to the live session's; letterboxed frames, y4m frames and
synthetic images bit-equal to the JAX example's. Every driver refuses
`--device cuda` where CUDA is missing, and a fresh interpreter that
imports every example driver and converter of the port loads no JAX."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import bcnn_tpu as bt
from bcnn_tpu.config import load_net as jax_load_net
from bcnn_tpu.models import yolov3_tiny as jax_tiny

from bcnn_tpu_torch import bridge
from bcnn_tpu_torch.models import yolov3_tiny
from bcnn_tpu_torch.serialization import save_weights_darknet
from tests.test_torch_data import pin_port_bip

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))

RTOL = ATOL = 1e-4
INT8_SHARE = 2.0**-5
SIZE, BATCH = 64, 2
SERVE_DRIVERS = ["inference_benchmark", "yolo_example", "serve_detection",
                 "export_serving", "serving_latency"]


@pytest.fixture(scope="module", autouse=True)
def same_backend():
    yield from pin_port_bip()


@pytest.fixture(scope="module")
def tiny():
    """bcnn_tpu's YOLOv3-tiny at 64 px, batch 2, 80 classes, PREDICT,
    with He-scaled numpy weights (its XAVIER heads at random are all
    saturated): (session, (params, state) numpy)."""
    jnet = jax_tiny(BATCH, SIZE, SIZE)
    p_np, s_np = bridge.he_numpy_weights(yolov3_tiny(BATCH, SIZE, SIZE), 0)
    js = bt.Session(jnet, 0)
    js.params = {k: np.asarray(v) for k, v in p_np.items()}
    js.state = {k: np.asarray(v) for k, v in s_np.items()}
    return js.compile_net(), (p_np, s_np)


def x_of(batch, size=SIZE):
    return np.random.RandomState(0).rand(batch, 3, size, size).astype(
        np.float32)


@pytest.mark.parametrize("name", SERVE_DRIVERS)
def test_driver_refuses_cuda_without_it(name, monkeypatch, tmp_path):
    import importlib

    mod = importlib.import_module(f"examples_torch.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--device", "cuda"]
    if name == "yolo_example":
        argv = ["img.png"] + argv
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)


def test_inference_benchmark_fp32_and_int8(tiny):
    """The timed forward's heads against bcnn_tpu's forward of the same
    input, fp32; then int8 on bcnn_tpu's quant dict."""
    import jax.numpy as jnp
    from bcnn_tpu.ops import quant as jq

    from examples_torch import inference_benchmark as ib

    js, weights = tiny
    args = ["--model", "yolov3-tiny", "--batch", str(BATCH), "--size",
            str(SIZE), "--runs", "2", "--device", "cpu"]
    res = ib.main(args + ["--fp32"], weights=weights)
    assert res["batch"] == BATCH and 0 < res["min_ms"] <= res["avg_ms"]
    x = x_of(BATCH)
    want, _ = js.predict_on_batch(x, outputs=["lid17", "lid24"])
    assert len(res["outputs"]) == 2
    for g, w in zip(res["outputs"], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)

    jnet = jax_tiny(BATCH, SIZE, SIZE)
    jnet.compute_dtype = jnp.bfloat16
    jq8 = bt.Session(jnet, 0)
    jq8.params, jq8.state = js.params, dict(js.state)
    jq8.compile_net()
    jq.ptq_synthetic(jnet, jq8)
    quant = bridge.quant_from_numpy(yolov3_tiny(BATCH, SIZE, SIZE),
                                    jnet.quant)
    # ptq_synthetic set the running variances to 1: the state the quant
    # dict was calibrated with goes with it
    res8 = ib.main(args + ["--int8"], quant=quant, weights=(
        weights[0], {k: np.asarray(v) for k, v in jq8.state.items()}))
    want8, _ = jq8.predict_on_batch(x, outputs=["lid17", "lid24"])
    for g, w in zip(res8["outputs"], want8):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=INT8_SHARE * np.abs(w).max())


def small_cfg(tmp_path):
    """examples/yolo/yolov3-tiny.cfg at 64 px, and a Darknet .weights of
    He-scaled seeded weights for it: (cfg, weights)."""
    with open(os.path.join(REPO, "examples", "yolo", "yolov3-tiny.cfg")) as f:
        text = f.read()
    text = text.replace("width=416", f"width={SIZE}").replace(
        "height=416", f"height={SIZE}")
    cfg = str(tmp_path / "tiny64.cfg")
    with open(cfg, "w") as f:
        f.write(text)
    net = yolov3_tiny(1, SIZE, SIZE)  # the cfg's layers, in its order
    p, s = bridge.params_from_numpy(net, *bridge.he_numpy_weights(net, 0))
    weights = str(tmp_path / "tiny64.weights")
    save_weights_darknet(net, p, s, weights)
    return cfg, weights


def jax_detections(cfg, weights, img, thresh):
    """What examples/yolo_example.py computes for `img`."""
    from yolo_example import prepare_frame

    jnet = bt.Net(bt.Mode.PREDICT)
    jax_load_net(jnet, cfg, weights)
    js = bt.Session(jnet, 0).compile_net()
    t0 = jnet.tensors[0]
    dets = js.yolo_get_detections(prepare_frame(img, t0.w, t0.h),
                                  img.shape[1], img.shape[0], t0.w, t0.h,
                                  thresh=thresh)
    return [d for d in dets if d["objectness"] > 0]


def same_dets(got, want):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        for k in ("x", "y", "w", "h", "objectness"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g["prob"], w["prob"], rtol=RTOL,
                                   atol=ATOL)


def test_yolo_example_image_and_video(tmp_path):
    """The letterbox bit-equal to the JAX example's; image mode on the cfg
    + .weights path against bcnn_tpu's detections; the video loop over a
    y4m clip (its frames bit-equal to the JAX reader's) writes every
    frame, the first frame's detections bcnn_tpu's."""
    import yolo_example as jy

    from bcnn_tpu_torch import bip
    from examples_torch import yolo_example as ty
    from tests.test_yolo_video import _write_y4m

    rng = np.random.RandomState(3)
    img = (rng.rand(48, 80, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(ty.prepare_frame(img, SIZE, SIZE),
                                  jy.prepare_frame(img, SIZE, SIZE))
    cfg, weights = small_cfg(tmp_path)
    path = str(tmp_path / "img.png")
    bip.write_image(path, img)
    out = str(tmp_path / "dets.png")
    res = ty.main([path, cfg, weights, "--out", out, "--thresh", "0.3",
                   "--device", "cpu"])
    same_dets(res["detections"], jax_detections(cfg, weights, img, 0.3))
    assert os.path.exists(out) and res["inference_ms"] > 0

    frames = [(rng.rand(32, 48, 3) * 255).astype(np.uint8) for _ in range(3)]
    clip = str(tmp_path / "clip.y4m")
    _write_y4m(clip, frames)
    got = list(ty.read_y4m_frames(clip))
    want = list(jy.read_y4m_frames(clip))
    assert len(got) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    vout = str(tmp_path / "video")
    res = ty.main(["video", clip, cfg, weights, "--out", vout, "--thresh",
                   "0.3", "--device", "cpu"])
    assert res["frames"] == 3
    assert sorted(os.listdir(vout)) == [f"frame_{i:05d}.png"
                                        for i in range(3)]
    same_dets(res["detections"][0], jax_detections(cfg, weights, want[0],
                                                   0.3))


def test_serve_detection_against_bcnn_tpu(tiny, tmp_path):
    """The synthetic images are the JAX example's draws; the first
    batch's detections (fp32) within tolerance of bcnn_tpu's
    detect_on_batch on the JAX example's feed of the same list."""
    from serve_detection import _DetectionFeed as JaxFeed

    from bcnn_tpu_torch import bip
    from examples_torch import serve_detection as sd

    js, weights = tiny
    lst = sd.synth_images(4, str(tmp_path))
    rng = np.random.RandomState(0)
    with open(lst) as f:
        paths = [line.strip() for line in f]
    for p in paths:
        np.testing.assert_array_equal(
            bip.load_image(p), (rng.rand(240, 320, 3) * 255).astype(np.uint8))
    res = sd.main([lst, "--batch", str(BATCH), "--steps", "1", "--size",
                   str(SIZE), "--fp32", "--thresh", "0.3", "--device", "cpu"],
                  weights=weights)
    assert res["images"] == BATCH and res["img_s"] > 0
    x, _ = JaxFeed(js.net, lst).next_batch()
    want = js.detect_on_batch(x, thresh=0.3)
    obj = np.asarray(want[2])
    assert (obj > 0).any()
    for g, w in zip(res["first"], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_export_serving_forward_and_detect(tiny, tmp_path):
    """The served forward bit-equal to live and within tolerance of
    bcnn_tpu's; the served detection program bit-equal to live."""
    from examples_torch import export_serving as es

    js, weights = tiny
    argv = ["--batch", str(BATCH), "--size", str(SIZE), "--device", "cpu"]
    res = es.main(argv + ["--out", str(tmp_path / "f.pt2")], weights=weights)
    assert res["bit_equal"] and res["shapes"] == [(BATCH, 255, 2, 2),
                                                  (BATCH, 255, 4, 4)]
    want, _ = js.predict_on_batch(x_of(BATCH), outputs=["lid17", "lid24"])
    for g, w in zip(res["outputs"], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    res = es.main(argv + ["--detect", "--out", str(tmp_path / "d.pt2")],
                  weights=weights)
    assert res["bit_equal"] and res["shapes"][0] == (BATCH, 100, 4)


def test_serving_latency_buckets(tiny, tmp_path):
    """A bucket a precision: the percentiles in order, the artifact's
    output bit-equal to the live session's."""
    from examples_torch import serving_latency as sl

    rows = sl.main(["--mode", "both", "--buckets", "1", "--calls", "3",
                    "--size", str(SIZE), "--outdir", str(tmp_path),
                    "--device", "cpu"], weights=tiny[1])
    assert [(r["mode"], r["batch"]) for r in rows] == [("bf16", 1),
                                                       ("int8", 1)]
    for r in rows:
        assert r["bit_equal_to_live"]
        assert 0 < r["min_ms"] <= r["p50_ms"] <= r["p90_ms"] <= r["p99_ms"]
        assert r["img_s_at_p50"] > 0


def test_no_jax_in_the_examples_and_converters(tmp_path):
    """A fresh interpreter imports every examples_torch module,
    bcnn_tpu_torch.tflite and tools/bcnn2tflite_torch.py, writes LeNet's
    direct TFLite blob and runs the inference benchmark once, and has
    loaded no JAX module and no bcnn_tpu module."""
    code = textwrap.dedent(
        """
        import importlib, os, sys
        import torch
        torch.set_num_threads(1)
        sys.path.insert(0, os.path.join(os.getcwd(), "tools"))
        for name in ("_common", "mnist_example", "mnist_fast",
                     "cifar10_example", "inference_benchmark",
                     "yolo_example", "serve_detection", "export_serving",
                     "serving_latency", "train_throughput", "train_soak"):
            importlib.import_module("examples_torch." + name)
        import bcnn2tflite_torch
        from bcnn_tpu_torch import Session
        from bcnn_tpu_torch.models import lenet_mnist
        from bcnn_tpu_torch.tflite import convert_net
        from bcnn_tpu_torch.types import Mode
        net = lenet_mnist(1, Mode.PREDICT)
        s = Session(net, 0, device="cpu").compile_net()
        assert convert_net(net, s.params, s.state, None, backend="direct")
        from examples_torch import inference_benchmark
        inference_benchmark.main(["--model", "lenet", "--batch", "2",
                                  "--runs", "1", "--device", "cpu"])
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "bcnn_tpu" or m.startswith("bcnn_tpu."))
        assert not bad, bad
        print("OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), \
        res.stderr[-3000:]
