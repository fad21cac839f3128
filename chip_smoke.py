#!/usr/bin/env python3
"""Smoke run of bcnn_tpu_torch, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from bcnn_tpu_torch/csrc and holds each
against its plain PyTorch version on the card: K1 (YOLO decode), K2
(the shear shift, row mode and column mode, bit for bit), K3
(depthwise conv + bias + activation) and K4 (the int8 conv with its
dequant/BN/activation/requant epilogue, bit for bit, on channels-last
int8 x and the (O, k, k, C) weight, each shape's tile plan and split of
K printed) at the shapes their paths give them, each warm and cold, and K3 and K4 on ragged shapes (K3
with each fused activation), and K6 (a conv's BN and activation, bit for
bit in bf16 and fp32, at full YOLOv3's, YOLOv4's and YOLOv7's BN shapes
at batch 64 and at the edges, beside a copy of the same bytes; phase 3f); then the whole shear chain of rotation
augmentation (three K2 launches, no copy) against its CPU run. Then it drives the main
paths (full width and depth, random weights from a seed), each serving
path checked and its launches counted, not timed (the benchmark,
benchmark/run.py, times serving):
  - YOLOv3-tiny serving (416x416, 80 classes): Session.detect_on_batch
    at batch 8 on both detection branches, checked against the port's
    CPU run;
  - MobileNet-v1 classification serving (224x224, 1000 classes, fp32,
    He-scaled weights from a numpy seed): Session.predict_on_batch at
    batch 64, 13 K3 launches a forward, fc and softmax of two images
    checked against the port's CPU run;
  - YOLOv3-tiny serving at bf16 (compute_dtype = act_dtype = bf16, as
    bench.py runs it), both branches, against the CPU port; then bench.py's
    int8 program (ptq_synthetic, int8 activations between layers, K4 on
    all 13 convs, the int8 flow channels-last) on the top-k-first
    branch, card against CPU with one quant dict: every int8 tensor
    equal;
  - MobileNet-v1 at bf16 (K3 on the bf16-rounded values);
  - full YOLOv4 (phase 6e, benchmark/configs/yolov4-608.cfg) at 608 px,
    batch 8, fp32 and bf16: K6 on its 107 BN convs (72 MISH), the heads
    against the benchmark's plain reference, int8 refused (K4 has no
    Mish);
  - YOLOv3-tiny training: Session.train_on_batch at batch 32, SGD (lr 0.001,
    momentum 0.9, decay 0.0005), on uint8 images augmented on the card
    with flip, contrast, brightness and rotation 10 (three K2 launches a
    step); one warm-up step, then 5 steps; then one batch-2 step on the
    card and on the CPU from the same weights and augmentation draws;
  - bench.py's training program: YOLOv3-tiny 416 at batch 64 with bf16
    convs both ways and bf16 activations between layers
    (compute_dtype = train_act_dtype = bf16), one warm-up step and 10
    timed, then fp32 at batch 64 the same way; a bf16 step at 96 px,
    batch 2, card against CPU; make_train_scan of 4 steps at batch 32
    with rotation (12 K2 launches); a remat step and an accum_steps=2
    step at batch 32 against the plain step they stand for;
  - training from files (phase 9): 96 PNGs, a Darknet .weights file of
    seeded YOLOv3-tiny parameters and MNIST idx files written into a
    temporary directory; `bcnn_tpu_torch.cli` train / valid (mAP) /
    predict (det_*.png) on examples/yolo/yolov3-tiny.cfg's layers at
    batch 32, 416 px; its first two steps card against CPU from
    byte-equal loader batches; the feeds (the sequential loader,
    BatchPipeline, ShardedBatchPipeline(4), raw records with device
    augmentation through train_on_batch, the staged scan and the
    resident scan: three K2 launches a step) timed beside phase 7's
    step on batches built in advance; the sharded pipeline's batches on
    the card byte-equal to the sequential loader's, the resident scan
    against the staged one; examples/mnist_cl/mnist.conf through the CLI
    for 200 batches and its first two steps card against CPU;
  - full YOLOv3 training (phase 10): examples/yolo/yolov3.cfg through
    config.load_net at 416 px, batch 16, from a .weights file of seeded
    weights, rotation 10 (three K2 launches a step), yolo_stats; one
    warm-up and 5 steps fp32, then bf16 + act16; an accum_steps=2 step
    and the resident scan; one batch-2 step on the card and on the CPU,
    each held to a float64 run that takes its own kink sides and max-pool
    picks (bcnn_tpu_torch.replay);
  - ResNet-18 (phase 10b): served at batch 64, 224 px, fp32 and bf16;
    trained at batch 32 fp32 and bf16 + act16; its batch-2 step held so;
  - the layers left (phase 10c): a small net with a deconv (fp32, bf16,
    the reference's padded quirk), LRN, dropout (the card's masks handed
    to the CPU), PReLU and the lifted-structure loss, one step card vs
    CPU; MobileNet-v1 bf16 + act16 training at batch 32 (FC and depthwise
    in bf16); bcnn-cl train on the lifted-structure recipe at batch 128;
  - deploy and resume (phase 13): YOLOv3-tiny's detect program (416,
    batch 8) at fp32 and int8 and MobileNet-v1's forward (224, batch 64)
    at fp32 and int8 exported with Session.export_serving (torch.export,
    the kernels as bcnn_tpu_torch ops in the graph), loaded from the
    .pt2 file and served against the live path (bit-equal, the same
    launches a call) and a CPU export; the int8 YOLOv3-tiny file served
    by a fresh process; bcnn-cl export of yolov3-tiny.cfg --detect over
    a seeded .weights; a checkpoint of YOLOv3-tiny training (batch 32,
    rotation 10) resumed bit for bit; profile_forward and memory_report;
    the host time of one K4 call through its wrapper, its op and its
    launcher;
  - data parallel (phase 14, `bcnn_tpu_torch.parallel`): one NCCL rank
    runs every DP form at full width, YOLOv3-tiny 416 at batch 32 (the
    DP step, ZeRO-1, FSDP, Session(mesh=, zero=3) fed by
    BatchPipeline(sharding=), the DP scan, the replicated and sharded
    resident scans with rotation 10: K2) and MobileNet-v1's DP forward
    at batch 64, fp32 (K3, K6) and int8 (K4 + K5), bit-equal to
    predict_on_batch; each training form held to the single-device run
    that takes its own kink sides and max-pool picks; an FSDP checkpoint
    resumed on ZeRO-1 and on one device; then two gloo ranks share the
    card for the DP step and the replicated resident scan, held to one
    rank's run of the global batch and to each other bit for bit;
  - the example drivers (phase 15, `examples_torch/`), each main(argv)
    called here at full width with its launches counted: the inference
    benchmark (MobileNet-v1 224 at batch 64, fp32, bf16 and int8: K3,
    K4, K5; YOLOv3-tiny int8 bit-equal to the CPU's), serving latency
    over exported int8 and bf16 buckets (K4; each artifact bit-equal to
    live), export_serving, serve_detection (its first batch as the
    CPU's), yolo_example's image and video modes, mnist_example,
    mnist_fast, both CIFAR-10 nets, train_throughput's four feeds, and
    the soak (YOLOv3-tiny 416, batch 32, rotation 10: K2) run whole,
    then killed through its --pidfile in a new process after its
    checkpoint at step 100 and resumed, ending bit-equal to the whole
    run under cuDNN's deterministic algorithms, its memory flat;
  - pipeline stages (phase 17, `bcnn_tpu_torch.parallel.Pipeline`): one
    NCCL rank holding every stage runs MobileNet-v1's forward (224,
    batch 64, 3 stages, 4 microbatches) fp32 (K3 and K6 on every stage)
    and
    int8 (K4 and K5 on every stage, bit-equal to one device), and
    YOLOv3-tiny training (416, batch 32, 2 stages) at one microbatch and
    at four under GPipe and 1F1B, each update held to a float64 replay
    of its own choices, with step times and peak memory beside the
    plain and accumulation steps; two gloo ranks on the card run the
    1F1B step a stage each.
Each path runs with the launch counts set to 0 just before it and read
just after: K6 once a BN conv in every float forward outside TRAIN on
the card (serving, exports, the DP, spatial and pipeline forwards), none
in int8 forwards and training; each phase prints its seconds. Every
kernel is reached through its torch.library op (bcnn_tpu_torch/ops/library.py). Any failure exits nonzero. The last line of stdout is
{"ok": true, "device": {...}}; the line before it lists each kernel with
its launches on its path, its error against the plain version, its time
warm and cold, the plain version's, its bound (the bytes it must move at
the card's memory rate, or its operations at the fp32 rate, K4's at the
dense int8 rate, whichever is longer) and the time of one PyTorch call that computes the same
function, where there is one (K3: the grouped conv, without the
activation; K4: cuDNN's bf16 conv of the same values, PyTorch having no
int8 conv on CUDA; K6: F.batch_norm then F.leaky_relu). The kernel
timers are tools/card_timing.py's, the peaks benchmark/roofline.py's.
Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from bcnn_tpu_torch import Session, bridge, kernels, replay
from bcnn_tpu_torch.compile import (execute, get_loss, make_train_scan,
                                    make_train_step, output_value)
from bcnn_tpu_torch.learner import apply_updates, init_opt_state
from bcnn_tpu_torch.data.device_augment import _rotate_3shear, _shear_bounds
from bcnn_tpu_torch.models import (mobilenet_v1, resnet18, yolov3,
                                   yolov3_tiny, yolov4, yolov7)
from bcnn_tpu_torch.ops.conv_int8 import (channels_last_weight,
                                          conv_int8_fused,
                                          conv_int8_fused_ref,
                                          plan_conv_int8)
from bcnn_tpu_torch.ops import library
from bcnn_tpu_torch.ops import quant as tq
from bcnn_tpu_torch.ops.bn_act import FUSED_ACT as K6_ACTS
from bcnn_tpu_torch.ops.bn_act import bn_act, bn_act_ref, channels_last_form
from bcnn_tpu_torch.ops.depthwise import depthwise_fused, depthwise_fused_ref
from bcnn_tpu_torch.ops.grouped_int8 import (grouped_int8_fused,
                                             grouped_int8_fused_ref,
                                             grouped_weight,
                                             plan_grouped_int8)
from bcnn_tpu_torch.ops.quant import ptq_synthetic, quantize_tensor
from bcnn_tpu_torch.ops.row_shift import (col_shift, col_shift_ref,
                                          row_shift, row_shift_ref)
from bcnn_tpu_torch.ops.yolo_decode import decode_fused, decode_grid_ref
from bcnn_tpu_torch.serialization import save_weights_darknet
from bcnn_tpu_torch.types import Activation, Mode
from benchmark.roofline import PEAK_BYTES, PEAK_OPS
from tools.card_timing import (FLUSH_FLOATS, cold_ms, cuda_ms, device_us,
                               gpu_line)

SEED = 0
BATCH, SIZE, CLASSES = 8, 416, 80
REQUESTS = 3
TRAIN_BATCH, TRAIN_STEPS = 32, 5
# examples/train_soak.py's detection augmentation with --rotation 10
AUGMENT = dict(random_fliph=1, min_contrast=0.8, max_contrast=1.2,
               min_brightness=-30, max_brightness=30, rotation_range=10.0)
# K2 is held to its plain version bit for bit (it rounds as the sweep
# does). The whole shear chain on the card against the CPU:
# tests/test_torch_augment.py's warp tolerance on [0, 255] values (tan
# and sin of the angles may differ by an ulp between the two devices)
WARP_ATOL = 5e-4
# one training step, card against CPU: the loss at rtol 1e-4; each
# parameter's update within 1e-3 of its largest entry (every conv and BN
# sum is taken in another order on each device). A max-pool window whose
# two inputs tie within that rounding sends its gradient to the other
# input on one device; the step counts such windows, and the convs that
# feed a window that flipped get 1e-1: each of their weight gradients is
# a sum over P positions (P = 338 at 13x13 for batch 2) that cancels to
# about sqrt(P) terms, and a flip moves one of them. TF32 in the backward
# is caught apart from this, at rtol 1e-4, by tests/test_torch_cuda.py.
STEP_LOSS_RTOL, STEP_UPDATE_TOL, FLIPPED_UPDATE_TOL = 1e-4, 1e-3, 1e-1
# a YOLO delta that moves by more than DELTA_JUMP plus DELTA_RTOL of its
# size between card and CPU took another ignore or anchor choice: such a
# choice moves an objectness or class delta (in [-1, 1]) by O(0.1-1),
# rounding by about 1e-7 of the delta
DELTA_JUMP, DELTA_RTOL = 1e-3, 1e-5
# phase 9's first two steps of YOLOv3-tiny at batch 32, 416 px, card
# against CPU: each parameter's update within BN_UPDATE_TOL of its
# largest entry where no differing choice reaches it. Measured on an
# H100 at 700 W (PERF.md): the 13x13 convs' first updates differ by up to
# 3.4e-3 of their largest entry with no max-pool or YOLO choice counted;
# the first loss is 12,298 (seeded weights: a no-object delta near 1 in
# every cell), so the gradient reaching the BN convs is nearly uniform.
# tools/f3_float64.py ran that first step in float64 on the CPU: the
# CPU's fp32 update lands up to 3.5e-3 of a tensor's largest entry from
# it (1.8e-3 on lid13_w, where the card's lands 5e-6) and the card's up
# to 3.8e-3 (3.0e-3 on lid10_w, the CPU's 6.9e-4): each device's own
# rounding, of one order, and the card's no worse, so the bound stays
# (tests/test_torch_train.py pins the CPU's half). The losses keep
# STEP_LOSS_RTOL; the MNIST recipe keeps STEP_UPDATE_TOL.
BN_UPDATE_TOL = 1e-2
# under net.qat each device's fake-quant codes are imposed on its float64
# replay, which holds each to the replay's own x / s (within
# replay.CODE_EPS of its rounding interval) and counts the codes it would
# have rounded the other way: at most BOUNDARY_SHARE of them. Measured
# on an H100 at 700 W (PERF.md): phase 12's batch-2 step at 416 px lies
# 0.5 + 6.9e-5 codes at worst from its replay on the card, 0.5 + 3.5e-5
# on the CPU, with 6.0e-6 and 4.8e-6 of the codes on a boundary
BOUNDARY_SHARE = 1e-4
ANCHORS = [10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319]
# K1 against its plain version: the tolerance tests/test_yolo_pallas.py
# sets for the TPU kernel
K1_RTOL, K1_ATOL = 1e-5, 1e-6
# GPU heads against the CPU port: the repo's fp32 detection tolerance
HEAD_RTOL, HEAD_ATOL = 1e-4, 1e-4
# MobileNet-v1 serving: batch 64 at 224 px (examples/inference_benchmark
# .py's default batch), one warm-up, then 3 requests
MB_BATCH, MB_SIZE, MB_CLASSES = 64, 224, 1000
MB_REQUESTS = 3
MB_OUTPUTS = ["fc", "softmax"]
# K3 against its plain version: tests/test_dw_pallas.py's atol 1e-4 for
# the TPU kernel, taken relative to the largest output
K3_RTOL = 1e-4
# the nine distinct depthwise layers of MobileNet-v1 at batch 64, 224 px:
# (n, c, h, w, stride), k 3, pad 1, RELU
K3_MOBILENET = [
    (64, 32, 112, 112, 1), (64, 64, 112, 112, 2), (64, 128, 56, 56, 1),
    (64, 128, 56, 56, 2), (64, 256, 28, 28, 1), (64, 256, 28, 28, 2),
    (64, 512, 14, 14, 1), (64, 512, 14, 14, 2), (64, 1024, 7, 7, 1),
]
# launches of each of those shapes in one forward (dw7-11 share a shape)
K3_PER_FORWARD = [1, 1, 1, 1, 1, 1, 5, 1, 1]
# ragged shapes, each fused activation: (n, c, h, w, k, stride, pad, act)
K3_RAGGED = [
    (3, 5, 15, 13, 3, 1, 1, Activation.NONE),
    (2, 6, 15, 13, 5, 3, 0, Activation.LRELU),
    (2, 7, 15, 13, 3, 2, 1, Activation.CLAMP),
    (2, 4, 9, 11, 7, 1, 3, Activation.CLAMP),
    (1, 3, 40, 300, 3, 2, 1, Activation.RELU),
    (70, 16, 7, 7, 3, 1, 1, Activation.LRELU),
]
# K4 rows beyond the 13 convs of YOLOv3-tiny 416 at batch 8 (each checked
# in its path's form and in the other one): ragged shapes, (n, c, h, w,
# o, k, stride, pad)
K4_RAGGED = [
    (1, 3, 416, 416, 16, 3, 1, 1),     # batch 1, C = 3 (K = 27)
    (1, 512, 13, 13, 255, 1, 1, 0),    # batch 1, 13x13, O = 255
    (3, 64, 27, 25, 70, 3, 2, 1),      # stride 2, odd planes, O = 70
    (2, 7, 13, 13, 9, 5, 2, 0),        # K = 175, C not a multiple of 16
    (1, 512, 13, 13, 255, 3, 1, 1),    # batch 1, K split in 18 runs
    (2, 48, 26, 26, 40, 3, 2, 1),      # C = 48: K % 64 = 48, O = 40
]
# bf16 serving against the CPU port: cuDNN's and oneDNN's bf16 convs sum
# in other orders, so a value near a bf16 rounding boundary rounds the
# other way (2^-8 relative) and moves the layers after it; against
# bcnn_tpu on the CPU the heads came within 1.5 such roundings of their
# largest value (tests/test_torch_mixed_precision.py). Heads within
# 2^-5 of the largest value; MobileNet-v1's logits within 2^-4 of the
# largest (13 layers more, K3's fp32 bias before one bf16 round).
BF16_HEAD_TOL, BF16_FC_TOL = 2.0**-5, 2.0**-4
# full YOLOv3's weights: He-scaled, each residual branch's BN scales times
# 0.1, so that 23 residual adds keep the heads O(1)
# (tests/test_torch_yolov3.py); the host-exact detections of one image
# decode about HOST_DETS candidates
RESIDUAL_SCALE, HOST_DETS = 0.1, 200
# bench.py's training program (bench_train): batch 64 at 416 px, its
# input and box; bf16 + act16, then fp32, one warm-up step and 10 timed
T16_BATCH, T16_STEPS = 64, 10
# the bf16 step card against CPU at 96 px, batch 2, under the gate of
# tests/test_torch_train_bf16.py: per tensor, where the CPU's bf16
# gradient meets bcnn_tpu's bf16 gate against the CPU's fp32 one
# (cosine >= 0.99, max|d| < 0.5 rms), the card's meets 1 - cosine <=
# 4 * 2.35e-3 and max|d| < 0.5 rms against the CPU's bf16 one; elsewhere
# it is at most twice that bf16-to-fp32 gap; the loss within 2^-5
T16_SMALL, COS_GAP, RMS_GAP, NOISE_RATIO = 96, 4 * 2.35e-3, 0.5, 2.0
T16_LOSS_RTOL = 2.0**-5
# the step forms at batch 32: make_train_scan of 4 steps with rotation;
# remat and accum_steps=2 within one bf16 rounding (2^-7) of each
# tensor's largest update from the step they stand for
FORMS_BATCH, SCAN_K, FORM_TOL = 32, 4, 2.0**-7


def bound(nbytes, flops, rate=PEAK_OPS["fp32"]):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move nbytes once and do flops operations at `rate` (fp32 by
    default)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def fmt_device(total_us, iters):
    return "not measured" if not total_us else f"{total_us / iters:.1f} us"


def check_k1(shapes):
    """K1 against decode_grid_ref on the card, timed warm in turns
    (plain, kernel, kernel, plain) and cold. Returns per-shape records."""
    gen = torch.Generator().manual_seed(SEED)
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    rows = []
    for n, classes, h, w, mask in shapes:
        x = (3 * torch.randn(n, 3 * (5 + classes), h, w, generator=gen)).cuda()
        p = dict(num=3, classes=classes, mask=mask, anchors=ANCHORS)
        before = library.launches("yolo_decode")
        got = decode_fused(x, p, SIZE, SIZE)
        want = decode_grid_ref(x, p, SIZE, SIZE)
        torch.cuda.synchronize()
        if library.launches("yolo_decode") != before + 1:
            raise RuntimeError("decode_fused did not count its launch")
        err = 0.0
        for g, r in zip(got, want):
            if g.shape != r.shape:
                raise RuntimeError(f"K1 shape {g.shape} != {r.shape}")
            torch.testing.assert_close(g, r, rtol=K1_RTOL, atol=K1_ATOL)
            err = max(err, float((g - r).abs().max()))
        t = [
            cuda_ms(lambda: decode_grid_ref(x, p, SIZE, SIZE)),
            cuda_ms(lambda: decode_fused(x, p, SIZE, SIZE)),
            cuda_ms(lambda: decode_fused(x, p, SIZE, SIZE)),
            cuda_ms(lambda: decode_grid_ref(x, p, SIZE, SIZE)),
        ]
        nbytes = 4 * (x.numel() + sum(g.numel() for g in got))
        rows.append(dict(shape=tuple(x.shape), max_abs_err=err,
                         ms=(t[1] + t[2]) / 2, plain_ms=(t[0] + t[3]) / 2,
                         cold_ms=cold_ms(
                             lambda: decode_fused(x, p, SIZE, SIZE), flush),
                         # a sigmoid or exp of each input: ~4 operations
                         bound=bound(nbytes, 4 * x.numel())))
        k_dev = device_us(lambda: decode_fused(x, p, SIZE, SIZE))
        p_dev = device_us(lambda: decode_grid_ref(x, p, SIZE, SIZE))
        print(f"K1 {tuple(x.shape)}: max_abs_err {err:.3g}; CUDA-event "
              f"time per call: kernel {rows[-1]['ms']:.4f} ms warm, "
              f"{rows[-1]['cold_ms']:.4f} ms cold, plain "
              f"{rows[-1]['plain_ms']:.4f} ms; device time per call "
              f"(profiler): kernel {fmt_device(sum(k_dev.values()), 20)}, "
              f"plain {fmt_device(sum(p_dev.values()), 20)} in "
              f"{len(p_dev)} kernel names; {nbytes / 1e6:.2f} MB "
              f"read+written, bound {1e3 * rows[-1]['bound'][0]:.2f} us")
    return rows


def same_detections(a, b):
    """Both branches keep the same slots with the same objectness; the
    rows (box, scores) kept agree as sets, since candidates whose fp32
    sigmoids tie may take their slots in another order on the other
    branch (top-k on logits vs on sigmoid values)."""
    (b1, s1, o1), (b2, s2, o2) = a, b
    alive = o1 > 0
    if not torch.equal(alive, o2 > 0) or not alive.any():
        raise RuntimeError("the two branches keep different slots")
    torch.testing.assert_close(o1, o2, rtol=K1_RTOL, atol=K1_ATOL)
    for i in range(o1.shape[0]):
        r1 = torch.cat([b1[i], s1[i]], 1)[alive[i]].double()
        r2 = torch.cat([b2[i], s2[i]], 1)[alive[i]].double()
        tol = K1_ATOL + K1_RTOL * r2.abs()[None]
        close = ((r1[:, None] - r2[None]).abs() <= tol).all(-1)
        match = close.double().argmax(1)
        if not close.any(1).all() or match.unique().numel() != len(match):
            raise RuntimeError(f"image {i}: the branches keep other boxes")


def bn_stats(net, seed=SEED):
    """BN running stats from a numpy seed: run_var in [0.5, 1.5],
    run_mean in [-0.1, 0.1] (zero stats would scale each BN by 1000)."""
    rng = np.random.RandomState(seed)
    out = {}
    for t in net.state_specs():
        lo, hi = (0.5, 1.5) if t.key.endswith("_run_var") else (-0.1, 0.1)
        out[t.key] = torch.from_numpy(
            rng.uniform(lo, hi, t.mem_shape).astype(np.float32)
        )
    return out


def serve(request, batches):
    """Answer each batch x as one request(x); returns (outputs on the
    host, latencies ms) with the host clock around the request, upload
    and sync included."""
    outs, lat = [], []
    for x in batches:
        t0 = time.perf_counter()
        out = request(x)
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
        outs.append(tuple(o.cpu() for o in out))
    return outs, lat


def k2_cases():
    """The three shears of one training step at 416 px, rotation 10,
    batch 32, each on the layout the path hands it (shifts as the shear
    chain makes them, from a random angle per image): pass 1 and 3 in
    row mode, pass 2 in column mode on r3's (32, 418, 438, 3); then
    ragged cases with integer and negative shifts, one a mode. Each case
    is (column mode, img, d, kmax, out_x0, out_w, in_x0)."""
    kx, ky, kx2, myc, mxc = _shear_bounds(10.0, SIZE, SIZE)
    gen = torch.Generator().manual_seed(SEED)
    n = TRAIN_BATCH
    theta = torch.deg2rad((torch.rand(n, generator=gen) - 0.5) * 10.0)
    alpha = -torch.tan(theta / 2)[:, None]
    beta = torch.sin(theta)[:, None]
    cy = cx = (SIZE - 1) / 2.0
    ar = torch.arange
    cases = [
        (False, (SIZE + 2 * myc, SIZE + 2 * mxc),
         alpha * (ar(SIZE + 2 * myc) - myc - cy), kx2, -kx, SIZE + 2 * kx,
         -mxc),
        (True, (SIZE + 2 * myc, SIZE + 2 * kx),
         beta * (ar(SIZE + 2 * kx) - kx - cx), ky, 0, SIZE, -myc),
        (False, (SIZE, SIZE + 2 * kx), alpha * (ar(SIZE) - cy), kx, 0, SIZE,
         -kx),
    ]
    out = []
    for column, hw, d, kmax, out_x0, out_w, in_x0 in cases:
        img = 255 * torch.rand(n, *hw, 3, generator=gen)
        out.append((column, img, d.float(), kmax, out_x0, out_w, in_x0))
    for column in (False, True):
        d = (2 * torch.rand(3, 37, generator=gen) - 1) * 8
        d[0, :5] = torch.tensor([2.0, -3.0, 0.0, -8.0, 8.0])
        img = 255 * torch.rand(3, 37, 53, 1, generator=gen)
        if column:
            img = img.transpose(1, 2).contiguous()
        out.append((column, img, d, 9, -9, 71, -1))
    return out


def check_k2():
    """K2 against its plain version on the card (bit for bit), timed warm
    in turns (plain, kernel, kernel, plain) and cold. Returns per-shape
    records."""
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    rows = []
    for column, img, d, kmax, out_x0, out_w, in_x0 in k2_cases():
        img, d = img.cuda(), d.cuda()
        args = (kmax, out_x0, out_w, in_x0, 128.0)
        fn, ref = (col_shift, col_shift_ref) if column else (row_shift,
                                                             row_shift_ref)
        before = library.launches("row_shift")
        got = fn(img, d, *args)
        want = ref(img, d, *args)
        torch.cuda.synchronize()
        if library.launches("row_shift") != before + 1:
            raise RuntimeError(f"{fn.__name__} did not count its launch")
        if got.shape != want.shape:
            raise RuntimeError(f"K2 shape {got.shape} != {want.shape}")
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise RuntimeError(f"K2 {fn.__name__} {tuple(img.shape)} is not "
                               f"bit-equal to its plain version: {err}")
        kern = lambda: fn(img, d, *args)  # noqa: E731
        plain = lambda: ref(img, d, *args)  # noqa: E731
        t = [cuda_ms(f, iters=30) for f in (plain, kern, kern, plain)]
        nbytes = 4 * (img.numel() + d.numel() + got.numel())
        rows.append(dict(shape=tuple(img.shape), out=tuple(got.shape),
                         kmax=kmax, max_abs_err=err, ms=(t[1] + t[2]) / 2,
                         plain_ms=(t[0] + t[3]) / 2,
                         cold_ms=cold_ms(kern, flush),
                         # two taps an output: 2 multiplies, 1 add
                         bound=bound(nbytes, 3 * got.numel())))
        r = rows[-1]
        k_dev = device_us(kern, iters=10)
        p_dev = device_us(plain, iters=10)
        mb = nbytes / 1e6
        kd = sum(k_dev.values()) / 10
        print(f"K2 {fn.__name__} {tuple(img.shape)} -> {tuple(got.shape)} "
              f"kmax {kmax}: bit-equal; CUDA-event time per call: kernel "
              f"{r['ms']:.4f} ms warm, {r['cold_ms']:.4f} ms cold "
              f"({r['bound'][0] / r['cold_ms']:.0%} of the bound), plain "
              f"{r['plain_ms']:.4f} ms; device time per call (profiler): "
              f"kernel {fmt_device(sum(k_dev.values()), 10)}, plain "
              f"{fmt_device(sum(p_dev.values()), 10)} in {len(p_dev)} "
              f"kernel names; {mb:.0f} MB read+written"
              + (f", {mb / kd:.2f} TB/s" if kd else "")
              + f", bound {1e3 * r['bound'][0]:.1f} us")
    return rows


def shear_chain_phase():
    """The whole shear chain of rotation augmentation on the card,
    `_rotate_3shear` at batch 32, 416 px, rotation 10: three K2 launches
    and no copy between them; its device time by kernel name; its output
    against the port's CPU run."""
    kx, ky, kx2, myc, mxc = _shear_bounds(10.0, SIZE, SIZE)
    gen = torch.Generator().manual_seed(SEED + 5)
    # A smooth image in [2, 254]: three waves a channel with periods of
    # 64 px or more, about the fill value 128, tapered to it over the 48
    # px at the canvas border. The card's tanf and sinf may differ from
    # the CPU's by a few ulps, which moves a shift by ~1e-6 px and an
    # output by that times the image's step there: on noise, and at
    # content-to-fill edges, that came to 3.8e-4 of the 5e-4 tolerance;
    # here 8 ulps of theta move no output by more than 7.6e-5 (the CPU
    # port). A wrong row or column still moves outputs by whole levels.
    h, w = SIZE + 2 * myc, SIZE + 2 * mxc

    def ramp(m):  # 0 at the border, 1 from 48 px inside it
        t = torch.arange(m, dtype=torch.float32)
        e = torch.clamp(torch.minimum(t, m - 1 - t) / 48, max=1.0)
        return e * e * (3 - 2 * e)

    yy = torch.arange(h, dtype=torch.float32)[:, None, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :, None]
    waves = torch.zeros((TRAIN_BATCH, h, w, 3))
    for _ in range(3):
        fy, fx, ph = (torch.rand(3, TRAIN_BATCH, 1, 1, 3, generator=gen)
                      * torch.tensor([1 / 64, 1 / 64, 2 * torch.pi])
                      .reshape(3, 1, 1, 1, 1)).unbind(0)
        waves += 42.0 * torch.sin(2 * torch.pi * ((fy - 1 / 128) * yy
                                                  + (fx - 1 / 128) * xx) + ph)
    mid = 128.0 + (ramp(h)[:, None] * ramp(w)[None, :])[..., None] * waves
    theta = torch.deg2rad((torch.rand(TRAIN_BATCH, generator=gen) - 0.5)
                          * 10.0)
    args = (SIZE, SIZE, kx, ky, kx2, myc, mxc, 128.0)
    mid_c, theta_c = mid.cuda(), theta.cuda()
    run = lambda: _rotate_3shear(mid_c, theta_c, *args)  # noqa: E731
    before = library.launches("row_shift")
    got = run()
    torch.cuda.synchronize()
    if library.launches("row_shift") != before + 3:
        raise RuntimeError("the shear chain did not make 3 K2 launches")
    want = _rotate_3shear(mid, theta, *args)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=WARP_ATOL)
    err = float((got.cpu() - want).abs().max())
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    warm, cold = cuda_ms(run, iters=30), cold_ms(run, flush)
    dev = device_us(run, iters=10)
    copies = [k for k in dev if "copy" in k.lower()]
    if copies:
        raise RuntimeError(f"the shear chain copies on the card: {copies}")
    total = sum(dev.values()) / 10
    print(f"shear chain _rotate_3shear {tuple(mid.shape)} -> "
          f"{tuple(got.shape)}: card vs CPU max_abs_err {err:.3g} (limit "
          f"{WARP_ATOL}); CUDA-event time {1e3 * warm:.1f} us warm, "
          f"{1e3 * cold:.1f} us cold; device time "
          + (f"{total:.1f} us a chain, by kernel name (no copy):"
             if total else "not measured"))
    for k, us in sorted(dev.items(), key=lambda kv: -kv[1]):
        print(f"    {us / 10:8.1f} us  {k[:90]}")


def check_k3():
    """K3 against depthwise_fused_ref on the card: the nine MobileNet
    shapes, then the ragged ones. Timed warm in turns (plain, kernel,
    library, library, kernel, plain), the library being the grouped conv
    F.conv2d(x, w, b, stride, pad, groups=C) without the activation;
    then cold (each launch after a write larger than L2, timed by its own
    events), kernel and library, from which the share of the bound is
    taken. Returns per-shape records, the MobileNet ones first."""
    gen = torch.Generator().manual_seed(SEED)
    cases = [(n, c, h, w, 3, s, 1, Activation.RELU)
             for n, c, h, w, s in K3_MOBILENET] + K3_RAGGED
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    rows = []
    for n, c, h, w, k, stride, pad, act in cases:
        x = torch.randn(n, c, h, w, generator=gen).cuda()
        wt = (torch.randn(c, 1, k, k, generator=gen)
              * (2.0 / (k * k)) ** 0.5).cuda()
        b = (0.2 * torch.rand(c, generator=gen) - 0.1).cuda()
        args = (x, wt, b, stride, pad, act)
        before = library.launches("depthwise")
        got = depthwise_fused(*args)
        want = depthwise_fused_ref(*args)
        torch.cuda.synchronize()
        if library.launches("depthwise") != before + 1:
            raise RuntimeError("depthwise_fused did not count its launch")
        if got.shape != want.shape:
            raise RuntimeError(f"K3 shape {got.shape} != {want.shape}")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= K3_RTOL * scale:
            raise RuntimeError(f"K3 {tuple(x.shape)} k{k} s{stride} p{pad} "
                               f"{act.name}: max_abs_err {err} > "
                               f"{K3_RTOL} x {scale}")
        iters = 50 if n == 64 else 20
        kern = lambda: depthwise_fused(*args)  # noqa: E731
        plain = lambda: depthwise_fused_ref(*args)  # noqa: E731
        lib = lambda: F.conv2d(x, wt, b, stride, pad, 1, c)  # noqa: E731
        t = [cuda_ms(f, iters=iters)
             for f in (plain, kern, lib, lib, kern, plain)]
        nbytes = 4 * (x.numel() + got.numel())
        rows.append(dict(
            shape=tuple(x.shape), max_abs_err=err,
            bit_equal=bool(torch.equal(got, want)),
            ms=(t[1] + t[4]) / 2, plain_ms=(t[0] + t[5]) / 2,
            library_ms=(t[2] + t[3]) / 2, cold_ms=cold_ms(kern, flush),
            library_cold_ms=cold_ms(lib, flush),
            bound=bound(nbytes, 2 * k * k * got.numel()), mb=nbytes / 1e6))
        r = rows[-1]
        k_dev = device_us(kern, iters=10)
        p_dev = device_us(plain, iters=10)
        kd = sum(k_dev.values()) / 10
        r["dev_ms"] = kd / 1e3 if kd else None
        print(f"K3 {tuple(x.shape)} k{k} s{stride} p{pad} {act.name} -> "
              f"{tuple(got.shape)}: max_abs_err {err:.3g} (largest output "
              f"{scale:.3g}, bit-equal {r['bit_equal']}); {r['mb']:.1f} MB "
              f"read+written, bound {1e3 * r['bound'][0]:.1f} us "
              f"({r['bound'][1]}); CUDA-event time per call, warm: kernel "
              f"{1e3 * r['ms']:.1f} us, plain {1e3 * r['plain_ms']:.1f} us, "
              f"library {1e3 * r['library_ms']:.1f} us; cold: kernel "
              f"{1e3 * r['cold_ms']:.1f} us "
              f"({r['bound'][0] / r['cold_ms']:.0%} of the bound), library "
              f"{1e3 * r['library_cold_ms']:.1f} us; kernel <= library "
              f"{r['ms'] <= r['library_ms']} (warm), "
              f"{r['cold_ms'] <= r['library_cold_ms']} (cold); device time "
              f"per call (profiler): kernel "
              f"{fmt_device(sum(k_dev.values()), 10)}, plain "
              f"{fmt_device(sum(p_dev.values()), 10)} in {len(p_dev)} "
              f"kernel names"
              + (f", {r['mb'] / kd:.2f} TB/s" if kd else ""))
    del flush
    fwd = {key: sum(m * (r[key][0] if key == "bound" else r[key])
                    for m, r in zip(K3_PER_FORWARD, rows))
           for key in ("ms", "cold_ms", "plain_ms", "library_ms",
                       "library_cold_ms", "bound")}
    print(f"K3 per MobileNet-v1 forward (13 launches, batch 64): warm "
          f"{fwd['ms']:.4f} ms, cold {fwd['cold_ms']:.4f} ms, device "
          f"{forward_dev_ms(rows)} (profiler), bound "
          f"{fwd['bound']:.4f} ms ({fwd['bound'] / fwd['cold_ms']:.0%} of "
          f"it cold); plain {fwd['plain_ms']:.4f} ms; library "
          f"{fwd['library_ms']:.4f} ms warm, {fwd['library_cold_ms']:.4f} "
          "ms cold")
    return rows


def forward_dev_ms(rows) -> str:
    """The profiler's device time of a MobileNet-v1 forward's launches
    (rows: the nine depthwise shapes in K3_MOBILENET's order), which the
    host's launch time cannot reach, unlike the CUDA-event times when one
    call's host time outgrows the sleep queued before it."""
    dev = [r.get("dev_ms") for r in rows[:len(K3_PER_FORWARD)]]
    if None in dev:
        return "not measured"
    return f"{sum(m * d for m, d in zip(K3_PER_FORWARD, dev)):.4f} ms"


def k4_path_cases(net, name, bn_mode):
    """The convs of `net` (416 px, batch 8) in the form its int8 path runs
    them, one case a distinct shape: (name, (n, c, h, w, o, k, stride,
    pad), BN, the activation, int8 out, the launches of that shape a
    request). The trunk convs run BN + LRELU + int8 out, the heads a
    linear fp32 output. bn_mode: "unfolded" (mean and 1/sqrt(var)
    applied: YOLOv3-tiny's path, random weights and no file) or "folded"
    (the scale only, as after a weight file's load in PREDICT: full
    YOLOv3's path)."""
    cases = {}
    for node in net.nodes:
        if node.type.name != "CONV2D":
            continue
        s, d, p = net.tensors[node.src[0]], net.tensors[node.dst[0]], node.param
        bn = bool(p["batch_norm"])
        shape = (s.n, s.c, s.h, s.w, d.c, p["size"], p["stride"], p["pad"])
        if shape in cases:
            cases[shape][-1] += 1
        else:
            cases[shape] = [f"{name}:{d.name}", shape, bn_mode if bn else None,
                            Activation(p["activation"]), bn, 1]
    return [tuple(c) for c in cases.values()]


def k4_args(shape, bn, act, int8_out, gen):
    """Random int8 x (channels-last, as the int8 flow holds it) and w
    ((O, k, k, C) in memory) on the card and the epilogue's vectors, d
    scaled so that y spreads over the int8 codes of s_out = 2/127; bn
    "unfolded", "folded" or None."""
    n, c, h, w, o, k, stride, pad = shape
    x = torch.randint(-127, 128, (n, c, h, w), generator=gen,
                      dtype=torch.int8).contiguous(
                          memory_format=torch.channels_last)
    wt = channels_last_weight(torch.randint(
        -127, 128, (o, c, k, k), generator=gen, dtype=torch.int8))
    u = lambda lo, hi: (lo + (hi - lo) * torch.rand(o, generator=gen)  # noqa
                        ).cuda()
    # |acc| ~ (127^2 / 3) sqrt(K)
    d = u(0.5, 1.5) * (3.0 / (127.0**2 * (c * k * k) ** 0.5))
    kw = dict(act=act, s_out=2.0 / 127 if int8_out else None)
    if bn:
        kw.update(scale=u(0.8, 1.2))
    if bn == "unfolded":
        kw.update(mean=u(-0.1, 0.1), inv=1 / torch.sqrt(u(0.5, 1.5) + 1e-6))
    return (x.cuda(), wt.cuda(), d, u(-0.1, 0.1), stride, pad), kw


def k4_request(rows, label):
    """Sums of one request's K4 rows (each shape times its launches);
    prints them."""
    tot = {key: sum(r["n"] * (r[key][0] if key == "bound" else r[key])
                    for r in rows)
           for key in ("ms", "cold_ms", "plain_ms", "library_ms",
                       "library_cold_ms", "bound")}
    launches = sum(r["n"] for r in rows)
    print(f"K4 per {label} int8 request ({launches} launches): warm {tot['ms']:.4f} ms, cold {tot['cold_ms']:.4f} ms, "
          f"bound {tot['bound']:.4f} ms ({tot['bound'] / tot['cold_ms']:.0%} "
          f"of it cold); plain {tot['plain_ms']:.2f} ms; library (bf16 "
          f"cuDNN) {tot['library_ms']:.4f} ms warm, "
          f"{tot['library_cold_ms']:.4f} ms cold")
    return tot


def check_k4():
    """K4 against conv_int8_fused_ref on the card, bit for bit: the 13
    YOLOv3-tiny 416 convs and the 23 distinct shapes of full YOLOv3's 75
    (batch 8) in their path's form and in the other (int8 or fp32 out,
    BN or none, LRELU or NONE), then ragged shapes in both forms, each
    shape's plan printed. Each path shape timed warm in turns (plain,
    kernel, library, library, kernel, plain), the library being the
    cuDNN bf16 conv of the same values (F.conv2d on NCHW bf16 tensors:
    PyTorch has no int8 conv on CUDA), then cold. Returns (YOLOv3-tiny
    rows, full YOLOv3 rows, all rows); a path row's "n" is its launches
    a request."""
    gen = torch.Generator().manual_seed(SEED)
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    paths = {"yolov3_tiny": [], "yolov3": [], "mobilenet_v1": [],
             "resnet18": []}
    rows = []
    # phase 11's int8 classifiers at batch 64: their convs, and the FC as
    # the 1x1 conv K4 runs for it (no BN, fp32 out)
    fcs = [(f"{name}:fc", (I8_BATCH, c, 1, 1, 1000, 1, 1, 0), None,
            Activation.NONE, False, 1)
           for name, c in (("mobilenet_v1", 1024), ("resnet18", 512))]
    cases = [c + (True,) for c in
             k4_path_cases(yolov3_tiny(BATCH, SIZE, SIZE, CLASSES),
                           "yolov3_tiny", "unfolded")
             + k4_path_cases(yolov3(BATCH, SIZE, SIZE, CLASSES), "yolov3",
                             "folded")
             + k4_path_cases(mobilenet_v1(I8_BATCH, 1000), "mobilenet_v1",
                             "unfolded") + fcs[:1]
             + k4_path_cases(resnet18(I8_BATCH, 1000), "resnet18",
                             "unfolded") + fcs[1:]]
    cases += [(f"ragged{i}", shape, "unfolded" if i % 2 == 0 else None,
               Activation.LRELU, i % 2 == 0, 0, False)
              for i, shape in enumerate(K4_RAGGED)]
    for name, shape, bn, act, int8_out, n_req, timed in cases:
        other = (None if bn else "unfolded", Activation.NONE
                 if act == Activation.LRELU else Activation.LRELU,
                 not int8_out)
        err = 0.0
        for form in ((bn, act, int8_out), other):
            args, kw = k4_args(shape, *form, gen)
            before = library.launches("conv_int8")
            got = conv_int8_fused(*args, **kw)
            want = conv_int8_fused_ref(*args, **kw)
            torch.cuda.synchronize()
            if library.launches("conv_int8") != before + 1:
                raise RuntimeError("conv_int8_fused did not count its launch")
            if got.shape != want.shape or got.dtype != want.dtype:
                raise RuntimeError(f"K4 {name}: {got.shape} {got.dtype} != "
                                   f"{want.shape} {want.dtype}")
            e = float((got.float() - want.float()).abs().max())
            if not torch.equal(got, want):
                raise RuntimeError(f"K4 {name} {shape} {form} is not bit-equal"
                                   f" to its plain version: {e}")
            err = max(err, e)
            del got, want
        rows.append(dict(name=name, max_abs_err=err))
        plan = plan_conv_int8(*shape, sms=kernels.sm_count(
            torch.device("cuda")))
        plan_s = (f"plan {plan.bm}x{plan.bn} tiles, K in {plan.splits} "
                  f"run(s) of {plan.split_steps} of {plan.steps} steps, "
                  f"{plan.blocks} blocks")
        if not timed:
            print(f"K4 {name} {shape}: bit-equal in both forms; {plan_s}")
            continue
        args, kw = k4_args(shape, bn, act, int8_out, gen)
        x, wt, _, _, stride, pad = args
        xb = x.contiguous().to(torch.bfloat16)
        wb = wt.contiguous().to(torch.bfloat16)
        kern = lambda: conv_int8_fused(*args, **kw)  # noqa: E731
        plain = lambda: conv_int8_fused_ref(*args, **kw)  # noqa: E731
        lib = lambda: F.conv2d(xb, wb, None, stride, pad)  # noqa: E731
        t = [cuda_ms(f, iters=i, warmup=w) for f, i, w in (
            (plain, 3, 1), (kern, 50, 5), (lib, 50, 5), (lib, 50, 5),
            (kern, 50, 5), (plain, 3, 1))]
        n, c, h, w, o, k, _, _ = shape
        out = kern()
        m_rows = out.shape[0] * out.shape[2] * out.shape[3]
        nbytes = x.numel() + wt.numel() + out.numel() * out.element_size()
        ops = 2 * m_rows * o * c * k * k
        r = rows[-1]
        r.update(shape=shape, n=n_req, ms=(t[1] + t[4]) / 2,
                 plain_ms=(t[0] + t[5]) / 2, library_ms=(t[2] + t[3]) / 2,
                 cold_ms=cold_ms(kern, flush),
                 library_cold_ms=cold_ms(lib, flush),
                 bound=bound(nbytes, ops, PEAK_OPS["int8"]), mb=nbytes / 1e6,
                 gop=ops / 1e9)
        paths[name.split(":")[0]].append(r)
        del x, wt, xb, wb, out, args
        bn_s = {None: "no BN", "folded": "BN folded",
                "unfolded": "BN"}[bn]
        print(f"K4 {name} {shape} x{n_req} {bn_s} {act.name} "
              f"{'int8' if int8_out else 'fp32'} out: bit-equal in both forms;"
              f" {r['mb']:.2f} MB, {r['gop']:.2f} G int8 ops, bound "
              f"{1e3 * r['bound'][0]:.2f} us ({r['bound'][1]}); warm: kernel "
              f"{1e3 * r['ms']:.1f} us, plain {1e3 * r['plain_ms']:.1f} us, "
              f"library (bf16 cuDNN) {1e3 * r['library_ms']:.1f} us; cold: "
              f"kernel {1e3 * r['cold_ms']:.1f} us "
              f"({r['bound'][0] / r['cold_ms']:.0%} of the bound), library "
              f"{1e3 * r['library_cold_ms']:.1f} us; "
              f"{r['gop'] / r['ms']:.1f} TOPS warm; {plan_s}")
    del flush
    k4_request(paths["yolov3_tiny"], "YOLOv3-tiny 416")
    k4_request(paths["yolov3"], "full YOLOv3 416")
    k4_request(paths["mobilenet_v1"], "MobileNet-v1 224, batch 64,")
    k4_request(paths["resnet18"], "ResNet-18 224, batch 64,")
    return paths["yolov3_tiny"], paths["yolov3"], rows


def check_detections(out, n):
    for t, shape in zip(out, [(n, 100, 4), (n, 100, CLASSES), (n, 100)]):
        if tuple(t.shape) != shape or not torch.isfinite(t.float()).all():
            raise RuntimeError(f"bad detection output {tuple(t.shape)}")


def yolo_bf16_phase():
    """YOLOv3-tiny 416 at batch 8 with compute_dtype = act_dtype = bf16
    (bench.py's forward and detect), both detection branches: a warm-up
    request and one after it each, the launch counts set to 0 before
    each branch, K6 on every BN conv; the heads of two images against
    the port's CPU run. Returns K6's launches on the path."""
    net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES)
    net.compute_dtype = net.act_dtype = torch.bfloat16
    sess = Session(net, SEED, device="cuda")
    sess.state = bn_stats(net)
    sess.compile_net()
    x = np.random.RandomState(SEED + 6).rand(BATCH, 3, SIZE, SIZE).astype(
        np.float32)
    k6 = 0
    for label, topk_first in (("decode-everything (K1)", False),
                              ("top-k-first", True)):
        zero_counts()
        req = lambda v: sess.detect_on_batch(  # noqa: E731
            v, topk_first=topk_first)
        outs, _ = serve(req, [x, x])
        want = none_but(K1=0 if topk_first else 2 * len(outs),
                        K6=k6_convs(net) * len(outs))
        got = counts()
        if got != want:
            raise RuntimeError(f"bf16 {label}: launches {got}, wanted "
                               f"{want}")
        k6 += got["K6"]
        for o in outs:
            check_detections(o, BATCH)
    heads = ["lid16", "lid23"]
    g_heads, _ = sess.predict_on_batch(x, outputs=heads)
    cpu = Session(net, SEED, device="cpu")
    cpu.params = {k: v.cpu() for k, v in sess.params.items()}
    cpu.state = {k: v.cpu() for k, v in sess.state.items()}
    cpu.compile_net()
    c_heads, _ = cpu.predict_on_batch(x[:2], outputs=heads)
    for name, g, c in zip(heads, g_heads, c_heads):
        g, c = g[:2].cpu().float(), c.float()
        share = float((g - c).abs().max()) / float(c.abs().max())
        if g.dtype != c.dtype or not share <= BF16_HEAD_TOL:
            raise RuntimeError(f"bf16 head {name}: card vs CPU differ by "
                               f"{share:.3g} of the largest value")
        print(f"bf16 head {name} {tuple(g.shape)}: card vs CPU max_abs_err "
              f"{share:.3g} of the largest value (limit {BF16_HEAD_TOL}), "
              f"{float((g != c).float().mean()):.3g} of the values differ")
    return k6


def yolo_int8_phase():
    """YOLOv3-tiny 416 at batch 8, bench.py's int8 program: bf16 compute
    and storage, ptq_synthetic (run on the CPU once, so that card and CPU
    share the quant dict), detect on the top-k-first branch: a warm-up
    request and one after it with the launch counts set to 0 before
    them, 13 K4 launches a request; then two images through the card and
    the CPU: every int8 flow tensor and both raw heads equal, and the
    detections. Returns K4's launches on the path."""
    net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES)
    net.compute_dtype = net.act_dtype = torch.bfloat16
    cpu = Session(net, SEED, device="cpu")
    cpu.state = bn_stats(net)
    cpu.compile_net()
    t0 = time.perf_counter()
    quant_cpu = ptq_synthetic(net, cpu)
    print(f"ptq_synthetic on the CPU: {time.perf_counter() - t0:.1f} s, "
          f"{len(quant_cpu['act_scales'])} act scales, "
          f"{len(quant_cpu['weights'])} int8 weights")
    quant_gpu = dict(quant_cpu, weights={
        k: {kk: vv.cuda() for kk, vv in e.items()}
        for k, e in quant_cpu["weights"].items()})
    sess = Session(net, SEED, device="cuda")
    sess.params = {k: v.cuda() for k, v in cpu.params.items()}
    sess.state = {k: v.cuda() for k, v in cpu.state.items()}
    sess.compile_net()
    net.quant = quant_gpu
    x = np.random.RandomState(SEED + 7).rand(BATCH, 3, SIZE, SIZE).astype(
        np.float32)

    zero_counts()
    req = lambda v: sess.detect_on_batch(v)  # noqa: E731
    outs, _ = serve(req, [x, x])
    got = counts()
    k4_launches = got["K4"]
    if k4_launches != 13 * len(outs):
        raise RuntimeError(f"K4 launched {k4_launches} times in {len(outs)} "
                           "int8 requests")
    if got["K1"] or got["K3"] or got["K2"] or got["K6"]:
        raise RuntimeError(f"the int8 path launched {got}")
    for o in outs:
        check_detections(o, BATCH)

    x2 = x[:2]
    with torch.inference_mode():
        got = execute(net, sess.params, sess.state,
                      {"input": torch.from_numpy(x2).cuda()}, Mode.PREDICT)
        g_det = sess.detect_on_batch(x2)
        net.quant = quant_cpu
        want = execute(net, cpu.params, cpu.state,
                       {"input": torch.from_numpy(x2)}, Mode.PREDICT)
        c_det = cpu.detect_on_batch(x2)
    n_int8 = 0
    for i, v in want.values.items():
        g = got.values[i].cpu()
        name = net.tensors[i].name
        if v.dtype == torch.int8:
            n_int8 += 1
            if not got.values[i].is_contiguous(
                    memory_format=torch.channels_last):
                raise RuntimeError(f"int8 path: {name} is not channels-last"
                                   " on the card")
        if v.dtype in (torch.int8, torch.bfloat16) and not torch.equal(g, v):
            raise RuntimeError(f"int8 path: {name} ({v.dtype}) differs between"
                               " card and CPU")
    if n_int8 < 10:
        raise RuntimeError(f"only {n_int8} int8 tensors on the int8 path")
    alive = c_det[2] > 0
    if not torch.equal(g_det[2].cpu() > 0, alive):
        raise RuntimeError("int8 detect: card and CPU keep other slots")
    exact = all(torch.equal(g.cpu(), c) for g, c in zip(g_det, c_det))
    for g, c in zip(g_det, c_det):
        torch.testing.assert_close(g.cpu().float(), c.float(), rtol=2.0**-7,
                                   atol=1e-6)
    print(f"int8 path card vs CPU, two images, one quant dict: all {n_int8} "
          f"int8 flow tensors (channels-last) and both bf16 heads "
          f"bit-equal; detections "
          f"{'bit-equal' if exact else 'within one bf16 rounding'} "
          f"({int(alive.sum())} kept)")
    return k4_launches


def mobilenet_phase(bf16=False):
    """MobileNet-v1 PREDICT at batch 64, 224 px, 1000 classes, fp32 (or,
    with bf16, compute_dtype = act_dtype = bf16: K3 on the bf16-rounded
    values in fp32), with He-scaled weights from a numpy seed: a
    warm-up and MB_REQUESTS requests (one at bf16), with the launch
    counts set to 0 before them; fc and softmax of the first two images
    against the port's CPU run; K6 on every BN conv. Returns (K3, K6)
    launches on the path."""
    net = mobilenet_v1(MB_BATCH, MB_CLASSES)
    if bf16:
        net.compute_dtype = net.act_dtype = torch.bfloat16
    p_np, s_np = bridge.he_numpy_weights(net, SEED)
    sess = Session(net, SEED, device="cuda")
    sess.params, sess.state = bridge.params_from_numpy(net, p_np, s_np,
                                                       device="cuda")
    sess.compile_net()
    rng = np.random.RandomState(SEED + 4)
    batches = [rng.rand(MB_BATCH, 3, MB_SIZE, MB_SIZE).astype(np.float32)
               for _ in range(1 if bf16 else MB_REQUESTS + 1)]
    if bf16:  # the first one warms up; the card vs CPU check reads [1]
        batches.append(batches[0])

    zero_counts()
    outs, _ = serve(
        lambda x: sess.predict_on_batch(x, outputs=MB_OUTPUTS)[0], batches)
    k3_launches = library.launches("depthwise")
    forwards = len(batches)
    if k3_launches != 13 * forwards:
        raise RuntimeError(
            f"K3 launched {k3_launches} times in {forwards} forwards"
        )
    k6_launches = library.launches("bn_act")
    if k6_launches != k6_convs(net) * forwards:
        raise RuntimeError(
            f"K6 launched {k6_launches} times in {forwards} forwards")
    if library.launches("yolo_decode") or library.launches("row_shift") or \
            library.launches("conv_int8"):
        raise RuntimeError("the MobileNet path launched K1, K2 or K4")

    for out in outs:
        for t in out:
            if tuple(t.shape) != (MB_BATCH, MB_CLASSES, 1, 1) or not bool(
                    torch.isfinite(t).all()):
                raise RuntimeError(f"bad MobileNet output {tuple(t.shape)}")
    cpu = Session(net, SEED, device="cpu")
    cpu.params, cpu.state = bridge.params_from_numpy(net, p_np, s_np)
    cpu.compile_net()
    want, _ = cpu.predict_on_batch(batches[1][:2], outputs=MB_OUTPUTS)
    for name, g, c in zip(MB_OUTPUTS, outs[1], want):
        g = g[:2]
        if bf16:
            share = float((g - c).abs().max()) / float(c.abs().max())
            if not share <= BF16_FC_TOL:
                raise RuntimeError(f"bf16 {name}: card vs CPU differ by "
                                   f"{share:.3g} of the largest value")
        else:
            torch.testing.assert_close(g, c, rtol=HEAD_RTOL, atol=HEAD_ATOL)
        print(f"{name} {tuple(g.shape)} GPU vs CPU max_abs_err "
              f"{float((g - c).abs().max()):.3g}, std {float(c.std()):.3g}")
    fc_g, fc_c = outs[1][0][:2].flatten(1), want[0].flatten(1)
    if float(fc_c.std()) <= 0.05:
        raise RuntimeError("degenerate fc logits")
    top2 = fc_c.topk(2, dim=1).values
    # at bf16, top-1 is held equal where the CPU's margin to the second
    # logit exceeds twice the tolerance
    sure = (top2[:, 0] - top2[:, 1]) > (
        2 * BF16_FC_TOL * float(fc_c.abs().max()) if bf16 else 0.0)
    if not torch.equal(fc_g.argmax(1)[sure], fc_c.argmax(1)[sure]):
        raise RuntimeError("top-1 differs between card and CPU")
    print(f"top-1 {fc_g.argmax(1).tolist()} on the card, "
          f"{fc_c.argmax(1).tolist()} on the CPU, margin to the second "
          f"{(top2[:, 0] - top2[:, 1]).tolist()}")
    return k3_launches, k6_launches


def host_detections_agree(a, b):
    """Two yolo_get_detections lists (card, CPU): the same length, the
    same number suppressed; the kept boxes agree as sets within the fp32
    head tolerance (candidates whose objectness ties within it may take
    each other's places in the sorted list)."""
    if len(a) != len(b) or not a:
        raise RuntimeError(f"yolo_get_detections: {len(a)} boxes on the "
                           f"card, {len(b)} on the CPU")

    def kept(ds):
        return np.array([[d["x"], d["y"], d["w"], d["h"], d["objectness"]]
                         + list(d["prob"]) for d in ds if d["objectness"] > 0])

    ka, kb = kept(a), kept(b)
    if ka.shape != kb.shape or not len(ka):
        raise RuntimeError(f"yolo_get_detections: {len(ka)} kept on the "
                           f"card, {len(kb)} on the CPU")
    tol = HEAD_ATOL + HEAD_RTOL * np.abs(kb)[None]
    close = (np.abs(ka[:, None] - kb[None]) <= tol).all(-1)
    match = close.argmax(1)
    if not close.any(1).all() or len(set(match.tolist())) != len(match):
        raise RuntimeError("yolo_get_detections: card and CPU keep other "
                           "boxes")
    return len(ka)


def host_thresh(cpu, x1, yolo_names):
    """A threshold between two objectness values of image x1 on the CPU,
    about HOST_DETS from the top with a gap of at least 1e-4 to the next,
    so that no candidate straddles it between the two devices and the
    host's O(n^2) NMS loop stays short."""
    outs, _ = cpu.predict_on_batch(x1, outputs=yolo_names)
    obj = torch.cat([o.reshape(1, 3, 5 + CLASSES, -1)[0, :, 4].flatten()
                     for o in outs]).double().sort(descending=True).values
    for k in range(HOST_DETS, len(obj) - 1):
        if obj[k] - obj[k + 1] >= 1e-4:
            return float((obj[k] + obj[k + 1]) / 2)
    raise RuntimeError("no objectness gap for the host detections")


# full YOLOv4 (phase 6e): benchmark/configs/yolov4-608.cfg at its 608 px,
# batch 8, with the benchmark reference's seeded weights; its fp32 heads
# within YOLOV4_FP32_TOL of the reference's (||port - ref|| / ||ref||:
# cuDNN's algorithms sum in their own orders, on both sides, through 110
# convs), its bf16 heads within the benchmark cell's `heads` limit
YOLOV4_BATCH, YOLOV4_SIZE = 8, 608
YOLOV4_FP32_TOL = 1e-4


def yolov4_phase():
    """Full YOLOv4 (CSPDarknet53 with Mish, SPP, PANet, three heads with
    scale_x_y) at 608 px, batch YOLOV4_BATCH, 80 classes: the benchmark's
    program (`benchmark/program.Served`: models.yolov4 from the frozen
    cfg, the reference's seeded weights) served in fp32 and bf16 on the
    top-k-first branch, a warm-up request and one after it each with the
    launch counts set to 0 before them: one K6 launch a BN conv a request
    (72 MISH, 35 LRELU) and no other kernel. The heads of two images
    against the plain reference (`benchmark/reference/yolov4.py`, fp32,
    TF32 off) at YOLOV4_FP32_TOL (fp32) and the cell's `heads` limit
    (bf16). The decode-everything branch raises on the heads'
    scale_x_y, and int8 serving raises naming MISH. Returns K6's
    launches on the path, and those of its MISH form."""
    from benchmark import harness
    from benchmark.program import Served

    cell = harness.load_cell("yolov4-608.detect-bf16.b64")
    ref, cfg = cell["ref"], dict(cell["cfg"], input_size=YOLOV4_SIZE)
    layers = ref.build(cfg["cfg_path"], YOLOV4_SIZE)
    weights = ref.make_weights(layers, SEED, "cuda")
    x = np.random.RandomState(SEED + 9).rand(
        YOLOV4_BATCH, 3, YOLOV4_SIZE, YOLOV4_SIZE).astype(np.float32)
    with torch.no_grad():
        want = ref.forward(layers, weights, torch.as_tensor(x[:2]).cuda())
    k6 = mish = 0
    for prec, tol in (("fp32", YOLOV4_FP32_TOL),
                      ("bf16", cell["check"]["limits"]["heads"])):
        served = Served(cfg, dict(cell, batch=YOLOV4_BATCH, precision=prec),
                        weights, None, "cuda")
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        outs, _ = serve(served.detect, [x, x])
        n_bn = k6_convs(served.net)
        got = counts()
        by_act = {a: library.launches("bn_act", a)
                  for a in ("MISH", "LRELU")}
        # bf16 runs channels-last (`compile.channels_last_layout`): every
        # K6 launch its channels-last form; fp32 NCHW
        cl = library.launches("bn_act", "channels_last")
        if (n_bn != 107 or got != none_but(K6=n_bn * len(outs))
                or by_act != {"MISH": 72 * len(outs),
                              "LRELU": 35 * len(outs)}
                or cl != (got["K6"] if prec == "bf16" else 0)):
            raise RuntimeError(f"YOLOv4 {prec}: launches {got}, by "
                               f"activation {by_act}, channels-last {cl}, "
                               f"{n_bn} BN convs")
        k6 += got["K6"]
        mish += by_act["MISH"]
        for o in outs:
            check_detections(o, YOLOV4_BATCH)
        heads = served.heads(x[:2])
        gaps = [float((h.cuda() - r).norm() / r.norm())
                for h, r in zip(heads, want)]
        if not max(gaps) <= tol:
            raise RuntimeError(f"YOLOv4 {prec} heads against the reference: "
                               f"{gaps} (limit {tol})")
        print(f"YOLOv4 {prec} at {YOLOV4_SIZE} px, batch {YOLOV4_BATCH}: "
              f"K6 {by_act['MISH'] // len(outs)} MISH + "
              f"{by_act['LRELU'] // len(outs)} LRELU a request "
              f"({cl // len(outs)} in the channels-last form); heads "
              f"against the reference {', '.join(f'{g:.3g}' for g in gaps)}"
              f" (limit {tol}); peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        if prec == "bf16":
            try:
                served.sess.detect_on_batch(x, topk_first=False)
            except ValueError as e:
                print(f"YOLOv4 decode-everything raises: {e}")
            else:
                raise RuntimeError("YOLOv4's decode-everything did not "
                                   "raise on scale_x_y")
        served.free()
    calib = torch.rand(4, 3, YOLOV4_SIZE, YOLOV4_SIZE,
                       generator=torch.Generator().manual_seed(SEED)).numpy()
    served = Served(cfg, dict(cell, batch=YOLOV4_BATCH, precision="int8"),
                    weights, calib, "cuda")
    try:
        served.detect(x)
    except ValueError as e:
        if "MISH" not in str(e):
            raise
        print(f"YOLOv4 int8 raises: {e}")
    else:
        raise RuntimeError("YOLOv4 int8 served on the card without MISH")
    served.free()
    return k6, mish


def yolov3_phase():
    """Full YOLOv3 from examples/yolo/yolov3.cfg (Darknet-53, 75 convs,
    23 shortcuts, three heads) at 416 px, batch 8, 80 classes: a Darknet
    .weights file written by save_weights_darknet from seeded weights
    into a temporary directory, loaded by Session.load_weights (BN
    folded), served in fp32, bf16 and int8 (ptq_synthetic, int8
    activations through the shortcuts, K4 on all 75 convs), each on both
    detection branches: a warm-up request and one after it with the
    launch counts set to 0 before each, K1 three times a
    decode-everything request. Against the port's CPU run on two images:
    fp32 heads at the fp32 head tolerance, bf16 within BF16_HEAD_TOL of
    the largest value, int8 every int8 and bf16 tensor equal under one
    quant dict; yolo_get_detections of one image equal; K6 on every BN
    conv in fp32 and bf16. Returns (K1, K4, K6) launches on the path."""
    t_phase = time.perf_counter()
    net = yolov3(BATCH, SIZE, SIZE, CLASSES)
    heads = [net.tensors[n.src[0]].name for n in net.nodes
             if n.type.name == "YOLOV3"]
    yolo_out = [net.tensors[n.dst[0]].name for n in net.nodes
                if n.type.name == "YOLOV3"]
    n_conv = sum(n.type.name == "CONV2D" for n in net.nodes)
    adds = [n.dst[0] for n in net.nodes if n.type.name == "ELTWISE"]
    params, state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, SEED,
                                      residual_scale=RESIDUAL_SCALE))
    sess = Session(net, SEED, device="cuda").compile_net()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "yolov3.weights")
        t0 = time.perf_counter()
        save_weights_darknet(net, params, state, path)
        t1 = time.perf_counter()
        sess.load_weights(path)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        mb = os.path.getsize(path) / 1e6
    del params, state
    if not net.bn_folded:
        raise RuntimeError("load_weights in PREDICT did not fold BN")
    print(f"full YOLOv3: {n_conv} convs, {len(adds)} shortcuts, heads "
          f"{heads}; {sum(v.numel() for v in sess.params.values()) / 1e6:.1f}"
          f" M params; .weights {mb:.1f} MB written in {t1 - t0:.1f} s, "
          f"loaded to the card (BN folded) in {t2 - t1:.1f} s")
    cpu = Session(net, SEED, device="cpu")

    def to_cpu():
        cpu.params = {k: v.cpu() for k, v in sess.params.items()}
        cpu.state = {k: v.cpu() for k, v in sess.state.items()}

    to_cpu()
    x = np.random.RandomState(SEED + 8).rand(BATCH, 3, SIZE, SIZE).astype(
        np.float32)
    x2 = x[:2]
    k1_total = k4_total = k6_total = 0
    for prec in ("fp32", "bf16", "int8"):
        if prec != "fp32":
            net.compute_dtype = net.act_dtype = torch.bfloat16
        if prec == "int8":
            t0 = time.perf_counter()
            quant_gpu = ptq_synthetic(net, sess)
            torch.cuda.synchronize()
            quant_cpu = dict(quant_gpu, weights={
                k: {kk: vv.cpu() for kk, vv in e.items()}
                for k, e in quant_gpu["weights"].items()})
            to_cpu()  # ptq_synthetic sets the running variances to 1
            print(f"ptq_synthetic on the card: "
                  f"{time.perf_counter() - t0:.1f} s, "
                  f"{len(quant_gpu['act_scales'])} act scales, "
                  f"{len(quant_gpu['weights'])} int8 weights")
        last = {}
        for label, topk_first in (("decode-everything (K1)", False),
                                  ("top-k-first", True)):
            zero_counts()
            outs, _ = serve(
                lambda v: sess.detect_on_batch(v, topk_first=topk_first),
                [x, x])
            got = counts()
            want = none_but(K1=0 if topk_first else 3 * len(outs),
                            K4=n_conv * len(outs) if prec == "int8" else 0,
                            K6=0 if prec == "int8"
                            else k6_convs(net) * len(outs))
            if got != want:
                raise RuntimeError(f"full YOLOv3 {prec} {label}: launches "
                                   f"{got}, wanted {want}")
            k1_total += got["K1"]
            k4_total += got["K4"]
            k6_total += got["K6"]
            for o in outs:
                check_detections(o, BATCH)
            last[topk_first] = outs[-1]
        if prec == "fp32":
            same_detections(last[True], last[False])

        if prec == "int8":
            with torch.inference_mode():
                got = execute(net, sess.params, sess.state,
                              {"input": torch.from_numpy(x2).cuda()},
                              Mode.PREDICT)
                net.quant = quant_cpu
                want = execute(net, cpu.params, cpu.state,
                               {"input": torch.from_numpy(x2)}, Mode.PREDICT)
                net.quant = quant_gpu
            n_int8 = 0
            for i, v in want.values.items():
                name = net.tensors[i].name
                if v.dtype == torch.int8:
                    n_int8 += 1
                    if not got.values[i].is_contiguous(
                            memory_format=torch.channels_last):
                        raise RuntimeError(f"full YOLOv3 int8: {name} is not "
                                           "channels-last on the card")
                if v.dtype in (torch.int8, torch.bfloat16) and \
                        not torch.equal(got.values[i].cpu(), v):
                    raise RuntimeError(f"full YOLOv3 int8: {name} ({v.dtype})"
                                       " differs between card and CPU")
            int8_adds = sum(want.values[i].dtype == torch.int8 for i in adds)
            for h in heads:
                i = net.get_tensor_index_by_name(h)
                if want.values[i].dtype != torch.bfloat16:
                    raise RuntimeError(f"full YOLOv3 int8: head {h} is "
                                       f"{want.values[i].dtype}")
            print(f"full YOLOv3 int8 card vs CPU, two images, one quant dict:"
                  f" all {n_int8} int8 tensors (channels-last; {int8_adds} of"
                  f" the {len(adds)} shortcut sums among them) and the three "
                  "bf16 heads bit-equal")
            del got, want
            continue
        g_heads, _ = sess.predict_on_batch(x2, outputs=heads)
        c_heads, _ = cpu.predict_on_batch(x2, outputs=heads)
        for name, g, c in zip(heads, g_heads, c_heads):
            g, c = g.cpu().float(), c.float()
            if not torch.isfinite(g).all() or float(c.std()) < 0.1:
                raise RuntimeError(f"full YOLOv3 {prec}: head {name} is "
                                   "non-finite or degenerate")
            share = float((g - c).abs().max()) / float(c.abs().max())
            if prec == "fp32":
                torch.testing.assert_close(g, c, rtol=HEAD_RTOL,
                                           atol=HEAD_ATOL)
            elif not share <= BF16_HEAD_TOL:
                raise RuntimeError(f"full YOLOv3 bf16 head {name}: card vs "
                                   f"CPU differ by {share:.3g} of the "
                                   "largest value")
            print(f"full YOLOv3 {prec} head {name} {tuple(g.shape)}: card vs"
                  f" CPU max_abs_err {float((g - c).abs().max()):.3g} "
                  f"({share:.3g} of the largest value {float(c.abs().max()):.3g})")
        if prec == "fp32":
            thresh = host_thresh(cpu, x[:1], yolo_out)
            t0 = time.perf_counter()
            dets_g = sess.yolo_get_detections(x[:1], SIZE, SIZE, SIZE, SIZE,
                                              thresh)
            t1 = time.perf_counter()
            dets_c = cpu.yolo_get_detections(x[:1], SIZE, SIZE, SIZE, SIZE,
                                             thresh)
            n_kept = host_detections_agree(dets_g, dets_c)
            print(f"full YOLOv3 yolo_get_detections, one image, thresh "
                  f"{thresh:.6f}: {len(dets_g)} boxes, {n_kept} kept after "
                  f"NMS, card and CPU agree; {1e3 * (t1 - t0):.1f} ms on the "
                  "card's path")
    net.compute_dtype = net.act_dtype = net.quant = None
    print(f"full YOLOv3 phase: {time.perf_counter() - t_phase:.1f} s")
    return k1_total, k4_total, k6_total


def det_labels(rng, n):
    """(n, 250) labels of 1-5 random boxes per image."""
    lab = np.zeros((n, 50, 5), np.float32)
    for i in range(n):
        for t in range(rng.randint(1, 6)):
            lab[i, t] = [rng.uniform(0.1, 0.9), rng.uniform(0.1, 0.9),
                         rng.uniform(0.05, 0.6), rng.uniform(0.05, 0.6),
                         rng.randint(CLASSES)]
    return lab.reshape(n, 250)


def train_session(batch, device, params=None, state=None):
    net = yolov3_tiny(batch, SIZE, SIZE, CLASSES, mode=Mode.TRAIN)
    net.device_augment = AUGMENT
    sess = Session(net, SEED, device=device)
    if params is not None:
        sess.params = {k: v.clone() for k, v in params.items()}
        sess.state = {k: v.clone() for k, v in state.items()}
    return sess.compile_net()


def train_phase(gpu):
    """YOLOv3-tiny TRAIN at batch 32 on the card: one warm-up step, then
    TRAIN_STEPS steps with the launch counts set to 0 before them.
    Returns (K2 launches on the path, the median step in ms)."""
    sess = train_session(TRAIN_BATCH, "cuda")
    sess.state = {k: v.cuda() for k, v in bn_stats(sess.net).items()}
    rng = np.random.RandomState(SEED + 2)
    x = rng.randint(0, 256, (TRAIN_BATCH, 3, SIZE, SIZE)).astype(np.uint8)
    lab = det_labels(rng, TRAIN_BATCH)
    sess.train_on_batch(x, lab)  # warm-up
    torch.cuda.synchronize()
    p0 = {k: v.clone() for k, v in sess.params.items()}
    s0 = {k: v.clone() for k, v in sess.state.items()}

    zero_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(sess.train_on_batch(x, lab))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    k2_launches = library.launches("row_shift")
    if library.launches("yolo_decode"):
        raise RuntimeError("the training path launched K1")
    if k2_launches != 3 * TRAIN_STEPS:
        raise RuntimeError(
            f"K2 launched {k2_launches} times in {TRAIN_STEPS} steps"
        )
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or min(losses) <= 0:
        raise RuntimeError(f"bad training losses {losses}")
    moved = [k for k in p0 if not torch.equal(p0[k], sess.params[k])]
    trainable = [t.key for t in sess.net.param_specs() if t.trainable]
    if sorted(moved) != sorted(trainable):
        raise RuntimeError("not every trainable parameter moved")
    if all(torch.equal(s0[k], sess.state[k]) for k in s0):
        raise RuntimeError("the BN running stats did not move")

    med = statistics.median(times)
    dev = device_us(lambda: sess.train_on_batch(x, lab), iters=3)
    busy = sum(dev.values()) / 3 / 1e3
    print(f"train_on_batch, batch {TRAIN_BATCH}, {SIZE} px, {CLASSES} "
          f"classes, fp32 (TF32 off), augment {AUGMENT} on {gpu}: steps "
          + ", ".join(f"{v:.1f}" for v in times)
          + f" ms; median {med:.1f} ms = "
          f"{TRAIN_BATCH / med * 1e3:.1f} images/s; losses "
          + ", ".join(f"{v:.2f}" for v in losses)
          + "; device busy "
          + (f"{busy:.1f} ms per step ({100 * busy / med:.0f}% of the "
             "median)" if busy else "not measured")
          + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
          " GiB")
    for k, us in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / 3 / 1e3:8.3f} ms  {k[:90]}")
    return k2_launches, med


def feeding(net, targets):
    """Param keys of the nodes whose output reaches a node in `targets`
    (node positions), the nodes' gradients that a change there moves."""
    readers = {}
    for j, node in enumerate(net.nodes):
        for src in node.src:
            readers.setdefault(src, []).append(j)
    keys = set()
    for i, node in enumerate(net.nodes):
        todo, seen = [i], {i}
        while todo:
            k = todo.pop()
            if k in targets:
                keys.update(net.tensors[s].key for s in node.src[1:])
                break
            for d in net.nodes[k].dst:
                for j in readers.get(d, []):
                    if j > k and j not in seen:
                        seen.add(j)
                        todo.append(j)
    return keys


def pool_choices(sess, x, lab):
    """The input each max-pool window picks in the session's TRAIN
    forward on the step's augmented batch (the draws train_on_batch
    makes next), without changing the session."""
    from bcnn_tpu_torch.compile import execute
    from bcnn_tpu_torch.data import device_augment as da

    gen = torch.Generator().manual_seed(SEED ^ 0x5EED)
    sub = int(torch.randint(2**62, (), generator=gen))
    params = da.sample_params(torch.Generator().manual_seed(sub), 2, AUGMENT)
    dev = sess.device
    xa, la = da.apply_augment_with_boxes(
        torch.from_numpy(x).to(dev).permute(0, 2, 3, 1).float(),
        torch.from_numpy(lab).to(dev), params, AUGMENT)
    with torch.no_grad():
        ex = execute(sess.net, sess.params, sess.state,
                     {"input": xa.permute(0, 3, 1, 2).contiguous(),
                      "label": la}, Mode.TRAIN)
    out = []
    for node in sess.net.nodes:
        if node.type.name != "MAXPOOL":
            continue
        p, d = node.param, sess.net.tensors[node.dst[0]]
        out.append(replay.windows(ex.values[node.src[0]], p["size"],
                                  p["stride"], d.h, d.w).argmax(-1).cpu())
    return out


def cross_device_step():
    """One batch-2 step from the same weights and augmentation draws on
    the card and on the CPU (BN batch stats depend on the batch, so both
    run the same 2 images)."""
    cpu = train_session(2, "cpu")
    cpu.state = bn_stats(cpu.net)
    gpu = train_session(2, "cuda", params=cpu.params, state=cpu.state)
    rng = np.random.RandomState(SEED + 3)
    x = rng.randint(0, 256, (2, 3, SIZE, SIZE)).astype(np.uint8)
    lab = det_labels(rng, 2)
    p0 = {k: v.clone() for k, v in cpu.params.items()}
    on_cpu = pool_choices(cpu, x, lab)
    flips = [int((a != b).sum())
             for a, b in zip(on_cpu, pool_choices(gpu, x, lab))]
    windows = sum(int(a.numel()) for a in on_cpu)
    pools = [i for i, n in enumerate(cpu.net.nodes)
             if n.type.name == "MAXPOOL"]
    flipped = feeding(cpu.net, {i for i, f in zip(pools, flips) if f}) & set(
        cpu.params)
    loss_c = float(cpu.train_on_batch(x, lab))
    loss_g = float(gpu.train_on_batch(x, lab))
    if not np.isclose(loss_g, loss_c, rtol=STEP_LOSS_RTOL, atol=0):
        raise RuntimeError(f"batch-2 step loss: card {loss_g}, CPU {loss_c}")
    worst = {False: (0.0, None), True: (0.0, None)}
    for k, v0 in p0.items():
        du_c = cpu.params[k] - v0
        du_g = gpu.params[k].cpu() - v0
        scale = float(du_c.abs().max())
        if scale == 0:
            if float(du_g.abs().max()) != 0:
                raise RuntimeError(f"{k} moved on the card only")
            continue
        err = float((du_g - du_c).abs().max()) / scale
        hit = k in flipped
        if err >= worst[hit][0]:
            worst[hit] = (err, k)
        if err > (FLIPPED_UPDATE_TOL if hit else STEP_UPDATE_TOL):
            raise RuntimeError(f"{k}: update differs by {err:.3g} of its "
                               "largest entry between card and CPU")
    state_err = max(float((gpu.state[k].cpu() - v).abs().max())
                    for k, v in cpu.state.items())
    print(f"batch-2 step card vs CPU: loss {loss_g:.6f} vs {loss_c:.6f} "
          f"(rel {abs(loss_g - loss_c) / abs(loss_c):.2g}); max-pool "
          f"windows that pick another input on the card: {flips} of "
          f"{windows} (per pool layer); worst update error, as a share of "
          f"the tensor's largest update: {worst[False][0]:.3g} in "
          f"{worst[False][1]} (limit {STEP_UPDATE_TOL}), and "
          f"{worst[True][0]:.3g} in {worst[True][1]} among the "
          f"{len(flipped)} tensors that feed a flipped window (limit "
          f"{FLIPPED_UPDATE_TOL}); running stats max_abs_err "
          f"{state_err:.3g}")


def bench_batch(batch, size, device):
    """bench.py's training input: RandomState(0).rand and the box [0.5,
    0.5, 0.25, 0.25, class 1] an image."""
    x = np.random.RandomState(0).rand(batch, 3, size, size).astype(
        np.float32)
    lab = np.zeros((batch, 250), np.float32)
    lab[:, 0:5] = [0.5, 0.5, 0.25, 0.25, 1]
    return {"input": torch.as_tensor(x, device=device),
            "label": torch.as_tensor(lab, device=device)}


def train_net(batch, size, bf16=True):
    """YOLOv3-tiny in TRAIN, compute_dtype = train_act_dtype = bf16 as
    bench.py's train mode sets them, or fp32."""
    net = yolov3_tiny(batch, size, size, CLASSES, mode=Mode.TRAIN)
    if bf16:
        net.compute_dtype = net.train_act_dtype = torch.bfloat16
    return net


def check_fp32(what, params, state, opt_state):
    """Master params, running stats and optimizer buffers: fp32, finite."""
    for name, table in (("param", params), ("running stat", state),
                        ("velocity", opt_state["velocity"])):
        for k, v in table.items():
            if v.dtype != torch.float32 or not torch.isfinite(v).all():
                raise RuntimeError(f"{what}: {name} {k} is {v.dtype} "
                                   "or not finite")


def kernel_group(name):
    """A device kernel's kind, from its name: the convs (cuDNN and the
    GEMMs it calls), layout and dtype copies, max-pool, reductions, the
    rest elementwise."""
    if any(t in name for t in ("cudnn::engines_precompiled::nchwToNhwc",
                               "nhwcToNchw", "copy")):
        return "copies and casts"
    if any(t in name for t in ("cudnn", "xmma", "gemm", "dgrad", "wgrad",
                               "convolve", "conv")):
        return "convs"
    if "max_pool" in name:
        return "max-pool"
    if "reduce_kernel" in name:
        return "reductions"
    return "elementwise"


def timed_training(gpu, bf16):
    """make_train_step at batch T16_BATCH, 416 px, on bench.py's input:
    one warm-up step, T16_STEPS timed steps (host clock, the loss read
    back each step), device time by name over 3 steps, peak memory.
    Returns (median ms, busy ms, peak GiB)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = train_net(T16_BATCH, SIZE, bf16)
    sess = Session(net, SEED, device="cuda").compile_net()
    step = make_train_step(net)
    data = bench_batch(T16_BATCH, SIZE, "cuda")
    st = [sess.params, sess.state, sess.opt_state]

    def one():
        out = step(*st, data, None)
        st[:] = out[:3]
        return out[3]

    losses, times = [float(one())], []
    for _ in range(T16_STEPS):
        t0 = time.perf_counter()
        losses.append(float(one()))
        times.append(1e3 * (time.perf_counter() - t0))
    what = "bf16 + act16" if bf16 else "fp32 (TF32 off)"
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{what} training losses {losses}")
    check_fp32(what, *st)
    med = statistics.median(times)
    dev = device_us(one, iters=3)
    busy = sum(dev.values()) / 3 / 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"bench.py's training program, {what}: YOLOv3-tiny {SIZE} px, "
          f"batch {T16_BATCH}, {CLASSES} classes on {gpu}: steps "
          + ", ".join(f"{v:.1f}" for v in times)
          + f" ms (after one warm-up); median {med:.2f} ms = "
          f"{T16_BATCH / med * 1e3:.1f} images/s; losses "
          + ", ".join(f"{v:.3f}" for v in losses)
          + "; device busy "
          + (f"{busy:.2f} ms per step ({100 * busy / med:.0f}% of the "
             "median)" if busy else "not measured")
          + f"; peak memory {peak:.2f} GiB")
    groups = {}
    for k, us in dev.items():
        g = kernel_group(k)
        groups[g] = groups.get(g, 0.0) + us / 3 / 1e3
    print("    by kind, ms a step: " + ", ".join(
        f"{g} {ms:.2f}" for g, ms in sorted(groups.items(),
                                           key=lambda kv: -kv[1])))
    for k, us in sorted(dev.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {us / 3 / 1e3:8.3f} ms  {k[:90]}")
    del sess, st, step
    return med, busy, peak


def grad_gaps(ref, got):
    """Per tensor: (1 - cosine, max|d| / rms of ref), in float64."""
    out = {}
    for k, r in ref.items():
        a, b = r.double().flatten(), got[k].double().flatten()
        na, nb = float(a.norm()), float(b.norm())
        if na == 0 and nb == 0:
            continue
        rms = float(a.square().mean().sqrt())
        out[k] = (1.0 - float(a @ b) / (na * nb + 1e-30),
                  float((a - b).abs().max()) / rms)
    return out


def cross_device_bf16():
    """One bf16 + act16 forward and backward at 96 px, batch 2, on the
    card and on the CPU from the same weights and batch, held to each
    other by tests/test_torch_train_bf16.py's gate, the CPU's fp32 run
    giving the noise bf16 itself brings."""
    rng = np.random.RandomState(SEED + 4)
    x = torch.from_numpy(
        (rng.rand(2, 3, T16_SMALL, T16_SMALL) * 2 - 1).astype(np.float32))
    lab = torch.from_numpy(det_labels(rng, 2))
    ref_net = train_net(2, T16_SMALL)
    params = Session(ref_net, SEED, device="cpu").compile_net().params
    state = bn_stats(ref_net)

    def grads(bf16, device):
        net = train_net(2, T16_SMALL, bf16)
        leaves = {k: v.detach().to(device, copy=True).requires_grad_()
                  for k, v in params.items()}
        ex = execute(net, leaves, {k: v.to(device) for k, v in
                                   state.items()},
                     {"input": x.to(device), "label": lab.to(device)},
                     Mode.TRAIN)
        ex.surrogate.backward()
        return ({k: v.grad.cpu() for k, v in leaves.items()},
                float(get_loss(ex)))

    g32, _ = grads(False, "cpu")
    g16, loss_c = grads(True, "cpu")
    gg, loss_g = grads(True, "cuda")
    if any(v.dtype != torch.float32 for v in gg.values()):
        raise RuntimeError("a bf16 gradient on the card is not fp32")
    if not np.isclose(loss_g, loss_c, rtol=T16_LOSS_RTOL, atol=0):
        raise RuntimeError(f"bf16 loss: card {loss_g}, CPU {loss_c}")
    noise, gaps = grad_gaps(g32, g16), grad_gaps(g16, gg)
    worst = {True: (0.0, 0.0), False: (0.0, 0.0)}
    for k, (cg, rg) in gaps.items():
        clean = noise[k][0] <= 0.01 and noise[k][1] < 0.5
        lim = ((COS_GAP, RMS_GAP) if clean else
               (NOISE_RATIO * noise[k][0], NOISE_RATIO * noise[k][1]))
        if cg > lim[0] or rg > lim[1]:
            raise RuntimeError(
                f"bf16 gradient of {k}, card vs CPU: 1 - cosine {cg:.3g}, "
                f"max|d| {rg:.3g} rms (limits {lim[0]:.3g}, {lim[1]:.3g})")
        worst[clean] = (max(worst[clean][0], cg / (lim[0] or 1)),
                        max(worst[clean][1], rg / lim[1]))
    n_clean = sum(1 for v in noise.values() if v[0] <= 0.01 and v[1] < 0.5)
    print(f"bf16 + act16 step at {T16_SMALL} px, batch 2, card vs CPU: "
          f"loss {loss_g:.5f} vs {loss_c:.5f} (rel "
          f"{abs(loss_g - loss_c) / abs(loss_c):.2g}); gradients of "
          f"{len(gaps)} tensors, {n_clean} where bf16 meets bcnn_tpu's "
          f"gate against fp32 (worst share of the limit: cosine "
          f"{worst[True][0]:.2f}, max|d| {worst[True][1]:.2f}); elsewhere "
          f"within {NOISE_RATIO}x bf16's own gap (worst share: "
          f"{worst[False][0]:.2f}, {worst[False][1]:.2f})")


def uint8_batches(rng, lead, batch):
    x = rng.randint(0, 256, lead + (batch, 3, SIZE, SIZE)).astype(np.uint8)
    lab = np.stack([det_labels(rng, batch) for _ in range(int(np.prod(
        lead, dtype=int)))]).reshape(lead + (batch, 250))
    return {"input": torch.from_numpy(x).cuda(),
            "label": torch.from_numpy(lab).cuda()}


def fresh(net, params, state):
    p = {k: v.clone() for k, v in params.items()}
    return p, {k: v.clone() for k, v in state.items()}, init_opt_state(
        net, p)


def scan_phase(gpu):
    """make_train_scan: SCAN_K bf16 + act16 steps at FORMS_BATCH, 416 px,
    with rotation augmentation on uint8 batches staged on the card, in
    one call, after one warm-up call. Returns K2's launches in the timed
    call (3 a step)."""
    net = train_net(FORMS_BATCH, SIZE)
    net.device_augment = AUGMENT
    sess = Session(net, SEED, device="cuda")
    sess.state = bn_stats(net)
    sess.compile_net()
    batches = uint8_batches(np.random.RandomState(SEED + 5), (SCAN_K,),
                            FORMS_BATCH)
    scan = make_train_scan(net)
    st = [sess.params, sess.state, sess.opt_state]
    gen = torch.Generator().manual_seed(SEED)
    st[:] = scan(*st, batches, gen)[:3]  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = scan(*st, batches, gen)
    losses = out[3].cpu()
    ms = 1e3 * (time.perf_counter() - t0)
    k2 = library.launches("row_shift")
    if k2 != 3 * SCAN_K or library.launches("yolo_decode"):
        raise RuntimeError(f"the scan launched K2 {k2} times and K1 "
                           f"{counts()['K1']} times")
    if tuple(losses.shape) != (SCAN_K,) or not torch.isfinite(losses).all():
        raise RuntimeError(f"scan losses {losses}")
    check_fp32("the scan", *out[:3])
    print(f"make_train_scan, {SCAN_K} bf16 + act16 steps at batch "
          f"{FORMS_BATCH}, {SIZE} px, augment {AUGMENT}, on {gpu}: one call "
          f"{ms:.1f} ms ({ms / SCAN_K:.1f} ms a step, "
          f"{FORMS_BATCH * SCAN_K / ms * 1e3:.1f} images/s); losses "
          + ", ".join(f"{v:.3f}" for v in losses.tolist())
          + f"; K2 launched {k2} times")
    return k2


def max_update_gap(p0, a, b):
    """max over tensors of max|du_a - du_b| / max|du_b|."""
    worst = 0.0
    for k in p0:
        da, db = a[k] - p0[k], b[k] - p0[k]
        scale = float(db.abs().max())
        if scale:
            worst = max(worst, float((da - db).abs().max()) / scale)
    return worst


def forms_phase(gpu):
    """At FORMS_BATCH, 416 px, bf16 + act16, from one set of weights: a
    remat step against the plain step (rotation augmentation, one
    generator seed: the same draws), and an accum_steps=2 step against
    the two half-batch forwards and backwards it stands for, gradients
    summed, the running stats carried from one half to the other. Time
    (median of 3 after a warm-up) and peak memory of each."""
    aug = train_net(FORMS_BATCH, SIZE)
    aug.device_augment = AUGMENT
    plain = train_net(FORMS_BATCH, SIZE)
    sess = Session(plain, SEED, device="cuda")
    sess.state = bn_stats(plain)
    sess.compile_net()
    p0, s0 = sess.params, sess.state
    rng = np.random.RandomState(SEED + 6)
    u8 = uint8_batches(rng, (), FORMS_BATCH)
    fl = bench_batch(FORMS_BATCH, SIZE, "cuda")
    runs = {
        "plain": (aug, dict(), u8),
        "remat": (aug, dict(remat=True), u8),
        "accum_steps=2": (plain, dict(accum_steps=2), fl),
    }
    res = {}
    for name, (net, kw, batch) in runs.items():
        step = make_train_step(net, **kw)
        times = []
        for i in range(4):
            args = fresh(net, p0, s0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = step(*args, batch, torch.Generator().manual_seed(SEED))
            float(out[3])
            times.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated() / 2**30
        res[name] = (out, statistics.median(times[1:]), peak)

    # the accumulation by hand: two half batches, one update
    net = plain
    params, state, opt = fresh(net, p0, s0)
    specs = {t.key: t for t in net.param_specs()}
    leaves = {k: v.detach().requires_grad_(specs[k].trainable)
              for k, v in params.items()}
    loss = 0.0
    half = FORMS_BATCH // 2
    for lo in (0, half):
        ex = execute(net, leaves, state,
                     {k: v[lo:lo + half] for k, v in fl.items()},
                     Mode.TRAIN)
        ex.surrogate.backward()
        state = ex.state
        loss = loss + get_loss(ex)
    params, opt = apply_updates(
        net, params, {k: v.grad for k, v in leaves.items()
                      if specs[k].trainable}, opt)

    for name, ref in (("remat", res["plain"][0]),
                      ("accum_steps=2", (params, state, opt, loss))):
        out = res[name][0]
        check_fp32(name, *out[:3])
        err = max_update_gap(p0, out[0], ref[0])
        lerr = abs(float(out[3]) - float(ref[3])) / abs(float(ref[3]))
        serr = max(float((out[1][k] - ref[1][k]).abs().max()) for k in s0)
        if err > FORM_TOL or lerr > FORM_TOL:
            raise RuntimeError(f"{name}: updates differ by {err:.3g} of "
                               f"their largest entry, loss by {lerr:.3g}")
        res[name] += (err, lerr, serr)
    print(f"step forms, bf16 + act16, batch {FORMS_BATCH}, {SIZE} px, on "
          f"{gpu}: " + "; ".join(
              f"{name} {r[1]:.1f} ms, peak {r[2]:.2f} GiB"
              + (f" (updates within {r[3]:.3g} of their largest entry, "
                 f"loss {r[4]:.3g} relative, running stats "
                 f"{r[5]:.3g} absolute, of the "
                 + ("plain step)" if name == "remat"
                    else "two half batches by hand)") if len(r) > 3 else "")
              for name, r in res.items()))


def bf16_training_phase(gpu):
    """bench.py's training program and the forms of the step. Returns
    K2's launches in the scan."""
    t0 = time.perf_counter()
    b16 = timed_training(gpu, bf16=True)
    f32 = timed_training(gpu, bf16=False)
    print(f"batch {T16_BATCH} training on {gpu}: bf16 + act16 "
          f"{T16_BATCH / b16[0] * 1e3:.1f} images/s against fp32 "
          f"{T16_BATCH / f32[0] * 1e3:.1f} ({f32[0] / b16[0]:.2f}x); "
          f"device busy {b16[1]:.2f} / {f32[1]:.2f} ms a step; peak memory "
          f"{b16[2]:.2f} / {f32[2]:.2f} GiB")
    cross_device_bf16()
    k2 = scan_phase(gpu)
    forms_phase(gpu)
    print(f"bf16 training phase: {time.perf_counter() - t0:.1f} s")
    return k2


# ------------------------------------------------------------------------
# phase 9: train from files (the data feed, the cost layer, the CLI)
# ------------------------------------------------------------------------

# the detection set: P9_IMAGES RGB PNGs, sides drawn in P9_SIDES px (the
# letterbox takes both orientations), 1-6 filled boxes each
P9_IMAGES, P9_SIDES, P9_BOXES = 96, (300, 640), (1, 6)
# the feeds: warm-up, then P9_STEPS steps at batch 32, 416 px, fp32; the
# scans in calls of P9_SCAN_K steps; the sharded pipeline's workers
P9_STEPS, P9_SCAN_K, P9_WORKERS = 4, 4, 4
# MNIST idx files (train, test) and the recipe's run through the CLI
P9_MNIST, P9_MNIST_BATCHES = (2048, 512), 200
# the raw-record feed's device augmentation (rotation within 90 degrees:
# three K2 launches a step)
P9_AUGMENT = dict(random_fliph=1, min_contrast=0.8, max_contrast=1.2,
                  min_brightness=-30, max_brightness=30,
                  rotation_range=10.0)
P9_NET = """[net]
batch={batch}
width={size}
height={size}
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.001
max_batches=8
data_format=detection
source_train={lst}
source_test={lst}
input_model={weights}
output_model={out}
{extra}eval_test=1
eval_period=4
num_pred=64
save_model=4
flip_h=1
min_contrast=0.8
max_contrast=1.2
min_brightness=-30
max_brightness=30

"""


def write_detection_set(tmp, rng):
    """P9_IMAGES PNGs with their boxes and the detection list."""
    from bcnn_tpu_torch import bip

    lines, shapes = [], []
    for i in range(P9_IMAGES):
        h, w = (int(v) for v in rng.randint(P9_SIDES[0], P9_SIDES[1] + 1,
                                            2))
        shapes.append((h, w))
        yy, xx = np.mgrid[0:h, 0:w]
        img = (rng.uniform(40, 160, 3)[None, None, :]
               + 60 * (xx / w)[..., None] + 40 * (yy / h)[..., None]
               + rng.randint(0, 8, (h, w, 3)))
        boxes = []
        for _ in range(rng.randint(P9_BOXES[0], P9_BOXES[1] + 1)):
            bw, bh = rng.uniform(0.08, 0.5) * w, rng.uniform(0.08, 0.5) * h
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            img[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] = rng.randint(
                0, 256, 3)
            boxes.append(f"{rng.randint(CLASSES)} {(x0 + bw / 2) / w:.6f} "
                         f"{(y0 + bh / 2) / h:.6f} {bw / w:.6f} {bh / h:.6f}")
        path = os.path.join(tmp, f"img{i:03d}.png")
        bip.write_image(path, np.clip(img, 0, 255).astype(np.uint8))
        lines.append(path + " " + " ".join(boxes))
    if not any(h > w for h, w in shapes) or not any(w > h for h, w in shapes):
        raise RuntimeError("the detection set lacks an orientation")
    lst = os.path.join(tmp, "train.txt")
    with open(lst, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lst


def write_mnist_set(tmp, rng):
    """idx files of P9_MNIST (train, test) images: label-placed bright
    squares on noise."""
    import struct

    out = []
    for name, n in zip(("train", "t10k"), P9_MNIST):
        labels = rng.randint(0, 10, n).astype(np.uint8)
        imgs = (rng.rand(n, 28, 28) * 40).astype(np.uint8)
        for i, c in enumerate(labels):
            r, col = divmod(int(c), 4)
            imgs[i, 2 + r * 8:8 + r * 8, 2 + col * 6:8 + col * 6] = 250
        pi = os.path.join(tmp, f"{name}-images.idx3-ubyte")
        pl = os.path.join(tmp, f"{name}-labels.idx1-ubyte")
        with open(pi, "wb") as f:
            f.write(struct.pack(">4i", 0x803, n, 28, 28))
            imgs.tofile(f)
        with open(pl, "wb") as f:
            f.write(struct.pack(">2i", 0x801, n))
            labels.tofile(f)
        out += [pi, pl]
    return out


def tiny_conf(tmp, lst, weights, batch=TRAIN_BATCH, extra="", name="tiny",
              size=SIZE):
    """examples/yolo/yolov3-tiny.cfg's layers under P9_NET's [net]."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "examples", "yolo", "yolov3-tiny.cfg")) as f:
        cfg = f.read()
    layers = cfg[cfg.index("[convolutional]"):]
    path = os.path.join(tmp, f"{name}.conf")
    with open(path, "w") as f:
        f.write(P9_NET.format(batch=batch, size=size, lst=lst,
                              weights=weights, extra=extra,
                              out=os.path.join(tmp, f"{name}.bcnnmodel"))
                + layers)
    return path


def run_cli(argv, tmp):
    """cli.main in `tmp`, its stderr kept; returns the stderr lines."""
    import contextlib
    import io

    from bcnn_tpu_torch import cli

    err, cwd = io.StringIO(), os.getcwd()
    os.chdir(tmp)
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"bcnn-cl {argv} returned {rc}")
    return err.getvalue().splitlines()


def conf_session(conf, device):
    """The session `bcnn-cl train conf` builds (cli.main), on `device`."""
    from bcnn_tpu_torch.cli import load_cli_param
    from bcnn_tpu_torch.config import load_net
    from bcnn_tpu_torch.graph import Net

    p = load_cli_param(conf)
    net = Net(Mode.TRAIN)
    load_net(net, conf, p.input_model)
    sess = Session(net, 0, device=device)
    sess.set_data_loader(p.data_format, p.train_input, p.path_train_label,
                         p.test_input, p.path_test_label)
    return sess.compile_net()


def decisions(sess, batch):
    """The discrete choices of the session's TRAIN forward on a host batch,
    without changing the session: the input each max-pool window picks,
    and each YOLO head's gradient (its deltas, whose ignore and
    best-anchor choices jump at a threshold)."""
    dev = sess.device
    x = torch.as_tensor(batch["input"], dtype=torch.float32,
                        device=dev).requires_grad_()
    ex = execute(sess.net, sess.params, sess.state,
                 {"input": x, "label": torch.as_tensor(batch["label"],
                                                       device=dev)},
                 Mode.TRAIN)
    picks, heads = [], []
    for i, node in enumerate(sess.net.nodes):
        if node.type.name == "YOLOV3":
            heads.append((i, ex.values[node.src[0]]))
        if node.type.name != "MAXPOOL":
            continue
        p, d = node.param, sess.net.tensors[node.dst[0]]
        picks.append((i, replay.windows(ex.values[node.src[0]].detach(),
                                        p["size"], p["stride"], d.h,
                                        d.w).argmax(-1).cpu()))
    grads = torch.autograd.grad(ex.surrogate, [h for _, h in heads]) \
        if heads else []
    return picks, [(i, g.cpu()) for (i, _), g in zip(heads, grads)]


def steps_card_vs_cpu(label, conf, tol=STEP_UPDATE_TOL, steps=2):
    """The first `steps` loader-fed steps of `conf` on the card and on the
    CPU port from the same start: the loaders' batches byte-equal on the
    host, each step's loss within STEP_LOSS_RTOL, and after each step
    every parameter's total update within `tol` of its largest entry. As in phase 7, a max-pool window that picks another input on
    the card is counted, and so is a YOLO delta that jumps (an ignore or
    anchor choice at its threshold: by more than DELTA_JUMP + DELTA_RTOL
    of its size); the
    tensors feeding such a choice get FLIPPED_UPDATE_TOL.
    A choice that differed in one step moved the parameters every later
    forward reads, so from the next step on every tensor gets it."""
    gpu, cpu = conf_session(conf, "cuda"), conf_session(conf, "cpu")
    p0 = {k: v.clone() for k, v in cpu.params.items()}
    for k, v in gpu.params.items():
        if not torch.equal(v.cpu(), p0[k]):
            raise RuntimeError(f"{label}: the two starts differ at {k}")
    flips, flipped, losses, errs, bad = [], set(), [], {}, []
    flipped_before, worsts = False, []
    for s in range(steps):
        xg, yg = gpu.loader.next_batch()
        xc, yc = cpu.loader.next_batch()
        if not (np.array_equal(xg, xc) and np.array_equal(yg, yc)):
            raise RuntimeError(f"{label}: the loaders' batches differ")
        batch = {"input": xc, "label": yc}
        (pc, hc), (pg, hg) = decisions(cpu, batch), decisions(gpu, batch)
        step = {}
        for (i, a), (_, b) in zip(pc, pg):
            step[f"pool {i}"] = int((a != b).sum())
        for (i, a), (_, b) in zip(hc, hg):
            step[f"yolo {i}"] = int(((a - b).abs() > DELTA_JUMP
                                     + DELTA_RTOL * a.abs()).sum())
        flips.append(step)
        if s and flipped_before:
            flipped = set(p0)
        flipped_before = any(step.values())
        flipped |= feeding(cpu.net, {int(k.split()[1]) for k, n in
                                     step.items() if n})
        losses.append((float(gpu.train_on_batch(xg, yg)),
                       float(cpu.train_on_batch(xc, yc))))
        for k, v0 in p0.items():
            du_c = cpu.params[k] - v0
            du_g = gpu.params[k].cpu() - v0
            scale = float(du_c.abs().max())
            if scale == 0:
                if float(du_g.abs().max()) != 0:
                    bad.append(f"{k} moved on the card only")
                continue
            errs[k] = float((du_g - du_c).abs().max()) / scale
            if errs[k] > (FLIPPED_UPDATE_TOL if k in flipped else tol):
                bad.append(f"step {s + 1}: {k} update differs by "
                           f"{errs[k]:.3g} of its largest entry"
                           + " (fed a flip)" * (k in flipped))
        calm = [(round(e, 5), k) for k, e in errs.items() if k not in flipped]
        fed = [(round(e, 5), k) for k, e in errs.items() if k in flipped]
        worsts.append((max(calm) if calm else None, max(fed) if fed else None))
    for lg, lc in losses:
        if not np.isclose(lg, lc, rtol=STEP_LOSS_RTOL, atol=0):
            bad.append(f"losses card {lg}, CPU {lc}")
    print(f"{label}, first {steps} steps card vs CPU from byte-equal loader "
          "batches: losses " + ", ".join(f"{a:.6f}/{b:.6f}"
                                         for a, b in losses)
          + f"; choices that differ on the card, per step: {flips}; per "
          f"step, the worst update error "
          f"(share of the tensor's largest entry) where no differing choice "
          f"reaches (limit {tol}) and where one does (limit "
          f"{FLIPPED_UPDATE_TOL}): {worsts}", flush=True)
    if bad:
        print("    per tensor: " + ", ".join(
            f"{k} {e:.2g}" for k, e in sorted(errs.items(),
                                              key=lambda kv: -kv[1])[:12]))
        raise RuntimeError(f"{label}: " + "; ".join(bad[:6]))


def timed_feed(label, step, per_call, rows, gpu, calls=None):
    """One warm-up call of step(), then the timed calls (P9_STEPS steps,
    per_call steps a call), device time by name over 3 calls, peak
    memory. Appends (label, median ms a step, images/s, busy share, peak
    GiB) to rows; returns the K2 launches of the timed calls."""
    calls = calls or P9_STEPS // per_call
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, losses = [], []
    for _ in range(calls):
        t0 = time.perf_counter()
        losses.append(float(step()))
        times.append(1e3 * (time.perf_counter() - t0) / per_call)
    k2 = library.launches("row_shift")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{label}: losses {losses}")
    med = statistics.median(times)
    dev = device_us(step, iters=3)
    busy = sum(dev.values()) / 3 / per_call / 1e3
    rows.append((label, med, TRAIN_BATCH / med * 1e3,
                 busy / med if busy else None,
                 torch.cuda.max_memory_allocated() / 2**30))
    return k2


def loader_rate(next_batch, n=3):
    """Images/s of a host feed alone: n batches, nothing else."""
    t0 = time.perf_counter()
    for _ in range(n):
        next_batch()
    return n * TRAIN_BATCH / (time.perf_counter() - t0)


def loader_stages(lst, n=TRAIN_BATCH):
    """Where DetectionListLoader's host time goes: ms an image over the
    list's first n images for the decode, the letterbox resize, contrast
    and brightness, and the float conversion, each timed alone."""
    from bcnn_tpu_torch import bip
    from bcnn_tpu_torch.data import convert_img_to_float

    with open(lst) as f:
        paths = [ln.split()[0] for ln in f][:n]
    t = dict(decode=0.0, resize=0.0, contrast_brightness=0.0, to_float=0.0)
    for p in paths:
        t0 = time.perf_counter()
        img = bip.load_image(p)
        t1 = time.perf_counter()
        h, w = img.shape[:2]
        nw, nh = (SIZE, max(1, int(SIZE * h / w))) if w >= h else (
            max(1, int(SIZE * w / h)), SIZE)
        canvas = np.full((SIZE, SIZE, 3), 128, np.uint8)
        bip.crop_image(bip.resize_bilinear(img, nw, nh), 0, 0, SIZE, SIZE,
                       out=canvas)
        t2 = time.perf_counter()
        canvas = bip.image_brightness(bip.contrast_stretch(canvas, 1.1), 10)
        t3 = time.perf_counter()
        convert_img_to_float(canvas)
        t4 = time.perf_counter()
        for k, dt in zip(t, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            t[k] += dt
    return {k: 1e3 * v / len(paths) for k, v in t.items()}


def feeds_phase(gpu, tmp, conf, lst, prebuilt_ms):
    """YOLOv3-tiny fp32 at batch 32, 416 px, fed from files: the
    sequential loader, BatchPipeline(depth=2), ShardedBatchPipeline(4),
    and raw records with device augmentation through train_on_batch,
    the staged scan and the resident scan. Prints the feed table beside
    phase 7's step on batches built in advance; returns K2's launches on
    the record feeds (three a step)."""
    from bcnn_tpu_torch.data import (BatchPipeline, DetectionListLoader,
                                     RawRecordLoader, ShardedBatchPipeline,
                                     records_from_loader)

    rows, rates, k2 = [], {}, 0
    stages = loader_stages(lst)
    sess = conf_session(conf, "cuda")
    net = sess.net
    rates["sequential loader"] = loader_rate(sess.loader.next_batch)
    timed_feed("sequential loader, train_on_batch()",
               sess.train_on_batch, 1, rows, gpu)

    pipe = BatchPipeline(DetectionListLoader(net, lst), depth=2).start()
    it = iter(pipe)
    try:
        timed_feed("BatchPipeline(depth=2)",
                   lambda: sess.train_on_batch(*next(it)), 1, rows, gpu)
    finally:
        pipe.stop()
    pipe = ShardedBatchPipeline(lambda: DetectionListLoader(net, lst),
                                workers=P9_WORKERS).start()
    it = iter(pipe)
    try:
        rates[f"ShardedBatchPipeline({P9_WORKERS})"] = loader_rate(
            lambda: next(it)[0].sum().item(), n=6)
        timed_feed(f"ShardedBatchPipeline(workers={P9_WORKERS})",
                   lambda: sess.train_on_batch(*next(it)), 1, rows, gpu)
    finally:
        pipe.stop()
    del sess, pipe, it

    # raw records: the VALID letterbox decoded once, augmentation on the
    # card (three K2 launches a step)
    rec = os.path.join(tmp, "train.bcrd")
    t0 = time.perf_counter()
    n = records_from_loader(DetectionListLoader(net, lst), rec, P9_IMAGES)
    t_rec = time.perf_counter() - t0
    rsess = conf_session(conf, "cuda")
    rsess.net.device_augment = dict(P9_AUGMENT)
    rsess.loader = RawRecordLoader(rsess.net, rec)
    rates["raw records"] = loader_rate(rsess.loader.next_batch)
    for label, step, per in (
        ("raw records, train_on_batch()", rsess.train_on_batch, 1),
        (f"raw records, train_scan_on_batches({P9_SCAN_K})",
         lambda: rsess.train_scan_on_batches(P9_SCAN_K), P9_SCAN_K),
        (f"raw records, train_scan_resident_on_batches({P9_SCAN_K})",
         lambda: rsess.train_scan_resident_on_batches(P9_SCAN_K),
         P9_SCAN_K),
    ):
        calls = -(-P9_STEPS // per)
        got = timed_feed(label, step, per, rows, gpu, calls)
        if got != 3 * calls * per:
            raise RuntimeError(f"{label}: K2 launched {got} times in "
                               f"{calls * per} steps")
        k2 += got
    print(f"the feeds, YOLOv3-tiny fp32 (TF32 off), batch {TRAIN_BATCH}, "
          f"{SIZE} px, {P9_IMAGES} PNGs ({P9_SIDES[0]}-{P9_SIDES[1]} px) "
          f"through DetectionListLoader (host flip/contrast/brightness) "
          f"or {n} raw records ({os.path.getsize(rec) / 1e6:.1f} MB, "
          f"written in {t_rec:.1f} s; device augment {P9_AUGMENT}), on "
          f"{gpu}; {P9_STEPS} steps after a warm-up:")
    print(f"    {'feed':58s} {'ms/step':>8s} {'img/s':>8s} {'busy':>6s} "
          f"{'peak GiB':>8s}")
    print(f"    {'batches built in advance (phase 7, device augment)':58s} "
          f"{prebuilt_ms:8.1f} {TRAIN_BATCH / prebuilt_ms * 1e3:8.1f}")
    for label, med, ips, busy, peak in rows:
        b = f"{100 * busy:5.0f}%" if busy else "   n/m"
        print(f"    {label:58s} {med:8.1f} {ips:8.1f} {b:>6s} {peak:8.2f}")
    print("    host feed alone, images/s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rates.items()))
    print("    DetectionListLoader, ms an image (the main thread, each "
          "stage alone): " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    return k2


def order_and_scan_checks(conf, lst, tmp):
    """ShardedBatchPipeline(4) puts the sequential loader's batches on the
    card, byte for byte (VALID: the centered letterbox, no augmentation
    draws); the resident scan equals the staged scan on the card (one
    start, the same records and draws) within the trajectory tolerances,
    with cuDNN's deterministic algorithms for the two runs."""
    from bcnn_tpu_torch.data import (DetectionListLoader, RawRecordLoader,
                                     ShardedBatchPipeline)

    net = conf_session(conf, "cpu").net

    def valid_loader():
        ld = DetectionListLoader(net, lst)
        ld.set_mode(Mode.VALID)
        return ld

    ref = valid_loader()
    pipe = ShardedBatchPipeline(valid_loader, workers=P9_WORKERS).start()
    n = 2 * P9_IMAGES // TRAIN_BATCH + 1
    try:
        for i, (x, y) in zip(range(n), pipe):
            rx, ry = ref.next_batch()
            if not (np.array_equal(x.cpu().numpy(), rx)
                    and np.array_equal(y.cpu().numpy(), ry)):
                raise RuntimeError(f"ShardedBatchPipeline batch {i} is not "
                                   "the sequential loader's")
    finally:
        pipe.stop()
    rec = os.path.join(tmp, "train.bcrd")
    runs = []
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for resident in (True, False):
            s = conf_session(conf, "cuda")
            s.net.device_augment = dict(P9_AUGMENT)
            s.loader = RawRecordLoader(s.net, rec)
            p0 = {k: v.clone() for k, v in s.params.items()}
            fn = (s.train_scan_resident_on_batches if resident
                  else s.train_scan_on_batches)
            runs.append(([fn(P9_SCAN_K) for _ in range(2)], p0, s.params))
    finally:
        torch.backends.cudnn.deterministic = det
    (la, p0, pa), (lb, _, pb) = runs
    if not np.allclose(la, lb, rtol=STEP_LOSS_RTOL, atol=0):
        raise RuntimeError(f"resident scan losses {la}, staged {lb}")
    worst = 0.0
    for k in p0:
        du_a, du_b = pa[k] - p0[k], pb[k] - p0[k]
        scale = float(du_b.abs().max())
        err = float((du_a - du_b).abs().max()) / scale if scale else 0.0
        worst = max(worst, err)
        if err > STEP_UPDATE_TOL:
            raise RuntimeError(f"resident scan: {k} update differs by "
                               f"{err:.3g} of its largest entry")
    print(f"ShardedBatchPipeline({P9_WORKERS}): {n} VALID batches on the card "
          "byte-equal to the sequential loader's; resident scan vs staged "
          f"scan, 2 x {P9_SCAN_K} steps: loss sums {la} vs {lb}, worst "
          f"update error {worst:.3g} (limit {STEP_UPDATE_TOL})")


def files_phase(gpu, prebuilt_ms):
    """Phase 9: train from files. Writes its data from SEED into a
    temporary directory, runs the CLI on the detection conf (train,
    valid with mAP, predict with the det_*.png dumps), the first two
    steps card against CPU, the feeds, the order and scan checks, and
    the MNIST recipe through the CLI. Returns K2's launches on the
    record feeds."""
    from bcnn_tpu_torch import bip

    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 9)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        lst = write_detection_set(tmp, rng)
        mnist = write_mnist_set(tmp, rng)
        net = yolov3_tiny(TRAIN_BATCH, SIZE, SIZE, CLASSES, mode=Mode.TRAIN)
        params, state = bridge.params_from_numpy(
            net, *bridge.he_numpy_weights(net, SEED))
        weights = os.path.join(tmp, "tiny.weights")
        save_weights_darknet(net, params, state, weights)
        del params, state
        t_data = time.perf_counter() - t0
        print(f"phase 9: data written in {t_data:.1f} s", flush=True)
        conf = tiny_conf(tmp, lst, weights)
        pred_conf = tiny_conf(tmp, lst, weights, extra="out_pred=raw.txt\n",
                              name="tiny_pred")

        # 1. the CLI on the detection conf
        t0 = time.perf_counter()
        err = run_cli(["train", conf], tmp)
        t_train = time.perf_counter() - t0
        print(f"    bcnn-cl train: {t_train:.1f} s", flush=True)
        for f in ("tiny.bcnnmodel", "tiny.bcnnmodel_iter4.bcnnmodel"):
            if not os.path.exists(os.path.join(tmp, f)):
                raise RuntimeError(f"bcnn-cl train wrote no {f}")
        stats = [ln for ln in err if ln.startswith("Yolo Avg IOU")]
        if len(stats) != 2 * 8:
            raise RuntimeError(f"{len(stats)} yolo stats lines for 8 steps")
        evals = [ln for ln in err if ln.startswith("iter-batches=")]
        ended = [ln for ln in err if ln.startswith("Training ended")]
        if len(evals) != 1 or "test-error=" not in evals[0] or not ended:
            raise RuntimeError(f"bcnn-cl train printed {err[-4:]}")
        t0 = time.perf_counter()
        verr = run_cli(["valid", conf], tmp)
        maps = [ln for ln in verr if ln.startswith("mAP@0.5=")]
        if not maps:
            raise RuntimeError(f"bcnn-cl valid printed {verr[-3:]}")
        perr = run_cli(["predict", pred_conf], tmp)
        dumps = [f for f in os.listdir(tmp) if f.startswith("det_")]
        if len(dumps) != TRAIN_BATCH:
            raise RuntimeError(f"bcnn-cl predict dumped {len(dumps)} images")
        t_eval = time.perf_counter() - t0
        print(f"bcnn-cl on examples/yolo/yolov3-tiny.cfg's layers, batch "
              f"{TRAIN_BATCH}, {SIZE} px, {P9_IMAGES} PNGs on {gpu}: train 8 "
              f"steps with an eval at 4 and checkpoints in {t_train:.1f} s; "
              f"{evals[0]}; {ended[0]}; valid and predict ({len(dumps)} "
              f"det_*.png) in {t_eval:.1f} s: {verr[0]}; {maps[0]}; "
              f"{perr[0]}; last yolo stats: {stats[-1]}")

        # 2. its first two steps card against CPU
        t0 = time.perf_counter()
        steps_card_vs_cpu("YOLOv3-tiny from the detection list", conf,
                          tol=BN_UPDATE_TOL)
        print(f"    ({time.perf_counter() - t0:.1f} s)", flush=True)

        # 3. the feeds; 4. order and scan checks
        t0 = time.perf_counter()
        k2 = feeds_phase(gpu, tmp, conf, lst, prebuilt_ms)
        print(f"    ({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        order_and_scan_checks(conf, lst, tmp)
        print(f"    ({time.perf_counter() - t0:.1f} s)", flush=True)

        # 5. the MNIST recipe through the CLI
        here = os.path.dirname(os.path.abspath(__file__))
        with open(os.path.join(here, "examples", "mnist_cl",
                               "mnist.conf")) as f:
            text = f.read()
        for a, b in (
            ("output_model=mnist.bcnnmodel",
             f"output_model={os.path.join(tmp, 'mnist.bcnnmodel')}"),
            ("out_pred=./pred_mnist.txt",
             f"out_pred={os.path.join(tmp, 'pred_mnist.txt')}"),
            ("eval_period=500", f"eval_period={P9_MNIST_BATCHES // 2}"),
            ("num_pred=4096", f"num_pred={P9_MNIST[1]}"),
            ("max_batches=200000", f"max_batches={P9_MNIST_BATCHES}"),
            ("source_train=./train-images.idx3-ubyte",
             f"source_train={mnist[0]}"),
            ("label_train=train-labels.idx1-ubyte",
             f"label_train={mnist[1]}"),
            ("source_test=t10k-images.idx3-ubyte",
             f"source_test={mnist[2]}"),
            ("label_test=t10k-labels.idx1-ubyte", f"label_test={mnist[3]}"),
        ):
            if a not in text:
                raise RuntimeError(f"mnist.conf lacks {a!r}")
            text = text.replace(a, b)
        mconf = os.path.join(tmp, "mnist.conf")
        with open(mconf, "w") as f:
            f.write(text)
        t0 = time.perf_counter()
        merr = run_cli(["train", mconf], tmp)
        t_mnist = time.perf_counter() - t0
        mevals = [ln for ln in merr if ln.startswith("iter-batches=")]
        mended = [ln for ln in merr if ln.startswith("Training ended")]
        if len(mevals) != 1 or not mended:
            raise RuntimeError(f"the MNIST recipe printed {merr[-3:]}")
        with open(os.path.join(tmp, "pred_mnist.txt")) as f:
            rows = [ln for ln in f.read().splitlines() if ln]
        if len(rows) != P9_MNIST[1]:
            raise RuntimeError(f"{len(rows)} prediction rows")
        print(f"bcnn-cl on examples/mnist_cl/mnist.conf (batch 16, host "
              f"shift/scale/rotation), {P9_MNIST_BATCHES} batches on {gpu} "
              f"in {t_mnist:.1f} s: {mevals[0]}; {mended[0]}")
        steps_card_vs_cpu("the MNIST recipe", mconf)
        print(f"phase 9: bip backend {bip.backend()}, decode "
              f"{bip.decoder()}; data written in {t_data:.1f} s; "
              f"{time.perf_counter() - t_phase:.1f} s in all")
    return k2


# ------------------------------------------------------------------------
# phase 10: full YOLOv3 training; 10b: ResNet-18; 10c: the layers left
# ------------------------------------------------------------------------

# full YOLOv3 training: examples/yolo/yolov3.cfg through config.load_net
# at 416 px (the cfg says 608), 80 classes, batch 16, the cfg's SGD,
# AUGMENT (rotation 10: K2), yolo_stats; one warm-up and P10_STEPS timed
# steps fp32 (TF32 off), then bf16 + act16; the step forms accum_steps=2
# and the resident scan on P10_RECORDS raw records
P10_BATCH, P10_STEPS, P10_RECORDS = 16, 5, 32
# the card the phases below run on (a rehearsal on the CPU sets "cpu")
DEV = "cuda"
# a step card vs CPU (batch 2, byte-equal fp32 batches): the loss within
# STEP_LOSS_RTOL; each device's update against a float64 run of the step
# that takes the device's own choices (bcnn_tpu_torch.replay: each
# RELU/LRELU unit's side of its kink and each max-pool window's pick),
# so that only rounding parts them. The card's within STEP_UPDATE_TOL of
# the tensor's largest entry, or within twice the CPU fp32 update's own
# distance to its replay where that is wider: F3 (tools/f3_float64.py,
# PERF.md) found either device's fp32 update of a seeded BN-conv net up
# to 3.8e-3 from float64, the card's of the CPU's order; one float32
# spacing of the parameter's largest entry is the floor. A YOLO delta
# that jumps between a run and its replay (DELTA_JUMP) fails the step.
# Without the replay a unit within 2e-7 of its kink that takes the other
# slope moves its conv's update by 7.7% and every update below it by up
# to 4% (F3's run of phase 10's step, PERF.md)
# ResNet-18 at 224 px, 1000 classes: served at batch 64, trained at 32
R18_SERVE, R18_TRAIN, R18_STEPS = 64, 32, 5
# the layers left: a small net (conv, deconv, LRN, dropout, PReLU twice,
# an FC embedding, the lifted loss) at 32 px, batch 16, 8 classes; its
# fp32 gradients card vs CPU within STEP_UPDATE_TOL of each tensor's
# largest, bf16 under tests/test_torch_train_bf16.py's gate; MobileNet-v1
# bf16 + act16 training at batch 32, 224 px; bcnn-cl train on the
# lifted-structure recipe (batch 128, 64 px) for P10C_CLI_BATCHES
L10_BATCH, L10_SIZE, L10_CLASSES = 16, 32, 8
MB_TRAIN, MB_TRAIN_STEPS, P10C_CLI_BATCHES = 32, 3, 6


# each kernel's op (`ops.library`), whose launches the library counts
K_OPS = {"K1": "yolo_decode", "K2": "row_shift", "K3": "depthwise",
         "K4": "conv_int8", "K5": "grouped_int8", "K6": "bn_act"}


def zero_counts():
    library.reset_launches()


def counts():
    return {k: library.launches(op) for k, op in K_OPS.items()}


def none_but(**want):
    """Each kernel's count: 0 but where `want` names it."""
    return {k: want.get(k, 0) for k in K_OPS}


def k6_convs(net):
    """K6's launches in one float forward of `net` outside TRAIN on the
    card: its BN convs with an activation K6 fuses."""
    return sum(n.type.name == "CONV2D" and bool(n.param.get("batch_norm"))
               and n.param["activation"] in K6_ACTS for n in net.nodes)


def replayed_step(label, net, p_np, s_np, x, lab):
    """One SGD step of `net` (no augmentation) from the same weights and
    host batch on the card (`Session.train_on_batch`) and on the CPU,
    each held to a float64 replay of its own choices (under net.qat its
    fake-quant codes too, and its loss to its replay's), as the
    constants above say. Also prints the choices each device makes against a plain
    float64 run, and each device's distance to that run. Returns the
    worst errors (card, CPU) against the replays."""
    t0 = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    batch = {"input": torch.from_numpy(x), "label": torch.from_numpy(lab)}
    params, state = bridge.params_from_numpy(net, p_np, s_np)
    gpu = Session(net, SEED, device=DEV)
    gpu.params, gpu.state = bridge.params_from_numpy(net, p_np, s_np, DEV)
    gpu.compile_net()
    heads = [n.src[0] for n in net.nodes if n.type.name == "YOLOV3"]
    kinked, pooling = replay.kinked_nodes(net), replay.pooling_nodes(net)
    choices, upd, deltas, bad = {}, {}, {}, []
    for run, dev, dt in (("card", DEV, f32), ("CPU", "cpu", f32),
                         ("float64", "cpu", f64)):
        choices[run] = replay.Choices()
        upd[run], ex = replay.sgd_update(
            net, params, state, batch, dt, dev,
            replay.record(choices[run]), retain=heads)
        deltas[run] = [ex.values[i].grad.cpu().double() for i in heads]
        if run == "CPU":
            loss_c = float(get_loss(ex))
        del ex
    # the card's update is train_on_batch's, held to a replay of the
    # choices its own forward made (the run above may differ from it by
    # a unit at a kink: cuDNN's backward is not deterministic)
    p0 = {k: params[k].clone() for k in upd["CPU"]}
    choices["step"] = replay.Choices()
    with replay.record(choices["step"]):
        loss_g = float(gpu.train_on_batch(x, lab))
    du_card = {k: gpu.params[k].cpu() - p0[k] for k in p0}
    # under net.qat a fake-quant code near .5 rounds to the next code on
    # one device and moves the loss by more than rounding: each device's
    # loss is then held to its own replay's, and its codes to the
    # replay's own x / s (below), else card to CPU
    qat = bool(getattr(net, "qat", None))
    if not qat and not np.isclose(loss_g, loss_c, rtol=STEP_LOSS_RTOL,
                                  atol=0):
        bad.append(f"loss card {loss_g}, CPU {loss_c}")

    def differ(a, b):
        """Choices of run a that differ from run b's, by node (the fake
        quant's by call: a node's input, then its weight)."""
        out = {f"kink {i}": int((u != v).sum()) for i, u, v in
               zip(kinked, choices[a].kinks, choices[b].kinks)}
        out.update({f"pool {i}": int((u != v).sum()) for i, u, v in
                    zip(pooling, choices[a].picks, choices[b].picks)})
        out.update({f"code {j}": int((u != v).sum()) for j, (u, v) in
                    enumerate(zip(choices[a].codes, choices[b].codes))})
        return {k: n for k, n in out.items() if n}

    flips = {run: differ(run, "float64") for run in ("step", "CPU")}
    ref, loss64, edge, worst_off = {}, {}, {}, {}
    for run in ("card", "CPU"):
        own_choices = choices["step" if run == "card" else run]
        ref[run], ex = replay.sgd_update(
            net, params, state, batch, f64, "cpu",
            replay.impose(own_choices), retain=heads)
        loss64[run] = float(get_loss(ex))
        if qat:
            total = sum(c.numel() for c in own_choices.codes)
            edge[run] = sum(own_choices.boundary) / total
            worst_off[run] = max(own_choices.off)
            if edge[run] > BOUNDARY_SHARE:
                bad.append(f"{sum(own_choices.boundary)} of {total} "
                           f"fake-quant codes of the {run}'s run round the "
                           "other way in its float64 replay (limit "
                           f"{BOUNDARY_SHARE:.0e} of them)")
        own = loss_g if run == "card" else loss_c
        if qat and not np.isclose(own, loss64[run], rtol=STEP_LOSS_RTOL,
                                  atol=0):
            bad.append(f"loss {run} {own}, its float64 replay's "
                       f"{loss64[run]}")
        jumps = sum(int(((d - ex.values[i].grad.double()).abs() > DELTA_JUMP
                         + DELTA_RTOL * d.abs()).sum())
                    for i, d in zip(heads, deltas[run]))
        if jumps:
            bad.append(f"{jumps} YOLO deltas of the {run}'s run jump "
                       "against its float64 replay")
        del ex

    def rel(a, b, scale):
        err = float((a - b).abs().max())
        return err / scale if scale else err

    worst = {"card": (0.0, ""), "CPU": (0.0, ""), "share": (0.0, "")}
    errs, plain = [], []
    for k, v0 in p0.items():
        scale = float(ref["card"][k].abs().max())
        scale_c = float(ref["CPU"][k].abs().max())
        if scale == 0 or scale_c == 0:
            if float(du_card[k].abs().max()) or float(
                    upd["CPU"][k].abs().max()):
                bad.append(f"{k} moved, float64's update is 0")
            continue
        e_card = rel(du_card[k], ref["card"][k], scale)
        e_cpu = rel(upd["CPU"][k], ref["CPU"][k], scale_c)
        # an update a few float32 spacings of its parameter wide (a layer
        # whose gradient the routing has faded) moves by one spacing on
        # another rounding: one spacing of the largest entry is the floor
        floor = float(np.spacing(np.float32(v0.abs().max()))) / scale
        lim = max(STEP_UPDATE_TOL, 2 * e_cpu, floor)
        worst["card"] = max(worst["card"], (e_card, k))
        worst["CPU"] = max(worst["CPU"], (e_cpu, k))
        worst["share"] = max(worst["share"], (e_card / lim, k))
        errs.append((e_card, e_cpu))
        s64 = float(upd["float64"][k].abs().max())
        plain.append((rel(du_card[k], upd["float64"][k], s64),
                      rel(upd["CPU"][k], upd["float64"][k], s64)))
        if e_card > lim:
            bad.append(f"{k}: the card's update is {e_card:.3g} of its "
                       f"largest entry from its float64 replay (limit "
                       f"{lim:.3g}; the CPU's {e_cpu:.3g})")
    same = max(rel(du_card[k], upd["card"][k], float(upd["card"][k].abs(
    ).max())) for k in p0)
    med = [statistics.median(e[j] for e in errs) for j in (0, 1)]
    med_plain = [statistics.median(e[j] for e in plain) for j in (0, 1)]
    apart = differ("step", "CPU")
    print(f"{label}, card vs CPU, each against float64: loss {loss_g:.6f} "
          f"vs {loss_c:.6f} (rel {abs(loss_g - loss_c) / abs(loss_c):.2g}"
          + (f"; each against its replay's: {loss64['card']:.6f}, "
             f"{loss64['CPU']:.6f}; fake-quant codes that differ card vs "
             f"CPU {sum(n for k, n in apart.items() if 'code' in k)}; "
             "each device's codes against its replay's own x / s: worst "
             f"0.5 + {worst_off['card']:.3g} codes on the card, 0.5 + "
             f"{worst_off['CPU']:.3g} on the CPU (limit 0.5 + "
             f"{replay.CODE_EPS:.0e}), share on a boundary card "
             f"{edge['card']:.3g}, CPU {edge['CPU']:.3g}"
             if qat else "") + "); "
          f"choices that differ from a float64 run's, of {len(kinked)} "
          f"kinked and {len(pooling)} max-pool layers"
          + (f" and {len(choices['CPU'].codes)} fake quants" if qat else "")
          + ": card "
          f"{sum(flips['step'].values())} {flips['step']}, CPU "
          f"{sum(flips['CPU'].values())} {flips['CPU']}; median update "
          f"error against that run, as a share of its largest entry: card "
          f"{med_plain[0]:.3g}, CPU {med_plain[1]:.3g}; against a float64 "
          f"replay of each device's own choices: worst card "
          f"{worst['card'][0]:.3g} ({worst['card'][1]}), CPU "
          f"{worst['CPU'][0]:.3g} ({worst['CPU'][1]}), median over the "
          f"{len(errs)} tensors card {med[0]:.3g}, CPU {med[1]:.3g}; worst "
          f"share of its limit {worst['share'][0]:.2f} "
          f"({worst['share'][1]}); train_on_batch's update within "
          f"{same:.3g} of the card's first run's, choices that differ "
          f"between the two {differ('step', 'card')}; "
          f"{time.perf_counter() - t0:.1f} s",
          flush=True)
    if bad:
        raise RuntimeError(f"{label}: " + "; ".join(bad[:6]))
    return worst["card"][0], worst["CPU"][0]


def timed_steps(label, sess, x, lab, steps, gpu, want_k2):
    """A warm-up step, then `steps` timed train_on_batch calls (host clock,
    the loss read back each step) with the launch counts set to 0 before
    them; K2 must launch want_k2 times and every other kernel none.
    Prints the median, img/s, busy share, peak memory and device time
    by kind; returns (median ms, K2 launches)."""
    torch.cuda.reset_peak_memory_stats()
    sess.train_on_batch(x, lab)
    torch.cuda.synchronize()
    zero_counts()
    times, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(sess.train_on_batch(x, lab)))
        times.append(1e3 * (time.perf_counter() - t0))
    got = counts()
    if got != none_but(K2=want_k2):
        raise RuntimeError(f"{label}: launches {got}, K2 {want_k2} wanted")
    if not all(np.isfinite(losses)) or min(losses) < 0:
        raise RuntimeError(f"{label}: losses {losses}")
    check_fp32(label, sess.params, sess.state, sess.opt_state)
    med = statistics.median(times)
    dev = device_us(lambda: sess.train_on_batch(x, lab), iters=2)
    busy = sum(dev.values()) / 2 / 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = x.shape[0]
    print(f"{label} on {gpu}: steps " + ", ".join(f"{v:.1f}" for v in times)
          + f" ms (after one warm-up); median {med:.2f} ms = "
          f"{n / med * 1e3:.1f} images/s; losses "
          + ", ".join(f"{v:.4g}" for v in losses) + "; device busy "
          + (f"{busy:.2f} ms per step ({100 * busy / med:.0f}% of the "
             "median)" if busy else "not measured")
          + f"; peak memory {peak:.2f} GiB", flush=True)
    groups = {}
    for k, us in dev.items():
        g = kernel_group(k)
        groups[g] = groups.get(g, 0.0) + us / 2 / 1e3
    print("    by kind, ms a step: " + ", ".join(
        f"{g} {ms:.2f}" for g, ms in sorted(groups.items(),
                                           key=lambda kv: -kv[1])))
    return med, got["K2"]


def yolov3_train_phase(gpu):
    """Phase 10: full YOLOv3 training at 416 px from its cfg and a
    .weights file of seeded weights (He-scaled, each residual branch's BN
    scales times RESIDUAL_SCALE), through config.load_net; fp32 then bf16
    + act16, each with three K2 launches a step and yolo_stats; the
    accum_steps=2 step and the resident scan; one batch-2 step card vs
    CPU vs float64. Returns K2's launches on the path."""
    from bcnn_tpu_torch.config import load_net
    from bcnn_tpu_torch.data import records
    from bcnn_tpu_torch.graph import Net

    t_phase = time.perf_counter()
    ref = yolov3(P10_BATCH, SIZE, SIZE, CLASSES, mode=Mode.TRAIN)
    p_np, s_np = bridge.he_numpy_weights(ref, SEED,
                                         residual_scale=RESIDUAL_SCALE)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "examples", "yolo", "yolov3.cfg")) as f:
        text = f.read()
    for a, b in (("\nbatch=1\n", f"\nbatch={P10_BATCH}\n"),
                 ("width=608", f"width={SIZE}"),
                 ("height=608", f"height={SIZE}")):
        if a not in text:
            raise RuntimeError(f"yolov3.cfg lacks {a!r}")
        text = text.replace(a, b)
    with tempfile.TemporaryDirectory() as tmp:
        cfg, weights = (os.path.join(tmp, "yolov3_train.cfg"),
                        os.path.join(tmp, "yolov3.weights"))
        with open(cfg, "w") as f:
            f.write(text)
        save_weights_darknet(ref, *bridge.params_from_numpy(ref, p_np, s_np),
                             weights)
        net = load_net(Net(Mode.TRAIN), cfg, weights)
    types = [n.type.name for n in net.nodes]
    if (types.count("CONV2D"), types.count("ELTWISE"), types.count(
            "YOLOV3"), net.batch_size, net.tensors[0].h) != (
            75, 23, 3, P10_BATCH, SIZE):
        raise RuntimeError("the yolov3.cfg net is not Darknet-53 at 416")
    net.device_augment = AUGMENT
    net.yolo_stats = True
    rng = np.random.RandomState(SEED + 10)
    x = rng.randint(0, 256, (P10_BATCH, 3, SIZE, SIZE)).astype(np.uint8)
    lab = det_labels(rng, P10_BATCH)
    k2, meds = 0, {}
    heads = [net.tensors[net.nodes[i - 1].src[1]].key
             for i, n in enumerate(net.nodes) if n.type.name == "YOLOV3"]
    for prec in ("fp32", "bf16"):
        net.compute_dtype = net.train_act_dtype = (
            torch.bfloat16 if prec == "bf16" else None)
        torch.cuda.empty_cache()
        sess = Session(net, SEED, device=DEV).compile_net()
        p0 = {k: sess.params[k].clone() for k in heads}
        what = "bf16 + act16" if prec == "bf16" else "fp32 (TF32 off)"
        meds[prec], n2 = timed_steps(
            f"full YOLOv3 train_on_batch {what}, batch {P10_BATCH}, {SIZE} "
            f"px, {CLASSES} classes, augment {AUGMENT}, yolo_stats", sess,
            x, lab, P10_STEPS, gpu, 3 * P10_STEPS)
        k2 += n2
        if any(torch.equal(p0[k], sess.params[k]) for k in heads):
            raise RuntimeError(f"full YOLOv3 {prec}: a head did not move")
        st = sess.last_yolo_stats
        if len(st) != 3 or not all(np.isfinite(d["cost"]) for d in st):
            raise RuntimeError(f"full YOLOv3 {prec}: yolo stats {st}")
        print("    " + "; ".join(
            f"head {i}: cost {d['cost']:.1f}, {d['count']:.0f} truths"
            for i, d in enumerate(st)))
        del sess
    print(f"full YOLOv3 training on {gpu}: bf16 + act16 "
          f"{meds['fp32'] / meds['bf16']:.2f}x fp32", flush=True)

    # the step forms on full YOLOv3, fp32
    net.compute_dtype = net.train_act_dtype = None
    torch.cuda.empty_cache()
    sess = Session(net, SEED, device=DEV).compile_net()
    p0 = {k: sess.params[k].clone() for k in heads}
    zero_counts()
    t0 = time.perf_counter()
    out = make_train_step(net, accum_steps=2)(
        sess.params, sess.state, sess.opt_state,
        {"input": torch.from_numpy(x).to(DEV),
         "label": torch.from_numpy(lab).to(DEV)},
        torch.Generator().manual_seed(SEED))
    loss = float(out[3])
    t_accum = 1e3 * (time.perf_counter() - t0)
    if counts()["K2"] != 6 or not np.isfinite(loss) or any(
            torch.equal(p0[k], out[0][k]) for k in heads):
        raise RuntimeError(f"full YOLOv3 accum_steps=2: loss {loss}, "
                           f"launches {counts()}")
    k2 += library.launches("row_shift")
    sess = Session(net, SEED, device=DEV).compile_net()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "v3.bcrd")
        xs = rng.randint(0, 256, (P10_RECORDS, 3, SIZE, SIZE)).astype(
            np.uint8)
        records.write_records(path, zip(xs, det_labels(rng, P10_RECORDS)),
                              3, SIZE, SIZE, 250)
        sess.loader = records.RawRecordLoader(net, path)
        zero_counts()
        t0 = time.perf_counter()
        total = sess.train_scan_resident_on_batches(2)
        t_res = 1e3 * (time.perf_counter() - t0)
        sess.loader = None
    if counts()["K2"] != 6 or not np.isfinite(total) or total <= 0:
        raise RuntimeError(f"full YOLOv3 resident scan: loss sum {total}, "
                           f"launches {counts()}")
    k2 += library.launches("row_shift")
    print(f"full YOLOv3 step forms, fp32, batch {P10_BATCH}: accum_steps=2 "
          f"one step {t_accum:.1f} ms (loss {loss:.1f}, 6 K2 launches); "
          f"the resident scan of 2 steps on {P10_RECORDS} raw records "
          f"{t_res:.1f} ms with its first call's upload (loss sum "
          f"{total:.1f}, 6 K2 launches)", flush=True)
    del sess, out

    small = yolov3(2, SIZE, SIZE, CLASSES, mode=Mode.TRAIN)
    rng = np.random.RandomState(SEED + 11)
    x2 = (rng.rand(2, 3, SIZE, SIZE) * 2 - 1).astype(np.float32)
    replayed_step(f"full YOLOv3 fp32 step at batch 2, {SIZE} px", small,
                  p_np, s_np, x2, det_labels(rng, 2))
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k2


def resnet18_phase(gpu):
    """Phase 10b: ResNet-18 at 224 px, 1000 classes (He-scaled seeded
    weights): served at batch R18_SERVE in fp32 and bf16 (fc and softmax
    of two images against the CPU port), trained at batch R18_TRAIN in
    fp32 and bf16 + act16, one batch-2 step card vs CPU vs float64.
    Returns K6's launches in the serving (every BN conv)."""
    t_phase = time.perf_counter()
    net = resnet18(R18_SERVE, 1000)
    p_np, s_np = bridge.he_numpy_weights(net, SEED)
    sess = Session(net, SEED, device=DEV)
    sess.params, sess.state = bridge.params_from_numpy(net, p_np, s_np,
                                                       DEV)
    sess.compile_net()
    cpu = Session(net, SEED, device="cpu")
    cpu.params, cpu.state = bridge.params_from_numpy(net, p_np, s_np)
    cpu.compile_net()
    rng = np.random.RandomState(SEED + 12)
    x = rng.rand(R18_SERVE, 3, 224, 224).astype(np.float32)
    k6 = 0
    for prec in ("fp32", "bf16"):
        net.compute_dtype = net.act_dtype = (
            torch.bfloat16 if prec == "bf16" else None)
        zero_counts()
        outs, _ = serve(
            lambda v: sess.predict_on_batch(v, outputs=MB_OUTPUTS)[0], [x, x])
        got, want = counts(), none_but(K6=k6_convs(net) * len(outs))
        if got != want:
            raise RuntimeError(f"ResNet-18 serving launched {got}, wanted "
                               f"{want}")
        k6 += got["K6"]
        fc = outs[-1][0].float()
        if tuple(fc.shape) != (R18_SERVE, 1000, 1, 1) or not torch.isfinite(
                fc).all():
            raise RuntimeError(f"ResNet-18 {prec}: fc {tuple(fc.shape)}")
        (ref, _), _ = cpu.predict_on_batch(x[:2], outputs=MB_OUTPUTS)
        err = float((fc[:2] - ref.float()).abs().max())
        scale = float(ref.abs().max())
        if prec == "fp32":
            torch.testing.assert_close(fc[:2], ref, rtol=HEAD_RTOL,
                                       atol=HEAD_ATOL * scale)
        elif err > BF16_FC_TOL * scale:
            raise RuntimeError(f"ResNet-18 bf16 fc: {err:.3g} of "
                               f"{scale:.3g}")
        print(f"ResNet-18 predict_on_batch {prec}, batch {R18_SERVE}, 224 "
              f"px: fc of two images vs the CPU port max_abs_err {err:.3g} "
              f"(largest {scale:.3g})")
    net.compute_dtype = net.act_dtype = None
    del sess, cpu

    tnet = resnet18(R18_TRAIN, 1000, mode=Mode.TRAIN)
    x = rng.rand(R18_TRAIN, 3, 224, 224).astype(np.float32)
    lab = np.zeros((R18_TRAIN, 1000), np.float32)
    lab[np.arange(R18_TRAIN), rng.randint(1000, size=R18_TRAIN)] = 1.0
    meds = {}
    for prec in ("fp32", "bf16"):
        tnet.compute_dtype = tnet.train_act_dtype = (
            torch.bfloat16 if prec == "bf16" else None)
        torch.cuda.empty_cache()
        sess = Session(tnet, SEED, device=DEV)
        sess.params, sess.state = bridge.params_from_numpy(tnet, p_np, s_np,
                                                           DEV)
        sess.compile_net()
        what = "bf16 + act16" if prec == "bf16" else "fp32 (TF32 off)"
        meds[prec], _ = timed_steps(
            f"ResNet-18 train_on_batch {what}, batch {R18_TRAIN}, 224 px",
            sess, x, lab, R18_STEPS, gpu, 0)
        del sess
    print(f"ResNet-18 training: bf16 + act16 "
          f"{meds['fp32'] / meds['bf16']:.2f}x fp32")
    x2 = (rng.rand(2, 3, 224, 224) * 2 - 1).astype(np.float32)
    lab2 = np.zeros((2, 1000), np.float32)
    lab2[[0, 1], rng.randint(1000, size=2)] = 1.0
    replayed_step("ResNet-18 fp32 step at batch 2, 224 px",
                  resnet18(2, 1000, mode=Mode.TRAIN), p_np, s_np, x2, lab2)
    print(f"phase 10b: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return k6


def layers_net(quirk=False, bf16=False):
    """conv -> deconv (pad 1) -> LRN (k = 2, AlexNet's; the builder drops
    k, and k = 0 lets the window's sum cancel to 0) -> dropout -> conv
    with PReLU -> standalone PReLU -> FC embedding -> the lifted loss."""
    from bcnn_tpu_torch.graph import Net
    from bcnn_tpu_torch.types import FillerType, Loss, Metric

    net = Net(Mode.TRAIN)
    net.set_input_shape(L10_SIZE, L10_SIZE, 3, L10_BATCH)
    net.set_sgd_optimizer(0.01, 0.9)
    net.set_weight_regularizer(0.0005)
    A, X = Activation, FillerType.XAVIER
    net.add_convolutional_layer(16, 3, 2, 1, 1, 1, X, A.RELU, 0, "input",
                                "c1")
    net.add_deconvolutional_layer(12, 3, 2, 1, X, A.LRELU, "c1", "d1")
    net.add_lrn_layer(5, 0.5, 0.75, 2.0, "d1", "n1")
    net.nodes[-1].param["k"] = 2.0
    net.add_dropout_layer(0.3, "n1")
    net.add_convolutional_layer(16, 3, 2, 1, 1, 0, X, A.PRELU, 0, "n1", "c2")
    net.add_activation_layer(A.PRELU, "c2")
    net.add_fullc_layer(32, X, A.NONE, 0, "c2", "emb")
    net.add_cost_layer(Loss.LIFTED_STRUCT, Metric.SSE, 1.0, "emb", "label",
                       "cost")
    net.ref_deconv_quirk = quirk
    if bf16:
        net.compute_dtype = net.train_act_dtype = torch.bfloat16
    return net


def layers_step(net, p_np, s_np, x, lab, device, seed=None, masks=None):
    """One forward and backward of `net` on `device`: (loss, the updates of
    one SGD step as CPU tensors, the dropout masks it used)."""
    update, ex = replay.sgd_update(
        net, *bridge.params_from_numpy(net, p_np, s_np),
        {"input": x, "label": lab}, device=device, seed=seed,
        dropout_masks=masks)
    return float(get_loss(ex).detach()), update, ex.dropout_masks


def lifted_recipe(tmp, batch=128):
    """Seeded 64x64 PNGs (8 classes, 4 images each, a class colour and
    noise) and examples/lifted_structure_loss/lifted_structure.conf on a
    list of `batch` lines that groups same-class images; returns the
    conf's path."""
    from bcnn_tpu_torch import bip

    rng = np.random.RandomState(SEED + 13)
    rows = []
    for c in range(8):
        base = rng.randint(0, 256, 3)
        for j in range(4):
            img = np.clip(base + rng.randint(-30, 30, (64, 64, 3)), 0,
                          255).astype(np.uint8)
            path = os.path.join(tmp, f"c{c}_{j}.png")
            bip.write_image(path, img)
            rows.append(f"{path} {c}")
    lst = os.path.join(tmp, "list.txt")
    with open(lst, "w") as f:
        f.write("\n".join(rows[i % len(rows)] for i in range(batch)) + "\n")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "examples", "lifted_structure_loss",
                           "lifted_structure.conf")) as f:
        text = f.read()
    for a, b in (("source_train=train_list.txt",
                  f"source_train={lst}\noutput_model="
                  f"{os.path.join(tmp, 'lifted.bcnnmodel')}"),
                 ("source_test=test_list.txt", f"source_test={lst}"),
                 ("max_batches=100000", f"max_batches={P10C_CLI_BATCHES}"),
                 ("eval_period=500", f"eval_period={P10C_CLI_BATCHES // 2}"),
                 ("num_pred=1024", f"num_pred={batch}")):
        if a not in text:
            raise RuntimeError(f"lifted_structure.conf lacks {a!r}")
        text = text.replace(a, b)
    conf = os.path.join(tmp, "lifted.conf")
    with open(conf, "w") as f:
        f.write(text)
    return conf


def layers_left_phase(gpu):
    """Phase 10c: one training step of `layers_net` card vs CPU in fp32,
    bf16 and the deconv quirk (the card's dropout masks handed to the
    CPU); MobileNet-v1 bf16 + act16 training (FC and depthwise in bf16,
    no K3 in TRAIN); bcnn-cl train on the lifted-structure recipe."""
    t_phase = time.perf_counter()
    rng = np.random.RandomState(SEED + 14)
    x = rng.randn(L10_BATCH, 3, L10_SIZE, L10_SIZE).astype(np.float32)
    lab = np.zeros((L10_BATCH, 32), np.float32)
    lab[np.arange(L10_BATCH), np.arange(L10_BATCH) // 2 % L10_CLASSES] = 1.0
    p_np, s_np = bridge.he_numpy_weights(layers_net(), SEED)
    for form in ("fp32", "quirk", "bf16"):
        net = layers_net(quirk=form == "quirk", bf16=form == "bf16")
        zero_counts()
        loss_g, du_g, masks = layers_step(net, p_np, s_np, x, lab, DEV,
                                          seed=SEED)
        if any(counts().values()):
            raise RuntimeError(f"layers net launched {counts()}")
        cpu_masks = {i: m.cpu() for i, m in masks.items()}
        loss_c, du_c, _ = layers_step(net, p_np, s_np, x, lab, "cpu",
                                      masks=cpu_masks)
        # the lifted loss reads only the embeddings' differences, so the
        # embedding's bias gets no gradient but rounding: left out
        for du in (du_c, du_g):
            du.pop("c2_b")
        keep = float(next(iter(cpu_masks.values())).float().mean())
        if form != "bf16":
            if not np.isclose(loss_g, loss_c, rtol=STEP_LOSS_RTOL, atol=0):
                raise RuntimeError(f"layers net {form}: loss card {loss_g}, "
                                   f"CPU {loss_c}")
            errs = {k: float((du_g[k] - v).abs().max()) / float(
                v.abs().max()) for k, v in du_c.items() if v.abs().max()}
            worst = max(errs.items(), key=lambda kv: kv[1])
            if worst[1] > STEP_UPDATE_TOL:
                raise RuntimeError(f"layers net {form}: {worst[0]} update "
                                   f"differs by {worst[1]:.3g}")
            print(f"layers net {form} (conv, deconv, LRN, dropout kept "
                  f"{keep:.3f}, PReLU x2, FC, lifted loss), batch "
                  f"{L10_BATCH}, {L10_SIZE} px, one SGD step card vs CPU: "
                  f"loss {loss_g:.6f} vs {loss_c:.6f}; worst update error "
                  f"{worst[1]:.3g} ({worst[0]}) of {len(errs)} tensors",
                  flush=True)
            continue
        _, du32, _ = layers_step(layers_net(), p_np, s_np, x, lab, "cpu",
                                 masks=cpu_masks)
        du32.pop("c2_b")
        if not np.isclose(loss_g, loss_c, rtol=T16_LOSS_RTOL, atol=0):
            raise RuntimeError(f"layers net bf16: loss card {loss_g}, CPU "
                               f"{loss_c}")
        noise, gaps = grad_gaps(du32, du_c), grad_gaps(du_c, du_g)
        for k, (cg, rg) in gaps.items():
            clean = noise[k][0] <= 0.01 and noise[k][1] < 0.5
            lim = ((COS_GAP, RMS_GAP) if clean else
                   (NOISE_RATIO * noise[k][0], NOISE_RATIO * noise[k][1]))
            if cg > lim[0] or rg > lim[1]:
                raise RuntimeError(f"layers net bf16 {k}: 1 - cosine "
                                   f"{cg:.3g}, max|d| {rg:.3g} rms")
        print(f"layers net bf16 + act16: loss {loss_g:.5f} vs {loss_c:.5f} "
              f"card vs CPU; {len(gaps)} updates under the bf16 gate "
              "(worst 1 - cosine "
              f"{max(v[0] for v in gaps.values()):.3g})", flush=True)

    # MobileNet-v1 bf16 + act16 training, FC and depthwise in bf16
    net = mobilenet_v1(MB_TRAIN, MB_CLASSES, Mode.TRAIN)
    net.compute_dtype = net.train_act_dtype = torch.bfloat16
    sess = Session(net, SEED, device=DEV)
    sess.params, sess.state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, SEED), DEV)
    sess.compile_net()
    xm = rng.rand(MB_TRAIN, 3, MB_SIZE, MB_SIZE).astype(np.float32)
    lm = np.zeros((MB_TRAIN, MB_CLASSES), np.float32)
    lm[np.arange(MB_TRAIN), rng.randint(MB_CLASSES, size=MB_TRAIN)] = 1.0
    timed_steps(f"MobileNet-v1 train_on_batch bf16 + act16 (FC and 13 "
                f"depthwise in bf16, K3 not in TRAIN), batch {MB_TRAIN}, "
                f"{MB_SIZE} px", sess, xm, lm, MB_TRAIN_STEPS, gpu, 0)
    del sess

    # bcnn-cl train on the lifted-structure recipe
    with tempfile.TemporaryDirectory() as tmp:
        conf = lifted_recipe(tmp)
        t0 = time.perf_counter()
        err = run_cli(["train", conf], tmp)
        t_cli = time.perf_counter() - t0
        evals = [ln for ln in err if ln.startswith("iter-batches=")]
        ended = [ln for ln in err if ln.startswith("Training ended")]
        if len(evals) != 1 or not ended or not os.path.exists(
                os.path.join(tmp, "lifted.bcnnmodel")):
            raise RuntimeError(f"bcnn-cl lifted recipe printed {err[-3:]}")
    print(f"bcnn-cl train on examples/lifted_structure_loss/"
          f"lifted_structure.conf (batch 128, 64 px, host contrast/"
          f"brightness/flip), {P10C_CLI_BATCHES} batches on {gpu} in "
          f"{t_cli:.1f} s: {evals[0]}; {ended[0]}")
    print(f"phase 10c: {time.perf_counter() - t_phase:.1f} s", flush=True)



# -- phase 3e, 11, 12: K5, int8 classification, QAT ----------------------

# K5 against its plain version, bit for bit: MobileNet-v1's nine
# depthwise shapes at batch 64 (the path's), a grouped conv with BN, and
# ragged shapes: (n, c, h, w, o, k, stride, pad, groups, bn, act)
K5_MOBILENET = [(MB_BATCH, c, h, w, c, 3, s, 1, c, None, Activation.RELU)
                for _, c, h, w, s in K3_MOBILENET]
K5_OTHER = [
    (8, 256, 26, 26, 256, 3, 1, 1, 4, "unfolded", Activation.LRELU),
    (3, 6, 15, 13, 6, 3, 1, 1, 6, None, Activation.LRELU),
    (2, 5, 9, 11, 5, 5, 2, 0, 5, None, Activation.NONE),
    (2, 9, 7, 7, 6, 3, 2, 1, 3, "folded", Activation.NONE),
    (1, 1400, 3, 3, 4, 3, 1, 1, 1, None, Activation.RELU),
    (70, 16, 7, 7, 16, 3, 1, 1, 16, None, Activation.LRELU),
]
# the redesign's edges: a ragged strip end, stride 2 on odd widths, C =
# 16 j + 8, groups of 4 and of 64 input channels, batch 1
K5_EDGES = [
    (2, 32, 14, 14, 32, 3, 1, 1, 32, None, Activation.RELU),
    (2, 48, 13, 11, 48, 3, 2, 1, 48, None, Activation.LRELU),
    (2, 24, 8, 8, 24, 3, 1, 1, 24, None, Activation.NONE),
    (2, 16, 9, 9, 16, 3, 1, 1, 4, "unfolded", Activation.RELU),
    (2, 128, 10, 10, 64, 3, 1, 1, 2, "folded", Activation.LRELU),
    (1, 1024, 7, 7, 1024, 3, 1, 1, 1024, None, Activation.RELU),
]
# phase 11: int8 classification at batch 64, 224 px, 1000 classes
I8_BATCH = 64


def k5_args(shape, gen):
    """Random int8 x (channels-last) and w (K5's (k, k, O, C/G) layout)
    on the card, d scaled so that y spreads over the codes of s_out =
    2/127, the BN vectors as `bn` says."""
    n, c, h, w, o, k, stride, pad, groups, bn, act = shape
    x = torch.randint(-127, 128, (n, c, h, w), generator=gen,
                      dtype=torch.int8).contiguous(
                          memory_format=torch.channels_last)
    wt = grouped_weight(torch.randint(-127, 128, (o, c // groups, k, k),
                                      generator=gen, dtype=torch.int8))
    u = lambda lo, hi: (lo + (hi - lo) * torch.rand(o, generator=gen)  # noqa
                        ).cuda()
    d = u(0.5, 1.5) * (3.0 / (127.0**2 * (c // groups * k * k) ** 0.5))
    kw = dict(act=act, s_out=2.0 / 127)
    if bn:
        kw.update(scale=u(0.8, 1.2))
    if bn == "unfolded":
        kw.update(mean=u(-0.1, 0.1), inv=1 / torch.sqrt(u(0.5, 1.5) + 1e-6))
    return (x.cuda(), wt.cuda(), d, u(-0.1, 0.1), stride, pad, groups), kw


def check_k5():
    """Phase 3e: K5 against grouped_int8_fused_ref on the card, bit for
    bit, int8 and fp32 out: MobileNet-v1's nine depthwise shapes at batch
    64, then the other shapes and the edges. The MobileNet shapes and
    the grouped one timed warm in turns (plain, kernel, library, library,
    kernel, plain), the library being cuDNN's bf16 grouped conv of the
    same values, channels-last (PyTorch has no int8 conv on CUDA), then
    cold. Returns per-shape records, the MobileNet ones first."""
    gen = torch.Generator().manual_seed(SEED)
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    rows = []
    for i, shape in enumerate(K5_MOBILENET + K5_OTHER + K5_EDGES):
        args, kw = k5_args(shape, gen)
        err = 0.0
        for s_out in (kw["s_out"], None):
            kw_f = dict(kw, s_out=s_out)
            before = library.launches("grouped_int8")
            got = grouped_int8_fused(*args, **kw_f)
            want = grouped_int8_fused_ref(*args, **kw_f)
            torch.cuda.synchronize()
            if library.launches("grouped_int8") != before + 1:
                raise RuntimeError("grouped_int8_fused did not count its "
                                   "launch")
            if got.shape != want.shape or got.dtype != want.dtype or \
                    not torch.equal(got, want):
                raise RuntimeError(
                    f"K5 {shape[:9]} {'int8' if s_out else 'fp32'} out is "
                    "not bit-equal to its plain version: max_abs_err "
                    f"{float((got.float() - want.float()).abs().max())}")
            err = max(err, float((got.float() - want.float()).abs().max()))
            del got, want
        n, c, h, w, o, k, stride, pad, groups, bn, act = shape
        plan = plan_grouped_int8(n, c, h, w, o, k, stride, pad, groups)
        plan_s = (f"plan {plan.describe()} (lanes x strips x rows), "
                  f"{plan.blocks(n)} blocks")
        rows.append(dict(shape=shape[:9], max_abs_err=err))
        if i > len(K5_MOBILENET):
            print(f"K5 {shape[:9]} {bn or 'no BN'} {act.name}: bit-equal, "
                  f"int8 and fp32 out; {plan_s}")
            continue
        x, wt, _, _, _, _, _ = args
        xb = x.to(torch.bfloat16)  # channels-last, as x
        wb = wt.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        kern = lambda: grouped_int8_fused(*args, **kw)  # noqa: E731
        plain = lambda: grouped_int8_fused_ref(*args, **kw)  # noqa: E731
        lib = lambda: F.conv2d(xb, wb, None, stride, pad, 1,  # noqa: E731
                               groups)
        t = [cuda_ms(f, iters=it, warmup=wu) for f, it, wu in (
            (plain, 3, 1), (kern, 50, 5), (lib, 50, 5), (lib, 50, 5),
            (kern, 50, 5), (plain, 3, 1))]
        out = kern()
        k_dev = sum(device_us(kern, iters=10).values()) / 10
        nbytes = x.numel() + wt.numel() + out.numel() + 4 * 5 * o
        ops = 2 * out.numel() * (c // groups) * k * k
        r = rows[-1]
        r.update(ms=(t[1] + t[4]) / 2, plain_ms=(t[0] + t[5]) / 2,
                 library_ms=(t[2] + t[3]) / 2, cold_ms=cold_ms(kern, flush),
                 library_cold_ms=cold_ms(lib, flush),
                 bound=bound(nbytes, ops, PEAK_OPS["int8"]), mb=nbytes / 1e6,
                 gop=ops / 1e9, dev_ms=k_dev / 1e3 if k_dev else None)
        del x, wt, xb, wb, out, args
        print(f"K5 {shape[:9]} {bn or 'no BN'} {act.name}: bit-equal, int8 "
              f"and fp32 out; {r['mb']:.2f} MB, {r['gop']:.3f} G int ops, "
              f"bound {1e3 * r['bound'][0]:.2f} us ({r['bound'][1]}); warm: "
              f"kernel {1e3 * r['ms']:.1f} us, plain "
              f"{1e3 * r['plain_ms']:.1f} us, library (bf16 cuDNN grouped, "
              f"channels-last) {1e3 * r['library_ms']:.1f} us; cold: kernel "
              f"{1e3 * r['cold_ms']:.1f} us "
              f"({r['bound'][0] / r['cold_ms']:.0%} of the bound), library "
              f"{1e3 * r['library_cold_ms']:.1f} us; device (profiler): "
              f"kernel {fmt_device(k_dev * 10, 10)}; {plan_s}")
    del flush
    mb = rows[:len(K5_MOBILENET)]
    fwd = {key: sum(m * (r[key][0] if key == "bound" else r[key])
                    for m, r in zip(K3_PER_FORWARD, mb))
           for key in ("ms", "cold_ms", "plain_ms", "library_ms",
                       "library_cold_ms", "bound")}
    print(f"K5 per int8 MobileNet-v1 forward (13 launches, batch "
          f"{MB_BATCH}): warm {fwd['ms']:.4f} ms, cold {fwd['cold_ms']:.4f} "
          f"ms, device {forward_dev_ms(mb)} (profiler), bound "
          f"{fwd['bound']:.4f} ms ({fwd['bound'] / fwd['cold_ms']:.0%} of "
          f"it cold); plain {fwd['plain_ms']:.2f} ms; library (bf16 "
          f"cuDNN grouped) {fwd['library_ms']:.4f} ms warm, "
          f"{fwd['library_cold_ms']:.4f} ms cold")
    for r, m in zip(mb, K3_PER_FORWARD):
        r["n"] = m
    return rows


# -- phase 3f: K6, a conv's BN and activation outside TRAIN ----------------

# K6 against its plain version, bit for bit (NaNs and signed zeros too),
# at full YOLOv3 416's 72 BN convs (13 shapes), YOLOv4 608's 107 (13
# shapes; x spread 12-fold, so that Mish meets |y| past 20) and YOLOv7
# 640's 89 (16 shapes; x spread 40-fold, so that swish's exp(-y) under-
# and overflows) at batch 64, each (shape, activation) of a net timed in
# the bf16 serving cells' form (BN unfolded; LRELU, MISH in YOLOv4's
# backbone, SWISH in YOLOv7); then edges: planes
# of 1 and of 3 values, C = 1, odd planes, a misaligned x, special
# values, and a batch past 2^31 values, which K6 runs as two launches
K6_BATCH = 64
# (label, net, activations checked at its shapes, x's spread)
K6_NETS = (("full YOLOv3 416",
            lambda: yolov3(K6_BATCH, SIZE, SIZE, CLASSES),
            (Activation.LRELU, Activation.RELU, Activation.NONE), 1.0),
           ("YOLOv4 608", lambda: yolov4(K6_BATCH, 608, 608, CLASSES),
            (Activation.MISH, Activation.LRELU), 12.0),
           ("YOLOv7 640", lambda: yolov7(K6_BATCH, 640, 640, CLASSES),
            (Activation.SWISH,), 40.0))
# the library's form of each timed activation, after F.batch_norm
K6_LIBRARY = {Activation.LRELU: ("F.leaky_relu",
                                 lambda y: F.leaky_relu(y, 0.1)),
              Activation.MISH: ("F.mish", F.mish),
              Activation.SWISH: ("F.silu", F.silu)}
K6_EDGES = [(3, 1, 1, 1), (2, 3, 13, 13), (2, 5, 3, 1), (1, 1, 7, 9),
            (2, 255, 26, 26), (3, 1024, 13, 13), (2, 7, 2, 2)]
# 2.16e9 bf16 values: two launches, the second from an image 14 bytes
# past a 16-byte boundary (a head of one value)
K6_BIG = (720, 3, 999, 1001)
# 2.15e9 bf16 values channels-last, C a multiple of 8: two launches of
# one image each, both in 16-byte vectors
K6_BIG_CL = (2, 8, 16384, 8193)


def k6_shapes(net):
    """{((c, h, w), activation): convs} of the BN convs of `net`, in
    order."""
    shapes = {}
    for node in net.nodes:
        if node.type.name == "CONV2D" and node.param.get("batch_norm"):
            d = net.tensors[node.dst[0]]
            key = ((d.c, d.h, d.w), Activation(node.param["activation"]))
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def k6_vectors(c, gen):
    """(scales, biases, run_mean, run_var) fp32 on the card."""
    u = lambda lo, hi: (lo + (hi - lo) * torch.rand(c, generator=gen)  # noqa
                        ).cuda()
    return u(0.8, 1.2), u(-0.1, 0.1), u(-0.5, 0.5), u(0.2, 2.0)


def k6_bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def k6_equal(x, vecs, folded, act, what):
    """K6 on x (contiguous NCHW or channels-last) against its plain
    version: one launch counted, in the total, under its activation and,
    for its channels-last form, under "channels_last"; the same shape and
    dtype, x's strides (the plain ops' on every dimension of more than one
    value: on a unit one a stride means nothing, and theirs vary by op),
    the same bits."""
    wide = lambda t: [st for st, n in zip(t.stride(), t.shape)  # noqa: E731
                      if n > 1]
    name = Activation(act).name
    kinds = (None, name, "channels_last")
    before = [library.launches("bn_act", k) for k in kinds]
    got = bn_act(x, *vecs, folded, act)
    want = bn_act_ref(x, *vecs, folded, act)
    torch.cuda.synchronize()
    one = int(x.numel() > 0)
    cl = one * channels_last_form(x)
    if [library.launches("bn_act", k) for k in kinds] != [
            before[0] + one, before[1] + one, before[2] + cl]:
        raise RuntimeError(f"K6 {what}: its launch was not counted")
    if (got.shape != want.shape or got.dtype != want.dtype
            or got.stride() != x.stride() or wide(got) != wide(want)
            or not torch.equal(k6_bits(got), k6_bits(want))):
        diff = (got.float() - want.float()).abs().nan_to_num(0)
        raise RuntimeError(
            f"K6 {what} {tuple(x.shape)} {x.dtype} "
            f"{'folded' if folded else 'unfolded'} {name} "
            "is not bit-equal to its plain version: "
            f"{int((k6_bits(got) != k6_bits(want)).sum())} values differ, "
            f"max_abs_err {float(diff.max())}")


def k6_rows(label, net, checked, spread, gen, flush):
    """K6 at each BN conv shape of `net` at batch K6_BATCH: bit-equal to
    bn_act_ref with each of `checked`, in bf16 and fp32, folded and
    unfolded, on x ~ spread * N(0, 1); then each (shape, activation) the
    net has, timed warm in turns in bf16, BN unfolded (plain, kernel,
    library, library, kernel, plain), the library being F.batch_norm
    then the activation's own function (with its own rounding between),
    then a copy of the same bytes (what the card's memory allows a pass
    of one read and one write), then cold and by the profiler. Returns
    the rows (a row's "n" is its convs in one request, its "act" the
    activation)."""
    shapes = k6_shapes(net)
    xgen = torch.Generator("cuda").manual_seed(SEED)
    rows, seen = [], set()
    for ((c, h, w), act), convs in shapes.items():
        vecs = k6_vectors(c, gen)
        x = spread * torch.randn(K6_BATCH, c, h, w, device="cuda",
                                 generator=xgen)
        if (c, h, w) not in seen:
            seen.add((c, h, w))
            for dtype in (torch.bfloat16, torch.float32):
                xd = x.to(dtype)
                for xs in (xd, xd.contiguous(
                        memory_format=torch.channels_last)):
                    for folded in (False, True):
                        for a in checked:
                            k6_equal(xs, vecs, folded, a, label)
                    del xs
                del xd
        xb = x.to(torch.bfloat16)
        del x
        kern = lambda: bn_act(xb, *vecs, False, act)  # noqa: E731
        plain = lambda: bn_act_ref(xb, *vecs, False, act)  # noqa: E731
        s, b, m, v = vecs
        lib_name, lib_act = K6_LIBRARY[act]
        lib = lambda: lib_act(F.batch_norm(  # noqa: E731
            xb, m, v, s, b, False, 0.0, 1e-6))
        out = torch.empty_like(xb)
        copy = lambda: out.copy_(xb)  # noqa: E731  the same bytes moved
        t = [cuda_ms(f, iters=i, warmup=wu) for f, i, wu in (
            (plain, 3, 1), (kern, 50, 5), (lib, 20, 2), (lib, 20, 2),
            (kern, 50, 5), (plain, 3, 1), (copy, 50, 5))]
        dev = sum(device_us(kern, iters=10).values()) / 10
        nbytes = 2 * xb.numel() * xb.element_size() + 4 * 4 * c
        r = dict(shape=(K6_BATCH, c, h, w), act=act, n=convs,
                 max_abs_err=0.0, ms=(t[1] + t[4]) / 2,
                 plain_ms=(t[0] + t[5]) / 2, library_ms=(t[2] + t[3]) / 2,
                 cold_ms=cold_ms(kern, flush), copy_ms=t[6],
                 bound=bound(nbytes, 0), mb=nbytes / 1e6,
                 dev_ms=dev / 1e3 if dev else None)
        rows.append(r)
        del xb, out
        print(f"K6 {label} {r['shape']} x{convs} bf16 BN {act.name}: "
              "bit-equal to its plain version in bf16 and fp32, NCHW and "
              "channels-last, folded and "
              f"unfolded, {', '.join(a.name for a in checked)}; "
              f"{r['mb']:.1f} MB, bound {1e3 * r['bound'][0]:.1f} us "
              f"({r['bound'][1]}); warm: kernel {1e3 * r['ms']:.1f} us, "
              f"plain {1e3 * r['plain_ms']:.1f} us, library (F.batch_norm, "
              f"{lib_name}) {1e3 * r['library_ms']:.1f} us, copy of the "
              f"same bytes {1e3 * r['copy_ms']:.1f} us; cold: kernel "
              f"{1e3 * r['cold_ms']:.1f} us "
              f"({r['bound'][0] / r['cold_ms']:.0%} of the bound); device "
              f"(profiler) {fmt_device(dev * 10, 10)}", flush=True)
    for act in sorted({a for _, a in shapes}, key=lambda a: a.name):
        k6_total(f"{label}'s {act.name} form",
                 [r for r in rows if r["act"] == act])
    return rows


def k6_total(what, rows):
    """Prints K6's times over `rows`, one request's convs of a form."""
    launches = sum(r["n"] for r in rows)
    tot = {key: sum(r["n"] * (r[key][0] if key == "bound" else r[key])
                    for r in rows)
           for key in ("ms", "cold_ms", "plain_ms", "library_ms", "copy_ms",
                       "bound")}
    dev = [r["dev_ms"] for r in rows]
    dev_s = ("not measured" if None in dev else
             f"{sum(r['n'] * d for r, d in zip(rows, dev)):.4f} ms")
    print(f"K6 per bf16 {what} ({launches} launches a request, batch "
          f"{K6_BATCH}): warm {tot['ms']:.4f} ms, cold {tot['cold_ms']:.4f} "
          f"ms, device {dev_s} (profiler), bound {tot['bound']:.4f} ms "
          f"({tot['bound'] / tot['cold_ms']:.0%} of it cold); plain ops "
          f"{tot['plain_ms']:.2f} ms; library (F.batch_norm, then the "
          f"activation) {tot['library_ms']:.4f} ms warm; a copy of the "
          f"same bytes (Tensor.copy_) {tot['copy_ms']:.4f} ms warm",
          flush=True)


def check_k6():
    """Phase 3f: K6 against bn_act_ref on the card, bit for bit, at full
    YOLOv3 416's, YOLOv4 608's and YOLOv7 640's BN conv shapes at batch
    64 (k6_rows; each net's forms timed and printed, YOLOv7's SWISH form
    too) and at the edges, in bf16 and fp32, folded and unfolded, with
    every activation K6 fuses. Returns the timed rows (YOLOv3's LRELU
    form, YOLOv4's MISH form); the serving phases count the launches on
    the paths."""
    gen = torch.Generator().manual_seed(SEED)
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    rows = {label: k6_rows(label, build(), checked, spread, gen, flush)
            for label, build, checked, spread in K6_NETS}
    del flush
    for i, shape in enumerate(K6_EDGES):
        vecs = k6_vectors(shape[1], gen)
        x = torch.randn(*shape, generator=gen).cuda()
        special = torch.tensor([float("nan"), -0.0, float("inf"),
                                -float("inf"), 1e-40])  # an fp32 subnormal
        x.view(-1)[:5] = special[:x.numel()].cuda()
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            off = torch.empty(xd.numel() + 1, dtype=dtype,
                              device="cuda")[1:].view(shape)
            off.copy_(xd)  # one value off a 16-byte boundary
            n, c, h, w = shape
            cl = xd.contiguous(memory_format=torch.channels_last)
            off_cl = torch.empty(xd.numel() + 1, dtype=dtype, device="cuda")[
                1:].view(n, h, w, c).permute(0, 3, 1, 2)
            off_cl.copy_(xd)  # channels-last, off a 16-byte boundary
            for xs, what in ((xd, "edge"), (off, "edge, misaligned x"),
                             (cl, "edge, channels-last"),
                             (off_cl, "edge, channels-last, misaligned")):
                for folded in (False, True):
                    for act in K6_ACTS:
                        k6_equal(xs, vecs, folded, act, what)
    vecs = k6_vectors(K6_BIG[1], gen)
    x = torch.randn(K6_BIG, device="cuda", dtype=torch.bfloat16)
    for act in (Activation.LRELU, Activation.MISH, Activation.SWISH):
        k6_equal(x, vecs, False, act, "past 2^31 values")
    del x
    vecs = k6_vectors(K6_BIG_CL[1], gen)
    x = torch.empty(K6_BIG_CL, device="cuda", dtype=torch.bfloat16,
                    memory_format=torch.channels_last).normal_()
    for act in (Activation.LRELU, Activation.MISH, Activation.SWISH):
        k6_equal(x, vecs, False, act, "channels-last, past 2^31 values")
    del x
    print(f"K6 edges {K6_EDGES} (NaN, -0, inf, subnormal; aligned and "
          f"not; NCHW and channels-last) and {K6_BIG} (two launches), "
          f"{K6_BIG_CL} channels-last (two launches): bit-equal in every "
          "form", flush=True)
    return (rows["full YOLOv3 416"],
            [r for r in rows["YOLOv4 608"] if r["act"] == Activation.MISH])


def int8_classifier_phase(name, net, p_np, s_np):
    """Phase 11: `net` (PREDICT, batch I8_BATCH, 224 px, 1000 classes) on
    He-scaled seeded weights, PTQ by ptq_synthetic on the CPU (one quant
    dict for card and CPU), served through predict_on_batch: a warm-up
    request and one after it with the launch counts set to 0 before them,
    K4 on every conv and the FC, K5 on every depthwise layer; then two
    images card against CPU: every int8 tensor equal, the logits within
    the effect of the FC input codes that differ (at most one an
    image). Returns (K4, K5) launches."""
    t_phase = time.perf_counter()
    cpu = Session(net, SEED, device="cpu")
    cpu.params, cpu.state = bridge.params_from_numpy(net, p_np, s_np)
    cpu.compile_net()
    quant_cpu = ptq_synthetic(net, cpu)
    quant_gpu = dict(quant_cpu, weights={
        k: {kk: vv.cuda() for kk, vv in e.items()}
        for k, e in quant_cpu["weights"].items()})
    sess = Session(net, SEED, device="cuda")
    sess.params = {k: v.cuda() for k, v in cpu.params.items()}
    sess.state = {k: v.cuda() for k, v in cpu.state.items()}
    sess.compile_net()
    net.quant = quant_gpu
    n_dw = sum(n.type.name == "DEPTHWISE_CONV2D" for n in net.nodes)
    n_k4 = sum(n.type.name in ("CONV2D", "FULL_CONNECTED") for n in net.nodes)
    x = np.random.RandomState(SEED + 21).rand(
        I8_BATCH, 3, 224, 224).astype(np.float32)
    zero_counts()
    outs, _ = serve(
        lambda v: sess.predict_on_batch(v, outputs=MB_OUTPUTS)[0], [x, x])
    got = counts()
    want = none_but(K4=n_k4 * len(outs), K5=n_dw * len(outs))
    if got != want:
        raise RuntimeError(f"int8 {name}: launches {got}, wanted {want}")
    for o in outs:
        for t in o:
            if tuple(t.shape) != (I8_BATCH, 1000, 1, 1) or not bool(
                    torch.isfinite(t).all()):
                raise RuntimeError(f"int8 {name}: bad output {t.shape}")

    x2 = x[:2]
    with torch.inference_mode():
        g_ex = execute(net, sess.params, sess.state,
                       {"input": torch.from_numpy(x2).cuda()}, Mode.PREDICT)
        net.quant = quant_cpu
        c_ex = execute(net, cpu.params, cpu.state,
                       {"input": torch.from_numpy(x2)}, Mode.PREDICT)
    net.quant = None
    n_int8 = 0
    for i, v in c_ex.values.items():
        if v.dtype != torch.int8:
            continue
        n_int8 += 1
        g = g_ex.values[i]
        if not g.is_contiguous(memory_format=torch.channels_last):
            raise RuntimeError(f"int8 {name}: {net.tensors[i].name} is not "
                               "channels-last on the card")
        if not torch.equal(g.cpu(), v):
            raise RuntimeError(f"int8 {name}: {net.tensors[i].name} differs "
                               "between card and CPU")
    fc = next(n for n in net.nodes if n.type.name == "FULL_CONNECTED")
    s_x = quant_cpu["act_scales"][fc.src[0]]
    codes = [quantize_tensor(e.values[fc.src[0]].cpu().float(), s_x)
             for e in (g_ex, c_ex)]
    apart = (codes[0] != codes[1]).flatten(1).sum(1)
    wfc = quant_cpu["weights"][net.tensors[fc.src[1]].key]
    one = s_x * float((wfc["q"].float().flatten(1).abs()
                       * wfc["scale"][:, None]).max())
    fc_g = g_ex.values[fc.dst[0]].cpu().flatten(1)
    fc_c = c_ex.values[fc.dst[0]].cpu().flatten(1)
    err = (fc_g - fc_c).abs().amax(1)
    lim = apart.float() * one + 1e-5 * float(fc_c.abs().max())
    if int(apart.max()) > 1 or bool((err > lim).any()):
        raise RuntimeError(f"int8 {name}: logits card vs CPU {err.tolist()}"
                           f", FC input codes apart {apart.tolist()}, one "
                           f"code moves a logit by up to {one:.3g}")
    print(f"int8 {name} card vs CPU, two images, one quant dict: all "
          f"{n_int8} int8 tensors (channels-last) bit-equal; FC input codes "
          f"that differ {apart.tolist()}; logits max_abs_err "
          f"{err.tolist()} (one code's effect {one:.3g}); top-1 card "
          f"{fc_g.argmax(1).tolist()}, CPU {fc_c.argmax(1).tolist()}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return got["K4"], got["K5"]


def qat_phase(gpu):
    """Phase 12: YOLOv3-tiny QAT training at 416 px, batch 32, rotation
    10 (three K2 launches a step; K4 and K5 none), a warm-up and
    TRAIN_STEPS timed steps; one batch-2 step card vs CPU, each held to a
    float64 replay of its own choices (fake-quant codes included); then
    Session.freeze_qat and the frozen net served at int8 on both
    detection branches at batch BATCH, a warm-up request and one after it
    each (13 K4 launches a request, K1 two on decode-everything), every
    int8 tensor equal card vs CPU. Returns (K1, K2, K4) launches."""
    t_phase = time.perf_counter()
    sess = train_session(TRAIN_BATCH, "cuda")
    sess.net.qat = True
    sess.state = {k: v.cuda() for k, v in bn_stats(sess.net).items()}
    sess.compile_net()
    if len([k for k in sess.state if k.startswith("qat_amax/")]) != 15:
        raise RuntimeError("QAT: YOLOv3-tiny should watch 15 tensors")
    rng = np.random.RandomState(SEED + 31)
    x = rng.randint(0, 256, (TRAIN_BATCH, 3, SIZE, SIZE)).astype(np.uint8)
    lab = det_labels(rng, TRAIN_BATCH)
    med, k2 = timed_steps(
        f"QAT train_on_batch (net.qat, fake quant on 13 convs), batch "
        f"{TRAIN_BATCH}, {SIZE} px, augment {AUGMENT}", sess, x, lab,
        TRAIN_STEPS, gpu, 3 * TRAIN_STEPS)
    ranges = {k: float(v) for k, v in sess.state.items()
              if k.startswith("qat_amax/")}
    if not all(np.isfinite(v) and v > 0 for v in ranges.values()):
        raise RuntimeError(f"QAT ranges {ranges}")
    print(f"QAT: {len(ranges)} ranges after {TRAIN_STEPS + 3} steps, "
          f"{min(ranges.values()):.3g} to {max(ranges.values()):.3g}")

    small = yolov3_tiny(2, SIZE, SIZE, CLASSES, mode=Mode.TRAIN)
    small.qat = True
    p_np, s_np = bridge.he_numpy_weights(small, SEED)
    x2 = (rng.rand(2, 3, SIZE, SIZE) * 2 - 1).astype(np.float32)
    replayed_step("YOLOv3-tiny QAT fp32 step at batch 2, 416 px", small,
                  p_np, s_np, x2, det_labels(rng, 2))

    quant = sess.freeze_qat()
    serve_net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES)
    if sorted(quant["act_scales"]) != sorted(
            tq.watch_tensors(serve_net)):
        raise RuntimeError("QAT: the serving net watches other tensors")
    card = Session(serve_net, SEED, device="cuda")
    card.params = dict(sess.params)
    card.state = {k: v for k, v in sess.state.items()
                  if not k.startswith("qat_amax/")}
    card.compile_net()
    del sess
    xs = np.random.RandomState(SEED + 32).rand(BATCH, 3, SIZE, SIZE).astype(
        np.float32)
    serve_net.quant = quant
    launches = {}
    for topk_first in (True, False):
        zero_counts()
        outs, _ = serve(
            lambda v: card.detect_on_batch(v, topk_first=topk_first),
            [xs, xs])
        got = counts()
        want = none_but(K1=0 if topk_first else 2 * len(outs),
                        K4=13 * len(outs))
        if got != want:
            raise RuntimeError(f"frozen QAT detect: launches {got}, wanted "
                               f"{want}")
        for o in outs:
            check_detections(o, BATCH)
        launches[topk_first] = got
    cpu = Session(serve_net, SEED, device="cpu")
    cpu.params = {k: v.cpu() for k, v in card.params.items()}
    cpu.state = {k: v.cpu() for k, v in card.state.items()}
    cpu.compile_net()
    quant_cpu = dict(quant, weights={
        k: {kk: vv.cpu() for kk, vv in e.items()}
        for k, e in quant["weights"].items()})
    with torch.inference_mode():
        g_ex = execute(serve_net, card.params, card.state,
                       {"input": torch.from_numpy(xs[:2]).cuda()},
                       Mode.PREDICT)
        serve_net.quant = quant_cpu
        c_ex = execute(serve_net, cpu.params, cpu.state,
                       {"input": torch.from_numpy(xs[:2])}, Mode.PREDICT)
    serve_net.quant = None
    n_int8 = 0
    for i, v in c_ex.values.items():
        if v.dtype == torch.int8:
            n_int8 += 1
            if not torch.equal(g_ex.values[i].cpu(), v):
                raise RuntimeError(f"frozen QAT: {serve_net.tensors[i].name}"
                                   " differs between card and CPU")
    if n_int8 < 10:
        raise RuntimeError(f"frozen QAT: only {n_int8} int8 tensors")
    print(f"frozen QAT int8 card vs CPU, two images, one quant dict: all "
          f"{n_int8} int8 tensors bit-equal; phase 12 "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return (launches[False]["K1"], k2,
            launches[True]["K4"] + launches[False]["K4"])


# ------------------------------------------------------------------------
# phase 13: deploy and resume (torch.export artifacts, checkpoints)
# ------------------------------------------------------------------------

# each exported program serves P13_REQUESTS requests after a warm-up, and
# its live counterpart as many, in turns; an fp32 export that is not
# bit-equal to live is held within P13_RTOL (counted entries apart)
P13_REQUESTS, P13_RTOL = 20, 1e-5
# the checkpoint phase: YOLOv3-tiny at 416, batch 32, rotation 10: steps
# before the checkpoint, and the steps replayed after it
P13_STEPS = 3
# the op's dispatch against a direct call of its launcher: host time of
# one K4 call, each call timed alone, in turns, median of P13_HOST_CALLS
P13_HOST_CALLS = 200


def exported_check(label, served, live, x, want_counts, gpu, t_export,
                   t_load, exact_only):
    """Serve x through the loaded program (`served`) and the live path
    (`live`): a warm-up and P13_REQUESTS requests each, in turns, with
    the launch counts set to 0 before the program's: its counts a call
    must be `want_counts`. Its outputs bit-equal to live (`exact_only`),
    or else the count of entries apart printed and each within
    P13_RTOL. Prints the latencies; returns the counts and the outputs
    of the last request."""
    zero_counts()
    outs, lat_exp = serve(served, [x] * (1 + P13_REQUESTS))
    got = counts()
    calls = len(lat_exp)
    want = {k: want_counts.get(k, 0) * calls for k in got}
    if got != want:
        raise RuntimeError(f"{label}: exported program launched {got}, "
                           f"wanted {want} in {calls} calls")
    live_outs, lat_live = serve(live, [x] * (1 + P13_REQUESTS))
    apart = 0
    for g, w in zip(outs[-1], live_outs[-1]):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise RuntimeError(f"{label}: exported {g.shape} {g.dtype}, "
                               f"live {w.shape} {w.dtype}")
        if torch.equal(g, w):
            continue
        if exact_only:
            raise RuntimeError(f"{label}: exported output is not bit-equal "
                               "to live")
        apart += int((g != w).sum())
        torch.testing.assert_close(g, w, rtol=P13_RTOL, atol=0)
    if any(not all(torch.equal(a, b) for a, b in zip(o, outs[-1]))
           for o in outs[1:]):
        raise RuntimeError(f"{label}: the exported program's requests "
                           "differ from one another")
    e, l_ = lat_exp[1:], lat_live[1:]
    print(f"{label} on {gpu}: export {t_export:.2f} s, load {t_load:.2f} s;"
          f" {P13_REQUESTS} requests after a warm-up: exported median "
          f"{statistics.median(e):.2f} ms, min {min(e):.2f} ms; live median "
          f"{statistics.median(l_):.2f} ms, min {min(l_):.2f} ms; launches "
          f"a call {want_counts}; "
          + ("bit-equal to live" if not apart else
             f"{apart} entries apart from live, within rtol {P13_RTOL}"),
          flush=True)
    return got, outs[-1]


def export_and_load(sess, path, **kw):
    """sess.export_serving to `path`, then deploy.load_exported of the
    file: (the loaded call, export seconds, load seconds)."""
    from bcnn_tpu_torch import deploy

    t0 = time.perf_counter()
    sess.export_serving(path, **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    served = deploy.load_exported(path)
    t2 = time.perf_counter()
    if served.platforms != (sess.device.type,):
        raise RuntimeError(f"artifact platforms {served.platforms}")
    return served, t1 - t0, t2 - t1


def cpu_twin(net, params, state, quant=None, bf16=False):
    """A CPU session of `net` (the card's graph at batch 2) on copies of
    the card's weights, with `quant` (the CPU quant dict) where given and
    bf16 compute and activations with `bf16`."""
    net.quant = quant
    if bf16:
        net.compute_dtype = net.act_dtype = torch.bfloat16
    cpu = Session(net, SEED, device="cpu")
    cpu.params = {k: v.cpu() for k, v in params.items()}
    cpu.state = {k: v.cpu() for k, v in state.items()}
    return cpu.compile_net()


def int8_sessions(net, params, state):
    """ptq_synthetic on the CPU (one quant dict for both devices, as phase
    6b and 11 make it), then the card's session on the CPU's weights with
    the quant weights moved over: (card session, CPU quant dict)."""
    cpu = Session(net, SEED, device="cpu")
    cpu.params = {k: v.cpu() for k, v in params.items()}
    cpu.state = {k: v.cpu() for k, v in state.items()}
    cpu.compile_net()
    quant_cpu = ptq_synthetic(net, cpu)
    sess = Session(net, SEED, device="cuda")
    sess.params = {k: v.cuda() for k, v in cpu.params.items()}
    sess.state = {k: v.cuda() for k, v in cpu.state.items()}
    sess.compile_net()
    net.quant = dict(quant_cpu, weights={
        k: {kk: vv.cuda() for kk, vv in e.items()}
        for k, e in quant_cpu["weights"].items()})
    return sess, quant_cpu


def served_on_cpu(cpu, path, x, **kw):
    """The CPU export of the twin session, served on x (two images)."""
    from bcnn_tpu_torch import deploy

    cpu.export_serving(path, **kw)
    return deploy.load_exported(path)(torch.from_numpy(x))


def fresh_process_check(path, x, want, tmp):
    """A new Python process that imports only bcnn_tpu_torch.deploy loads
    the artifact and serves x on the card; its outputs must equal
    `want`."""
    xin, out = os.path.join(tmp, "x.npy"), os.path.join(tmp, "out.pt")
    np.save(xin, x)
    code = (
        "import sys, numpy as np, torch\n"
        "from bcnn_tpu_torch import deploy\n"
        "call = deploy.load_exported(sys.argv[1])\n"
        "y = call(torch.from_numpy(np.load(sys.argv[2])).cuda())\n"
        "torch.cuda.synchronize()\n"
        "torch.save([t.cpu() for t in y], sys.argv[3])\n")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code, path, xin, out],
                         capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    if res.returncode != 0:
        raise RuntimeError(f"fresh process failed:\n{res.stderr[-3000:]}")
    got = torch.load(out)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError("the fresh process's outputs differ")
    print(f"a fresh process (imports bcnn_tpu_torch.deploy only) loaded "
          f"{os.path.basename(path)} and served it on the card, bit-equal, "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)


def op_host_cost(gpu):
    """Host time of one K4 call (the 13x13 conv of YOLOv3-tiny 416 at batch
    8, int8 out) through the public wrapper, through the op
    (`torch.ops.bcnn_tpu_torch.conv_int8`) and through its launcher
    called directly (`conv_int8_cuda`), each call timed alone on the host
    clock, in turns, median and min of P13_HOST_CALLS."""
    from bcnn_tpu_torch.ops import conv_int8 as k4

    gen = torch.Generator().manual_seed(SEED + 31)
    x = torch.randint(-127, 128, (BATCH, 256, 13, 13), generator=gen,
                      dtype=torch.int8).cuda().contiguous(
                          memory_format=torch.channels_last)
    w = channels_last_weight(torch.randint(
        -127, 128, (512, 256, 3, 3), generator=gen, dtype=torch.int8)).cuda()
    d = torch.full((512,), 1e-4).cuda()
    b = torch.zeros(512).cuda()
    args = (x, w, d, b, 1, 1, int(Activation.LRELU), None, None, None, 0.05)
    op = torch.ops.bcnn_tpu_torch.conv_int8.default
    fns = {
        "wrapper": lambda: conv_int8_fused(x, w, d, b, 1, 1,
                                           Activation.LRELU, s_out=0.05),
        "op": lambda: op(*args),
        "launcher": lambda: k4.conv_int8_cuda(*args),
    }
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for i in range(P13_HOST_CALLS):
        for k in (fns if i % 2 == 0 else reversed(list(fns))):
            t0 = time.perf_counter()
            fns[k]()
            times[k].append(1e6 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    out = {k: (statistics.median(v), min(v)) for k, v in times.items()}
    print(f"host time of one K4 call on {gpu}, median / min of "
          f"{P13_HOST_CALLS} (us): "
          + ", ".join(f"{k} {m:.1f} / {lo:.1f}" for k, (m, lo) in out.items())
          + f"; the op's dispatch adds {out['op'][0] - out['launcher'][0]:.1f}"
          " us a call", flush=True)
    return out


def resume_phase(gpu, tmp):
    """YOLOv3-tiny TRAIN at 416, batch 32, rotation 10 (K2), cuDNN's
    deterministic algorithms: P13_STEPS steps, save_checkpoint, P13_STEPS
    more; a fresh Session loads the checkpoint, takes the
    session generator's state at the save (the augmentation's draws) and
    the same steps: params, state, optimizer state and seen bit-equal.
    Returns K2's launches."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sess = train_session(TRAIN_BATCH, "cuda")
        sess.state = {k: v.cuda() for k, v in bn_stats(sess.net).items()}
        rng = np.random.RandomState(SEED + 33)
        batches = [(rng.randint(0, 256, (TRAIN_BATCH, 3, SIZE, SIZE)).astype(
            np.uint8), det_labels(rng, TRAIN_BATCH))
            for _ in range(2 * P13_STEPS)]
        zero_counts()
        for x, lab in batches[:P13_STEPS]:
            sess.train_on_batch(x, lab)
        path = os.path.join(tmp, "tiny_ckpt.npz")
        t0 = time.perf_counter()
        sess.save_checkpoint(path)
        t1 = time.perf_counter()
        rng_state = sess._rng.get_state()
        for x, lab in batches[P13_STEPS:]:
            sess.train_on_batch(x, lab)
        fresh = train_session(TRAIN_BATCH, "cuda")
        t2 = time.perf_counter()
        fresh.load_checkpoint(path)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        fresh._rng.set_state(rng_state)
        for x, lab in batches[P13_STEPS:]:
            fresh.train_on_batch(x, lab)
        torch.cuda.synchronize()
        k2 = library.launches("row_shift")
    finally:
        torch.backends.cudnn.deterministic = det
    if k2 != 3 * 3 * P13_STEPS:
        raise RuntimeError(f"K2 launched {k2} times in {3 * P13_STEPS} "
                           "steps")
    for name, a, b in (("params", sess.params, fresh.params),
                       ("state", sess.state, fresh.state),
                       ("velocity", sess.opt_state["velocity"],
                        fresh.opt_state["velocity"])):
        if set(a) != set(b) or not all(torch.equal(a[k], b[k]) for k in a):
            raise RuntimeError(f"resumed training: {name} differ")
    if sess.opt_state["seen"] != fresh.opt_state["seen"] or \
            fresh._step_count != 2 * P13_STEPS:
        raise RuntimeError("resumed training: seen or the step count differ")
    print(f"checkpoint and resume, YOLOv3-tiny {SIZE} px, batch "
          f"{TRAIN_BATCH}, rotation 10, cudnn.deterministic, on {gpu}: "
          f"save {t1 - t0:.2f} s ({os.path.getsize(path) / 1e6:.1f} MB), "
          f"load {t3 - t2:.2f} s; after {P13_STEPS} more steps the resumed "
          f"session's params, running stats, velocity and seen "
          f"({fresh.opt_state['seen']}) are bit-equal to the uninterrupted "
          f"one's", flush=True)
    return k2


def profile_phase(gpu):
    """profiling.profile_forward and memory_report on YOLOv3-tiny 416 at
    batch 8 (fp32) on the card."""
    from bcnn_tpu_torch import profiling

    net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES)
    sess = Session(net, SEED, device="cuda")
    sess.state = bn_stats(net)
    sess.compile_net()
    x = np.random.RandomState(SEED + 35).rand(BATCH, 3, SIZE, SIZE).astype(
        np.float32)
    timings = profiling.profile_forward(sess, x, runs=3)
    if len(timings) != len(net.nodes):
        raise RuntimeError("profile_forward missed nodes")
    total = sum(t for _, _, t in timings)
    print(f"profile_forward YOLOv3-tiny {SIZE} px, batch {BATCH}, fp32, on "
          f"{gpu}: {total:.2f} ms over {len(timings)} nodes (best of 3, "
          "synchronized a node); top 5:")
    for typ, name, ms in sorted(timings, key=lambda t: -t[2])[:5]:
        print(f"    {ms:8.3f} ms  {typ} {name}")
    xt = torch.from_numpy(x).cuda()
    with torch.inference_mode():
        rep = profiling.memory_report(
            lambda v: sess.detect_on_batch(v), xt)
    print(f"memory_report detect_on_batch: peak {rep['peak_bytes'] / 2**20:.1f}"
          f" MiB, arguments {rep['argument_size_in_bytes'] / 2**20:.1f} MiB, "
          f"outputs {rep['output_size_in_bytes'] / 2**10:.1f} KiB, "
          f"{rep['flops'] / 1e9:.2f} GFLOP", flush=True)
    if not rep["flops"] > 0:
        raise RuntimeError(f"memory_report counted {rep['flops']} flops")


def deploy_phase(gpu):
    """Phase 13: YOLOv3-tiny (416, batch 8) and MobileNet-v1 (224, batch 64)
    exported at fp32 and int8 through Session.export_serving, loaded
    from the .pt2 file and served against the live path and a CPU export
    (batch 2); a fresh process loads the int8 YOLOv3-tiny file; the CLI
    exports yolov3-tiny.cfg with --detect over a seeded .weights; a
    checkpoint resumes training bit for bit; profile_forward and
    memory_report; the op's host cost. Returns the launches of K2-K6."""
    t_phase = time.perf_counter()
    launched = dict.fromkeys(K_OPS, 0)
    with tempfile.TemporaryDirectory() as tmp:
        # YOLOv3-tiny fp32: the detect program (K6 on each BN conv)
        net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES)
        sess = Session(net, SEED, device="cuda")
        sess.state = bn_stats(net)
        sess.compile_net()
        x = np.random.RandomState(SEED + 41).rand(
            BATCH, 3, SIZE, SIZE).astype(np.float32)
        served, te, tl = export_and_load(
            sess, os.path.join(tmp, "tiny.pt2"), detect=True)
        got, out = exported_check(
            f"exported YOLOv3-tiny detect fp32, batch {BATCH}, {SIZE} px",
            served, lambda v: sess.detect_on_batch(v), x,
            {"K6": k6_convs(net)}, gpu, te, tl, exact_only=False)
        launched["K6"] += got["K6"]
        check_detections(out, BATCH)
        cpu = cpu_twin(yolov3_tiny(2, SIZE, SIZE, CLASSES), sess.params,
                       sess.state)
        same_detections(tuple(o[:2] for o in out), served_on_cpu(
            cpu, os.path.join(tmp, "tiny_cpu.pt2"), x[:2], detect=True))
        print(f"    its detections agree with a CPU export's "
              f"({int((out[2][:2] > 0).sum())} kept in two images)")

        # YOLOv3-tiny int8 (phase 6b's net): 13 K4 launches a call
        net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES)
        net.compute_dtype = net.act_dtype = torch.bfloat16
        sess8, quant_cpu = int8_sessions(net, sess.params, bn_stats(net))
        path8 = os.path.join(tmp, "tiny_int8.pt2")
        served, te, tl = export_and_load(sess8, path8, detect=True)
        got, out8 = exported_check(
            f"exported YOLOv3-tiny detect int8, batch {BATCH}, {SIZE} px",
            served, lambda v: sess8.detect_on_batch(v), x, {"K4": 13}, gpu,
            te, tl, exact_only=True)
        launched["K4"] += got["K4"]
        check_detections(out8, BATCH)
        c8 = served_on_cpu(
            cpu_twin(yolov3_tiny(2, SIZE, SIZE, CLASSES), sess8.params,
                     sess8.state, quant_cpu, bf16=True),
            os.path.join(tmp, "tiny_int8_cpu.pt2"), x[:2], detect=True)
        if not torch.equal(out8[2][:2] > 0, c8[2] > 0):
            raise RuntimeError("int8 export: card and CPU keep other slots")
        for g, c in zip(out8, c8):
            torch.testing.assert_close(g[:2].float(), c.float(),
                                       rtol=2.0**-7, atol=1e-6)
        print(f"    its detections agree with a CPU export's "
              f"({int((c8[2] > 0).sum())} kept in two images)")
        fresh_process_check(path8, x, out8, tmp)

        # MobileNet-v1 fp32 (K3 x 13, K6 on each BN conv) and int8
        # (K5 x 13, K4 x 15)
        net = mobilenet_v1(MB_BATCH, MB_CLASSES)
        p_np, s_np = bridge.he_numpy_weights(net, SEED)
        sess = Session(net, SEED, device="cuda")
        sess.params, sess.state = bridge.params_from_numpy(
            net, p_np, s_np, device="cuda")
        sess.compile_net()
        xm = np.random.RandomState(SEED + 43).rand(
            MB_BATCH, 3, MB_SIZE, MB_SIZE).astype(np.float32)
        served, te, tl = export_and_load(
            sess, os.path.join(tmp, "mb.pt2"), outputs=MB_OUTPUTS)
        got, outm = exported_check(
            f"exported MobileNet-v1 forward fp32, batch {MB_BATCH}, "
            f"{MB_SIZE} px", served,
            lambda v: sess.predict_on_batch(v, outputs=MB_OUTPUTS)[0], xm,
            {"K3": 13, "K6": k6_convs(net)}, gpu, te, tl, exact_only=False)
        launched["K3"] += got["K3"]
        launched["K6"] += got["K6"]
        cm = served_on_cpu(
            cpu_twin(mobilenet_v1(2, MB_CLASSES), sess.params, sess.state),
            os.path.join(tmp, "mb_cpu.pt2"), xm[:2],
            outputs=MB_OUTPUTS)
        for g, c in zip(outm, cm):
            torch.testing.assert_close(g[:2], c, rtol=HEAD_RTOL,
                                       atol=HEAD_ATOL)
        print(f"    fc and softmax of two images within rtol {HEAD_RTOL} of "
              "a CPU export's")

        net = mobilenet_v1(MB_BATCH, MB_CLASSES)
        sess8, quant_cpu = int8_sessions(net, sess.params, sess.state)
        n_k4 = sum(n.type.name in ("CONV2D", "FULL_CONNECTED")
                   for n in net.nodes)
        served, te, tl = export_and_load(
            sess8, os.path.join(tmp, "mb_int8.pt2"), outputs=MB_OUTPUTS)
        got, outm8 = exported_check(
            f"exported MobileNet-v1 forward int8, batch {MB_BATCH}, "
            f"{MB_SIZE} px", served,
            lambda v: sess8.predict_on_batch(v, outputs=MB_OUTPUTS)[0], xm,
            {"K4": n_k4, "K5": 13}, gpu, te, tl, exact_only=True)
        launched["K4"] += got["K4"]
        launched["K5"] += got["K5"]
        cm8 = served_on_cpu(
            cpu_twin(mobilenet_v1(2, MB_CLASSES), sess8.params, sess8.state,
                     quant_cpu), os.path.join(tmp, "mb_int8_cpu.pt2"),
            xm[:2], outputs=MB_OUTPUTS)
        fc = next(n for n in net.nodes if n.type.name == "FULL_CONNECTED")
        wfc = quant_cpu["weights"][net.tensors[fc.src[1]].key]
        one = quant_cpu["act_scales"][fc.src[0]] * float(
            (wfc["q"].float().flatten(1).abs()
             * wfc["scale"][:, None]).max())
        err = float((outm8[0][:2] - cm8[0]).abs().max())
        if not err <= one + 1e-5 * float(cm8[0].abs().max()):
            raise RuntimeError(f"int8 MobileNet export: logits card vs CPU "
                               f"export {err:.3g}, one FC code {one:.3g}")
        print(f"    logits of two images within one FC input code's effect "
              f"({err:.3g} <= {one:.3g}) of a CPU export's")

        # bcnn-cl export of the cfg over a seeded .weights, with --detect
        from bcnn_tpu_torch import cli, config, deploy
        from bcnn_tpu_torch.graph import Net

        cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "examples", "yolo", "yolov3-tiny.cfg")
        ref = yolov3_tiny(1, 416, 416, 80)  # the cfg's net: batch 1
        weights = os.path.join(tmp, "tiny.weights")
        save_weights_darknet(ref, *bridge.params_from_numpy(
            ref, *bridge.he_numpy_weights(ref, SEED)), weights)
        out_cli = os.path.join(tmp, "cli_tiny.pt2")
        t0 = time.perf_counter()
        if cli.main(["export", cfg, weights, "--detect", "--out", out_cli],
                    device="cuda") != 0:
            raise RuntimeError("bcnn-cl export failed")
        t_cli = time.perf_counter() - t0
        live = Session(config.load_net(Net(Mode.PREDICT), cfg, weights),
                       SEED, device="cuda").compile_net()
        served = deploy.load_exported(out_cli)
        t0 = ref.tensors[0]
        x1 = np.random.RandomState(SEED + 45).rand(
            t0.n, t0.c, t0.h, t0.w).astype(np.float32)
        zero_counts()
        got_cli = served(torch.from_numpy(x1).cuda())
        want_cli = live.detect_on_batch(x1)
        if not all(torch.equal(g, w) for g, w in zip(got_cli, want_cli)):
            raise RuntimeError("the CLI's artifact differs from the live "
                               "session of the cfg and weights")
        got = counts()  # the artifact's call and the live one's
        if got != none_but(K6=2 * k6_convs(live.net)):
            raise RuntimeError(f"the CLI's artifact and its live session "
                               f"launched {got}")
        launched["K6"] += got["K6"]
        print(f"bcnn-cl export {os.path.basename(cfg)} --detect over a "
              f"seeded .weights: {t_cli:.2f} s "
              f"({os.path.getsize(out_cli) / 1e6:.1f} MB); served on the "
              "card, bit-equal to the live session of the cfg", flush=True)

        launched["K2"] += resume_phase(gpu, tmp)
    profile_phase(gpu)
    op_host_cost(gpu)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


# ------------------------------------------------------------------------
# phase 14: data parallel on torch.distributed (bcnn_tpu_torch.parallel)
# ------------------------------------------------------------------------

# (a) one rank under NCCL runs every DP form at full width: YOLOv3-tiny
# 416 at batch P14_BATCH (the DP step, ZeRO-1, FSDP, Session(mesh=, zero=3)
# fed by BatchPipeline(sharding=), the DP scan of P14_K steps, and the
# replicated and sharded resident scans over P14_RECORDS raw records
# with AUGMENT's rotation 10: K2), and MobileNet-v1's DP forward (224,
# batch MB_BATCH) fp32 (K3, K6) and int8 (K4 + K5). Each form is held to
# the single-device path on the same inputs and seeds: a forward bit for bit;
# a training form by a replay, the single-device run taking the DP run's
# own kink sides and max-pool picks (`bcnn_tpu_torch.replay.impose`) so
# that only rounding parts them (BN's global sums are taken as sum / n,
# torch.mean's otherwise), each update within BN_UPDATE_TOL of its
# largest entry (phase 9's bound for batch-32 steps of these seeded
# weights, whose gradients cancel) and the losses within STEP_LOSS_RTOL,
# under cuDNN's deterministic algorithms. (b) Two gloo ranks share the
# card (NCCL refuses two ranks on one GPU; gloo runs broadcast and
# all_reduce on CUDA tensors), P14_BATCH / 2 rows each: the DP step and
# the replicated resident scan, held the same way to one rank's run of
# the global batch, and to each other bit for bit.
P14_BATCH, P14_K, P14_RECORDS, P14_RANKS = 32, 2, 64, 2
# the rank device and (a)'s backend (a rehearsal on the CPU sets "cpu"
# and "gloo"); the gloo ranks take the settings below from (a)
P14_DEV, P14_BACKEND = "cuda:0", "nccl"
P14_SETTINGS = ("SIZE", "CLASSES", "MB_BATCH", "MB_SIZE", "P14_BATCH",
                "P14_K", "P14_RECORDS", "P14_DEV")


def on_card() -> bool:
    return torch.device(P14_DEV).type == "cuda"


def p14_sync():
    if on_card():
        torch.cuda.synchronize()


def p14_reset_peak():
    if on_card():
        torch.cuda.reset_peak_memory_stats()


def p14_peak() -> float:
    return torch.cuda.max_memory_allocated() / 2**30 if on_card() else 0.0


def compact(choices):
    """A Choices' kink sides packed 8 to a byte and its picks as uint8
    (a window holds at most size^2 <= 16 inputs), for another process."""
    return {"kinks": [(tuple(k.shape), np.packbits(k.numpy().ravel()))
                      for k in choices.kinks],
            "picks": [p.to(torch.uint8).numpy() for p in choices.picks]}


def expand(parts):
    """replay.Choices of the ranks' compacted choices, each rank's stripe
    in rank order (the global batch's)."""
    def kinks(i):
        return torch.cat([torch.from_numpy(np.unpackbits(
            bits, count=int(np.prod(shape))).reshape(shape).astype(bool))
            for shape, bits in (p["kinks"][i] for p in parts)])

    return replay.Choices(
        kinks=[kinks(i) for i in range(len(parts[0]["kinks"]))],
        picks=[torch.cat([torch.from_numpy(p["picks"][i]).long()
                          for p in parts])
               for i in range(len(parts[0]["picks"]))])


def recorded(fn):
    choices = replay.Choices()
    with replay.record(choices):
        out = fn()
    return out, choices


def p14_net(batch, augment=False):
    net = yolov3_tiny(batch, SIZE, SIZE, CLASSES, mode=Mode.TRAIN)
    if augment:
        net.device_augment = AUGMENT
    return net


def p14_start(net, device):
    """Phase 7's start: the session's seeded weights, seeded BN stats,
    a fresh optimizer state; CPU copies to hand on."""
    from bcnn_tpu_torch.compile import init_params

    params, _ = init_params(net, SEED)
    state = bn_stats(net)
    return ({k: v.to(device) for k, v in params.items()},
            {k: v.to(device) for k, v in state.items()},
            init_opt_state(net, {k: v.to(device) for k, v in params.items()}))


def p14_inputs():
    rng = np.random.RandomState(SEED + 41)
    x = (rng.rand(P14_BATCH, 3, SIZE, SIZE) * 2 - 1).astype(np.float32)
    lab = det_labels(rng, P14_BATCH)
    xs = (rng.rand(P14_K, P14_BATCH, 3, SIZE, SIZE) * 2 - 1).astype(
        np.float32)
    ys = np.stack([det_labels(rng, P14_BATCH) for _ in range(P14_K)])
    data = rng.randint(0, 256, (P14_RECORDS, 3, SIZE, SIZE)).astype(np.uint8)
    dlab = det_labels(rng, P14_RECORDS)
    idx = rng.randint(0, P14_RECORDS, (P14_K, P14_BATCH)).astype(np.int64)
    return dict(x=x, lab=lab, xs=xs, ys=ys, data=data, dlab=dlab, idx=idx)


def floats(a):
    if torch.is_tensor(a):
        return a.detach().float().cpu().reshape(-1).tolist()
    return np.asarray(a, np.float64).reshape(-1).tolist()


def held(label, p0, got, ref, loss, ref_loss):
    """Each trainable update of `got` (dict of tensors) within
    BN_UPDATE_TOL of its largest entry of `ref`'s; the losses within
    STEP_LOSS_RTOL. Returns the worst share."""
    worst = (0.0, "")
    for k in ref:
        du, dr = got[k].cpu() - p0[k].cpu(), ref[k].cpu() - p0[k].cpu()
        scale = float(dr.abs().max())
        if scale == 0:
            if float(du.abs().max()):
                raise RuntimeError(f"{label}: {k} moved where the "
                                   "single-device step left it")
            continue
        worst = max(worst, (float((du - dr).abs().max()) / scale, k))
    loss, ref_loss = np.asarray(floats(loss)), np.asarray(floats(ref_loss))
    if worst[0] > BN_UPDATE_TOL or not np.allclose(
            loss, ref_loss, rtol=STEP_LOSS_RTOL, atol=0):
        raise RuntimeError(f"{label}: update {worst[0]:.3g} of its largest "
                           f"entry from the single-device one ({worst[1]}; "
                           f"limit {BN_UPDATE_TOL}), losses {loss} vs "
                           f"{ref_loss}")
    return worst


def single_device(net, p0, s0, fn, choices):
    """fn(params, state, opt) on clones of the start, under `choices`
    imposed: the single-device run the DP run is held to."""
    params = {k: v.clone() for k, v in p0.items()}
    state = {k: v.clone() for k, v in s0.items()}
    with replay.impose(choices):
        return fn(params, state, init_opt_state(net, params))


def p14_gloo_rank(rank, tmp, out):
    """(b): one of P14_RANKS gloo ranks on cuda:0, its rows of the global
    batch: the DP step, then the replicated resident scan with rotation;
    writes its params, losses, compacted choices, step time, K2 launches
    and peak memory to `out`."""
    import datetime

    from bcnn_tpu_torch.parallel import (make_dp_train_scan_resident,
                                         make_dp_train_step, multihost,
                                         replicate, shard_batch)

    inp = torch.load(os.path.join(tmp, "p14_inputs.pt"), weights_only=False)
    globals().update(inp["settings"])
    multihost.initialize(f"file://{tmp}/gloo_store", P14_RANKS, rank,
                         backend="gloo",
                         timeout=datetime.timedelta(seconds=120))
    torch.backends.cudnn.deterministic = True
    if on_card():
        kernels.library()
    mesh = multihost.global_mesh(device=P14_DEV)
    res = {}
    for form in ("step", "resident"):
        net = p14_net(P14_BATCH, augment=form == "resident")
        p, s, o = replicate(mesh, p14_start(net, "cpu"))
        if form == "step":
            step = make_dp_train_step(net, mesh)
            batch = shard_batch(mesh, {"input": inp["x"], "label": inp["lab"]})
            run = lambda: step(p, s, o, batch)  # noqa: E731
        else:
            scan = make_dp_train_scan_resident(net, mesh)
            ds = {"input": torch.from_numpy(inp["data"]).to(mesh.device),
                  "label": torch.from_numpy(inp["dlab"]).to(mesh.device)}
            idx = shard_batch(mesh, torch.from_numpy(inp["idx"]), axis=1)
            gen = torch.Generator().manual_seed(SEED + 42)
            run = lambda: scan(p, s, o, ds, idx, gen)  # noqa: E731
        p14_reset_peak()
        zero_counts()
        t0 = time.perf_counter()
        (params, _, _, loss), choices = recorded(run)
        p14_sync()
        res[form] = dict(
            ms=1e3 * (time.perf_counter() - t0), launches=counts(),
            peak=p14_peak(), loss=floats(loss),
            params={k: v.cpu() for k, v in params.items()},
            choices=compact(choices))
    # the step's time without recording: two warm calls, then the median
    # of three, the ranks in step with each other
    net = p14_net(P14_BATCH)
    step = make_dp_train_step(net, mesh)
    batch = shard_batch(mesh, {"input": inp["x"], "label": inp["lab"]})
    times = []
    for i in range(5):
        p, s, o = replicate(mesh, p14_start(net, "cpu"))
        mesh.barrier()
        p14_sync()
        t0 = time.perf_counter()
        float(step(p, s, o, batch)[3])
        if i >= 2:
            times.append(1e3 * (time.perf_counter() - t0))
    res["step_ms"] = statistics.median(times)
    torch.save(res, out)
    torch.distributed.destroy_process_group()


def p14_gloo_main(rank, tmp):
    try:
        p14_gloo_rank(rank, tmp, os.path.join(tmp, f"p14_rank{rank}.pt"))
    except BaseException:
        import traceback

        with open(os.path.join(tmp, f"p14_error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def parallel_phase(gpu):
    """Phase 14 (see the constants above). Returns the launches of K2-K5
    on its paths (the gloo ranks' included)."""
    import torch.distributed as dist

    from bcnn_tpu_torch.compile import make_train_scan_resident
    from bcnn_tpu_torch.data.pipeline import BatchPipeline
    from bcnn_tpu_torch.data.records import ShardedEpochIndexStream
    from bcnn_tpu_torch.parallel import (make_dp_forward, make_dp_train_scan,
                                         make_dp_train_scan_resident,
                                         make_dp_train_scan_resident_sharded,
                                         make_dp_train_step,
                                         make_fsdp_train_step, make_mesh,
                                         make_zero1_train_step, replicate,
                                         shard_batch, shard_resident_dataset,
                                         shard_zero_state)

    t_phase = time.perf_counter()
    launched = dict.fromkeys(K_OPS, 0)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp()
    try:
        dist.init_process_group(P14_BACKEND,
                                init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        mesh = make_mesh(device=P14_DEV)
        inp = p14_inputs()
        inp["settings"] = {k: globals()[k] for k in P14_SETTINGS}
        torch.save(inp, os.path.join(tmp, "p14_inputs.pt"))
        d = lambda a: torch.from_numpy(a).to(P14_DEV)  # noqa: E731
        worst, peaks, results = {}, {}, {}

        # -- the DP step, ZeRO-1 and FSDP against the single-device step --
        net = p14_net(P14_BATCH)
        p0, s0, _ = p14_start(net, P14_DEV)
        batch = {"input": d(inp["x"]), "label": d(inp["lab"])}
        ref_step = make_train_step(net)
        for form, make, zero in (("DP step", make_dp_train_step, 0),
                                 ("ZeRO-1 step", make_zero1_train_step, 1),
                                 ("FSDP step", make_fsdp_train_step, 3)):
            step = make(net, mesh)
            start = (p0, s0, init_opt_state(net, p0))
            p, s, o = (shard_zero_state(net, mesh, *start,
                                        params_too=zero == 3)
                       if zero else replicate(mesh, start))
            p14_reset_peak()
            zero_counts()
            (p, s, o, loss), ch = recorded(lambda: step(
                p, s, o, shard_batch(mesh, batch)))
            if any(counts().values()):
                raise RuntimeError(f"{form} launched {counts()}")
            peaks[form] = p14_peak()
            if zero:
                from bcnn_tpu_torch.parallel import gather_zero_state

                p, s, o = gather_zero_state(net, mesh, p, s, o)
            rp, _, _, rl = single_device(net, p0, s0, lambda *a: ref_step(
                *a, batch), ch)
            worst[form] = held(form, p0, p, rp, loss, rl)
            results[form] = (p, loss)

        # the step's cost at world size 1: DP step against the single-device
        # step, in turns, each from the start (no recording)
        t_dp, t_one = [], []
        step = make_dp_train_step(net, mesh)
        stripe = shard_batch(mesh, batch)
        for i in range(5):
            for times, fn in ((t_dp, lambda a: step(*a, stripe)),
                              (t_one, lambda a: ref_step(*a, batch))):
                start = replicate(mesh, (p0, s0, init_opt_state(net, p0)))
                p14_sync()
                t0 = time.perf_counter()
                float(fn(start)[3])
                if i >= 2:
                    times.append(1e3 * (time.perf_counter() - t0))

        # -- the DP scan over staged batches --------------------------------
        scan = make_dp_train_scan(net, mesh)
        xs = shard_batch(mesh, {"input": inp["xs"], "label": inp["ys"]},
                         axis=1)
        zero_counts()
        (p, _, _, losses), ch = recorded(lambda: scan(
            *replicate(mesh, (p0, s0, init_opt_state(net, p0))),
            xs["input"], xs["label"], torch.Generator().manual_seed(SEED)))
        rp, _, _, rl = single_device(net, p0, s0, lambda *a: make_train_scan(
            net)(*a, {"input": d(inp["xs"]), "label": d(inp["ys"])},
                 torch.Generator().manual_seed(SEED)), ch)
        worst["DP scan"] = held("DP scan", p0, p, rp, losses, rl)

        # -- the resident scans with rotation (K2) --------------------------
        anet = p14_net(P14_BATCH, augment=True)
        ds = {"input": d(inp["data"]), "label": d(inp["dlab"])}
        local = ShardedEpochIndexStream(P14_RECORDS, P14_BATCH, 1,
                                        seed=SEED).next(P14_K)
        for form in ("resident scan", "sharded resident scan"):
            if form == "resident scan":
                scan = make_dp_train_scan_resident(anet, mesh)
                dsm = replicate(mesh, ds)
                idx = shard_batch(mesh, torch.from_numpy(inp["idx"]), axis=1)
                gidx = d(inp["idx"])
            else:
                scan = make_dp_train_scan_resident_sharded(anet, mesh)
                dsm = shard_resident_dataset(mesh, ds)
                idx = shard_batch(mesh, torch.from_numpy(local).long(),
                                  axis=1)
                gidx = d(local[:, 0].astype(np.int64))
            p14_reset_peak()
            zero_counts()
            (p, _, _, losses), ch = recorded(lambda: scan(
                *replicate(mesh, (p0, s0, init_opt_state(anet, p0))), dsm,
                idx, torch.Generator().manual_seed(SEED + 42)))
            got = counts()
            peaks[form] = p14_peak()
            if got != none_but(K2=3 * P14_K * on_card()):
                raise RuntimeError(f"{form}: launches {got}")
            launched["K2"] += got["K2"]
            rp, _, _, rl = single_device(
                anet, p0, s0, lambda *a: make_train_scan_resident(anet)(
                    *a, ds, gidx, torch.Generator().manual_seed(SEED + 42)),
                ch)
            worst[form] = held(form, p0, p, rp, losses, rl)
            results[form] = (p, losses)

        # -- Session(mesh=, zero=3) fed by BatchPipeline(sharding=) --------
        class Feed:
            def next_batch(self):
                return inp["x"], inp["lab"]

        pipe = BatchPipeline(Feed(), depth=1, sharding=mesh).start()
        try:
            xb, yb = next(iter(pipe))
        finally:
            pipe.stop()
        sess = Session(net, SEED, mesh=mesh, zero=3)
        sess.params = {k: v.clone() for k, v in p0.items()}
        sess.state = {k: v.clone() for k, v in s0.items()}
        sess.compile_net()
        (loss,), ch = recorded(lambda: (sess.train_on_batch(xb, yb),))
        rp, _, _, rl = single_device(net, p0, s0, lambda *a: ref_step(
            *a, batch), ch)
        worst["Session(mesh, zero=3)"] = held(
            "Session(mesh, zero=3)", p0, sess._full_params(), rp, loss, rl)
        path = os.path.join(tmp, "p14.npz")
        sess.save_checkpoint(path)
        back = Session(p14_net(P14_BATCH), SEED, mesh=mesh, zero=1)
        back.compile_net().load_checkpoint(path)
        one = Session(p14_net(P14_BATCH), SEED, device=P14_DEV).compile_net()
        one.load_checkpoint(path)
        full = sess._full_params()
        for label, table in (("ZeRO-1", back.params), ("one device",
                                                       one.params)):
            if not all(torch.equal(table[k], full[k]) for k in full):
                raise RuntimeError(f"the FSDP checkpoint resumed on "
                                   f"{label} differs")

        # -- the DP forward of MobileNet-v1, fp32 (K3, K6), int8 (K4 + K5) -
        mnet = mobilenet_v1(MB_BATCH, 1000)
        if MB_SIZE != 224:  # a rehearsal's
            mnet.resize(MB_SIZE, MB_SIZE)
        mp, ms = bridge.params_from_numpy(
            mnet, *bridge.he_numpy_weights(mnet, SEED), P14_DEV)
        msess = Session(mnet, SEED, device=P14_DEV)
        msess.params, msess.state = mp, ms
        msess.compile_net()
        mx = np.random.RandomState(SEED + 43).rand(
            MB_BATCH, 3, MB_SIZE, MB_SIZE).astype(np.float32)
        fwd = make_dp_forward(mnet, mesh, MB_OUTPUTS, Mode.PREDICT)
        n_dw = sum(n.type.name == "DEPTHWISE_CONV2D" for n in mnet.nodes)
        n_k4 = sum(n.type.name in ("CONV2D", "FULL_CONNECTED")
                   for n in mnet.nodes)
        fwd_ms = {}
        for prec, want in (("fp32", dict(K3=n_dw, K6=k6_convs(mnet))),
                           ("int8", dict(K4=n_k4, K5=n_dw))):
            if prec == "int8":
                ptq_synthetic(mnet, msess)
            rp_, rs_ = replicate(mesh, (msess.params, msess.state))
            xb_ = shard_batch(mesh, {"input": mx})
            fwd(rp_, rs_, xb_)  # warm
            p14_sync()
            zero_counts()
            t0 = time.perf_counter()
            outs = fwd(rp_, rs_, xb_)
            p14_sync()
            fwd_ms[prec] = 1e3 * (time.perf_counter() - t0)
            got = {k: v for k, v in counts().items() if v}
            if not on_card():
                want = {}
            if got != want:
                raise RuntimeError(f"DP forward {prec}: launches {got}, "
                                   f"wanted {want}")
            for k, v in got.items():
                launched[k] += v
            ref, _ = msess.predict_on_batch(mx, outputs=MB_OUTPUTS)
            for o, r in zip(outs, ref):
                if not torch.equal(o, r):
                    raise RuntimeError(f"DP forward {prec}: not bit-equal "
                                       "to predict_on_batch")
        mnet.quant = None

        # -- (b): two gloo ranks on the card ---------------------------------
        if on_card():
            torch.cuda.empty_cache()  # the cached blocks, for the ranks
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=p14_gloo_main, args=(r, tmp))
                 for r in range(P14_RANKS)]
        t_b = time.perf_counter()
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(240)
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
        errs = [open(os.path.join(tmp, f"p14_error{r}.txt")).read()
                for r in range(P14_RANKS)
                if os.path.exists(os.path.join(tmp, f"p14_error{r}.txt"))]
        if errs or any(pr.exitcode for pr in procs):
            raise RuntimeError("gloo ranks failed: "
                               f"{[pr.exitcode for pr in procs]}\n"
                               + "\n".join(errs))
        t_b = time.perf_counter() - t_b
        ranks = [torch.load(os.path.join(tmp, f"p14_rank{r}.pt"),
                            weights_only=False) for r in range(P14_RANKS)]
        for form, ref_form, fn in (
                ("step", "DP step", lambda *a: ref_step(*a, batch)),
                ("resident", "resident scan",
                 lambda *a: make_train_scan_resident(anet)(
                     *a, ds, d(inp["idx"]),
                     torch.Generator().manual_seed(SEED + 42)))):
            for r in ranks[1:]:
                if not all(torch.equal(r[form]["params"][k],
                                       ranks[0][form]["params"][k])
                           for k in r[form]["params"]):
                    raise RuntimeError(f"gloo {form}: the ranks' params "
                                       "differ")
            fnet = anet if form == "resident" else net
            rp, _, _, rl = single_device(fnet, p0, s0, fn,
                                         expand([r[form]["choices"]
                                                 for r in ranks]))
            worst[f"2 gloo ranks, {form}"] = held(
                f"2 gloo ranks, {form}", p0, ranks[0][form]["params"], rp,
                ranks[0][form]["loss"], rl)
            # and against (a)'s one-rank run of the global batch
            a_p, a_l = results[ref_form]
            np.testing.assert_allclose(
                ranks[0][form]["loss"], [float(v) for v in
                                         torch.atleast_1d(a_l)],
                rtol=STEP_LOSS_RTOL)
        for r, res in enumerate(ranks):
            want = none_but()
            if res["step"]["launches"] != want:
                raise RuntimeError(f"gloo rank {r} step: "
                                   f"{res['step']['launches']}")
            want["K2"] = 3 * P14_K * on_card()
            if res["resident"]["launches"] != want:
                raise RuntimeError(f"gloo rank {r} resident scan: "
                                   f"{res['resident']['launches']}")
            launched["K2"] += want["K2"]
    finally:
        torch.backends.cudnn.deterministic = det
        if dist.is_initialized():
            dist.destroy_process_group()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)

    print(f"data parallel (phase 14), YOLOv3-tiny {SIZE} px, batch "
          f"{P14_BATCH}, on {gpu}: one {P14_BACKEND} rank, each form "
          "against the single-device run of its own choices, the worst "
          "update share of its largest entry: " + "; ".join(
              f"{k} {v[0]:.3g} ({v[1]})" for k, v in worst.items())
          + f"; the DP step {statistics.median(t_dp):.2f} ms ("
          + ", ".join(f"{v:.2f}" for v in t_dp) + ") against the "
          f"single-device step {statistics.median(t_one):.2f} ms ("
          + ", ".join(f"{v:.2f}" for v in t_one) + "; the collectives "
          "at world size 1, median of 3 in turns, host clock); peak "
          "memory " + ", ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items())
          + f"; MobileNet-v1's DP forward, batch {MB_BATCH}, bit-equal to "
          f"predict_on_batch: fp32 {fwd_ms['fp32']:.2f} ms ({n_dw} K3, "
          f"{k6_convs(mnet)} K6), "
          f"int8 {fwd_ms['int8']:.2f} ms ({n_k4} K4 + {n_dw} K5); the FSDP "
          "checkpoint resumed bit for bit on ZeRO-1 and on one device. "
          f"{P14_RANKS} gloo ranks on the one card, {P14_BATCH // P14_RANKS}"
          " rows each: the DP step "
          + ", ".join(f"{r['step_ms']:.1f}" for r in ranks)
          + " ms a rank (no scaling figure: two processes share one card "
          "and gloo stages its all-reduces through the host), bit-identical"
          " params, K2 " + ", ".join(str(r["resident"]["launches"]["K2"])
                                     for r in ranks)
          + f" a rank in the {P14_K}-step resident scan, peak memory "
          + ", ".join(f"{max(r['step']['peak'], r['resident']['peak']):.2f}"
                      for r in ranks)
          + f" GiB a rank; the ranks took {t_b:.1f} s with start-up; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


# ------------------------------------------------------------------------
# phase 15: the example drivers (examples_torch/) on the card
# ------------------------------------------------------------------------

# Each driver's main(argv) in this process, at full width (YOLOv3-tiny 416
# with 80 classes, MobileNet-v1 224 with 1000), batch and step counts cut
# so that the phase stays within P15_SECONDS. Checks, where the run is
# deterministic: inference_benchmark --int8 --act16 (YOLOv3-tiny, the
# CPU's quant dict and calibrated state) against the CPU's on the first
# two images, every int8 and bf16 tensor equal as in phase 6b (the YOLO
# layers' fp32 sigmoid and exp part by ulps between card and host);
# serve_detection's first batch (fp32) as the CPU's
# (p15_same_detections); export_serving's artifact (fp32) and every int8
# serving_latency bucket's bit-equal to the live session. The bf16
# bucket's difference from live is printed, not held: at bf16 compute
# with fp32 activations (the JAX example's setting) the live conv sums
# the bf16-rounded values in TF32 (`ops/conv.py`), the exported graph
# keeps no cuDNN flag and sums them in fp32 (`deploy.py`), and NMS on
# the top-k passes such ulps on to other slots. The soak (P15_SOAK:
# stream feed, rotation 10, cuDNN deterministic) runs to the end here;
# the same run in a subprocess is killed through its --pidfile right
# after its checkpoint at dispatch P15_KILL_AT, and resumed here: the
# final checkpoints must be equal array for array. Every driver's
# numbers are printed on a line of their own with the launches it
# caused; K2, K3, K4, K5 and K6 must each launch in the phase.
P15_DEV, P15_SIZE, P15_MB_SIZE = "cuda", SIZE, MB_SIZE
P15_SERVE_BATCH, P15_MB_BATCH, P15_INT8_CPU_BATCH = BATCH, MB_BATCH, 2
P15_BUCKETS, P15_BF16_BUCKETS, P15_CALLS = "1,8,64", "8", 30
P15_SOAK = ["--batch", "32", "--scan", "5", "--steps", "200", "--images",
            "64", "--ckpt-every", "10", "--eval-every", "10", "--eval-map",
            "20", "--mem-every", "4", "--rotation", "10", "--deterministic"]
P15_KILL_AT = 20  # dispatches: step 100
P15_TRAIN_BATCH, P15_TRAIN_STEPS, P15_WORKERS = 32, 8, 2
P15_SECONDS = 180.0


def p15_run(label, fn, gpu, launched):
    """fn() with the launch counts set to 0 just before it; prints the
    counts it caused and adds them to `launched`. Returns fn()'s result
    and the seconds it took."""
    zero_counts()
    t0 = time.perf_counter()
    out = fn()
    if P15_DEV.startswith("cuda"):
        torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    got = counts()
    for k, v in got.items():
        launched[k] += v
    print(f"  {label} on {gpu}: {sec:.1f} s, launches {got}", flush=True)
    return out, sec


def p15_int8_equal(card, cpu):
    """inference_benchmark's int8 program on the card against the CPU's
    (each main()'s net and session), on its first P15_INT8_CPU_BATCH
    images: every int8 and bf16 tensor of the forward equal, as phase 6b
    holds them, and the YOLO layers' outputs (the host's and the card's
    fp32 sigmoid and exp of equal heads) within HEAD_RTOL. Returns how
    many tensors were equal."""
    t0 = cpu["net"].tensors[0]
    x = torch.from_numpy(np.random.RandomState(0).rand(
        P15_INT8_CPU_BATCH, t0.c, t0.h, t0.w).astype(np.float32))
    with torch.inference_mode():
        got = execute(card["net"], card["session"].params,
                      card["session"].state, {"input": x.to(P15_DEV)},
                      Mode.PREDICT)
        want = execute(cpu["net"], cpu["session"].params,
                       cpu["session"].state, {"input": x}, Mode.PREDICT)
    n = 0
    for i, v in want.values.items():
        if v.dtype in (torch.int8, torch.bfloat16):
            if not torch.equal(got.values[i].cpu(), v):
                raise RuntimeError(
                    f"inference_benchmark --int8: {cpu['net'].tensors[i].name}"
                    f" ({v.dtype}) differs between card and CPU")
            n += 1
    if n < 10:
        raise RuntimeError(f"only {n} int8 and bf16 tensors on the path")
    for g, c in zip(card["outputs"], cpu["outputs"]):
        torch.testing.assert_close(g[:P15_INT8_CPU_BATCH].cpu().float(),
                                   c.float(), rtol=HEAD_RTOL, atol=0)
    return n


def p15_same_detections(card, cpu):
    """detect_on_batch's outputs on the card and the CPU (fp32): the same
    slots kept, and each image's kept rows (box, scores, objectness) the
    same as sets within the fp32 head tolerance of phase 4 (HEAD_RTOL,
    HEAD_ATOL): rows whose objectness ties within it may swap slots."""
    (b1, s1, o1), (b2, s2, o2) = card, cpu
    alive = o2 > 0
    if not torch.equal(o1 > 0, alive) or not alive.any():
        raise RuntimeError("serve_detection: card and CPU keep other slots")
    for i in range(o2.shape[0]):
        r1 = torch.cat([b1[i], s1[i], o1[i, :, None]], 1)[alive[i]].double()
        r2 = torch.cat([b2[i], s2[i], o2[i, :, None]], 1)[alive[i]].double()
        tol = HEAD_ATOL + HEAD_RTOL * r2.abs()[None]
        close = ((r1[:, None] - r2[None]).abs() <= tol).all(-1)
        match = close.double().argmax(1)
        if not close.any(1).all() or match.unique().numel() != len(match):
            raise RuntimeError(f"serve_detection: image {i}: card and CPU "
                               "keep other boxes")


def p15_soak_killed(argv, pid_path, log_path, tmp):
    """The soak in a new process, SIGKILLed through its pidfile as soon as
    its log shows the checkpoint at dispatch P15_KILL_AT."""
    import signal

    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples_torch", "train_soak.py")
    with open(os.path.join(tmp, "killed.log"), "w") as log:
        proc = subprocess.Popen([sys.executable, script] + argv,
                                stdout=log, stderr=subprocess.STDOUT)
    t0 = time.perf_counter()
    try:
        while True:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"the soak to be killed ended first (rc "
                    f"{proc.returncode})")
            if os.path.exists(log_path):
                with open(log_path) as f:
                    evs = [json.loads(ln) for ln in f if ln.strip()]
                if any(e["ev"] == "ckpt" and e["i"] == P15_KILL_AT
                       for e in evs):
                    break
            if time.perf_counter() - t0 > 300:
                raise RuntimeError("the soak to be killed took too long")
            time.sleep(0.02)
        with open(pid_path) as f:
            os.kill(int(f.read()), signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    last = max(e["i"] for e in evs if "i" in e)
    print(f"  killed the soak's process (rc {proc.returncode}) after its "
          f"checkpoint at dispatch {P15_KILL_AT}; its log reached dispatch "
          f"{last}", flush=True)


def p15_flat_memory(log_path):
    """The soak's memory in use at each --mem-every point: after the
    held-out batches are staged (the eval batch at the first
    --eval-every point, the two mAP batches at the first --eval-map
    point, fp32 on the card, kept for the run), it must not rise by more
    than the prefetched uint8 batches' swing over the rest of the run."""
    arg = dict(zip(P15_SOAK[::2], P15_SOAK[1::2]))
    staged = max(int(arg["--eval-every"]), int(arg["--eval-map"]))
    batch = int(arg["--batch"])
    swing = 4 * batch * 3 * P15_SIZE * P15_SIZE
    with open(log_path) as f:
        mems = [(e["i"], e["bytes_in_use"]) for e in map(json.loads, f)
                if e["ev"] == "mem"]
    after = [v for i, v in mems if i > staged]
    if len(after) < 3 or max(after) > after[0] + swing:
        raise RuntimeError(f"the soak's memory grew: {mems}")
    print("  the soak's memory in use (MiB) at dispatches "
          + ", ".join(f"{i}: {v / 2**20:.1f}" for i, v in mems)
          + f"; flat after dispatch {staged} (the held-out batches "
          "staged by then)", flush=True)


def p15_ckpt(d):
    with np.load(os.path.join(d, "ckpt_latest.npz")) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__meta__").tobytes()).decode())
    return flat, meta["extra"]


def examples_phase(gpu):
    """Phase 15 (see P15_*); returns the launches of each kernel."""
    from examples_torch import (cifar10_example, export_serving,
                                inference_benchmark, mnist_example,
                                mnist_fast, serve_detection,
                                serving_latency, train_soak,
                                train_throughput, yolo_example)

    t_phase = time.perf_counter()
    launched = dict.fromkeys(K_OPS, 0)
    dev = ["--device", P15_DEV]
    cpu = ["--device", "cpu"]
    tmp = tempfile.mkdtemp(prefix="p15_")
    det = os.path.join(tmp, "det")
    try:
        # -- serving --------------------------------------------------------
        mb = mobilenet_v1(P15_MB_BATCH, MB_CLASSES)
        mb_w = bridge.he_numpy_weights(mb, SEED)
        ib = ["--model", "mobilenet-v1", "--batch", str(P15_MB_BATCH),
              "--size", str(P15_MB_SIZE), "--runs", "10"]
        for tag, extra in (("fp32", ["--fp32"]), ("bf16", []),
                           ("int8", ["--int8"])):
            res, _ = p15_run(
                f"inference_benchmark mobilenet-v1 {tag} batch "
                f"{P15_MB_BATCH}",
                lambda: inference_benchmark.main(ib + extra + dev,
                                                 weights=mb_w),
                gpu, launched)
            out = res["outputs"][0]
            if not torch.isfinite(out.float()).all():
                raise RuntimeError(f"inference_benchmark {tag}: non-finite")
            print(f"    min {res['min_ms']:.3f} ms, max {res['max_ms']:.3f}"
                  f" ms, avg {res['avg_ms']:.3f} ms, {res['img_s']:.1f} "
                  "img/s", flush=True)
        # YOLOv3-tiny's drivers take He-scaled weights from SEED (the
        # seeded XAVIER heads saturate, and their exp overflows)
        # int8 YOLOv3-tiny at bench.py's setting (bf16 activations between
        # layers, as phase 6b): the CPU's quant dict and calibrated state
        # on the card, the first two images' heads bit-equal to the CPU's
        tw = bridge.he_numpy_weights(yolov3_tiny(1, P15_SIZE, P15_SIZE), SEED)
        ibt = ["--model", "yolov3-tiny", "--size", str(P15_SIZE), "--int8",
               "--act16"]
        cpu_res = inference_benchmark.main(
            ibt + ["--batch", str(P15_INT8_CPU_BATCH), "--runs", "1"] + cpu,
            weights=tw)
        cpu_state = bridge.params_to_numpy(cpu_res["net"],
                                           cpu_res["session"].state)
        res, _ = p15_run(
            f"inference_benchmark yolov3-tiny int8 act16 batch "
            f"{P15_SERVE_BATCH}",
            lambda: inference_benchmark.main(
                ibt + ["--batch", str(P15_SERVE_BATCH), "--runs", "10"]
                + dev, weights=(tw[0], cpu_state),
                quant=cpu_res["net"].quant),
            gpu, launched)
        n_equal = p15_int8_equal(res, cpu_res)
        print(f"    min {res['min_ms']:.3f} ms, avg {res['avg_ms']:.3f} ms, "
              f"{res['img_s']:.1f} img/s; {n_equal} int8 and bf16 tensors "
              "bit-equal to the CPU's", flush=True)

        for mode, buckets in (("int8", P15_BUCKETS), ("bf16",
                                                      P15_BF16_BUCKETS)):
            rows, _ = p15_run(
                f"serving_latency --mode {mode} --buckets {buckets}",
                lambda: serving_latency.main(
                    ["--mode", mode, "--buckets", buckets, "--calls",
                     str(P15_CALLS), "--size", str(P15_SIZE), "--outdir",
                     os.path.join(tmp, "art")] + dev, weights=tw),
                gpu, launched)
            for r in rows:
                if mode == "int8" and not r["bit_equal_to_live"]:
                    raise RuntimeError(f"serving_latency: {r} differs from "
                                       "live")
                if not r["p50_ms"] > 0:
                    raise RuntimeError(f"serving_latency: {r}")
        res, _ = p15_run(
            f"export_serving --detect batch {P15_SERVE_BATCH}",
            lambda: export_serving.main(
                ["--detect", "--batch", str(P15_SERVE_BATCH), "--size",
                 str(P15_SIZE), "--out", os.path.join(tmp, "d.pt2")] + dev,
                weights=tw), gpu, launched)
        if not res["bit_equal"]:
            raise RuntimeError("export_serving: served differs from live")
        print(f"    {res['mb']:.1f} MB, export {res['export_s']:.2f} s, "
              f"load {res['load_s']:.2f} s, first call "
              f"{res['first_call_s']:.3f} s; bit-equal to live", flush=True)

        lst = serve_detection.synth_images(32, os.path.join(tmp, "serve"))
        sw = tw
        sd = [lst, "--size", str(P15_SIZE), "--fp32"]
        res, _ = p15_run(
            f"serve_detection fp32 batch {P15_SERVE_BATCH}",
            lambda: serve_detection.main(
                sd + ["--batch", str(P15_SERVE_BATCH), "--steps", "10"]
                + dev, weights=sw), gpu, launched)
        want = serve_detection.main(
            sd + ["--batch", str(P15_INT8_CPU_BATCH), "--steps", "1"] + cpu,
            weights=sw)["first"]
        p15_same_detections(
            tuple(t[:P15_INT8_CPU_BATCH] for t in res["first"]), want)
        print(f"    {res['img_s']:.1f} img/s over {res['images']} images, "
              f"{res['detections']} detections; the first batch's as the "
              "CPU's", flush=True)

        img_dir = os.path.join(tmp, "frames")
        os.makedirs(img_dir)
        rng = np.random.RandomState(SEED)
        from bcnn_tpu_torch import bip

        for i in range(3):
            bip.write_image(os.path.join(img_dir, f"f{i}.png"),
                            (rng.rand(480, 640, 3) * 255).astype(np.uint8))
        res, _ = p15_run(
            "yolo_example image",
            lambda: yolo_example.main(
                [os.path.join(img_dir, "f0.png"), "--out",
                 os.path.join(tmp, "f0_dets.png")] + dev, weights=sw),
            gpu, launched)
        print(f"    inference {res['inference_ms']:.2f} ms, "
              f"{len(res['detections'])} detections", flush=True)
        res, _ = p15_run(
            "yolo_example video (3 frames)",
            lambda: yolo_example.main(
                ["video", img_dir, "--out", os.path.join(tmp, "video")]
                + dev, weights=sw), gpu, launched)
        print(f"    {res['frames']} frames, {res['fps']:.2f} FPS",
              flush=True)

        # -- training -------------------------------------------------------
        res, _ = p15_run("mnist_example --iters 100", lambda:
                         mnist_example.main(["--iters", "100",
                                             "--eval-every", "50",
                                             "--num-pred", "256"] + dev),
                         gpu, launched)
        res, _ = p15_run("mnist_fast (30 chunks of 20 steps, batch 128)",
                         lambda: mnist_fast.main(dev), gpu, launched)
        print(f"    accuracy {res['accuracy']:.4f}, {res['train_s']:.2f} s, "
              f"{res['img_s']:.1f} img/s", flush=True)
        for variant in ([], ["resnet"]):
            res, _ = p15_run(
                f"cifar10_example {variant or 'convnet'} --iters 50",
                lambda: cifar10_example.main(
                    variant + ["--iters", "50", "--eval-every", "25"] + dev),
                gpu, launched)
        rows, _ = p15_run(
            f"train_throughput batch {P15_TRAIN_BATCH}",
            lambda: train_throughput.main(
                ["--batch", str(P15_TRAIN_BATCH), "--steps",
                 str(P15_TRAIN_STEPS), "--size", str(P15_SIZE), "--images",
                 "64", "--workers", str(P15_WORKERS), "--outdir", det]
                + dev), gpu, launched)

        # -- the soak: uninterrupted, killed, resumed -----------------------
        soak = P15_SOAK + ["--size", str(P15_SIZE), "--outdir", det] + dev
        whole, part = os.path.join(tmp, "whole"), os.path.join(tmp, "part")
        rep, _ = p15_run("train_soak, uninterrupted",
                         lambda: train_soak.main(soak + ["--dir", whole]),
                         gpu, launched)
        print("    report " + json.dumps(rep), flush=True)
        os.makedirs(part)
        t0 = time.perf_counter()
        p15_soak_killed(soak + ["--dir", part, "--pidfile",
                                os.path.join(part, "pid")],
                        os.path.join(part, "pid"),
                        os.path.join(part, "soak_log.jsonl"), tmp)
        print("  train_soak, the killed segment: "
              f"{time.perf_counter() - t0:.1f} s (a new process)", flush=True)
        rep2, _ = p15_run("train_soak --resume",
                          lambda: train_soak.main(soak + ["--dir", part,
                                                          "--resume"]),
                          gpu, launched)
        print("    report " + json.dumps(rep2), flush=True)
        want, want_extra = p15_ckpt(whole)
        got, got_extra = p15_ckpt(part)
        if set(got) != set(want) or any(not np.array_equal(got[k], want[k])
                                        for k in want):
            raise RuntimeError("the resumed soak's checkpoint differs from "
                               "the uninterrupted run's")
        if (got_extra["loader_pos"], got_extra["dispatch"]) != (
                want_extra["loader_pos"], want_extra["dispatch"]):
            raise RuntimeError("the resumed soak ends elsewhere")
        if rep2["segments"] != 2 or rep2["steps"] != rep["steps"]:
            raise RuntimeError(f"resumed report {rep2}")
        print("  the resumed soak's final params, state, optimizer state "
              "and loader position equal the uninterrupted run's",
              flush=True)
        if P15_DEV.startswith("cuda"):
            p15_flat_memory(os.path.join(whole, "soak_log.jsonl"))
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    for k in ("K2", "K3", "K4", "K5", "K6"):
        if not launched[k]:
            raise RuntimeError(f"phase 15 launched no {k}")
    sec = time.perf_counter() - t_phase
    print(f"phase 15 launches {launched}; {sec:.1f} s (limit "
          f"{P15_SECONDS:.0f} s)", flush=True)
    if sec > P15_SECONDS:
        raise RuntimeError(f"phase 15 took {sec:.1f} s")
    return launched


# ------------------------------------------------------------------------
# phase 16: the int8 study, short (16a); the model axis of `parallel` (16b)
# ------------------------------------------------------------------------

# 16a: examples_torch/train_soak.py at 416 px, batch 32, 50 steps (its
# record sets written in the phase: 64 training images and 32 held-out),
# then tools/int8_map_study_torch.py on its checkpoint at P16_STUDY; K4
# must launch in the study, and one int8 request of the study's absmax
# net is held to the CPU port's on P16_INT8_CPU_BATCH held-out images:
# every int8 tensor and both heads bit for bit.
P16_SOAK = ["--batch", "32", "--scan", "5", "--steps", "50", "--images",
            "64", "--eval-every", "0", "--ckpt-every", "0"]
P16_STUDY = ["--batch", "32", "--images", "64", "--qat-steps", "10",
             "--qat-batch", "16", "--calib-batches", "1", "--calib-chunk",
             "16"]
P16_INT8_CPU_BATCH = 2
# 16b: (a) one rank (NCCL) on a 1x1 mesh: the TP and SP steps of
# YOLOv3-tiny at 416, batch P16_BATCH, each held to the single-device
# step of its own choices (`held`, phase 14's bound), and the spatial
# forwards equal to one device's; (b) P16_RANKS gloo ranks on the one
# card (NCCL refuses two ranks on one GPU; the model axis's collectives
# are all_reduce and broadcast, which gloo runs on CUDA tensors), a 1x2
# mesh: the TP and SP steps, each held to a float64 replay of the ranks'
# own kink sides and max-pool picks (each rank's channel slice or band of
# rows of them, joined) within STEP_UPDATE_TOL of its largest entry,
# twice the CPU's own distance to a replay of its own, or one float32
# spacing (`replayed_step`'s rule); MobileNet-v1 (224 px, batch MB_BATCH)
# fp32 through the spatial forward within P16_FWD_RTOL of the one-device
# forward with 13 K3 launches and one K6 a BN conv on each band, int8
# MobileNet-v1 and int8 YOLOv3-tiny at 416 bit-equal to one device with
# K4 and K5 on each band and no K6.
P16_DEV, P16_BACKEND = "cuda:0", "nccl"
P16_BATCH, P16_RANKS = 8, 2
P16_FWD_RTOL, P16_FWD_ATOL = 1e-4, 1e-5
P16_SETTINGS = ("SIZE", "CLASSES", "MB_BATCH", "MB_SIZE", "MB_CLASSES",
                "P16_BATCH", "P16_DEV")


def p16_on_card() -> bool:
    return torch.device(P16_DEV).type == "cuda"


def p16_sync():
    if p16_on_card():
        torch.cuda.synchronize()


def p16_tool(rel):
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(rel))[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


def study_phase(gpu):
    """16a (see P16_SOAK). Returns the launches of each kernel in the
    study."""
    import shutil

    from bcnn_tpu_torch.checkpoint import load_checkpoint
    from examples_torch import train_soak

    study = p16_tool("tools/int8_map_study_torch.py")
    tmp = tempfile.mkdtemp(prefix="p16_")
    data, run = os.path.join(tmp, "data"), os.path.join(tmp, "run")
    dev = ["--device", P16_DEV]
    try:
        t0 = time.perf_counter()
        rep = train_soak.main(P16_SOAK + ["--size", str(SIZE), "--dir", run,
                                          "--outdir", data] + dev)
        t_soak = time.perf_counter() - t0
        ckpt = os.path.join(run, "ckpt_latest.npz")
        trace = {}
        zero_counts()
        t0 = time.perf_counter()
        out = study.main(["--ckpt", ckpt, "--outdir", data, "--size",
                          str(SIZE)] + P16_STUDY + dev, trace=trace)
        p16_sync()
        t_study = time.perf_counter() - t0
        launched = counts()
        keys = ("fp32", "ptq_absmax", "ptq_percentile", "ptq_kl", "qat_fp32",
                "qat_int8")
        if not launched["K4"] or any(
                not 0.0 <= out[k] <= 1.0 for k in keys):
            raise RuntimeError(f"the int8 study: {out}, launches {launched}")
        # one int8 request, card against the CPU port, on the study's
        # absmax quant dict and the soak's checkpoint
        quant = trace["ptq"]["absmax"]
        xe = torch.from_numpy((trace["eval"][0][:P16_INT8_CPU_BATCH].astype(
            np.float32) - 127.5) / 127.5)
        runs = {}
        for where in (P16_DEV, "cpu"):
            net = study.yolo_net(P16_INT8_CPU_BATCH, SIZE, Mode.PREDICT)
            net.quant = to_device(quant, where)
            params, state, _, _ = load_checkpoint(net, ckpt, where)
            with torch.inference_mode():
                runs[where] = (net, execute(net, params, state,
                                            {"input": xe.to(where)},
                                            Mode.PREDICT))
        net, want = runs["cpu"]
        got = runs[P16_DEV][1]
        heads = {n.src[0] for n in net.nodes if n.type.name == "YOLOV3"}
        n_int8 = 0
        for i, v in want.values.items():
            if v.dtype == torch.int8 or i in heads:
                n_int8 += v.dtype == torch.int8
                if not torch.equal(got.values[i].cpu(), v):
                    raise RuntimeError(
                        f"the study's int8 request: {net.tensors[i].name} "
                        f"({v.dtype}) differs between card and CPU")
        if n_int8 < 10:
            raise RuntimeError(f"only {n_int8} int8 tensors on the path")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"int8 study (phase 16a), YOLOv3-tiny {SIZE} px on {gpu}: the soak "
          f"{' '.join(P16_SOAK)}: {t_soak:.1f} s with its records, "
          f"{rep['img_s_whole_run']} img/s whole run, steady "
          f"{rep['img_s_steady']}; the study {' '.join(P16_STUDY)}: "
          + ", ".join(f"{k} {out[k]}" for k in keys)
          + f" (held-out mAP@0.5 of {out['eval_images']} images; "
          f"{rep['steps']} steps from the nets' fillers: not a trained "
          f"model), {t_study:.1f} s, "
          f"launches {launched}; one int8 request of {P16_INT8_CPU_BATCH} "
          f"images card vs CPU: {n_int8} int8 tensors and both heads "
          "bit-equal", flush=True)
    return launched


def p16_net():
    return yolov3_tiny(P16_BATCH, SIZE, SIZE, CLASSES, mode=Mode.TRAIN)


def p16_forward_nets():
    """(name, net, outputs, int8) of the spatial forwards: MobileNet-v1
    at MB_SIZE, fp32 and int8, and YOLOv3-tiny at SIZE, int8."""
    mb = mobilenet_v1(MB_BATCH, MB_CLASSES)
    tiny = yolov3_tiny(P16_BATCH, SIZE, SIZE, CLASSES)
    heads = [tiny.tensors[n.src[0]].name for n in tiny.nodes
             if n.type.name == "YOLOV3"]
    return [("MobileNet-v1 fp32", mb, MB_OUTPUTS, False),
            ("MobileNet-v1 int8", mobilenet_v1(MB_BATCH, MB_CLASSES),
             MB_OUTPUTS, True),
            ("YOLOv3-tiny int8", tiny, heads, True)]


def p16_inputs():
    """The phase's weights and data, on the CPU: YOLOv3-tiny's seeded
    start (phase 14's), a batch, and each forward's weights, input and
    (int8) quant dict, calibrated on the card."""
    rng = np.random.RandomState(SEED + 61)
    net = p16_net()
    p0, s0, _ = p14_start(net, "cpu")
    inp = {"p0": p0, "s0": s0,
           "x": (rng.rand(P16_BATCH, 3, SIZE, SIZE) * 2 - 1).astype(
               np.float32),
           "lab": det_labels(rng, P16_BATCH), "fwd": []}
    for name, fnet, outs, int8 in p16_forward_nets():
        p, s = bridge.params_from_numpy(
            fnet, *bridge.he_numpy_weights(fnet, SEED))
        t0 = fnet.tensors[0]
        x = rng.rand(fnet.batch_size, t0.c, t0.h, t0.w).astype(np.float32)
        quant = None
        if int8:
            sess = Session(fnet, SEED, device=P16_DEV)
            sess.params, sess.state = to_device(p, P16_DEV), to_device(
                s, P16_DEV)
            sess.compile_net()
            quant = to_device(ptq_synthetic(fnet, sess), "cpu")
            fnet.quant = None
        inp["fwd"].append(dict(name=name, p=p, s=s, x=x, quant=quant,
                               outputs=outs))
    return inp


def p16_steps(mesh, inp, timed=0):
    """The TP and SP steps of YOLOv3-tiny on `mesh` from inp's start:
    {form: (params (joined), loss, choices, launches, ms)}; with timed,
    the median of that many more steps, each from the start."""
    from bcnn_tpu_torch.parallel import (gather_train_state,
                                         make_dp_sp_train_step,
                                         make_dp_tp_train_step, replicate,
                                         shard_batch, shard_spatial,
                                         shard_train_state)

    net = p16_net()
    batch = {"input": inp["x"], "label": inp["lab"]}
    out = {}
    for form in ("TP", "SP"):
        if form == "TP":
            step = make_dp_tp_train_step(net, mesh)
            part = shard_batch(mesh.batch, batch)

            def start():
                return shard_train_state(net, mesh, inp["p0"], inp["s0"],
                                         init_opt_state(net, inp["p0"]))
        else:
            step = make_dp_sp_train_step(net, mesh)
            part = shard_spatial(net, mesh, batch)

            def start():
                return replicate(mesh.world, (inp["p0"], inp["s0"],
                                              init_opt_state(net,
                                                             inp["p0"])))
        p, s, o = start()
        zero_counts()
        (p, s, o, loss), ch = recorded(lambda: step(p, s, o, part))
        p16_sync()
        launched = counts()
        if form == "TP":
            p, s, o = gather_train_state(net, mesh, p, s, o)
        times = []
        for _ in range(timed):
            q, s2, o2 = start()
            mesh.world.barrier()
            p16_sync()
            t0 = time.perf_counter()
            float(step(q, s2, o2, part)[3])
            times.append(1e3 * (time.perf_counter() - t0))
        out[form] = dict(params={k: v.cpu() for k, v in p.items()},
                         loss=floats(loss), choices=ch, launches=launched,
                         ms=statistics.median(times) if times else None)
    return out


def p16_forwards(mesh, inp, timed=0):
    """Each spatial forward of inp["fwd"] on `mesh`'s model axis: {name:
    (outputs on the CPU, launches, ms)}."""
    from bcnn_tpu_torch.parallel import make_spatial_forward, replicate

    out = {}
    nets = {name: (fnet, int8) for name, fnet, _, int8 in p16_forward_nets()}
    for f in inp["fwd"]:
        net, _ = nets[f["name"]]
        if f["quant"] is not None:
            net.quant = to_device(f["quant"], mesh.device)
        params, state = replicate(mesh.world, (f["p"], f["s"]))
        fwd = make_spatial_forward(net, mesh, f["outputs"], axis="model")
        zero_counts()
        outs = fwd(params, state, f["x"])
        p16_sync()
        launched = counts()
        times = []
        for _ in range(timed):
            mesh.world.barrier()
            t0 = time.perf_counter()
            fwd(params, state, f["x"])
            p16_sync()
            times.append(1e3 * (time.perf_counter() - t0))
        out[f["name"]] = dict(outs=[o.cpu() for o in outs],
                              launches=launched,
                              ms=statistics.median(times) if times else None)
    return out


def p16_gloo_main(rank, tmp):
    """(b): one of P16_RANKS gloo ranks on the card."""
    import datetime

    try:
        from bcnn_tpu_torch.parallel import make_mesh_2d, multihost

        inp = torch.load(os.path.join(tmp, "p16_inputs.pt"),
                         weights_only=False)
        globals().update(inp["settings"])
        multihost.initialize(f"file://{tmp}/gloo_store", P16_RANKS, rank,
                             backend="gloo",
                             timeout=datetime.timedelta(seconds=120))
        torch.backends.cudnn.deterministic = True
        if p16_on_card():
            kernels.library()
        mesh = make_mesh_2d(dp=1, device=P16_DEV)
        res = p16_steps(mesh, inp, timed=3)
        for form in res.values():
            form["choices"] = compact(form["choices"])
        res["fwd"] = p16_forwards(mesh, inp, timed=3)
        torch.save(res, os.path.join(tmp, f"p16_rank{rank}.pt"))
        torch.distributed.destroy_process_group()
    except BaseException:
        import traceback

        with open(os.path.join(tmp, f"p16_error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def joined_choices(parts, full, dim):
    """replay.Choices of the model ranks' compacted choices (rank order):
    a call whose shape `dim` is cut (TP: channels, 1; SP: rows, 2) joined
    along it, a whole one taken from the first rank."""
    def unpack(p, i):
        shape, bits = p["kinks"][i]
        return torch.from_numpy(np.unpackbits(
            bits, count=int(np.prod(shape))).reshape(shape).astype(bool))

    def join(tensors, shape):
        t0 = tensors[0]
        if t0.dim() > dim and t0.shape[dim] < shape[dim]:
            return torch.cat(tensors, dim)
        return t0

    kinks = [join([unpack(p, i) for p in parts], full.kinks[i].shape)
             for i in range(len(full.kinks))]
    picks = [join([torch.from_numpy(p["picks"][i]).long() for p in parts],
                  full.picks[i].shape) for i in range(len(full.picks))]
    for a, b in zip(kinks + picks, full.kinks + full.picks):
        if a.shape != b.shape:
            raise RuntimeError(f"joined choices {tuple(a.shape)} against "
                               f"one device's {tuple(b.shape)}")
    return replay.Choices(kinks=kinks, picks=picks)


def held_to_replay(label, net, inp, params, choices, e_cpu, ref=None):
    """The update params - p0 against a float64 run of `choices` on the
    CPU (or `ref`, such a run's update made elsewhere): each tensor
    within STEP_UPDATE_TOL of its largest entry, twice the reference
    device's own distance e_cpu[k], or one float32 spacing. Returns the
    worst (error, key)."""
    if ref is None:
        batch = {"input": inp["x"], "label": inp["lab"]}
        ref, _ = replay.sgd_update(net, inp["p0"], inp["s0"], batch,
                                   torch.float64, "cpu",
                                   replay.impose(choices))
    worst = (0.0, "")
    for k, r in ref.items():
        du = params[k] - inp["p0"][k]
        scale = float(r.abs().max())
        err = float((du - r).abs().max()) / scale if scale else float(
            du.abs().max())
        floor = float(np.spacing(np.float32(inp["p0"][k].abs().max())))
        lim = max(STEP_UPDATE_TOL, 2 * e_cpu.get(k, 0.0),
                  floor / scale if scale else floor)
        if err > lim:
            raise RuntimeError(f"{label}: {k}'s update is {err:.3g} of its "
                               f"largest entry from the float64 replay of "
                               f"the ranks' choices (limit {lim:.3g})")
        worst = max(worst, (err, k))
    return worst


def model_axis_phase(gpu):
    """16b (see P16_DEV). Returns the launches of each kernel on its
    paths (the gloo ranks' included)."""
    import shutil

    import torch.distributed as dist

    from bcnn_tpu_torch.parallel import make_mesh_2d

    t_phase = time.perf_counter()
    launched = dict.fromkeys(K_OPS, 0)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="p16_")
    lines = []
    try:
        inp = p16_inputs()
        inp["settings"] = {k: globals()[k] for k in P16_SETTINGS}
        torch.save(inp, os.path.join(tmp, "p16_inputs.pt"))
        net = p16_net()
        batch = {"input": torch.from_numpy(inp["x"]).to(P16_DEV),
                 "label": torch.from_numpy(inp["lab"]).to(P16_DEV)}
        p0 = to_device(inp["p0"], P16_DEV)
        s0 = to_device(inp["s0"], P16_DEV)
        ref_step = make_train_step(net)

        # one device: the steps' full choices, times, the forwards
        (_, _, _, _), full = recorded(lambda: ref_step(
            {k: v.clone() for k, v in p0.items()}, dict(s0),
            init_opt_state(net, p0), batch))
        t_one = []
        for _ in range(3):
            q = {k: v.clone() for k, v in p0.items()}
            p16_sync()
            t0 = time.perf_counter()
            float(ref_step(q, dict(s0), init_opt_state(net, q), batch)[3])
            t_one.append(1e3 * (time.perf_counter() - t0))
        one_fwd = {}
        k6_want = {}  # a rank's K6 launches: every BN conv on its band
        for f, (name, fnet, outs, int8) in zip(inp["fwd"],
                                               p16_forward_nets()):
            k6_want[name] = 0 if int8 else k6_convs(fnet)
            fnet.quant = to_device(f["quant"], P16_DEV) if int8 else None
            p, s = to_device(f["p"], P16_DEV), to_device(f["s"], P16_DEV)
            x = torch.from_numpy(f["x"]).to(P16_DEV)

            def run():
                with torch.inference_mode():
                    ex = execute(fnet, p, s, {"input": x}, Mode.PREDICT)
                    return [output_value(ex, fnet.get_tensor_index_by_name(
                        o)) for o in outs]

            got = run()
            times = []
            for _ in range(3):
                p16_sync()
                t0 = time.perf_counter()
                run()
                p16_sync()
                times.append(1e3 * (time.perf_counter() - t0))
            one_fwd[name] = ([o.cpu() for o in got],
                             statistics.median(times))

        # -- (a): one NCCL rank, a 1x1 mesh -----------------------------------
        dist.init_process_group(P16_BACKEND, init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        mesh = make_mesh_2d(dp=1, device=P16_DEV)
        res = p16_steps(mesh, inp)
        worst_a = {}
        for form, r in res.items():
            if any(r["launches"].values()):
                raise RuntimeError(f"the {form} step launched {r['launches']}")
            rp, _, _, rl = single_device(net, p0, s0, lambda *a: ref_step(
                *a, batch), r["choices"])
            worst_a[form] = held(f"{form} step, 1x1 mesh", p0, r["params"],
                                 rp, r["loss"], rl)
        fwd_a = p16_forwards(mesh, inp)
        for name, r in fwd_a.items():
            if r["launches"]["K6"] != k6_want[name]:
                raise RuntimeError(f"{name} on a 1x1 mesh launched "
                                   f"{r['launches']}")
            for k, v in r["launches"].items():
                launched[k] += v
            for g, w in zip(r["outs"], one_fwd[name][0]):
                if "fp32" in name:
                    torch.testing.assert_close(g, w, rtol=P16_FWD_RTOL,
                                               atol=P16_FWD_ATOL)
                elif not torch.equal(g, w):
                    raise RuntimeError(f"{name} on a 1x1 mesh differs from "
                                       "one device")
        dist.destroy_process_group()
        lines.append(
            f"(a) one {P16_BACKEND} rank, a 1x1 mesh: the TP and SP steps "
            "against the single-device step of their own choices, worst "
            "update share " + ", ".join(f"{k} {v[0]:.3g} ({v[1]})"
                                        for k, v in worst_a.items())
            + "; the spatial forwards equal to one device's (" + ", ".join(
                f"{n} {r['launches']}" for n, r in fwd_a.items()) + ")")

        # -- (b): two gloo ranks on the card, a 1x2 mesh ----------------------
        if p16_on_card():
            torch.cuda.empty_cache()
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=p16_gloo_main, args=(r, tmp))
                 for r in range(P16_RANKS)]
        t_b = time.perf_counter()
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(300)
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
        errs = [open(os.path.join(tmp, f"p16_error{r}.txt")).read()
                for r in range(P16_RANKS)
                if os.path.exists(os.path.join(tmp, f"p16_error{r}.txt"))]
        if errs or any(pr.exitcode for pr in procs):
            raise RuntimeError("gloo ranks failed: "
                               f"{[pr.exitcode for pr in procs]}\n"
                               + "\n".join(errs))
        t_b = time.perf_counter() - t_b
        ranks = [torch.load(os.path.join(tmp, f"p16_rank{r}.pt"),
                            weights_only=False) for r in range(P16_RANKS)]

        # the CPU's own distance to a float64 replay of its own choices
        host = {"input": inp["x"], "label": inp["lab"]}
        ch_cpu = replay.Choices()
        upd_cpu, _ = replay.sgd_update(net, inp["p0"], inp["s0"], host,
                                       torch.float32, "cpu",
                                       replay.record(ch_cpu))
        ref_cpu, _ = replay.sgd_update(net, inp["p0"], inp["s0"], host,
                                       torch.float64, "cpu",
                                       replay.impose(ch_cpu))
        e_cpu = {k: float((upd_cpu[k] - r).abs().max()) / max(
            float(r.abs().max()), 1e-30) for k, r in ref_cpu.items()}
        worst_b = {}
        for form, dim in (("TP", 1), ("SP", 2)):
            for r, o in enumerate(ranks[1:], 1):
                for k, v in o[form]["params"].items():
                    if not torch.equal(v, ranks[0][form]["params"][k]):
                        raise RuntimeError(f"{form}: rank {r}'s {k} differs")
            choices = joined_choices([o[form]["choices"] for o in ranks],
                                     full, dim)
            worst_b[form] = held_to_replay(
                f"{form} step, 1x2 gloo mesh", net, inp,
                ranks[0][form]["params"], choices, e_cpu)
        for name, (want, ms_one) in one_fwd.items():
            for r, o in enumerate(ranks):
                got = o["fwd"][name]
                for k, v in got["launches"].items():
                    launched[k] += v
                if "fp32" in name and got["launches"]["K3"] != 13:
                    raise RuntimeError(f"{name}: rank {r} launched K3 "
                                       f"{got['launches']['K3']} times")
                if got["launches"]["K6"] != k6_want[name]:
                    raise RuntimeError(f"{name}: rank {r} launched K6 "
                                       f"{got['launches']['K6']} times")
                if "int8" in name and not got["launches"]["K4"]:
                    raise RuntimeError(f"{name}: rank {r} launched no K4")
                if "MobileNet-v1 int8" == name and not got["launches"]["K5"]:
                    raise RuntimeError(f"{name}: rank {r} launched no K5")
                for g, w in zip(got["outs"], want):
                    if "fp32" in name:
                        torch.testing.assert_close(g, w, rtol=P16_FWD_RTOL,
                                                   atol=P16_FWD_ATOL)
                    elif not torch.equal(g, w):
                        raise RuntimeError(f"{name}: rank {r}'s output "
                                           "differs from one device's")
        lines.append(
            f"(b) {P16_RANKS} gloo ranks on the one card, a 1x2 mesh: TP "
            "and SP steps against a float64 replay of the ranks' own "
            "choices, worst update share " + ", ".join(
                f"{k} {v[0]:.3g} ({v[1]})" for k, v in worst_b.items())
            + " (the CPU's own worst "
            + f"{max(e_cpu.values()):.3g}); ms a step: TP "
            + ", ".join(f"{o['TP']['ms']:.1f}" for o in ranks) + ", SP "
            + ", ".join(f"{o['SP']['ms']:.1f}" for o in ranks)
            + f" a rank against one device's {statistics.median(t_one):.1f};"
            " ms a spatial forward: " + "; ".join(
                f"{n} " + ", ".join(f"{o['fwd'][n]['ms']:.1f}"
                                    for o in ranks)
                + f" against {ms:.1f} ({ranks[0]['fwd'][n]['launches']} a "
                "rank)" for n, (_, ms) in one_fwd.items())
            + f"; the ranks took {t_b:.1f} s with start-up")
    finally:
        torch.backends.cudnn.deterministic = det
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"model axis (phase 16b), YOLOv3-tiny {SIZE} px batch {P16_BATCH}"
          f", MobileNet-v1 {MB_SIZE} px batch {MB_BATCH}, on {gpu}: "
          + "; ".join(lines) + f"; phase {time.perf_counter() - t_phase:.1f}"
          " s", flush=True)
    return launched


# ------------------------------------------------------------------------
# phase 17: pipeline stages (bcnn_tpu_torch.parallel.Pipeline)
# ------------------------------------------------------------------------

# (a) one NCCL rank holding every stage. MobileNet-v1 (224 px, batch
# MB_BATCH, PREDICT) on split_stages' 3 stages and P17_MICRO
# microbatches: fp32 within P17_FWD_RTOL of the one-device forward, int8
# (ptq_synthetic) bit-equal to it, K3 and K6 (fp32), K4 and K5 (int8)
# launched on every stage. YOLOv3-tiny (416 px, batch P17_BATCH, TRAIN) on
# split_stages(net, 2): one microbatch against make_train_step, and
# P17_MICRO under GPipe and 1F1B against make_train_step(accum_steps=
# P17_MICRO); each update held to a float64 replay on the card of the
# pipeline's own kink sides and max-pool picks (recorded in its
# forwards, which run without autograd; every recompute checked bit-equal
# to its forward, under cuDNN's deterministic algorithms): within
# STEP_UPDATE_TOL of its largest entry, twice the one-device step's own
# distance to a float64 replay of its choices, or one float32 spacing;
# 1F1B bit-equal to GPipe; each step's median time and peak memory. (b)
# P17_RANKS gloo ranks sharing the card, a stage each, P17_MICRO
# microbatches under 1F1B: the ranks' gathered parameters equal and held
# to the same rule; the step's time.
P17_DEV, P17_BACKEND = "cuda:0", "nccl"
P17_BATCH, P17_MICRO, P17_RANKS, P17_TIMED = 32, 4, 2, 3
P17_FWD_RTOL, P17_FWD_ATOL = 1e-4, 1e-5
P17_SETTINGS = ("SIZE", "CLASSES", "P17_BATCH", "P17_MICRO", "P17_TIMED",
                "P17_DEV")


def p17_on_card() -> bool:
    return torch.device(P17_DEV).type == "cuda"


def p17_sync():
    if p17_on_card():
        torch.cuda.synchronize()


def p17_peak(reset=False) -> float:
    """GiB of peak device memory since the last reset (0 off the card)."""
    if not p17_on_card():
        return 0.0
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated() / 2**30


def forward_choices(fn):
    """fn() under `replay.record` of the calls made without autograd: a
    pipeline's forwards, not its recomputes."""
    choices = replay.Choices()
    with replay.record(choices, when=lambda: not torch.is_grad_enabled()):
        out = fn()
    return out, choices


def p17_net():
    return yolov3_tiny(P17_BATCH, SIZE, SIZE, CLASSES, mode=Mode.TRAIN)


def p17_inputs():
    """YOLOv3-tiny's seeded start (phase 14's) and a batch, on the CPU."""
    rng = np.random.RandomState(SEED + 71)
    p0, s0, _ = p14_start(p17_net(), "cpu")
    return {"p0": p0, "s0": s0,
            "x": (rng.rand(P17_BATCH, 3, SIZE, SIZE) * 2 - 1).astype(
                np.float32),
            "lab": det_labels(rng, P17_BATCH)}


def p17_step(stages, n_micro, schedule, inp, timed=0):
    """One Pipeline step of YOLOv3-tiny over `stages` from inp's start:
    (gathered params on the CPU, loss, this rank's forward choices), and
    with timed the median ms and peak GiB of that many more steps, each
    from the start."""
    from bcnn_tpu_torch.parallel import Pipeline

    net = p17_net()
    pipe = Pipeline(net, stages, Mode.TRAIN, n_microbatches=n_micro,
                    schedule=schedule, device=P17_DEV)
    batch = {"input": torch.from_numpy(inp["x"]).to(P17_DEV),
             "label": torch.from_numpy(inp["lab"]).to(P17_DEV)}
    p0, s0 = to_device(inp["p0"], P17_DEV), to_device(inp["s0"], P17_DEV)

    def start():
        return pipe.shard(p0, s0, init_opt_state(net, p0))

    ps, ss, os_ = start()
    pipe._check_recompute = True
    (ps, _, _, loss), choices = forward_choices(
        lambda: pipe.train_on_batch(ps, ss, os_, batch))
    pipe._check_recompute = False
    params = pipe.gather(ps)
    times, peak = [], 0.0
    for _ in range(timed):
        ps, ss, os_ = start()
        if pipe.world > 1:
            torch.distributed.barrier()
        p17_sync()
        p17_peak(reset=True)
        t0 = time.perf_counter()
        float(pipe.train_on_batch(ps, ss, os_, batch)[3])
        p17_sync()
        times.append(1e3 * (time.perf_counter() - t0))
        peak = max(peak, p17_peak())
    return dict(params=params, loss=floats(loss), choices=choices,
                ms=statistics.median(times) if times else None, peak=peak,
                ranges=pipe.ranges,
                busy=p17_busy(lambda: pipe.train_on_batch(*start(), batch))
                if timed and pipe.world == 1 else None)


def p17_one_device(net, inp, accum, timed):
    """make_train_step(accum_steps=accum) on the card from inp's start:
    (params, loss, choices, median ms, peak GiB)."""
    step = make_train_step(net, accum_steps=accum)
    batch = {"input": torch.from_numpy(inp["x"]).to(P17_DEV),
             "label": torch.from_numpy(inp["lab"]).to(P17_DEV)}

    p0, s0 = to_device(inp["p0"], P17_DEV), to_device(inp["s0"], P17_DEV)

    def start():
        p = {k: v.clone() for k, v in p0.items()}
        return p, dict(s0), init_opt_state(net, p)

    (p, _, _, loss), choices = recorded(lambda: step(*start(), batch))
    times, peak = [], 0.0
    for _ in range(timed):
        args = start()
        p17_sync()
        p17_peak(reset=True)
        t0 = time.perf_counter()
        float(step(*args, batch)[3])
        p17_sync()
        times.append(1e3 * (time.perf_counter() - t0))
        peak = max(peak, p17_peak())
    return dict(params={k: v.cpu() for k, v in p.items()},
                loss=floats(loss), choices=choices,
                ms=statistics.median(times), peak=peak,
                busy=p17_busy(lambda: step(*start(), batch)))


def p17_busy(fn):
    """Device ms of one call of fn (profiler; None off the card or where
    it saw no device time)."""
    if not p17_on_card():
        return None
    return sum(device_us(fn, iters=1).values()) / 1e3 or None


def p17_exact(net, inp, choices, accum):
    """The update of a float64 run on the card that takes `choices`
    (`replay.sgd_update`, accum_steps=accum)."""
    upd, _ = replay.sgd_update(net, inp["p0"], inp["s0"],
                               {"input": inp["x"], "label": inp["lab"]},
                               torch.float64, P17_DEV,
                               replay.impose(choices), accum_steps=accum)
    return upd


def p17_share(params, p0, exact):
    """Each update's largest distance to `exact`'s, over its largest
    entry."""
    return {k: float((params[k] - p0[k] - r).abs().max()) / max(
        float(r.abs().max()), 1e-30) for k, r in exact.items()}


def interleave(parts, counts, n_micro):
    """One rank's choices a stage (in stage order) joined in the order one
    device makes them: microbatch by microbatch, stage by stage. counts:
    the calls of each kind a stage makes a microbatch."""
    out = replay.Choices()
    for kind in ("kinks", "picks"):
        lists = [getattr(p, kind) for p in parts]
        for m in range(n_micro):
            for lst, c in zip(lists, counts):
                getattr(out, kind).extend(lst[m * c[kind]:(m + 1) * c[kind]])
    return out


def stage_counts(net, ranges):
    kinks, pools = replay.kinked_nodes(net), replay.pooling_nodes(net)
    return [{"kinks": sum(lo <= i < hi for i in kinks),
             "picks": sum(lo <= i < hi for i in pools)}
            for lo, hi in ranges]


def same_choices(a, b):
    return all(len(getattr(a, kind)) == len(getattr(b, kind)) and all(
        torch.equal(x, y) for x, y in zip(getattr(a, kind),
                                          getattr(b, kind)))
        for kind in ("kinks", "picks"))


def p17_gloo_main(rank, tmp):
    """(b): one of P17_RANKS gloo ranks on the card, a stage each."""
    import datetime

    try:
        from bcnn_tpu_torch.parallel import multihost

        inp = torch.load(os.path.join(tmp, "p17_inputs.pt"),
                         weights_only=False)
        globals().update(inp["settings"])
        multihost.initialize(f"file://{tmp}/gloo_store", P17_RANKS, rank,
                             backend="gloo",
                             timeout=datetime.timedelta(seconds=120))
        torch.backends.cudnn.deterministic = True
        res = p17_step([[r] for r in range(P17_RANKS)], P17_MICRO, "1f1b",
                       inp, timed=P17_TIMED)
        res["choices"] = compact(res["choices"])
        torch.save(res, os.path.join(tmp, f"p17_rank{rank}.pt"))
        torch.distributed.destroy_process_group()
    except BaseException:
        import traceback

        with open(os.path.join(tmp, f"p17_error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def p17_forwards():
    """(a)'s MobileNet-v1 forwards, fp32 then int8, each through the
    3-stage pipeline and on one device: {precision: (launches a stage,
    ms, one-device ms, one-device ms over the microbatches in turn,
    worst error)}."""
    from bcnn_tpu_torch.parallel import Pipeline

    net = mobilenet_v1(MB_BATCH, MB_CLASSES).resize(MB_SIZE, MB_SIZE)
    p, s = bridge.params_from_numpy(net, *bridge.he_numpy_weights(net, SEED))
    params, state = to_device(p, P17_DEV), to_device(s, P17_DEV)
    x = torch.from_numpy(np.random.RandomState(SEED + 72).rand(
        MB_BATCH, 3, MB_SIZE, MB_SIZE).astype(np.float32)).to(P17_DEV)
    idx = [net.get_tensor_index_by_name(o) for o in MB_OUTPUTS]
    out = {}
    for prec in ("fp32", "int8"):
        net.quant = None
        if prec == "int8":
            sess = Session(net, SEED, device=P17_DEV)
            sess.params, sess.state = params, state
            sess.compile_net()
            ptq_synthetic(net, sess)

        def one():
            with torch.inference_mode():
                ex = execute(net, params, state, {"input": x}, Mode.PREDICT)
                return [ex.values[i] for i in idx]

        def one_micro():  # one device, the microbatches in turn
            with torch.inference_mode():
                for xm in x.chunk(P17_MICRO):
                    execute(net, params, state, {"input": xm}, Mode.PREDICT)

        pipe = Pipeline(net, [[0]] * 3, Mode.PREDICT,
                        n_microbatches=P17_MICRO, output_names=MB_OUTPUTS,
                        device=P17_DEV)
        ps, ss = pipe.shard(params, state)
        per_stage = [dict.fromkeys(counts(), 0) for _ in pipe.ranges]
        run_stage = pipe._run_stage

        def counted(k, *args):
            before = counts()
            ex = run_stage(k, *args)
            for name, v in counts().items():
                per_stage[k][name] += v - before[name]
            return ex

        want = one()
        zero_counts()
        pipe._run_stage = counted
        got = pipe.forward(ps, ss, {"input": x})
        pipe._run_stage = run_stage
        p17_sync()
        kinds = ("K3", "K6") if prec == "fp32" else ("K4", "K5")
        layers = {"K3": 13, "K4": 15, "K5": 13, "K6": k6_convs(net)}
        for k, launched in enumerate(per_stage):
            if not all(launched[n] for n in kinds):
                raise RuntimeError(f"MobileNet-v1 {prec} pipeline: stage {k} "
                                   f"launched {launched}")
        if prec == "int8" and any(ls["K6"] for ls in per_stage):
            raise RuntimeError(f"the int8 MobileNet-v1 pipeline launched "
                               f"{per_stage}")
        for n in kinds:
            total = sum(ls[n] for ls in per_stage)
            if total != layers[n] * P17_MICRO:
                raise RuntimeError(f"MobileNet-v1 {prec} pipeline: {n} "
                                   f"launched {total} times")
        err = 0.0
        for g, w in zip(got, want):
            if prec == "fp32":
                torch.testing.assert_close(g, w, rtol=P17_FWD_RTOL,
                                           atol=P17_FWD_ATOL)
                err = max(err, float((g - w).abs().max()))
            elif not torch.equal(g, w):
                raise RuntimeError("the int8 MobileNet-v1 pipeline differs "
                                   "from one device")
        times = {"pipe": [], "one": [], "micro": []}
        for _ in range(P17_TIMED):
            for key, fn in (("one", one), ("micro", one_micro),
                            ("pipe", lambda: pipe.forward(
                                ps, ss, {"input": x}))):
                p17_sync()
                t0 = time.perf_counter()
                fn()
                p17_sync()
                times[key].append(1e3 * (time.perf_counter() - t0))
        out[prec] = (per_stage, statistics.median(times["pipe"]),
                     statistics.median(times["one"]),
                     statistics.median(times["micro"]), err)
    net.quant = None
    return out


def pipeline_phase(gpu):
    """Phase 17 (see P17_DEV). Returns the launches of each kernel."""
    import shutil

    import torch.distributed as dist

    t_phase = time.perf_counter()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="p17_")
    lines = []
    try:
        dist.init_process_group(P17_BACKEND,
                                init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        fwd = p17_forwards()
        launched = dict.fromkeys(K_OPS, 0)
        for per_stage, _, _, _, _ in fwd.values():
            for ls in per_stage:
                for k, v in ls.items():
                    launched[k] += v
        lines.append(
            f"(a) one {P17_BACKEND} rank, MobileNet-v1 {MB_SIZE} px batch "
            f"{MB_BATCH} on 3 stages, {P17_MICRO} microbatches: " + "; ".join(
                f"{prec} {ms:.2f} ms a forward against one device's "
                f"{one:.2f} ({micro:.2f} over the microbatches in turn; "
                + (f"max |err| {err:.3g}" if prec == "fp32" else "bit-equal")
                + "; launches a stage "
                + str([{k: v for k, v in ls.items() if v} for ls in per])
                + ")" for prec, (per, ms, one, micro, err) in fwd.items()))

        inp = p17_inputs()
        net = p17_net()
        plain = p17_one_device(net, inp, 1, P17_TIMED)
        accum = p17_one_device(net, inp, P17_MICRO, P17_TIMED)
        e_one = p17_share(plain["params"], inp["p0"],
                          p17_exact(net, inp, plain["choices"], 1))
        e_acc = p17_share(accum["params"], inp["p0"],
                          p17_exact(net, inp, accum["choices"], P17_MICRO))
        runs = {"n1": p17_step([[0], [0]], 1, "gpipe", inp, P17_TIMED),
                "gpipe": p17_step([[0], [0]], P17_MICRO, "gpipe", inp,
                                  P17_TIMED),
                "1f1b": p17_step([[0], [0]], P17_MICRO, "1f1b", inp,
                                 P17_TIMED)}
        ranges = runs["n1"]["ranges"]
        worst = {}
        exact = {}
        for name, r in runs.items():
            n = 1 if name == "n1" else P17_MICRO
            ref = plain if n == 1 else accum
            if not np.allclose(r["loss"], ref["loss"], rtol=STEP_LOSS_RTOL):
                raise RuntimeError(f"pipeline {name}: loss {r['loss']} "
                                   f"against one device's {ref['loss']}")
            if name == "1f1b" and same_choices(
                    r["choices"], runs["gpipe"]["choices"]):
                exact[name] = exact["gpipe"]
            else:
                exact[name] = p17_exact(net, inp, r["choices"], n)
            worst[name] = held_to_replay(
                f"pipeline {name}", net, inp, r["params"], None,
                e_one if n == 1 else e_acc, ref=exact[name])
        same = all(torch.equal(v, runs["gpipe"]["params"][k])
                   for k, v in runs["1f1b"]["params"].items())
        if not same:
            raise RuntimeError("1F1B's parameters differ from GPipe's")
        dist.destroy_process_group()
        lines.append(
            f"YOLOv3-tiny {SIZE} px batch "
            f"{P17_BATCH} on stages {ranges}: worst update share from the "
            "float64 replay of its own choices " + ", ".join(
                f"{k} {v[0]:.3g} ({v[1]})" for k, v in worst.items())
            + f" (one device's own: plain {max(e_one.values()):.3g}, "
            f"accumulation {max(e_acc.values()):.3g}); 1F1B bit-equal to "
            "GPipe; every recompute bit-equal to its forward; ms a step "
            f"(median of {P17_TIMED}): plain {plain['ms']:.1f}, pipeline "
            f"n1 {runs['n1']['ms']:.1f}; accumulation x{P17_MICRO} "
            f"{accum['ms']:.1f}, GPipe {runs['gpipe']['ms']:.1f}, 1F1B "
            f"{runs['1f1b']['ms']:.1f}; device busy ms a step (profiler): "
            + ", ".join(f"{k} " + ("not measured" if r["busy"] is None
                                   else f"{r['busy']:.1f}")
                        for k, r in (("plain", plain), ("n1", runs["n1"]),
                                     ("accumulation", accum),
                                     ("GPipe", runs["gpipe"]),
                                     ("1F1B", runs["1f1b"])))
            + f"; peak GiB: plain {plain['peak']:.3f}, "
            f"n1 {runs['n1']['peak']:.3f}, accumulation {accum['peak']:.3f}"
            f", GPipe {runs['gpipe']['peak']:.3f}, 1F1B "
            f"{runs['1f1b']['peak']:.3f}")

        # -- (b): gloo ranks on the card, a stage each ------------------------
        if p17_on_card():
            torch.cuda.empty_cache()
        inp["settings"] = {k: globals()[k] for k in P17_SETTINGS}
        torch.save(inp, os.path.join(tmp, "p17_inputs.pt"))
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=p17_gloo_main, args=(r, tmp))
                 for r in range(P17_RANKS)]
        t_b = time.perf_counter()
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(300)
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
        errs = [open(os.path.join(tmp, f"p17_error{r}.txt")).read()
                for r in range(P17_RANKS)
                if os.path.exists(os.path.join(tmp, f"p17_error{r}.txt"))]
        if errs or any(pr.exitcode for pr in procs):
            raise RuntimeError("gloo ranks failed: "
                               f"{[pr.exitcode for pr in procs]}\n"
                               + "\n".join(errs))
        t_b = time.perf_counter() - t_b
        ranks = [torch.load(os.path.join(tmp, f"p17_rank{r}.pt"),
                            weights_only=False) for r in range(P17_RANKS)]
        for r, o in enumerate(ranks[1:], 1):
            for k, v in o["params"].items():
                if not torch.equal(v, ranks[0]["params"][k]):
                    raise RuntimeError(f"gloo pipeline: rank {r}'s {k} "
                                       "differs from rank 0's")
        choices = interleave([expand([o["choices"]]) for o in ranks],
                             stage_counts(net, ranks[0]["ranges"]),
                             P17_MICRO)
        if same_choices(choices, runs["1f1b"]["choices"]):
            ex_b = exact["1f1b"]
        else:
            ex_b = p17_exact(net, inp, choices, P17_MICRO)
        worst_b = held_to_replay("gloo pipeline", net, inp,
                                 ranks[0]["params"], None, e_acc, ref=ex_b)
        bit = all(torch.equal(v, runs["1f1b"]["params"][k])
                  for k, v in ranks[0]["params"].items())
        lines.append(
            f"(b) {P17_RANKS} gloo ranks on the card, a stage each, "
            f"{P17_MICRO} microbatches, 1F1B: ranks equal, worst update share "
            f"{worst_b[0]:.3g} ({worst_b[1]}), "
            + ("bit-equal to" if bit else "not bit-equal to")
            + " (a)'s 1F1B; ms a step (median of "
            f"{P17_TIMED}) " + ", ".join(f"{o['ms']:.1f}" for o in ranks)
            + " a rank, peak GiB " + ", ".join(f"{o['peak']:.3f}"
                                               for o in ranks)
            + f"; the ranks took {t_b:.1f} s with start-up")
    finally:
        torch.backends.cudnn.deterministic = det
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"pipeline stages (phase 17) on {gpu}: " + "; ".join(lines)
          + f"; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launched


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    gpu = gpu_line()
    name = torch.cuda.get_device_name(0)
    print(gpu)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; cudnn "
          f"allow_tf32 {torch.backends.cudnn.allow_tf32} (the port's conv "
          "turns it off), matmul allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")

    marks = [time.perf_counter()]

    def stamp(phase):
        """Print the seconds since the last stamp (one phase's)."""
        now = time.perf_counter()
        print(f"[phase {phase}: {now - marks[0]:.1f} s]", flush=True)
        marks[0] = now

    # -- phase 2: build ---------------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    print(f"build + load: {time.perf_counter() - t0:.2f} s")
    stamp("2")

    # -- phase 3: K1 against its plain version on the card ---------------
    k1 = check_k1([
        (BATCH, CLASSES, 13, 13, [3, 4, 5]),
        (BATCH, CLASSES, 26, 26, [0, 1, 2]),
        (BATCH, CLASSES, 52, 52, [0, 1, 2]),  # full YOLOv3's stride 8
        (3, 7, 7, 11, [1, 3, 5]),  # ragged: odd grid, partial last block
    ])

    # -- phase 3b: K2 against its plain version on the card ---------------
    k2 = check_k2()
    shear_chain_phase()

    # -- phase 3c: K3 against its plain version on the card ---------------
    k3 = check_k3()

    # -- phase 3d: K4 against its plain version on the card ---------------
    _, k4_path, k4 = check_k4()

    # -- phase 3e: K5 against its plain version on the card ---------------
    k5 = check_k5()

    # -- phase 3f: K6 against its plain version on the card ---------------
    k6, k6_mish = check_k6()
    stamp("3")

    # -- phase 4: serve YOLOv3-tiny at 416 on both branches ---------------
    net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES)
    sess = Session(net, SEED, device="cuda")
    sess.state = bn_stats(net)
    sess.compile_net()
    rng = np.random.RandomState(SEED + 1)
    batches = [rng.rand(BATCH, 3, SIZE, SIZE).astype(np.float32)
               for _ in range(REQUESTS + 1)]  # the first one warms up

    zero_counts()
    full, _ = serve(
        lambda x: sess.detect_on_batch(x, topk_first=False), batches)
    k1_launches = library.launches("yolo_decode")
    topk, _ = serve(
        lambda x: sess.detect_on_batch(x, topk_first=True), batches)
    if library.launches("yolo_decode") != k1_launches:
        raise RuntimeError("the top-k-first branch launched K1")
    if k1_launches != 2 * len(batches):
        raise RuntimeError(
            f"K1 launched {k1_launches} times for {len(batches)} requests"
        )
    k6_launches = library.launches("bn_act")
    if k6_launches != 2 * len(batches) * k6_convs(net):
        raise RuntimeError(
            f"K6 launched {k6_launches} times for {2 * len(batches)} "
            "requests")

    # -- phase 5: outputs ------------------------------------------------
    for a, b in zip(topk, full):
        for t, shape in zip(a + b, [(BATCH, 100, 4), (BATCH, 100, CLASSES),
                                    (BATCH, 100)] * 2):
            if tuple(t.shape) != shape or not torch.isfinite(t).all():
                raise RuntimeError(f"bad detection output {tuple(t.shape)}")
        same_detections(a, b)

    heads = ["lid17", "lid24"]
    gpu_heads, _ = sess.predict_on_batch(batches[1], outputs=heads)
    cpu = Session(net, SEED, device="cpu")
    cpu.params = {k: v.cpu() for k, v in sess.params.items()}
    cpu.state = {k: v.cpu() for k, v in sess.state.items()}
    cpu.compile_net()
    cpu_heads, _ = cpu.predict_on_batch(batches[1][:2], outputs=heads)
    for g, c in zip(gpu_heads, cpu_heads):
        g = g[:2].cpu()
        if not torch.isfinite(g).all():
            raise RuntimeError("non-finite head")
        torch.testing.assert_close(g, c, rtol=HEAD_RTOL, atol=HEAD_ATOL)
        print(f"head {tuple(g.shape)} GPU vs CPU max_abs_err "
              f"{float((g - c).abs().max()):.3g}")

    stamp("4-5")

    # -- phase 6b: serve YOLOv3-tiny at bf16, then int8 -------------------
    k6_launches += yolo_bf16_phase()
    k4_launches = yolo_int8_phase()
    stamp("6b")

    # -- phase 6c: serve MobileNet-v1 at 224, batch 64, fp32 and bf16 ------
    k3_launches, k6_mb = mobilenet_phase()
    k6_launches += k6_mb + mobilenet_phase(bf16=True)[1]
    stamp("6c")

    # -- phase 6d: serve full YOLOv3 from its cfg and a .weights file -----
    k1_v3, k4_v3, k6_v3 = yolov3_phase()
    k1_launches += k1_v3
    k4_launches += k4_v3
    k6_launches += k6_v3
    stamp("6d")

    # -- phase 6e: serve full YOLOv4 at 608, fp32 and bf16 ----------------
    p6e, mish_launches = yolov4_phase()
    k6_launches += p6e
    stamp("6e")

    # -- phase 7: train YOLOv3-tiny at 416, batch 32 ----------------------
    k2_launches, prebuilt_ms = train_phase(gpu)
    cross_device_step()
    stamp("7")

    # -- phase 8: bench.py's training program at bf16, the step forms ------
    k2_launches += bf16_training_phase(gpu)
    stamp("8")

    # -- phase 9: train from files: the CLI, the feeds, MNIST --------------
    k2_launches += files_phase(gpu, prebuilt_ms)
    stamp("9")

    # -- phase 10: train full YOLOv3; 10b ResNet-18; 10c the layers left ---
    k2_launches += yolov3_train_phase(gpu)
    k6_launches += resnet18_phase(gpu)
    layers_left_phase(gpu)
    stamp("10")

    # -- phase 11: int8 MobileNet-v1 and ResNet-18; 12: QAT ---------------
    mb_net = mobilenet_v1(I8_BATCH, 1000)
    k4_mb, k5_launches = int8_classifier_phase(
        "MobileNet-v1", mb_net, *bridge.he_numpy_weights(mb_net, SEED))
    r18_net = resnet18(I8_BATCH, 1000)
    k4_r18, _ = int8_classifier_phase(
        "ResNet-18", r18_net, *bridge.he_numpy_weights(r18_net, SEED))
    stamp("11")
    k1_q, k2_q, k4_q = qat_phase(gpu)
    k1_launches += k1_q
    k2_launches += k2_q
    k4_launches += k4_mb + k4_r18 + k4_q
    stamp("12")

    # -- phase 13: deploy (torch.export) and resume (checkpoints) ---------
    p13 = deploy_phase(gpu)
    k2_launches += p13["K2"]
    k3_launches += p13["K3"]
    k4_launches += p13["K4"]
    k5_launches += p13["K5"]
    k6_launches += p13["K6"]
    stamp("13")

    # -- phase 14: data parallel (one NCCL rank; two gloo ranks) ----------
    p14 = parallel_phase(gpu)
    k2_launches += p14["K2"]
    k3_launches += p14["K3"]
    k4_launches += p14["K4"]
    k5_launches += p14["K5"]
    k6_launches += p14["K6"]
    stamp("14")

    # -- phase 15: the example drivers (examples_torch/) -------------------
    p15 = examples_phase(gpu)
    k1_launches += p15["K1"]
    k2_launches += p15["K2"]
    k3_launches += p15["K3"]
    k4_launches += p15["K4"]
    k5_launches += p15["K5"]
    k6_launches += p15["K6"]
    stamp("15")

    # -- phase 16: the int8 study, short; the model axis ----------------
    p16 = study_phase(gpu)
    for k, v in model_axis_phase(gpu).items():
        p16[k] += v
    k1_launches += p16["K1"]
    k2_launches += p16["K2"]
    k3_launches += p16["K3"]
    k4_launches += p16["K4"]
    k5_launches += p16["K5"]
    k6_launches += p16["K6"]
    stamp("16")

    # -- phase 17: pipeline stages (one NCCL rank; two gloo ranks) --------
    p17 = pipeline_phase(gpu)
    k3_launches += p17["K3"]
    k4_launches += p17["K4"]
    k5_launches += p17["K5"]
    k6_launches += p17["K6"]
    stamp("17")

    served = k1[:3]  # full YOLOv3's three heads (the first two tiny's)
    trained = k2[:3]  # the three shears of one training step
    mobilenet_dw = k3[:len(K3_MOBILENET)]  # the nine MobileNet layers

    def entry(name, source, replaces, launches, rows, checked, library):
        """A kernel's JSON record: times and bound summed over `rows`,
        the shapes of one request of its path (K1 and K4: full YOLOv3's;
        a row with "n" counts n times); max_abs_err over all `checked`;
        launches over every path that runs it."""
        def total(key, f=lambda v: v):
            return sum(r.get("n", 1) * f(r[key]) for r in rows)

        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": total("ms"),
            "cold_ms": total("cold_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound", lambda b: b[0]),
            "bound_by": ("bytes" if all(r["bound"][1] == "bytes"
                                        for r in rows) else "operations"),
            "library_ms": total("library_ms") if library else None,
        }

    print(json.dumps({"kernels": [
        # no single PyTorch call decodes a YOLO head or shifts rows by a
        # fractional amount a row
        entry("yolo_decode", "bcnn_tpu_torch/csrc/yolo_decode.cu",
              "bcnn_tpu/ops/yolo_pallas.py:74", k1_launches, served, k1,
              False),
        entry("row_shift", "bcnn_tpu_torch/csrc/row_shift.cu",
              "bcnn_tpu/ops/shear_pallas.py:132", k2_launches, trained, k2,
              False),
        entry("depthwise", "bcnn_tpu_torch/csrc/depthwise.cu",
              "bcnn_tpu/ops/dw_pallas.py:166", k3_launches, mobilenet_dw, k3,
              True),
        # no Pallas kernel: the quantized conv the JAX package leaves to
        # XLA; its library yardstick is cuDNN's bf16 conv of the same values
        entry("conv_int8", "bcnn_tpu_torch/csrc/conv_int8.cu",
              "bcnn_tpu/ops/quant.py:302", k4_launches, k4_path, k4, True),
        # no Pallas kernel: the quantized grouped and depthwise conv the
        # JAX package leaves to XLA (conv2d_int8 with groups); its library
        # yardstick is cuDNN's bf16 grouped conv of the same values
        entry("grouped_int8", "bcnn_tpu_torch/csrc/grouped_int8.cu",
              "bcnn_tpu/ops/quant.py:302", k5_launches,
              k5[:len(K5_MOBILENET)], k5, True),
        # no Pallas kernel: BN and the activation, which the JAX package
        # leaves to XLA; its library yardstick is F.batch_norm then
        # F.leaky_relu, the same function in two calls
        entry("bn_act", "bcnn_tpu_torch/csrc/bn_act.cu",
              "none (XLA's fusion of bcnn_tpu/ops/norm.py:batch_norm and "
              "the activation)", k6_launches, k6, k6, True),
        # K6's MISH form at YOLOv4 608's 72 backbone convs; its launches
        # are phase 6e's MISH ones (within bn_act's), its library
        # yardstick F.batch_norm then F.mish
        entry("bn_act_mish", "bcnn_tpu_torch/csrc/bn_act.cu",
              "none (XLA's fusion of bcnn_tpu/ops/norm.py:batch_norm and "
              "the activation)", mish_launches, k6_mish, k6_mish, True),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
