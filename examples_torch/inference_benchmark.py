"""Inference timing harness on the PyTorch port, the counterpart of
examples/inference_benchmark.py (the reference's
examples/inference_benchmark).

Times N forward runs of a model (a built-in name, or a .conf / .cfg
with its weights) and prints min/max/avg ms as the reference does
(inference_benchmark.c:92-112), plus img/s. bf16 compute by default
(--fp32 for fp32), --int8 for the int8 path calibrated by
`ptq_synthetic`. Each run ends with `torch.cuda.synchronize()` on the
card; the input is uploaded once, before the runs.

Usage:
  python examples_torch/inference_benchmark.py --model yolov3-tiny [--batch 64]
  python examples_torch/inference_benchmark.py --config net.conf
      --weights m.bcnnmodel
      [--fp32 | --int8 [--act16]] [--runs 20] [--size S]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

MODELS = ("yolov3-tiny", "yolov3", "mobilenet-v1", "resnet18", "lenet")


def build(args, dev, weights=None, quant=None):
    """(net, session) as the arguments say; `weights` (bcnn_tpu-layout
    numpy dicts) in place of the seeded init, `quant` (an int8 dict
    such as ptq_synthetic returns) in place of the calibration. A quant
    dict goes with the state it was calibrated with (ptq_synthetic sets
    the running variances to 1): hand that state in `weights`."""
    import torch

    from bcnn_tpu_torch import Mode, Net, Session, models
    from examples_torch._common import seed_weights

    if args.config:
        from bcnn_tpu_torch.config import load_net

        net = Net(Mode.PREDICT)
        net.set_input_shape(0, 0, 0, args.batch)
        load_net(net, args.config, args.weights)
    else:
        builders = {
            "yolov3-tiny": lambda: models.yolov3_tiny(args.batch),
            "yolov3": lambda: models.yolov3(args.batch),
            "mobilenet-v1": lambda: models.mobilenet_v1(args.batch),
            "resnet18": lambda: models.resnet18(args.batch),
            "lenet": lambda: models.lenet_mnist(args.batch, Mode.PREDICT),
        }
        net = builders[args.model]()
    if args.size:
        net.resize(args.size, args.size)
    if args.bf16:
        net.compute_dtype = torch.bfloat16
        if args.act16:
            net.act_dtype = torch.bfloat16
    sess = seed_weights(Session(net, seed=0, device=dev), weights)
    sess.compile_net()
    if quant is not None:
        net.quant = dict(quant, weights={
            k: {kk: vv.to(dev) for kk, vv in e.items()}
            for k, e in quant["weights"].items()})
    elif args.int8:
        from bcnn_tpu_torch.ops.quant import ptq_synthetic

        ptq_synthetic(net, sess)
    return net, sess


def main(argv=None, weights=None, quant=None):
    """Returns {"batch", "min_ms", "max_ms", "avg_ms", "img_s", "outputs":
    the last run's output tensors (every YOLO head, else the last
    node's), "net", "session"}."""
    from examples_torch._common import add_device, device, sync

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="yolov3-tiny", choices=MODELS)
    ap.add_argument("--config")
    ap.add_argument("--weights")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--size", type=int, default=0,
                    help="input width and height (default: the model's)")
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--act16", action="store_true",
                    help="bf16 activations between layers too (bench.py's "
                    "int8 program)")
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)

    import torch

    from bcnn_tpu_torch.compile import make_forward
    from bcnn_tpu_torch.deploy import default_outputs
    from bcnn_tpu_torch.types import Mode

    net, sess = build(args, dev, weights, quant)
    forward = make_forward(net, default_outputs(net), Mode.PREDICT)
    t0 = net.tensors[0]
    x = torch.as_tensor(
        np.random.RandomState(0).rand(t0.n, t0.c, t0.h, t0.w)
        .astype(np.float32), device=dev)

    def run():
        with torch.inference_mode():
            outs = forward(sess.params, sess.state, {"input": x})[0]
        sync(dev)
        return outs

    outs = run()  # warm-up: cuDNN plans, allocations
    times = []
    for _ in range(args.runs):
        t = time.perf_counter()
        outs = run()
        times.append((time.perf_counter() - t) * 1e3)
    res = {
        "batch": t0.n,
        "min_ms": min(times),
        "max_ms": max(times),
        "avg_ms": sum(times) / len(times),
        "img_s": t0.n / (min(times) / 1e3),
    }
    precision = ("int8" if args.int8 else "bf16" if args.bf16 else "fp32") + (
        " act16" if args.bf16 and args.act16 else "")
    print(
        f"{args.config or args.model} ({precision}, {dev}): batch={t0.n} "
        f"min= {res['min_ms']:.3f} ms max= {res['max_ms']:.3f} ms "
        f"avg= {res['avg_ms']:.3f} ms -> {res['img_s']:.0f} img/s"
    )
    res.update(outputs=outs, net=net, session=sess)
    return res


if __name__ == "__main__":
    main()
