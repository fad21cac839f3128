"""CIFAR-10 training example on the PyTorch port, the counterpart of
examples/cifar10_example.py (the reference's
examples/cifar10/cifar10_example.c).

Two variants: the plain convnet (batch 128) and the ResNet-style net
with eltwise shortcuts (batch 32), host bip augmentation as the
reference configures it. Synthetic CIFAR-10-format data (the same
bytes as examples/cifar10_example.py's for the same seeds) when no
dataset paths are given.

Usage:
  python examples_torch/cifar10_example.py [resnet] [train.bin test.bin]
      [--iters 300] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def synth_cifar(path, n, seed):
    rng = np.random.RandomState(seed)
    with open(path, "wb") as f:
        for _ in range(n):
            lbl = rng.randint(0, 10)
            img = (rng.rand(3, 32, 32) * 60).astype(np.uint8)
            r, c = divmod(lbl, 4)
            img[:, 4 + r * 8 : 12 + r * 8, 2 + c * 7 : 9 + c * 7] = 230
            f.write(bytes([lbl]))
            img.tofile(f)
    return path


def main(argv=None, weights=None):
    """Returns {"losses", "evals": [(iter, train error, test error)],
    "wall_s", "session"}. `weights`: (params, state) numpy dicts in bcnn_tpu's
    layout."""
    from examples_torch._common import add_device, data_dir, device, \
        seed_weights

    ap = argparse.ArgumentParser()
    ap.add_argument("args", nargs="*", help="[resnet] [train.bin test.bin]")
    ap.add_argument("--iters", type=int,
                    default=int(os.environ.get("CIFAR_ITERS", "300")))
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--batch", type=int, default=None,
                    help="default 32 (resnet) or 128")
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)

    from bcnn_tpu_torch import LoaderType, Mode, Session
    from bcnn_tpu_torch.models import cifar10_convnet, cifar10_resnet

    resnet = "resnet" in args.args
    paths = [a for a in args.args if a != "resnet"]
    if len(paths) >= 2:
        train_bin, test_bin = paths[:2]
    else:
        print("No dataset paths; generating synthetic CIFAR-format data")
        d = data_dir("bcnn_cifar")
        train_bin = synth_cifar(os.path.join(d, "train.bin"), 4096, 0)
        test_bin = synth_cifar(os.path.join(d, "test.bin"), 1024, 9)

    if resnet:
        net = cifar10_resnet(args.batch or 32)
    else:
        net = cifar10_convnet(args.batch or 128)
    # bip online augmentation, as the reference example configures
    net.data_aug = dict(
        range_shift_x=4, range_shift_y=4, random_fliph=1,
        min_contrast=0.8, max_contrast=1.2,
        min_brightness=-30, max_brightness=30,
    )
    sess = seed_weights(Session(net, seed=0, device=dev), weights)
    sess.set_data_loader(LoaderType.CIFAR10, train_bin, None, test_bin, None)
    sess.compile_net()

    losses, evals = [], []
    sum_err, t0 = 0.0, time.time()
    for i in range(1, args.iters + 1):
        loss = float(sess.train_on_batch())
        losses.append(loss)
        sum_err += loss
        if i % args.eval_every == 0:
            sess.set_mode(Mode.VALID)
            err = sum(
                float(sess.predict_on_batch()[1]) for _ in range(4)
            ) / (4 * net.batch_size)
            sess.set_mode(Mode.TRAIN)
            tr = sum_err / (args.eval_every * net.batch_size)
            evals.append((i, tr, err))
            print(f"iter= {i} train-error= {tr:.4f} test-error= {err:.4f} "
                  f"elapsed= {time.time() - t0:.1f}s")
            sum_err = 0.0
    return {"losses": losses, "evals": evals, "wall_s": time.time() - t0,
            "session": sess}


if __name__ == "__main__":
    main()
