"""MNIST training example on the PyTorch port, the counterpart of
examples/mnist_example.py (the reference's examples/mnist/mnist_example.c).

Trains the LeNet-style net (conv-bn-pool x2, fc x2, softmax, euclidean
cost) with SGD lr 0.003, momentum 0.9, sigmoid decay, wd 5e-4, host
shift + rotation augmentation (bip), printing train and test error every
eval period.

Usage:
  python examples_torch/mnist_example.py
      [train-img train-lbl test-img test-lbl]
      [--iters 500] [--device cuda|cpu]
Without paths, synthetic MNIST-format idx files are written (the same
bytes as examples/mnist_example.py's for the same seeds).
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def synth_mnist(path_prefix, n, seed):
    """Synthetic idx files with label-correlated patterns."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    imgs = (rng.rand(n, 28, 28) * 50).astype(np.uint8)
    for i, c in enumerate(labels):
        r, col = divmod(int(c), 4)
        imgs[i, 2 + r * 8 : 10 + r * 8, 2 + col * 7 : 9 + col * 7] = 240
    pi = path_prefix + "-images.idx3-ubyte"
    pl = path_prefix + "-labels.idx1-ubyte"
    with open(pi, "wb") as f:
        f.write(struct.pack(">4i", 0x803, n, 28, 28))
        imgs.tofile(f)
    with open(pl, "wb") as f:
        f.write(struct.pack(">2i", 0x801, n))
        labels.tofile(f)
    return pi, pl


def main(argv=None, weights=None):
    """Returns {"losses": each step's loss, "evals": [(iter, train
    error, test error)], "wall_s", "session"}. `weights`: (params, state) numpy
    dicts in bcnn_tpu's layout, in place of the seeded init."""
    from examples_torch._common import add_device, data_dir, device, \
        seed_weights

    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--iters", type=int,
                    default=int(os.environ.get("MNIST_ITERS", "500")))
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--num-pred", type=int, default=1024)
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)

    from bcnn_tpu_torch import LoaderType, Mode, Session
    from bcnn_tpu_torch.models import lenet_mnist

    if len(args.paths) >= 4:
        train_img, train_lbl, test_img, test_lbl = args.paths[:4]
    else:
        print("No dataset paths given; generating synthetic MNIST-format data")
        d = data_dir("bcnn_mnist")
        train_img, train_lbl = synth_mnist(os.path.join(d, "train"),
                                           4096, 0)
        test_img, test_lbl = synth_mnist(os.path.join(d, "t10k"),
                                         1024, 9)

    net = lenet_mnist(batch_size=16, mode=Mode.TRAIN)
    net.data_aug = dict(range_shift_x=5, range_shift_y=5, rotation_range=30.0)
    sess = seed_weights(Session(net, seed=0, device=dev), weights)
    sess.set_data_loader(LoaderType.MNIST, train_img, train_lbl, test_img,
                         test_lbl)
    sess.compile_net()

    losses, evals = [], []
    sum_err = 0.0
    t0 = time.time()
    for i in range(1, args.iters + 1):
        loss = float(sess.train_on_batch())
        losses.append(loss)
        sum_err += loss
        if i % args.eval_every == 0:
            sess.set_mode(Mode.VALID)
            err = 0.0
            for _ in range(args.num_pred // net.batch_size):
                _, loss = sess.predict_on_batch()
                err += float(loss)
            sess.set_mode(Mode.TRAIN)
            tr = sum_err / (args.eval_every * net.batch_size)
            te = err / args.num_pred
            evals.append((i, tr, te))
            print(f"iter= {i} train-error= {tr:.4f} test-error= {te:.4f} "
                  f"elapsed= {time.time() - t0:.1f}s")
            sum_err = 0.0
    wall = time.time() - t0
    print(f"total wall: {wall:.1f}s")
    return {"losses": losses, "evals": evals, "wall_s": wall,
            "session": sess}


if __name__ == "__main__":
    main()
