"""MNIST in seconds on the PyTorch port, the counterpart of
examples/mnist_fast.py.

The same LeNet as mnist_example.py, but the batches of a chunk are
staged on the device at once and trained by one `make_train_scan` call
of K steps; the losses come back once a chunk. It reports the test
accuracy, the training wall time and img/s on the card it ran on; it
sets no target.

Usage: python examples_torch/mnist_fast.py
    [train-img train-lbl test-img test-lbl] [--chunk 20] [--chunks 30]
    [--device cuda|cpu]
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


def load_idx(img_path, lbl_path):
    with open(img_path, "rb") as f:
        _, n, h, w = struct.unpack(">4i", f.read(16))
        imgs = np.frombuffer(f.read(n * h * w), np.uint8).reshape(n, h, w)
    with open(lbl_path, "rb") as f:
        struct.unpack(">2i", f.read(8))
        labels = np.frombuffer(f.read(n), np.uint8)
    return imgs, labels


def main(argv=None, weights=None):
    """Returns {"accuracy", "train_s", "img_s", "losses": the first
    (compile) chunk's per-step losses, "steps", "batch"}. `weights`:
    (params, state) numpy dicts in bcnn_tpu's layout."""
    from examples_torch._common import add_device, data_dir, device, \
        seed_weights, sync
    from examples_torch.mnist_example import synth_mnist

    ap = argparse.ArgumentParser()
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--chunk", type=int,
                    default=int(os.environ.get("CHUNK", "20")))
    ap.add_argument("--chunks", type=int,
                    default=int(os.environ.get("CHUNKS", "30")))
    ap.add_argument("--batch", type=int, default=128)
    add_device(ap)
    args = ap.parse_args(argv)
    dev = device(args.device)

    import torch

    from bcnn_tpu_torch import Mode, Session
    from bcnn_tpu_torch.compile import make_train_scan
    from bcnn_tpu_torch.models import lenet_mnist

    if len(args.paths) >= 4:
        tr_i, tr_l, te_i, te_l = args.paths[:4]
    else:
        print("No dataset paths; generating synthetic MNIST-format data")
        d = data_dir("bcnn_mnist")
        tr_i, tr_l = synth_mnist(os.path.join(d, "train"), 16384, 0)
        te_i, te_l = synth_mnist(os.path.join(d, "t10k"), 4096, 9)

    imgs, labels = load_idx(tr_i, tr_l)
    test_imgs, test_labels = load_idx(te_i, te_l)
    batch, k_steps = args.batch, args.chunk

    net = lenet_mnist(batch_size=batch, mode=Mode.TRAIN)
    net.set_sgd_optimizer(0.02, 0.9)  # larger batch -> larger lr
    sess = seed_weights(Session(net, seed=0, device=dev), weights)
    sess.compile_net()
    train_scan = make_train_scan(net)

    rng = np.random.RandomState(0)

    def stage(k):
        idx = rng.randint(0, len(imgs), k * batch)
        x = (imgs[idx].astype(np.float32) - 127.5) / 127.5
        x = x.reshape(k, batch, 1, 28, 28)
        y = np.zeros((k * batch, 10, 1, 1), np.float32)
        y[np.arange(k * batch), labels[idx]] = 1.0
        y = y.reshape(k, batch, 10, 1, 1)
        return {"input": torch.as_tensor(x, device=dev),
                "label": torch.as_tensor(y, device=dev)}

    def gen(c):
        return torch.Generator().manual_seed(c)

    # the first chunk warms up (cuDNN plans, allocations), outside the time
    p, s, o = sess.params, sess.state, sess.opt_state
    p, s, o, losses = train_scan(p, s, o, stage(k_steps), gen(0))
    first = losses.cpu().tolist()

    t0 = time.time()
    for c in range(args.chunks):
        p, s, o, losses = train_scan(p, s, o, stage(k_steps), gen(c))
    sync(dev)
    losses.cpu()
    train_s = time.time() - t0
    sess.params, sess.state, sess.opt_state = p, s, o

    net.set_mode(Mode.VALID)
    n_eval = (len(test_imgs) // batch) * batch
    correct = 0
    for i in range(0, n_eval, batch):
        x = (test_imgs[i : i + batch].astype(np.float32) - 127.5) / 127.5
        x = x.reshape(batch, 1, 28, 28)
        (probs,), _ = sess.predict_on_batch(x, outputs=["softmax"])
        pred = probs.reshape(batch, 10).argmax(1).cpu().numpy()
        correct += int((pred == test_labels[i : i + batch]).sum())
    acc = correct / n_eval
    steps = args.chunks * k_steps
    img_s = steps * batch / max(train_s, 1e-9)
    print(f"accuracy= {acc:.4f} train-time= {train_s:.1f}s "
          f"({steps} timed steps x batch {batch} after a {k_steps}-step "
          f"warm-up chunk, {img_s:.0f} img/s) on {dev}")
    return {"accuracy": acc, "train_s": train_s, "img_s": img_s,
            "losses": first, "steps": steps, "batch": batch}


if __name__ == "__main__":
    main()
