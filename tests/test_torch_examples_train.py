"""The port's training example drivers (examples_torch/: mnist_example,
mnist_fast, cifar10_example, train_throughput, train_soak) against
bcnn_tpu on the CPU, at their smallest sizes (64 px detection, batch
<= 2 there, a few steps), on bcnn_tpu's weights handed in
(`main(argv, weights=...)`).

- The synthetic data (`synth_mnist`, `synth_cifar`, `write_dataset`)
  is the JAX example's for the same seeds: the same idx and CIFAR bytes,
  the same decoded PNG pixels and labels.
- Training: each driver's first three losses within rtol 1e-3 of
  bcnn_tpu's on the same batches (the JAX example's loop run on the
  same weights); the first step's update held by
  tests/test_torch_train_shortcut.assert_updates (within 1e-3 of each
  tensor's largest update of the float64 step, and of bcnn_tpu's).
- The soak: two segments, a resume and the report; a resume bit-equal
  to an uninterrupted run on the same feed and across feeds (stream ->
  resident in the stream's order), and on the shuffled resident feed;
  and a checkpoint written by examples/train_soak.py resumed with its
  params, optimizer state, dispatch and loader position (its JAX key
  cannot be continued, so later losses are not compared).
- Every driver refuses `--device cuda` where CUDA is missing.
"""

import argparse
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import bcnn_tpu as bt
from bcnn_tpu import bip as jbip

from bcnn_tpu_torch import bip, bridge
from tests.test_torch_data import pin_port_bip
from tests.test_torch_train_shortcut import assert_updates

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))

LOSS_RTOL = 1e-3
TRAIN_DRIVERS = ["mnist_example", "mnist_fast", "cifar10_example",
                 "train_throughput", "train_soak"]


@pytest.fixture(scope="module", autouse=True)
def same_backend():
    yield from pin_port_bip()


def host(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("name", TRAIN_DRIVERS)
def test_driver_refuses_cuda_without_it(name, monkeypatch, tmp_path):
    import importlib

    mod = importlib.import_module(f"examples_torch.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--device", "cuda"]
    if name == "train_soak":
        argv += ["--dir", str(tmp_path / "d"), "--outdir",
                 str(tmp_path / "o")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)


# ------------------------------------------------------------- MNIST


@pytest.fixture(scope="module")
def mnist_files(tmp_path_factory):
    """The port's synthetic idx files, byte-equal to the JAX example's:
    (train-img, train-lbl, test-img, test-lbl)."""
    from mnist_example import synth_mnist as jax_synth

    from examples_torch.mnist_example import synth_mnist

    d = tmp_path_factory.mktemp("mnist")
    files = []
    for tag, n, seed in (("train", 512, 0), ("t10k", 128, 9)):
        mine = synth_mnist(str(d / tag), n, seed)
        theirs = jax_synth(str(d / f"jax_{tag}"), n, seed)
        for a, b in zip(mine, theirs):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()
        files += mine
    return files


def loader_session(jnet, files, loader_type):
    js = bt.Session(jnet, seed=0)
    js.set_data_loader(loader_type, *files)
    return js.compile_net()


def jax_steps(js, n):
    return [float(js.train_on_batch()) for _ in range(n)]


def first_batch(net, loader_type, files):
    """The first TRAIN batch the port's loader gives `net`."""
    from bcnn_tpu_torch.data import make_loader
    from bcnn_tpu_torch.types import Mode

    ld = make_loader(net, loader_type, *files)
    ld.set_mode(Mode.TRAIN)
    x, y = ld.next_batch()
    ld.close()
    return x, y


def test_mnist_example_against_bcnn_tpu(mnist_files):
    """LeNet with host shift + rotation augmentation: three losses, and
    the first step's update."""
    from bcnn_tpu.models import lenet_mnist as jax_lenet

    from bcnn_tpu_torch.types import LoaderType
    from examples_torch import mnist_example

    jnet = jax_lenet(batch_size=16, mode=bt.Mode.TRAIN)
    jnet.data_aug = dict(range_shift_x=5, range_shift_y=5,
                         rotation_range=30.0)
    js = loader_session(jnet, mnist_files, bt.LoaderType.MNIST)
    weights = host(js.params), host(js.state)
    want = jax_steps(js, 3)
    res = mnist_example.main(mnist_files + ["--iters", "3", "--device",
                                            "cpu"], weights=weights)
    np.testing.assert_allclose(res["losses"], want, rtol=LOSS_RTOL)

    jnet1 = jax_lenet(batch_size=16, mode=bt.Mode.TRAIN)
    jnet1.data_aug = jnet.data_aug
    js1 = loader_session(jnet1, mnist_files, bt.LoaderType.MNIST)
    js1.params, js1.state = weights
    js1.compile_net()
    js1.train_on_batch()
    one = mnist_example.main(mnist_files + ["--iters", "1", "--device",
                                            "cpu"], weights=weights)
    net = one["session"].net
    x, y = first_batch(net, LoaderType.MNIST, mnist_files)
    assert_updates(net, *weights, x, y, one["session"].params, js1.params)


def test_mnist_fast_against_bcnn_tpu(mnist_files):
    """The first scan of K = 3 staged batches: its three losses against
    bcnn_tpu's make_train_scan on the same batches."""
    import jax
    import jax.numpy as jnp
    from bcnn_tpu.compile import make_train_scan
    from bcnn_tpu.models import lenet_mnist as jax_lenet
    from mnist_fast import load_idx

    from examples_torch import mnist_fast

    batch = 16
    jnet = jax_lenet(batch_size=batch, mode=bt.Mode.TRAIN)
    jnet.set_sgd_optimizer(0.02, 0.9)
    js = bt.Session(jnet, seed=0).compile_net()
    weights = host(js.params), host(js.state)
    imgs, labels = load_idx(*mnist_files[:2])
    idx = np.random.RandomState(0).randint(0, len(imgs), 3 * batch)
    x = ((imgs[idx].astype(np.float32) - 127.5) / 127.5).reshape(
        3, batch, 1, 28, 28)
    y = np.zeros((3 * batch, 10, 1, 1), np.float32)
    y[np.arange(3 * batch), labels[idx]] = 1.0
    staged = {"input": jnp.asarray(x),
              "label": jnp.asarray(y.reshape(3, batch, 10, 1, 1))}
    *_, want = make_train_scan(jnet)(js.params, js.state, js.opt_state,
                                     staged, jax.random.PRNGKey(0))
    res = mnist_fast.main(mnist_files + ["--chunk", "3", "--chunks", "1",
                                         "--batch", str(batch), "--device",
                                         "cpu"], weights=weights)
    np.testing.assert_allclose(res["losses"], np.asarray(want),
                               rtol=LOSS_RTOL)
    assert 0.0 <= res["accuracy"] <= 1.0 and res["img_s"] > 0


@pytest.mark.parametrize("variant", ["convnet", "resnet"])
def test_cifar10_example_against_bcnn_tpu(variant, tmp_path):
    """Synthetic CIFAR bytes equal to the JAX example's; host flip,
    shift, contrast and brightness augmentation; three losses and the
    first step's update, at batch 4."""
    from bcnn_tpu.models import cifar10_convnet as jax_convnet
    from bcnn_tpu.models import cifar10_resnet as jax_resnet
    from cifar10_example import synth_cifar as jax_synth

    from bcnn_tpu_torch.types import LoaderType
    from examples_torch import cifar10_example
    from examples_torch.cifar10_example import synth_cifar

    train = synth_cifar(str(tmp_path / "train.bin"), 64, 0)
    test = synth_cifar(str(tmp_path / "test.bin"), 16, 9)
    for path, n, seed in ((train, 64, 0), (test, 16, 9)):
        theirs = jax_synth(str(tmp_path / "jax.bin"), n, seed)
        with open(path, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()
    files = [train, None, test, None]
    aug = dict(range_shift_x=4, range_shift_y=4, random_fliph=1,
               min_contrast=0.8, max_contrast=1.2,
               min_brightness=-30, max_brightness=30)

    def jax_session():
        jnet = (jax_resnet if variant == "resnet" else jax_convnet)(4)
        jnet.data_aug = aug
        return loader_session(jnet, files, bt.LoaderType.CIFAR10)

    js = jax_session()
    weights = host(js.params), host(js.state)
    want = jax_steps(js, 3)
    argv = ([variant] if variant == "resnet" else []) + [
        train, test, "--iters", "3", "--batch", "4", "--device", "cpu"]
    res = cifar10_example.main(argv, weights=weights)
    np.testing.assert_allclose(res["losses"], want, rtol=LOSS_RTOL)

    js1 = jax_session()
    js1.params, js1.state = weights
    js1.compile_net()
    js1.train_on_batch()
    argv[argv.index("3")] = "1"
    one = cifar10_example.main(argv, weights=weights)
    net = one["session"].net
    x, y = first_batch(net, LoaderType.CIFAR10, files)
    assert_updates(net, *weights, x, y, one["session"].params, js1.params)


# -------------------------------------------------- detection training


def test_write_dataset_is_the_jax_examples(tmp_path):
    """The same images (decoded) and labels as
    examples/train_throughput.write_dataset for the same seed."""
    from train_throughput import write_dataset as jax_write

    from examples_torch.train_throughput import write_dataset

    os.makedirs(tmp_path / "mine")
    os.makedirs(tmp_path / "theirs")
    for seed in (0, 999):
        mine = write_dataset(str(tmp_path / "mine"), 3, 96, 72, seed=seed)
        theirs = jax_write(str(tmp_path / "theirs"), 3, 96, 72, seed=seed)
        with open(mine) as a, open(theirs) as b:
            la, lb = a.read().splitlines(), b.read().splitlines()
        assert len(la) == len(lb) == 3
        for a, b in zip(la, lb):
            pa, *ra = a.split(" ")
            pb, *rb = b.split(" ")
            assert ra == rb and os.path.basename(pa) == os.path.basename(pb)
            np.testing.assert_array_equal(bip.load_image(pa),
                                          jbip.load_image(pb))


def test_train_throughput_against_bcnn_tpu(tmp_path):
    """The pure step (a constant batch) and the sync feed (the detection
    list loader) at 64 px, batch 2, fp32 (--compute fp32 --act fp32: the
    two packages' bf16 roundings part the third step's loss by 1.4%):
    each feed's first three losses against bcnn_tpu's make_train_step on
    the same batches, from the same weights, in the same order."""
    import jax
    import jax.numpy as jnp
    from bcnn_tpu.compile import make_train_step
    from bcnn_tpu.data import DetectionListLoader
    from bcnn_tpu.models import yolov3_tiny as jax_tiny

    from examples_torch import train_throughput as tt

    out = str(tmp_path / "data")
    rows = tt.main(["--batch", "2", "--steps", "4", "--size", "64",
                    "--src-size", "96", "--images", "4", "--modes", "sync",
                    "--act", "fp32", "--compute", "fp32", "--outdir", out,
                    "--device", "cpu"],
                   weights=WEIGHTS_OF["tiny"]())
    assert [r["feed"] for r in rows] == ["pure-step", "sync"]
    assert all(r["img_s"] > 0 for r in rows)

    def build():
        return jax_tiny(batch_size=2, width=64, height=64,
                        mode=bt.Mode.TRAIN)

    net = build()
    js = bt.Session(net, seed=0)
    js.params, js.state = WEIGHTS_OF["tiny"]()
    js.compile_net()
    step = jax.jit(make_train_step(net))
    p, s, o = js.params, js.state, js.opt_state
    key = jax.random.PRNGKey(0)
    x = jnp.asarray(np.random.RandomState(0).rand(2, 3, 64, 64), jnp.float32)
    y = jnp.zeros((2, 250), jnp.float32)
    pure = []
    for _ in range(4):
        p, s, o, loss = step(p, s, o, {"input": x, "label": y}, key)
        pure.append(float(loss))
    lst = [f for f in os.listdir(out) if f.endswith(".txt")]
    loader = DetectionListLoader(build(), os.path.join(out, lst[0]))
    sync = []
    for _ in range(3):
        xb, yb = loader.next_batch()
        p, s, o, loss = step(p, s, o, {"input": jnp.asarray(xb),
                                       "label": jnp.asarray(yb)}, key)
        sync.append(float(loss))
    np.testing.assert_allclose(rows[0]["losses"][:3], pure[:3],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(rows[1]["losses"][:3], sync, rtol=LOSS_RTOL)


def _tiny_weights():
    from bcnn_tpu_torch.models import yolov3_tiny

    return bridge.he_numpy_weights(yolov3_tiny(2, 64, 64), 0)


WEIGHTS_OF = {"tiny": _tiny_weights}

SOAK = ["--batch", "2", "--scan", "2", "--size", "64", "--src-size", "96",
        "--images", "4", "--eval-every", "3", "--ckpt-every", "2",
        "--mem-every", "1", "--act", "fp32", "--rotation", "10",
        "--device", "cpu"]


def ckpt_arrays(d):
    with np.load(os.path.join(d, "ckpt_latest.npz")) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__meta__").tobytes()).decode())
    return flat, meta["extra"]


def test_soak_two_segments_resume_and_report(tmp_path):
    """tests/test_soak_smoke.py's run: two segments with the held-out mAP
    on in the second, a report, and a third segment."""
    from examples_torch import train_soak

    d, o = str(tmp_path / "soak"), str(tmp_path / "data")
    common = SOAK + ["--dir", d, "--outdir", o]
    train_soak.main(common + ["--steps", "8"])
    assert os.path.exists(os.path.join(d, "ckpt_latest.npz"))
    rep = train_soak.main(common + ["--steps", "16", "--resume",
                                    "--eval-map", "4"])
    assert rep["steps"] == 16 and rep["segments"] == 2
    assert rep["steps_redone_after_kill"] == 0
    assert rep["map50_trajectory"] and 0.0 <= rep["map50_val_last"] <= 1.0
    assert rep["img_s_whole_run"] > 0 and rep["img_s_steady"] > 0
    assert rep["step_ms_p50"] > 0 and rep["eval_n"] >= 2
    assert rep["ckpt_n"] >= 2
    a, b = rep["eval_first_last_loss"]
    assert a == a and b == b and a > 0 and b > 0
    assert train_soak.main(["--dir", d, "--report"]) == rep
    rep3 = train_soak.main(common + ["--steps", "24", "--resume"])
    assert rep3["steps"] == 24 and rep3["segments"] == 3


@pytest.fixture(scope="module")
def soak_runs(tmp_path_factory):
    """One record set; on each feed a run to 16 steps and a run to 8:
    {feed: (whole dir, part dir)} and the records' directory."""
    from examples_torch import train_soak

    root = tmp_path_factory.mktemp("soak_runs")
    common = SOAK + ["--outdir", str(root / "data")]
    runs = {}
    for feed in ("stream", "resident"):
        whole, part = str(root / f"{feed}_whole"), str(root / f"{feed}_part")
        train_soak.main(common + ["--dir", whole, "--steps", "16", "--feed",
                                  feed])
        train_soak.main(common + ["--dir", part, "--steps", "8", "--feed",
                                  feed])
        runs[feed] = whole, part
    return runs, str(root / "data")


@pytest.mark.parametrize("feeds", [("stream", "stream"),
                                   ("stream", "resident"),
                                   ("resident", "resident")],
                         ids=["stream", "stream-to-resident", "resident"])
def test_soak_resume_is_bit_equal(feeds, soak_runs, tmp_path):
    """8 steps, a resume to 16, against one run to 16: every param,
    state and optimizer array and the loader position equal. Across
    feeds the resident feed walks the stream's order (--sequential);
    the resident-to-resident case keeps its per-epoch shuffle."""
    from examples_torch import train_soak

    first, second = feeds
    seq = ["--sequential"] if feeds == ("stream", "resident") else []
    (whole, part0), data = soak_runs[0][first], soak_runs[1]
    part = str(tmp_path / "part")
    shutil.copytree(part0, part)
    rep = train_soak.main(SOAK + ["--outdir", data, "--dir", part,
                                  "--steps", "16", "--resume", "--feed",
                                  second] + seq)
    assert rep["steps"] == 16 and rep["segments"] == 2
    want, want_extra = ckpt_arrays(whole)
    got, got_extra = ckpt_arrays(part)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got_extra["dispatch"] == want_extra["dispatch"] == 8
    if feeds != ("stream", "resident"):
        assert got_extra["loader_pos"] == want_extra["loader_pos"]


def test_soak_resumes_a_bcnn_tpu_checkpoint(tmp_path):
    """examples/train_soak.py writes ckpt_latest.npz at the same tiny
    size; the port resumes it: its params, state, optimizer state,
    dispatch and loader position carry over exactly, and training goes
    on from there."""
    import train_soak as jax_soak

    from examples_torch import train_soak

    d, o = str(tmp_path / "soak"), str(tmp_path / "data")
    ns = argparse.Namespace(
        steps=4, batch=2, scan=2, size=64, src_size=96, images=4,
        act="fp32", feed="stream", eval_every=0, eval_map=0, ckpt_every=0,
        mem_every=1000, dir=d, outdir=str(tmp_path / "jax_data"),
        rotation=0.0, seed=0, resume=False, report=False, pidfile="")
    jax_soak.run(ns)
    theirs, their_extra = ckpt_arrays(d)
    common = SOAK + ["--dir", d, "--outdir", o]
    rep = train_soak.main(common + ["--steps", "4", "--resume"])
    assert rep["segments"] == 2
    mine, my_extra = ckpt_arrays(d)
    assert set(mine) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    assert my_extra["dispatch"] == their_extra["dispatch"] == 2
    assert my_extra["loader_pos"] == their_extra["loader_pos"]
    shutil.copy(os.path.join(d, "ckpt_latest.npz"),
                str(tmp_path / "resumed.npz"))
    rep = train_soak.main(common + ["--steps", "8", "--resume"])
    assert rep["steps"] == 8 and rep["segments"] == 3
    after, _ = ckpt_arrays(d)
    assert all(np.isfinite(v).all() for v in after.values())
    assert any(not np.array_equal(after[k], mine[k]) for k in mine
               if k.startswith("params/"))
