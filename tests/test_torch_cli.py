"""The port's bcnn-cl (`bcnn_tpu_torch.cli`) against bcnn_tpu's, on the
CPU: the detection conf of tests/test_cli_detection.py and the MNIST
recipe (examples/mnist_cl/mnist.conf's net, its host augmentation and
solver, on small idx files) trained, validated and predicted through
both CLIs from one initial .bcnnmodel that bcnn_tpu writes.

Tolerances, those of tests/test_torch_train.py's trajectory: every
printed loss, error and YOLO statistic rtol 1e-4 (atol 1e-5 on values
printed with six decimals); each parameter's total update in the saved
model within 1e-3 of its largest entry; BN running stats rtol 1e-4,
atol 1e-5; mAP within 1e-3."""

import os
import re

import numpy as np
import pytest
import torch

from bcnn_tpu import Mode as JMode
from bcnn_tpu import Net as JNet
from bcnn_tpu.cli import main as jmain
from bcnn_tpu.compile import init_params as jinit_params
from bcnn_tpu.config import load_net as jload_net
from bcnn_tpu.serialization import save_weights as jsave_weights

from bcnn_tpu_torch import bip
from bcnn_tpu_torch.cli import load_cli_param, main
from bcnn_tpu_torch.compile import init_params
from bcnn_tpu_torch.config import load_net
from bcnn_tpu_torch.graph import Net
from bcnn_tpu_torch.serialization import load_weights
from bcnn_tpu_torch.types import Mode

from tests.test_cli_detection import CONF as DET_CONF
from tests.test_data import write_mnist
from tests.test_torch_data import pin_port_bip

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = re.compile(r"-?\d+\.\d+|-?\d+|nan")


@pytest.fixture(scope="module", autouse=True)
def same_backend():
    """Both CLIs augment on one host image backend: bcnn_tpu.bip's."""
    yield from pin_port_bip()


def init_model(conf, path):
    """bcnn_tpu's initial weights of the conf's net, as a .bcnnmodel."""
    net = JNet(JMode.TRAIN)
    jload_net(net, str(conf))
    p, s = jinit_params(net, 0)
    jsave_weights(net, {k: np.asarray(v) for k, v in p.items()},
                  {k: np.asarray(v) for k, v in s.items()}, str(path))


def run_both(tmp_path, monkeypatch, capsys, conf_text, argv):
    """Run argv (with {conf} and {dir}) through both CLIs, each in its
    own directory; returns {"jax"|"port": (stderr, dir)}."""
    out = {}
    for tag, fn in (("jax", jmain), ("port", main)):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        conf = d / "net.conf"
        conf.write_text(conf_text.replace("{dir}", str(d)))
        monkeypatch.chdir(d)
        args = [a.replace("{conf}", str(conf)).replace("{dir}", str(d))
                for a in argv]
        capsys.readouterr()
        kw = {} if tag == "jax" else {"device": "cpu"}
        assert fn(args, **kw) == 0
        out[tag] = (capsys.readouterr().err, d)
    return out


def numbers(err, prefix):
    return [[float(v) for v in NUM.findall(ln.split(prefix, 1)[1])]
            for ln in err.splitlines() if prefix in ln]


def assert_same_lines(out, prefix, rtol=1e-4, atol=1e-5):
    a = numbers(out["port"][0], prefix)
    b = numbers(out["jax"][0], prefix)
    assert len(a) == len(b) > 0, prefix
    for x, y in zip(a, b):
        if prefix == "iter-batches=":
            x, y = x[:-1], y[:-1]  # training-time: the seconds differ
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol, err_msg=prefix)


def saved(conf, path):
    net = Net(Mode.TRAIN)
    load_net(net, str(conf))
    p, s = init_params(net, 0)
    load_weights(net, p, s, str(path))
    return p, s


def assert_same_model(conf, init, a, b):
    p0, _ = saved(conf, init)
    pa, sa = saved(conf, a)
    pb, sb = saved(conf, b)
    moved = 0
    for k, v0 in p0.items():
        du_a, du_b = pa[k] - v0, pb[k] - v0
        scale = float(du_b.abs().max())
        moved += scale > 0
        np.testing.assert_allclose(du_a.numpy(), du_b.numpy(), rtol=0,
                                   atol=1e-3 * scale, err_msg=k)
    assert moved > 0
    for k in sb:
        np.testing.assert_allclose(sa[k].numpy(), sb[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------- detection #


def det_files(tmp_path):
    lines = []
    for i in range(2):
        img = np.full((48, 64, 3), 30 * (i + 1), np.uint8)
        img[10:30, 20:40] = 220
        p = tmp_path / f"im{i}.png"
        bip.write_image(str(p), img)
        lines.append(f"{p} 0 0.47 0.42 0.31 0.42")
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(lines) + "\n")
    text = DET_CONF.format(lst=lst).replace(
        "[network]", f"[network]\ninput_model={tmp_path / 'init.bcnnmodel'}"
        "\noutput_model={dir}/out.bcnnmodel")
    (tmp_path / "det.conf").write_text(text)
    init_model(tmp_path / "det.conf", tmp_path / "init.bcnnmodel")
    return text


def test_cli_detection_matches_bcnn_tpu(tmp_path, monkeypatch, capsys):
    text = det_files(tmp_path)
    out = run_both(tmp_path, monkeypatch, capsys, text, ["train", "{conf}"])
    assert_same_lines(out, "Yolo Avg IOU:")
    assert_same_lines(out, "Training ended, final error=")
    assert_same_model(tmp_path / "det.conf", tmp_path / "init.bcnnmodel",
                      out["port"][1] / "out.bcnnmodel",
                      out["jax"][1] / "out.bcnnmodel")

    out = run_both(tmp_path, monkeypatch, capsys, text,
                   ["valid", "{conf}", "{dir}/out.bcnnmodel"])
    assert_same_lines(out, "Average error=")
    assert_same_lines(out, "mAP@0.5=", rtol=0, atol=1e-3)
    for tag in out:
        d = out[tag][1]
        for b in range(2):  # valid with out_pred dumps the detections
            img = bip.load_image(str(d / f"det_{b}.png"))
            assert img.shape == (64, 64, 3)
            assert (img[:, :, 1] == 255).any()  # the truth box, green


def test_cli_detection_predict_and_scan_steps(tmp_path, monkeypatch,
                                              capsys):
    """predict dumps det_*.png; scan_steps=2 (eval and saves aligned)
    trains the same steps as the per-step loop."""
    text = det_files(tmp_path).replace("max_batches=3", "max_batches=4")
    models = {}
    for tag, extra in (("seq", ""), ("scan", "scan_steps=2\n")):
        d = tmp_path / tag
        d.mkdir()
        conf = d / "net.conf"
        conf.write_text(text.replace("{dir}", str(d)).replace(
            "eval_period=10", "eval_period=2").replace(
            "save_model=100", "save_model=2").replace(
            "[network]", "[network]\n" + extra))
        monkeypatch.chdir(d)
        assert main(["train", str(conf)], device="cpu") == 0
        models[tag] = (conf, d / "out.bcnnmodel")
    assert load_cli_param(str(models["scan"][0])).scan_steps == 2
    assert os.path.exists(tmp_path / "scan" / "out.bcnnmodel_iter2.bcnnmodel")
    pa, sa = saved(*models["seq"])
    pb, sb = saved(*models["scan"])
    for k in pa:
        torch.testing.assert_close(pa[k], pb[k], rtol=1e-6, atol=1e-7)
    err = capsys.readouterr().err
    assert err.count("Yolo Avg IOU:") == 8  # one head, 4 steps, 2 runs

    monkeypatch.chdir(tmp_path / "seq")
    for f in ("det_0.png", "det_1.png"):
        (tmp_path / "seq" / f).unlink(missing_ok=True)
    assert main(["predict", str(models["seq"][0]), str(models["seq"][1])],
                device="cpu") == 0
    assert os.path.exists(tmp_path / "seq" / "det_0.png")
    assert os.path.exists(tmp_path / "seq" / "det_1.png")


def test_cli_export_raises(tmp_path):
    """--out and --detect belong to export: another mode refuses them,
    as bcnn_tpu's CLI does (`ap.error`)."""
    text = det_files(tmp_path).replace("{dir}", str(tmp_path))
    (tmp_path / "x.conf").write_text(text)
    for argv in (["train", "--detect"], ["predict", "--out", "a.pt2"]):
        with pytest.raises(SystemExit):
            main([argv[0], str(tmp_path / "x.conf"), *argv[1:]],
                 device="cpu")


@pytest.mark.parametrize("detect", [False, True], ids=["forward", "detect"])
def test_cli_export_serves(tmp_path, monkeypatch, detect):
    """bcnn-cl export writes <output_model>.pt2 (or --out); the loaded
    file equals the live Session of the same conf bit for bit: the heads
    of the forward, or the detect program's three outputs."""
    from bcnn_tpu_torch import Session, deploy

    text = det_files(tmp_path).replace("{dir}", str(tmp_path))
    conf = tmp_path / "x.conf"
    conf.write_text(text)  # its input_model is bcnn_tpu's init weights
    monkeypatch.chdir(tmp_path)
    argv = ["export", str(conf)] + (["--detect", "--out", "d.pt2"]
                                    if detect else [])
    assert main(argv, device="cpu") == 0
    path = tmp_path / ("d.pt2" if detect else "out.bcnnmodel.pt2")
    served = deploy.load_exported(str(path))
    net = Net(Mode.PREDICT)
    load_net(net, str(conf), str(tmp_path / "init.bcnnmodel"))
    sess = Session(net, 0, device="cpu").compile_net()
    x = np.random.RandomState(0).rand(2, 3, 64, 64).astype(np.float32)
    if detect:
        live = sess.detect_on_batch(x)
    else:
        live, _ = sess.predict_on_batch(x, outputs=deploy.default_outputs(
            net))
    got = served(x)
    assert len(got) == len(live)
    for g, w in zip(got, live):
        assert torch.equal(g, w)


def test_cli_export_failed_returns_1(tmp_path, capsys):
    """--detect on a net without YOLO layers: "export failed", exit 1."""
    text = mnist_recipe(tmp_path)
    (tmp_path / "m.conf").write_text(text.replace("{dir}", str(tmp_path)))
    assert main(["export", str(tmp_path / "m.conf"), "--detect", "--out",
                 str(tmp_path / "m.pt2")], device="cpu") == 1
    assert "export failed" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "m.pt2")


# -------------------------------------------------------------- MNIST #


def mnist_recipe(tmp_path, max_batches=12):
    """examples/mnist_cl/mnist.conf with its data on small idx files, a
    short run, and bcnn_tpu's initial weights."""
    ti, tl, _, _ = write_mnist(tmp_path, n=96, seed=0, name="train")
    vi, vl, _, _ = write_mnist(tmp_path, n=48, seed=9, name="t10k")
    text = open(os.path.join(REPO, "examples", "mnist_cl",
                             "mnist.conf")).read()
    for a, b in (
        ("#input_model=", f"input_model={tmp_path / 'init.bcnnmodel'}"),
        ("output_model=mnist.bcnnmodel", "output_model={dir}/m.bcnnmodel"),
        ("out_pred=./pred_mnist.txt", "out_pred={dir}/pred.txt"),
        ("eval_period=500", "eval_period=6"),
        ("save_model=10000", "save_model=6"),
        ("num_pred=4096", "num_pred=32"),
        ("max_batches=200000", f"max_batches={max_batches}"),
        ("source_train=./train-images.idx3-ubyte", f"source_train={ti}"),
        ("label_train=train-labels.idx1-ubyte", f"label_train={tl}"),
        ("source_test=t10k-images.idx3-ubyte", f"source_test={vi}"),
        ("label_test=t10k-labels.idx1-ubyte", f"label_test={vl}"),
    ):
        assert a in text, a
        text = text.replace(a, b)
    (tmp_path / "mnist.conf").write_text(text)
    init_model(tmp_path / "mnist.conf", tmp_path / "init.bcnnmodel")
    return text


def test_cli_mnist_recipe_matches_bcnn_tpu(tmp_path, monkeypatch, capsys):
    text = mnist_recipe(tmp_path)
    out = run_both(tmp_path, monkeypatch, capsys, text, ["train", "{conf}"])
    assert_same_lines(out, "iter-batches=")
    assert_same_lines(out, "Training ended, final error=")
    for name in ("m.bcnnmodel", "m.bcnnmodel_iter6.bcnnmodel"):
        assert_same_model(tmp_path / "mnist.conf",
                          tmp_path / "init.bcnnmodel",
                          out["port"][1] / name, out["jax"][1] / name)

    out = run_both(tmp_path, monkeypatch, capsys, text,
                   ["valid", "{conf}", "{dir}/m.bcnnmodel"])
    assert_same_lines(out, "Average error=")
    rows = {tag: np.loadtxt(out[tag][1] / "pred.txt") for tag in out}
    assert rows["port"].shape == (32, 10)
    np.testing.assert_allclose(rows["port"], rows["jax"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(rows["port"].sum(1), 1.0, atol=1e-4)


def test_cli_mnist_scan_steps_match_the_per_step_loop(tmp_path,
                                                      monkeypatch):
    text = mnist_recipe(tmp_path, max_batches=12)
    models = {}
    for tag, extra in (("seq", ""), ("scan", "scan_steps=3\n")):
        d = tmp_path / tag
        d.mkdir()
        conf = d / "net.conf"
        conf.write_text(text.replace("{dir}", str(d)).replace(
            "[network]", "[network]\n" + extra).replace(
            "eval_test=1", "eval_test=0"))
        monkeypatch.chdir(d)
        assert main(["train", str(conf)], device="cpu") == 0
        models[tag] = (conf, d / "m.bcnnmodel")
    pa, _ = saved(*models["seq"])
    pb, _ = saved(*models["scan"])
    for k in pa:  # the same 12 steps on the same batches
        torch.testing.assert_close(pa[k], pb[k], rtol=1e-6, atol=1e-7)
