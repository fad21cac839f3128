"""The port's weight files (`bcnn_tpu_torch.serialization`) held to
`bcnn_tpu.serialization`: a `.bcnnmodel` or Darknet `.weights` file that
`bcnn_tpu` writes loads into the port as equal params and state (the BN
fold in PREDICT included); the port writes the same bytes for the same
params; the Darknet header's versions (u64 or u32 `seen`, the
transposed-era FC) read alike; broken files raise alike; the PReLU
slope slots; `Session.load_weights` / `save_weights`."""

import struct

import numpy as np
import pytest
import torch

import bcnn_tpu as bt
from bcnn_tpu import serialization as jser
from bcnn_tpu.models import mobilenet_v1 as jax_mobilenet
from bcnn_tpu.models import yolov3_tiny as jax_tiny

import bcnn_tpu_torch as pt
from bcnn_tpu_torch import Session
from bcnn_tpu_torch import serialization as tser
from bcnn_tpu_torch.models import mobilenet_v1, yolov3_tiny
from bcnn_tpu_torch.types import Mode
from tests.test_torch_config import weight_perm

torch.set_num_threads(1)


def zoo(pkg, mode):
    """Every layer with a weight blob: conv + BN, conv + bias, depthwise,
    deconv, a standalone BN, FC."""
    net = pkg.Net(pkg.Mode(int(mode)))
    net.set_input_shape(8, 8, 3, 2)
    if mode != Mode.PREDICT:
        net.set_sgd_optimizer(0.01, 0.9)
    A, F = pkg.Activation, pkg.FillerType
    net.add_convolutional_layer(6, 3, 1, 1, 1, 1, F.XAVIER, A.LRELU, 0,
                                "input", "c1")
    net.add_depthwise_conv_layer(3, 2, 1, 0, F.XAVIER, A.RELU, "c1", "d1")
    net.add_deconvolutional_layer(4, 2, 2, 0, F.XAVIER, A.NONE, "d1", "u1")
    net.add_convolutional_layer(8, 1, 1, 0, 2, 0, F.MSRA, A.NONE, 0, "u1",
                                "c2")
    net.add_batchnorm_layer("c2", "bn")
    net.add_fullc_layer(5, F.XAVIER, A.NONE, 0, "bn", "fc")
    return net


NETS = {
    "tiny": (lambda m: jax_tiny(2, 64, 64, 4, mode=bt.Mode(int(m))),
             lambda m: yolov3_tiny(2, 64, 64, 4, mode=m)),
    "mobilenet": (lambda m: jax_mobilenet(2, 10, width_mult=0.25),
                  lambda m: mobilenet_v1(2, 10, width_mult=0.25)),
    "zoo": (lambda m: zoo(bt, m), lambda m: zoo(pt, m)),
}
CASES = [("tiny", Mode.PREDICT), ("tiny", Mode.TRAIN),
         ("mobilenet", Mode.PREDICT), ("zoo", Mode.PREDICT),
         ("zoo", Mode.TRAIN)]
EXT = {"bcnn": ".bcnnmodel", "darknet": ".weights"}


def random_numpy(jnet, seed=0):
    """(params, state) in bcnn_tpu's layout from a numpy seed; running
    variances positive."""
    rng = np.random.RandomState(seed)
    params, state = {}, {}
    for t in jnet.tensors:
        if t.key is None:
            continue
        shape = tuple(t.mem_shape)
        if t.key.endswith("run_var"):
            state[t.key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif t.key.endswith("run_mean"):
            state[t.key] = rng.uniform(-0.2, 0.2, shape).astype(np.float32)
        else:
            params[t.key] = rng.normal(0, 0.5, shape).astype(np.float32)
    return params, state


def to_port(net, arrays):
    perm = weight_perm(net)
    return {k: torch.from_numpy(np.ascontiguousarray(
        np.asarray(v).transpose(perm[k]) if k in perm else np.asarray(v)))
        for k, v in arrays.items()}


def setup(name, mode):
    jnet, net = NETS[name][0](mode), NETS[name][1](mode)
    p_np, s_np = random_numpy(jnet)
    return jnet, net, p_np, s_np


def write_jax(fmt, jnet, p_np, s_np, path):
    if fmt == "bcnn":
        jser.save_weights(jnet, p_np, s_np, path)
    else:
        jser.save_weights_darknet(jnet, p_np, s_np, path, seen=77)


def load_both(jnet, net, path, p_np, s_np):
    """bcnn_tpu's load (in the port's layout) and the port's, each into
    its own copy of the same starting values."""
    jp, js = dict(p_np), dict(s_np)
    jser.load_weights(jnet, jp, js, path)
    tp, ts = to_port(net, p_np), to_port(net, s_np)
    tser.load_weights(net, tp, ts, path)
    return (to_port(net, jp), to_port(net, js)), (tp, ts)


def assert_tables_equal(want, got):
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == torch.float32
            assert torch.equal(g[k], w[k]), k


@pytest.mark.parametrize("fmt", list(EXT))
@pytest.mark.parametrize("name,mode", CASES)
def test_bcnn_tpu_file_loads_equal(tmp_path, name, mode, fmt):
    jnet, net, p_np, s_np = setup(name, mode)
    path = str(tmp_path / f"m{EXT[fmt]}")
    write_jax(fmt, jnet, p_np, s_np, path)
    want, got = load_both(jnet, net, path, p_np, s_np)
    assert_tables_equal(want, got)
    assert net.bn_folded == jnet.bn_folded == (mode == Mode.PREDICT)


@pytest.mark.parametrize("fmt", list(EXT))
@pytest.mark.parametrize("name,mode", CASES)
def test_port_writes_the_same_bytes(tmp_path, name, mode, fmt):
    jnet, net, p_np, s_np = setup(name, mode)
    ref, got = str(tmp_path / f"r{EXT[fmt]}"), str(tmp_path / f"p{EXT[fmt]}")
    write_jax(fmt, jnet, p_np, s_np, ref)
    tp, ts = to_port(net, p_np), to_port(net, s_np)
    if fmt == "bcnn":
        tser.save_weights(net, tp, ts, got)
    else:
        tser.save_weights_darknet(net, tp, ts, got, seen=77)
    with open(ref, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


def test_bn_fold_is_bcnn_tpus():
    """b - s*m / sqrt(v + 1e-6) and s / sqrt(v + 1e-6), bit for bit."""
    rng = np.random.RandomState(3)
    b, s, m = (rng.normal(0, 1, 64).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.0, 2.0, 64).astype(np.float32)
    for w, g in zip(jser._fold_bn(b, s, m, v), tser._fold_bn(b, s, m, v)):
        np.testing.assert_array_equal(g, w)
    assert tser.BN_FOLD_EPS == jser.BN_FOLD_EPS == 1e-6


def _header_variant(src, dst, version, seen_fmt):
    with open(src, "rb") as f:
        f.read(12 + 8)
        body = f.read()
    with open(dst, "wb") as f:
        f.write(struct.pack("<3i", *version))
        f.write(struct.pack(seen_fmt, 5))
        f.write(body)


@pytest.mark.parametrize("version,seen_fmt", [
    ((0, 2, 0), "<Q"), ((0, 1, 0), "<i"), ((1, 0, 0), "<Q"),
    ((1001, 0, 0), "<i"), ((0, 1001, 0), "<i"),
], ids=["v0.2-u64", "v0.1-u32", "v1.0-u64", "transposed-major",
        "transposed-minor"])
def test_darknet_headers_read_alike(tmp_path, version, seen_fmt):
    """The seen counter is u64 from version 0.2 on, else u32; a major or
    minor above 1000 marks a transposed-era file, whose FC weights are
    (in, out)."""
    jnet, net, p_np, s_np = setup("zoo", Mode.PREDICT)
    base, path = str(tmp_path / "b.weights"), str(tmp_path / "v.weights")
    jser.save_weights_darknet(jnet, p_np, s_np, base)
    _header_variant(base, path, version, seen_fmt)
    want, got = load_both(jnet, net, path, p_np, s_np)
    assert_tables_equal(want, got)
    fc = net.tensors[net.nodes[-1].src[1]].key
    plain = load_both(jnet, net, base, p_np, s_np)[1][0]
    assert torch.equal(got[0][fc], plain[fc]) == (max(version) <= 1000)


@pytest.mark.parametrize("name", ["model.weights", "model.bcnnmodel",
                                  "model.onnx", "model", "a.b.weights",
                                  "weights"])
def test_model_find_format_equal(name):
    assert tser.model_find_format(name) == jser.model_find_format(name)


@pytest.mark.parametrize("cut,fmt", [(7, "bcnn"), (1000, "bcnn"),
                                     (40, "darknet"), (999, "darknet")])
def test_truncated_files_raise_alike(tmp_path, cut, fmt):
    jnet, net, p_np, s_np = setup("zoo", Mode.PREDICT)
    path = str(tmp_path / f"m{EXT[fmt]}")
    write_jax(fmt, jnet, p_np, s_np, path)
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:cut] if cut > 100 else data[:-cut])
    with pytest.raises(ValueError) as ref:
        jser.load_weights(jnet, dict(p_np), dict(s_np), path)
    with pytest.raises(ValueError) as port:
        tser.load_weights(net, to_port(net, p_np), to_port(net, s_np), path)
    assert str(port.value) == str(ref.value)


def test_bad_magic_and_onnx_raise(tmp_path):
    _, net, p_np, s_np = setup("zoo", Mode.PREDICT)
    path = tmp_path / "m.bcnnmodel"
    path.write_bytes(b"XXXX" + bytes(64))
    with pytest.raises(ValueError, match="Invalid format"):
        tser.load_weights(net, {}, {}, str(path))
    with pytest.raises(NotImplementedError, match="onnx"):
        tser.load_weights(net, {}, {}, str(tmp_path / "m.onnx"))


def prelu_net(pkg, mode, where):
    """A BN conv with PReLU (slopes at src[6]), a plain conv with PReLU
    (src[3]), or a conv and a standalone PReLU activation."""
    net = pkg.Net(pkg.Mode(int(mode)))
    net.set_input_shape(8, 8, 3, 2)
    if mode != Mode.PREDICT:
        net.set_sgd_optimizer(0.01, 0.9)
    A, F = pkg.Activation, pkg.FillerType
    conv_act = A.PRELU if where != "activation" else A.RELU
    net.add_convolutional_layer(4, 3, 1, 1, 1, int(where != "conv_nobn"),
                                F.XAVIER, conv_act, 0, "input", "c1")
    if where == "activation":
        net.add_activation_layer(A.PRELU, "c1")
    net.add_convolutional_layer(2, 1, 1, 0, 1, 0, F.XAVIER, A.PRELU, 0,
                                "c1", "c2")
    return net


@pytest.mark.parametrize("mode", [Mode.PREDICT, Mode.TRAIN],
                         ids=["predict", "train"])
@pytest.mark.parametrize("where", ["conv", "activation", "conv_nobn"])
def test_prelu_slots_raise(tmp_path, where, mode):
    """Ported since: the PReLU slope slots (a conv's after its weights and
    BN, in both formats; a standalone activation's in .bcnnmodel only),
    read and written byte-identical to bcnn_tpu; a Session round trip
    keeps the slopes."""
    jnet, net = prelu_net(bt, mode, where), prelu_net(pt, mode, where)
    p_np, s_np = random_numpy(jnet)
    slopes = [k for k in p_np if "prelu" in k]  # c1_w_prelu standalone
    assert len(slopes) == 2
    for fmt in EXT:
        ref = str(tmp_path / f"r{EXT[fmt]}")
        got = str(tmp_path / f"p{EXT[fmt]}")
        write_jax(fmt, jnet, p_np, s_np, ref)
        tp, ts = to_port(net, p_np), to_port(net, s_np)
        save = tser.save_weights if fmt == "bcnn" else (
            lambda *a: tser.save_weights_darknet(*a, seen=77))
        save(net, tp, ts, got)
        with open(ref, "rb") as a, open(got, "rb") as b:
            assert a.read() == b.read(), fmt
        zero = {k: (np.zeros_like(v) if k in slopes else v)
                for k, v in p_np.items()}
        want, have = load_both(jnet, net, ref, zero, s_np)
        assert_tables_equal(want, have)
        for k in slopes:  # read back, but for a standalone .weights slope
            standalone = k.endswith("_w_prelu")
            assert torch.equal(have[0][k], torch.from_numpy(
                zero[k] if fmt == "darknet" and standalone else p_np[k])), k
    sess = Session(net, 0, device="cpu").compile_net()
    sess.params = dict(to_port(net, p_np))
    sess.save_weights(str(tmp_path / "s.bcnnmodel"))
    back = Session(net, 1, device="cpu").compile_net().load_weights(
        str(tmp_path / "s.bcnnmodel"))
    for k in slopes:
        assert torch.equal(back.params[k], sess.params[k]), k


@pytest.mark.parametrize("fmt", list(EXT))
def test_session_load_weights_serves_bcnn_tpus_file(tmp_path, fmt):
    """Session.load_weights after compile_net: the forward equals
    bcnn_tpu's Session after its load_weights of the same file, and
    save_weights writes back the bytes bcnn_tpu writes."""
    jnet, net, p_np, s_np = setup("tiny", Mode.PREDICT)
    path = str(tmp_path / f"m{EXT[fmt]}")
    write_jax(fmt, jnet, p_np, s_np, path)
    js = bt.Session(jnet, 0).compile_net().load_weights(path)
    ts = Session(net, 9, device="cpu").compile_net().load_weights(path)
    x = np.random.RandomState(4).rand(2, 3, 64, 64).astype(np.float32)
    (want,), _ = js.predict_on_batch(x, outputs=["lid16"])
    (got,), _ = ts.predict_on_batch(x, outputs=["lid16"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    ref, mine = str(tmp_path / "r.bcnnmodel"), str(tmp_path / "p.bcnnmodel")
    js.save_weights(ref)
    ts.save_weights(mine)
    with open(ref, "rb") as a, open(mine, "rb") as b:
        assert a.read() == b.read()


def test_session_round_trip_in_train_mode(tmp_path):
    """TRAIN keeps the BN constants as they are: save, load into a fresh
    session, equal tensors."""
    net = yolov3_tiny(2, 64, 64, 4, mode=Mode.TRAIN)
    a = Session(net, 1, device="cpu").compile_net()
    path = str(tmp_path / "t.bcnnmodel")
    a.save_weights(path)
    net2 = yolov3_tiny(2, 64, 64, 4, mode=Mode.TRAIN)
    b = Session(net2, 2, device="cpu").compile_net().load_weights(path)
    assert not net2.bn_folded
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for k in a.state:
        assert torch.equal(a.state[k], b.state[k]), k


def test_load_weights_lands_on_the_params_device_or_the_card(tmp_path):
    """Without `device`, the weights land where the params given lie (a
    Session's device: the CPU here); with no params to follow they go to
    the card, and where there is none that raises rather than loading to
    the CPU. device="cpu" asks for the CPU."""
    jnet, net, p_np, s_np = setup("zoo", Mode.TRAIN)
    path = str(tmp_path / "m.bcnnmodel")
    jser.save_weights(jnet, p_np, s_np, path)
    tp, ts = to_port(net, p_np), to_port(net, s_np)
    tser.load_weights(net, tp, ts, path)
    assert all(v.device.type == "cpu" for v in (*tp.values(), *ts.values()))
    # a net without a standalone BN (the one layer that reads a param it
    # is not given) loads from nothing: onto the CPU when asked
    jnet2, net2 = jax_tiny(2, 64, 64, 4), yolov3_tiny(2, 64, 64, 4)
    p2, s2 = random_numpy(jnet2)
    path2 = str(tmp_path / "t.bcnnmodel")
    jser.save_weights(jnet2, p2, s2, path2)
    p, s = tser.load_weights(net2, {}, {}, path2, device="cpu")
    assert set(p) == {t.key for t in net2.param_specs()}
    assert all(v.device.type == "cpu" for v in (*p.values(), *s.values()))
    if torch.cuda.is_available():
        return  # the no-params load below goes to the card
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tser.load_weights(net2, {}, {}, path2)
