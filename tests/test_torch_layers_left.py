"""The float layers the port trains beyond YOLOv3's and MobileNet-v1's,
against bcnn_tpu on the CPU: the deconv (fp32, bf16 and the reference's padded
quirk), LRN, dropout (bcnn_tpu's mask handed to the port), PReLU (its
update and a weight file read by both packages), the lifted-structure
loss (the op, and bcnn-cl train on examples/lifted_structure_loss/
lifted_structure.conf fed a seeded classification list), bf16 training
through FC and depthwise (the ops' roundings, and MobileNet-v1 at width
0.25), on the same numpy-made inputs.

Tolerances:
  - fp32 ops, forward and gradient: rtol 1e-5 of each tensor's largest
    entry (sums taken in another order); LRN runs bcnn_tpu's sequence of
    adds and subtracts, but XLA contracts each a*sq with the running sum
    into one fused multiply-add, which PyTorch's CPU kernels do not (up
    to 127 ulp apart where k = 0 lets the sum cancel);
  - bf16 deconv and depthwise: forward rtol 1e-5 (an fp32 sum of exact
    products), gradients within 2^-7 of their largest entry (one bf16
    rounding of the transposed convs' outputs); the bf16 FC's gradients
    bit for bit (JAX rounds the fp32 products of the cotangent to bf16,
    and so does the port);
  - net gradients: 1e-4 of each tensor's largest (tests/test_torch_losses
    .py); SGD updates within 1e-3 of each tensor's largest update;
  - MobileNet-v1 bf16 + act16: tests/test_torch_train_bf16.py's
    per-tensor gate;
  - the CLI: tests/test_torch_cli.py's (printed losses rtol 1e-4; each
    parameter's total update within 1e-3 of its largest entry)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcnn_tpu as bt
from bcnn_tpu import learner as jlearner
from bcnn_tpu import ops as jops
from bcnn_tpu import serialization as jser
from bcnn_tpu.compile import execute as jexecute
from bcnn_tpu.compile import make_train_step as jax_make_train_step
from bcnn_tpu.models import mobilenet_v1 as jmobilenet
from bcnn_tpu.ops import lifted_struct as jlifted
from bcnn_tpu.ops.conv import conv2d_transpose_ref_quirk as jquirk

import bcnn_tpu_torch as pt
from bcnn_tpu_torch import Session, bip, bridge, ops
from bcnn_tpu_torch.compile import execute, get_loss
from bcnn_tpu_torch.learner import apply_updates, init_opt_state
from bcnn_tpu_torch.models import mobilenet_v1
from bcnn_tpu_torch.ops.conv import conv2d_transpose_ref_quirk
from bcnn_tpu_torch.ops.lifted_struct import lifted_struct_surrogate
from bcnn_tpu_torch.types import LayerType, Mode
from tests.test_torch_cli import (REPO, assert_same_lines, init_model,
                                  run_both, saved)
from tests.test_torch_train_bf16 import (COS_GAP, NOISE_RATIO, RMS_GAP,
                                         grad_gaps)

torch.set_num_threads(1)

RTOL = 1e-5
BF16_TOL = 2.0**-7


def nchw(a):
    return np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))


def nhwc(a):
    return np.transpose(np.asarray(a, np.float32), (0, 2, 3, 1))


def close(got, ref, tol=RTOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


# ------------------------------------------------------------- deconv #

DECONV = [(2, 2, 0), (3, 2, 1), (4, 2, 1), (3, 1, 1)]


def deconv_case(k, stride, pad, seed=0):
    rng = np.random.RandomState(seed + 10 * k + stride)
    x = rng.randn(2, 5, 6, 7).astype(np.float32)
    w = (rng.randn(5, 3, k, k) * 0.3).astype(np.float32)  # (C, O, k, k)
    return x, w


def jax_deconv_vjp(fn, x, w):
    """fn(x NHWC, w (k,k,O,C)) -> (y NCHW, vjp in the port's layouts)."""
    y, vjp = jax.vjp(fn, jnp.asarray(nhwc(x)),
                     jnp.asarray(np.transpose(w, (2, 3, 1, 0))))

    def back(g):
        dx, dw = vjp(jnp.asarray(nhwc(g)))
        return nchw(dx), np.transpose(np.asarray(dw, np.float32),
                                      (3, 2, 0, 1))

    return nchw(y), back


def port_vjp(fn, x, w, g):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = fn(xt, wt)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("k,stride,pad", DECONV)
def test_deconv_fp32_matches_bcnn_tpu(k, stride, pad):
    x, w = deconv_case(k, stride, pad)
    yj, back = jax_deconv_vjp(
        lambda a, b: jops.conv2d_transpose(a, b, stride, pad), x, w)
    assert yj.shape[2] == stride * (6 - 1) + k - 2 * pad
    g = np.random.RandomState(1).randn(*yj.shape).astype(np.float32)
    y, dx, dw = port_vjp(
        lambda a, b: ops.conv2d_transpose(a, b, stride, pad), x, w, g)
    for got, ref in zip((y, dx, dw), (yj,) + back(g)):
        close(got, ref)


@pytest.mark.parametrize("k,stride,pad", DECONV)
def test_deconv_bf16_matches_bcnn_tpu(k, stride, pad):
    """compute_dtype bf16: bcnn_tpu's _convt_mixed and its VJP (the
    cotangent to bf16, both transposed convs in bf16, dx and dw back to
    the inputs' dtypes)."""
    x, w = deconv_case(k, stride, pad, seed=3)
    yj, back = jax_deconv_vjp(
        lambda a, b: jops.conv2d_transpose(a, b, stride, pad, jnp.bfloat16),
        x, w)
    g = np.random.RandomState(2).randn(*yj.shape).astype(np.float32)
    y, dx, dw = port_vjp(
        lambda a, b: ops.conv2d_transpose(a, b, stride, pad, torch.bfloat16),
        x, w, g)
    close(y, yj)
    for got, ref in zip((dx, dw), back(g)):
        close(got, ref, BF16_TOL)


@pytest.mark.parametrize("k,stride,pad", [(3, 2, 1), (4, 2, 1), (3, 1, 1),
                                          (2, 2, 0)])
def test_deconv_ref_quirk_matches_bcnn_tpu(k, stride, pad):
    """The reference's misread col2im (pad > 0) as bcnn_tpu replicates it,
    forward and the gradient of that forward; at pad 0 it is the true
    transpose conv."""
    x, w = deconv_case(k, stride, pad, seed=5)
    yj, back = jax_deconv_vjp(lambda a, b: jquirk(a, b, stride, pad), x, w)
    g = np.random.RandomState(3).randn(*yj.shape).astype(np.float32)
    y, dx, dw = port_vjp(
        lambda a, b: conv2d_transpose_ref_quirk(a, b, stride, pad), x, w, g)
    for got, ref in zip((y, dx, dw), (yj,) + back(g)):
        close(got, ref)
    if pad == 0:
        close(y, ops.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(
            w), stride, pad).numpy())


def deconv_net(pkg, mode, batch=2):
    """conv -> deconv (pad 1) -> LRN -> dropout -> conv with PReLU ->
    standalone PReLU -> FC -> softmax -> euclidean cost, in either
    package."""
    net = pkg.Net(pkg.Mode(int(mode)))
    net.set_input_shape(8, 8, 3, batch)
    if mode != Mode.PREDICT:
        net.set_sgd_optimizer(0.01, 0.9)
        net.set_weight_regularizer(0.0005)
    A, F = pkg.Activation, pkg.FillerType
    net.add_convolutional_layer(6, 3, 2, 1, 1, 1, F.XAVIER, A.RELU, 0,
                                "input", "c1")
    net.add_deconvolutional_layer(5, 3, 2, 1, F.XAVIER, A.LRELU, "c1", "d1")
    net.add_lrn_layer(3, 0.5, 0.75, 1.0, "d1", "n1")
    # the builder drops k (0, the reference's): the window's running sum
    # then cancels to 0 or below at some positions of this net, and both
    # packages give NaN there; AlexNet's k = 2 keeps it positive
    net.nodes[-1].param["k"] = 2.0
    net.add_dropout_layer(0.3, "n1")
    net.add_convolutional_layer(4, 3, 2, 1, 1, 0, F.XAVIER, A.PRELU, 0,
                                "n1", "c2")
    net.add_activation_layer(A.PRELU, "c2")
    net.add_fullc_layer(5, F.XAVIER, A.NONE, 0, "c2", "fc")
    net.add_softmax_layer("fc", "sm")
    net.add_cost_layer(pkg.Loss.EUCLIDEAN, pkg.Metric.SSE, 1.0, "sm",
                       "label", "cost")
    return net


def net_pair(quirk=False, bf16=False, seed=0):
    jnet, net = deconv_net(bt, Mode.TRAIN), deconv_net(pt, Mode.TRAIN)
    jnet.ref_deconv_quirk = net.ref_deconv_quirk = quirk
    if bf16:
        jnet.compute_dtype = jnet.train_act_dtype = jnp.bfloat16
        net.compute_dtype = net.train_act_dtype = torch.bfloat16
    p_np, s_np = bridge.he_numpy_weights(net, seed)
    return jnet, net, p_np, s_np


def net_batch(net, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    lab = np.zeros((2, 5), np.float32)
    lab[[0, 1], rng.randint(5, size=2)] = 1.0
    return x, lab


def jax_dropout_masks(jnet, rng_key, x, p_np, s_np):
    """bcnn_tpu's keep masks, drawn from the key its executor folds in
    for each dropout node (fold_in(rng, node index)), NCHW."""
    jex = jexecute(jnet, {k: jnp.asarray(v) for k, v in p_np.items()},
                   {k: jnp.asarray(v) for k, v in s_np.items()},
                   {"input": jnp.asarray(x)}, bt.Mode.PREDICT)
    out = {}
    for i, n in enumerate(jnet.nodes):
        if n.type == LayerType.DROPOUT:
            shape = jex.values[n.src[0]].shape
            keep = jax.random.uniform(jax.random.fold_in(rng_key, i),
                                      shape) >= n.param["rate"]
            out[i] = torch.from_numpy(np.ascontiguousarray(
                np.transpose(np.asarray(keep), (0, 3, 1, 2))))
    return out


@pytest.mark.parametrize("quirk", [False, True], ids=["deconv", "quirk"])
def test_layers_net_gradients_match_bcnn_tpu(quirk):
    """A TRAIN net through the deconv (true or quirk), LRN, dropout (with
    bcnn_tpu's mask), a conv PReLU and a standalone PReLU: the surrogate
    and every parameter's gradient, the slopes' included."""
    jnet, net, p_np, s_np = net_pair(quirk)
    x, lab = net_batch(net)
    key = jax.random.PRNGKey(4)
    masks = jax_dropout_masks(jnet, key, x, p_np, s_np)
    assert len(masks) == 1 and 0 < float(next(iter(masks.values())).float(
    ).mean()) < 1

    def jloss(p):
        return jexecute(jnet, p, {k: jnp.asarray(v) for k, v in s_np.items()},
                        {"input": jnp.asarray(x), "label": jnp.asarray(lab)},
                        bt.Mode.TRAIN, key).surrogate

    jsur, jg = jax.value_and_grad(jloss)(
        {k: jnp.asarray(v) for k, v in p_np.items()})
    params, state = bridge.params_from_numpy(net, p_np, s_np)
    specs = {t.key: t for t in net.param_specs()}
    leaves = {k: v.requires_grad_(specs[k].trainable)
              for k, v in params.items()}
    ex = execute(net, leaves, state, {"input": torch.from_numpy(x),
                                      "label": torch.from_numpy(lab)},
                 Mode.TRAIN, dropout_masks=masks)
    ex.surrogate.backward()
    np.testing.assert_allclose(float(ex.surrogate), float(jsur), rtol=1e-5)
    got = bridge.params_to_numpy(
        net, {k: v.grad for k, v in leaves.items() if v.grad is not None})
    assert "c2_w_prelu" in got
    for k, g in got.items():
        r = np.asarray(jg[k])
        assert np.abs(r).max() > 0, k
        close(g, r, 1e-4)


def test_layers_net_bf16_gradients_match_bcnn_tpu():
    """The same net at bf16 + act16 (the deconv through _convt_mixed, the
    FC's bf16 backward): every gradient within bf16's own noise, as
    tests/test_torch_train_bf16.py gates it."""
    jnet, net, p_np, s_np = net_pair(bf16=True)
    x, lab = net_batch(net, 2)
    key = jax.random.PRNGKey(5)
    masks = jax_dropout_masks(jnet, key, x, p_np, s_np)

    def jgrads():
        return jax.grad(lambda p: jexecute(
            jnet, p, {k: jnp.asarray(v) for k, v in s_np.items()},
            {"input": jnp.asarray(x), "label": jnp.asarray(lab)},
            bt.Mode.TRAIN, key).surrogate)(
            {k: jnp.asarray(v) for k, v in p_np.items()})

    ref = jgrads()
    jnet.compute_dtype = jnet.train_act_dtype = None
    ref32 = jgrads()
    params, state = bridge.params_from_numpy(net, p_np, s_np)
    specs = {t.key: t for t in net.param_specs()}
    leaves = {k: v.requires_grad_(specs[k].trainable)
              for k, v in params.items()}
    ex = execute(net, leaves, state, {"input": torch.from_numpy(x),
                                      "label": torch.from_numpy(lab)},
                 Mode.TRAIN, dropout_masks=masks)
    assert ex.values[net.get_tensor_index_by_name("d1")].dtype == (
        torch.bfloat16)
    ex.surrogate.backward()
    got = bridge.params_to_numpy(
        net, {k: v.grad for k, v in leaves.items() if v.grad is not None})
    gaps = grad_gaps({k: ref[k] for k in got}, got)
    noise = grad_gaps({k: ref32[k] for k in got},
                      {k: np.asarray(ref[k]) for k in got})
    for k, (cos_gap, rms_gap) in gaps.items():
        c, r = noise[k]
        if c <= 0.01 and r < 0.5:
            assert cos_gap <= COS_GAP and rms_gap < RMS_GAP, k
        else:
            assert cos_gap <= NOISE_RATIO * c, k
            assert rms_gap <= NOISE_RATIO * r, k


def test_layers_net_sgd_step_and_file_match_bcnn_tpu(tmp_path):
    """One SGD step of the net (bcnn_tpu's make_train_step; the port's
    forward, backward and update, bcnn_tpu's dropout mask handed over):
    the standalone PReLU slopes step
    by the SGD rule with lr divided by 1 (batch_div_one) and weight
    decay, the conv's slopes stay; then the stepped weights, written by
    the port as .bcnnmodel and .weights, read by bcnn_tpu equal."""
    jnet, net, p_np, s_np = net_pair()
    x, lab = net_batch(net, 3)
    key = jax.random.PRNGKey(6)
    masks = jax_dropout_masks(jnet, key, x, p_np, s_np)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    jp, js, _, jloss = jax_make_train_step(jnet)(
        jp, {k: jnp.asarray(v) for k, v in s_np.items()},
        jlearner.init_opt_state(jnet, jp),
        {"input": jnp.asarray(x), "label": jnp.asarray(lab)}, key)

    params, state = bridge.params_from_numpy(net, p_np, s_np)
    specs = {t.key: t for t in net.param_specs()}
    leaves = {k: v.detach().requires_grad_(specs[k].trainable)
              for k, v in params.items()}
    ex = execute(net, leaves, state, {"input": torch.from_numpy(x),
                                      "label": torch.from_numpy(lab)},
                 Mode.TRAIN, dropout_masks=masks)
    ex.surrogate.backward()
    params, _ = apply_updates(
        net, params, {k: v.grad for k, v in leaves.items()
                      if specs[k].trainable}, init_opt_state(net, params))
    state, loss = ex.state, get_loss(ex)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = bridge.params_to_numpy(net, params)
    for k, v in got.items():
        r, r0 = np.asarray(jp[k]), p_np[k]
        np.testing.assert_allclose(v - r0, r - r0, rtol=0,
                                   atol=1e-3 * np.abs(r - r0).max()
                                   + np.spacing(np.abs(r0).max()),
                                   err_msg=k)
    assert not np.array_equal(got["c2_w_prelu"], p_np["c2_w_prelu"])
    np.testing.assert_array_equal(got["n1_prelu_slopes"],
                                  p_np["n1_prelu_slopes"])

    for ext in (".bcnnmodel", ".weights"):
        path = str(tmp_path / f"m{ext}")
        if ext == ".bcnnmodel":
            pt.serialization.save_weights(net, params, state, path)
        else:
            pt.serialization.save_weights_darknet(net, params, state, path)
        jpp = {k: np.zeros_like(v) for k, v in p_np.items()}
        jss = {k: np.ones_like(v) for k, v in s_np.items()}
        jser.load_weights(deconv_net(bt, Mode.TRAIN), jpp, jss, path)
        for k, v in got.items():
            if ext == ".weights" and k == "c2_w_prelu":
                continue  # Darknet's format holds no standalone slopes
            np.testing.assert_array_equal(np.asarray(jpp[k]), v, err_msg=k)


# ---------------------------------------------------------------- LRN #

LRN = [(3, 8, 0.0), (5, 8, 0.0), (5, 7, 1.0), (1, 4, 0.0), (2, 5, 2.0),
       (5, 2, 1.0), (7, 3, 0.5)]


@pytest.mark.parametrize("ls,c,k", LRN)
def test_lrn_matches_bcnn_tpu(ls, c, k):
    """The quirky window in bcnn_tpu's order of adds and subtracts,
    degenerate C < window cases included; forward and gradient."""
    rng = np.random.RandomState(ls * 10 + c)
    x = (rng.randn(2, c, 4, 5) + 0.5).astype(np.float32)
    g = rng.randn(2, c, 4, 5).astype(np.float32)
    y, vjp = jax.vjp(lambda a: jops.lrn(a, ls, 0.3, 0.75, k),
                     jnp.asarray(nhwc(x)))
    (dx,) = vjp(jnp.asarray(nhwc(g)))
    xt = torch.from_numpy(x).requires_grad_()
    out = ops.lrn(xt, ls, 0.3, 0.75, k)
    out.backward(torch.from_numpy(g))
    for got, ref in ((out.detach().numpy(), nchw(y)),
                     (xt.grad.numpy(), nchw(dx))):
        # k = 0 (the reference's builder drops k): where the window's sum
        # is 0 both give inf or nan, and where it cancels the two orders
        # of rounding part by up to 1e-5 of the value itself
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
        fin = np.isfinite(ref)
        if fin.any():
            np.testing.assert_allclose(
                got[fin], ref[fin], rtol=1e-4 if k == 0 else 0,
                atol=RTOL * np.abs(ref[fin]).max())


def test_bf16_constants_made_in_inference_serve_training():
    """A bf16 constant (`activations.weak`, cached) first made while
    serving under inference mode then takes part in a training backward:
    LRN on bf16 activations, whose a = alpha / size is LRELU's 0.1."""
    from bcnn_tpu_torch.ops.activations import _weak_tensor
    from bcnn_tpu_torch.types import Activation

    _weak_tensor.cache_clear()
    x = torch.randn(1, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        ops.apply_activation(x.to(torch.bfloat16), Activation.LRELU)
    xt = (x + 2).to(torch.bfloat16).requires_grad_()
    ops.lrn(xt, 5, 0.5, 0.75, 2.0).sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad.float()).all()


# ------------------------------------------------------------ dropout #


def test_dropout_generator_repeats_under_one_seed():
    """The port's masks come from a generator seeded per node from the
    pass's seed: one seed gives one mask, another seed another, the keep
    share is about 1 - rate, and the survivors are scaled by
    1 / (1 - rate)."""
    _, net, p_np, s_np = net_pair()
    x, lab = net_batch(net)
    params, state = bridge.params_from_numpy(net, p_np, s_np)
    inputs = {"input": torch.from_numpy(x), "label": torch.from_numpy(lab)}
    a = execute(net, params, state, inputs, Mode.TRAIN, seed=7)
    b = execute(net, params, state, inputs, Mode.TRAIN, seed=7)
    c = execute(net, params, state, inputs, Mode.TRAIN, seed=8)
    (pos,) = a.dropout_masks
    assert torch.equal(a.dropout_masks[pos], b.dropout_masks[pos])
    assert not torch.equal(a.dropout_masks[pos], c.dropout_masks[pos])
    assert abs(float(a.dropout_masks[pos].float().mean()) - 0.7) < 0.1
    i = net.get_tensor_index_by_name("n1")
    kept = a.dropout_masks[pos]
    every = execute(net, params, state, inputs, Mode.TRAIN,
                    dropout_masks={pos: torch.ones_like(kept)})
    torch.testing.assert_close(a.values[i][kept], every.values[i][kept],
                               rtol=0, atol=0)
    assert not a.values[i][~kept].any()
    net.nodes[pos].param["rate"] = 0.0  # the layer passes x through
    x_in = execute(net, params, state, inputs, Mode.TRAIN).values[i]
    torch.testing.assert_close(every.values[i], x_in * (1 / 0.7))
    # outside TRAIN the layer passes x through
    assert not execute(net, params, state, inputs, Mode.VALID).dropout_masks


def test_dropout_masks_repeat_in_the_step_forms():
    """Session steps draw one seed a step from the session's generator:
    two sessions of one seed train alike; remat recomputes the same
    masks, so its step equals the plain one."""
    _, net, p_np, s_np = net_pair()
    x, lab = net_batch(net)
    out = []
    for remat in (False, False, True):
        net.remat = remat
        sess = Session(net, 3, device="cpu")
        sess.params, sess.state = bridge.params_from_numpy(net, p_np, s_np)
        sess.compile_net()
        sess.train_on_batch(x, lab)
        out.append(sess.params)
    net.remat = False
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k
        assert torch.equal(out[0][k], out[2][k]), k


# ------------------------------------------------------- lifted loss #


def test_lifted_struct_matches_bcnn_tpu():
    rng = np.random.RandomState(0)
    x = rng.randn(8, 6).astype(np.float32)
    lab = np.zeros((8, 5), np.float32)
    lab[np.arange(8), [0, 0, 1, 1, 2, 2, 3, 4]] = 1.0
    lab[7] = 0.0  # no positive entry: class -1
    ref, jg = jax.value_and_grad(
        lambda a: jlifted.lifted_struct_surrogate(a, jnp.asarray(lab), 0.7))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    sur = lifted_struct_surrogate(xt, torch.from_numpy(lab), 0.7)
    sur.backward()
    assert float(ref) > 0
    np.testing.assert_allclose(float(sur), float(ref), rtol=RTOL)
    close(xt.grad.numpy(), jg)


def lifted_files(tmp_path, n_classes=8, per=4, batch=128):
    """Seeded 64x64 PNGs, `per` of each class with a class colour and
    noise, and a list of `batch` lines grouping same-class images
    (the recipe's note: the loss needs same-class pairs in a batch)."""
    rng = np.random.RandomState(0)
    paths = []
    for c in range(n_classes):
        base = rng.randint(0, 256, 3)
        for j in range(per):
            img = np.clip(base + rng.randint(-30, 30, (64, 64, 3)), 0,
                          255).astype(np.uint8)
            p = tmp_path / f"c{c}_{j}.png"
            bip.write_image(str(p), img)
            paths.append(f"{p} {c}")
    lines = [paths[i % len(paths)] for i in range(batch)]
    (tmp_path / "list.txt").write_text("\n".join(lines) + "\n")
    text = open(os.path.join(REPO, "examples", "lifted_structure_loss",
                             "lifted_structure.conf")).read()
    for a, b in (
        ("source_train=train_list.txt",
         f"source_train={tmp_path / 'list.txt'}\n"
         f"input_model={tmp_path / 'init.bcnnmodel'}\n"
         "output_model={dir}/l.bcnnmodel"),
        ("source_test=test_list.txt",
         f"source_test={tmp_path / 'list.txt'}"),
        ("max_batches=100000", "max_batches=3"),
        ("eval_period=500", "eval_period=2"),
        ("num_pred=1024", "num_pred=128"),
    ):
        assert a in text, a
        text = text.replace(a, b)
    (tmp_path / "lifted.conf").write_text(text)
    init_model(tmp_path / "lifted.conf", tmp_path / "init.bcnnmodel")
    return text


def test_cli_lifted_structure_recipe_matches_bcnn_tpu(tmp_path, monkeypatch,
                                                      capsys):
    """bcnn-cl train on the lifted-structure recipe (batch 128, 64 px,
    host contrast/brightness/flip) for 3 batches through both CLIs from
    one initial .bcnnmodel: the printed losses and the saved model."""
    bip.native.get_lib()
    text = lifted_files(tmp_path)
    out = run_both(tmp_path, monkeypatch, capsys, text, ["train", "{conf}"])
    assert_same_lines(out, "iter-batches=")
    assert_same_lines(out, "Training ended, final error=")
    p0, _ = saved(tmp_path / "lifted.conf", tmp_path / "init.bcnnmodel")
    pa, sa = saved(tmp_path / "lifted.conf", out["port"][1] / "l.bcnnmodel")
    pb, sb = saved(tmp_path / "lifted.conf", out["jax"][1] / "l.bcnnmodel")
    # the loss reads only the embeddings' differences, so the embedding
    # bias's gradient is 0 but for rounding: both its updates stay below
    # 1e-6 of the embedding weight's largest
    big = float((pb["pool_w"] - p0["pool_w"]).abs().max())
    assert big > 0
    for k, v0 in p0.items():
        du_a, du_b = pa[k] - v0, pb[k] - v0
        if k == "pool_b":
            assert max(float(du_a.abs().max()),
                       float(du_b.abs().max())) < 1e-6 * big
            continue
        np.testing.assert_allclose(du_a.numpy(), du_b.numpy(), rtol=0,
                                   atol=1e-3 * float(du_b.abs().max()),
                                   err_msg=k)
    for k in sb:
        np.testing.assert_allclose(sa[k].numpy(), sb[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# ------------------------------------------- bf16 FC and depthwise #


def test_bf16_fc_backward_rounds_as_bcnn_tpu():
    """ops.full_connected with compute_dtype in autograd against jax.vjp
    of bcnn_tpu's: the forward an fp32 sum of bf16 products, each
    gradient the fp32 product of the cotangent and the other bf16
    operand rounded to bf16, bit for bit."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 5, 5).astype(np.float32)
    w = (rng.randn(75, 11) * 0.2).astype(np.float32)
    b = rng.randn(11).astype(np.float32)
    g = rng.randn(4, 11).astype(np.float32)
    y, vjp = jax.vjp(lambda a, c: jops.full_connected(
        a, c, jnp.asarray(b), jnp.bfloat16), jnp.asarray(nhwc(x)),
        jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g.reshape(4, 1, 1, 11)))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = ops.full_connected(xt, wt, torch.from_numpy(b), torch.bfloat16)
    out.backward(torch.from_numpy(g.reshape(4, 11, 1, 1)))
    assert out.dtype == xt.grad.dtype == wt.grad.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy().reshape(4, 11),
                               np.asarray(y).reshape(4, 11), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(xt.grad.numpy(), nchw(dx))
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(dw))


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_depthwise_backward_matches_bcnn_tpu(stride):
    """The depthwise conv with compute_dtype in TRAIN (the grouped conv's
    bf16 form, `_Conv2dMixed` with groups = C) against jax.vjp of
    bcnn_tpu's depthwise_conv2d."""
    rng = np.random.RandomState(stride)
    x = rng.randn(2, 6, 9, 9).astype(np.float32)
    w = (rng.randn(6, 1, 3, 3) * 0.4).astype(np.float32)
    y, vjp = jax.vjp(lambda a, c: jops.depthwise_conv2d(
        a, c, stride, 1, jnp.bfloat16), jnp.asarray(nhwc(x)),
        jnp.asarray(np.transpose(w, (2, 3, 1, 0))))
    g = rng.randn(*y.shape).astype(np.float32)
    dx, dw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = ops.conv2d(xt, wt, stride, 1, 6, torch.bfloat16)
    out.backward(torch.from_numpy(nchw(g)))
    close(out.detach().numpy(), nchw(y))
    close(xt.grad.numpy(), nchw(dx), BF16_TOL)
    close(wt.grad.numpy(), np.transpose(np.asarray(dw, np.float32),
                                        (3, 2, 0, 1)), BF16_TOL)


def test_mobilenet_bf16_step_matches_bcnn_tpu():
    """MobileNet-v1 at width 0.25 (batch 2, resized to 96 px) in TRAIN
    with compute_dtype = train_act_dtype = bf16, through its 13 depthwise
    convs and the FC: every gradient under the bf16 gate, then one step
    through Session: params, running stats and optimizer buffers stay
    fp32, the loss within 2^-5 of bcnn_tpu's bf16 loss."""
    jnet = jmobilenet(2, 10, bt.Mode.TRAIN, width_mult=0.25).resize(96, 96)
    net = mobilenet_v1(2, 10, Mode.TRAIN, width_mult=0.25).resize(96, 96)
    for n in (jnet, net):
        n.compute_dtype = n.train_act_dtype = (
            jnp.bfloat16 if n is jnet else torch.bfloat16)
    p_np, s_np = bridge.he_numpy_weights(net, 0)
    rng = np.random.RandomState(1)
    x = rng.rand(2, 3, 96, 96).astype(np.float32)
    lab = np.zeros((2, 10), np.float32)
    lab[[0, 1], [3, 7]] = 1.0
    batch = {"input": jnp.asarray(x), "label": jnp.asarray(lab)}
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    js = {k: jnp.asarray(v) for k, v in s_np.items()}

    def jgrads():
        return jax.jit(jax.grad(lambda p: jexecute(
            jnet, p, js, batch, bt.Mode.TRAIN).surrogate))(jp)

    ref = jgrads()
    jnet.compute_dtype = jnet.train_act_dtype = None
    ref32 = jgrads()
    jnet.compute_dtype = jnet.train_act_dtype = jnp.bfloat16
    params, state = bridge.params_from_numpy(net, p_np, s_np)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    ex = execute(net, leaves, state, {"input": torch.from_numpy(x),
                                      "label": torch.from_numpy(lab)},
                 Mode.TRAIN)
    assert ex.values[net.get_tensor_index_by_name("dw1")].dtype == (
        torch.bfloat16)
    ex.surrogate.backward()
    got = bridge.params_to_numpy(net, {k: v.grad for k, v in leaves.items()})
    gaps = grad_gaps(ref, got)
    noise = grad_gaps(ref32, {k: np.asarray(v) for k, v in ref.items()})
    assert {k for k in gaps if k.startswith(("dw", "avgpool"))}
    for k, (cos_gap, rms_gap) in gaps.items():
        c, r = noise[k]
        if c <= 0.01 and r < 0.5:
            assert cos_gap <= COS_GAP, f"{k}: 1 - cosine {cos_gap:.3g}"
            assert rms_gap < RMS_GAP, f"{k}: max|d| {rms_gap:.3g} rms"
        else:
            assert cos_gap <= NOISE_RATIO * c, k
            assert rms_gap <= NOISE_RATIO * r, k

    jloss = jax_make_train_step(jnet)(
        jp, js, jlearner.init_opt_state(jnet, jp), batch,
        jax.random.PRNGKey(0))[3]
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = bridge.params_from_numpy(net, p_np, s_np)
    sess.compile_net()
    loss = float(sess.train_on_batch(x, lab))
    np.testing.assert_allclose(loss, float(jloss), rtol=2.0**-5)
    for table in (sess.params, sess.state, sess.opt_state["velocity"]):
        assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
                   for v in table.values())
