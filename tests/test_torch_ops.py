"""Each op of the port against its bcnn_tpu counterpart on the same inputs
(made with numpy), on the CPU. JAX works in NHWC/HWIO, the port in
NCHW/OIHW; the tests transpose at the boundary.

Tolerances: rtol 1e-5, atol 1e-5 for the layer ops (conv sums are taken
in another order); rtol 1e-5, atol 1e-6 for the decode, the tolerance
tests/test_yolo_pallas.py sets for the Pallas kernel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bcnn_tpu import ops as jops
from bcnn_tpu.ops.yolo_pallas import decode_fused as jax_decode_fused
from bcnn_tpu.ops.yolo_pallas import decode_grid_jnp
from bcnn_tpu.types import Activation as JActivation

from bcnn_tpu_torch import ops
from bcnn_tpu_torch.ops import library
from bcnn_tpu_torch.ops.yolo_decode import decode_fused, decode_grid_ref
from bcnn_tpu_torch.types import Activation

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5


def nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def nhwc(a):
    return np.transpose(np.asarray(a), (0, 2, 3, 1))


def check(port_out, jax_out_nhwc, atol=ATOL):
    np.testing.assert_allclose(
        port_out.numpy(), nchw(jax_out_nhwc), rtol=RTOL, atol=atol
    )


@pytest.mark.parametrize(
    "k,stride,pad,cin,cout",
    [(3, 1, 1, 5, 7), (1, 1, 0, 6, 4), (3, 2, 1, 4, 8)],
)
def test_conv2d(k, stride, pad, cin, cout):
    rng = np.random.RandomState(k * 10 + stride)
    x = rng.randn(2, cin, 9, 11).astype(np.float32)
    w_oihw = rng.randn(cout, cin, k, k).astype(np.float32) * 0.3
    ref = jops.conv2d(
        jnp.asarray(nhwc(x)),
        jnp.asarray(np.transpose(w_oihw, (2, 3, 1, 0))),  # HWIO
        stride, pad,
    )
    out = ops.conv2d(torch.from_numpy(x), torch.from_numpy(w_oihw),
                     stride, pad)
    check(out, ref)


@pytest.mark.parametrize("folded", [False, True])
def test_batch_norm_predict(folded):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 5, 4).astype(np.float32) * 3
    c = 6
    scales, biases = rng.rand(c) + 0.5, rng.randn(c)
    mean, var = rng.uniform(-0.1, 0.1, c), rng.uniform(0.5, 1.5, c)
    f32 = [a.astype(np.float32) for a in (scales, biases, mean, var)]
    ref, _, _ = jops.batch_norm(
        jnp.asarray(nhwc(x)), *map(jnp.asarray, f32),
        training=False, folded=folded,
    )
    out = ops.batch_norm(
        torch.from_numpy(x), *map(torch.from_numpy, f32), folded=folded
    )
    check(out, ref)


@pytest.mark.parametrize(
    # bcnn_tpu's members (MISH and SWISH are the port's own:
    # tests/test_torch_yolov4.py, tests/test_torch_yolov7.py)
    "act", [a for a in Activation
            if a != Activation.PRELU and a.name in JActivation.__members__]
)
def test_activation(act):
    rng = np.random.RandomState(int(act))
    x = (rng.randn(2, 3, 4, 5) * 3).astype(np.float32)
    x[0, 0, 0, :3] = [0.0, -0.0, 1e-3]
    ref = jops.apply_activation(jnp.asarray(nhwc(x)), act)
    out = ops.apply_activation(torch.from_numpy(x), act)
    check(out, ref)


def test_prelu_not_ported():
    """Ported since: PReLU's forward and its output-based backward (the
    slope gradient sum dy*y*(y<0), dx = dy*(y > 0 ? 1 : slope)) against
    bcnn_tpu's custom VJP, zeros included; without slopes both raise."""
    import jax

    rng = np.random.RandomState(11)
    x = (rng.randn(2, 3, 4, 5) * 2).astype(np.float32)
    x[0, 0, 0, :3] = 0.0
    s = rng.uniform(-0.3, 0.5, 3).astype(np.float32)
    g = rng.randn(2, 3, 4, 5).astype(np.float32)
    ref, vjp = jax.vjp(
        lambda u, v: jops.apply_activation(u, Activation.PRELU, v),
        jnp.asarray(nhwc(x)), jnp.asarray(s))
    jdx, jds = vjp(jnp.asarray(nhwc(g)))
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    out = ops.apply_activation(tx, Activation.PRELU, ts)
    out.backward(torch.from_numpy(g))
    check(out.detach(), ref)
    check(tx.grad, jdx)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError, match="slopes"):
        ops.apply_activation(torch.zeros(1, 2, 2, 2), Activation.PRELU)


@pytest.mark.parametrize(
    "h,w,size,stride,out_h,out_w",
    [
        (11, 11, 2, 2, 6, 6),   # odd: high-side pad of one
        (7, 9, 2, 2, 4, 5),
        (8, 8, 2, 2, 4, 4),
        (13, 13, 2, 1, 13, 13),  # lid12 of YOLOv3-tiny: 2/1 SAME
        (5, 6, 3, 2, 3, 3),
    ],
)
def test_maxpool_high_side_pad(h, w, size, stride, out_h, out_w):
    rng = np.random.RandomState(h * w)
    # all-negative input: a both-sides pad with zeros would show
    x = (-1.0 - rng.rand(2, 3, h, w)).astype(np.float32)
    ref = jops.maxpool(jnp.asarray(nhwc(x)), size, stride, out_h, out_w)
    out = ops.maxpool(torch.from_numpy(x), size, stride, out_h, out_w)
    assert tuple(out.shape) == (2, 3, out_h, out_w)
    check(out, ref)


def test_concat_channels():
    rng = np.random.RandomState(3)
    xs = [rng.randn(2, c, 4, 5).astype(np.float32) for c in (3, 1, 4)]
    ref = jops.concat_channels([jnp.asarray(nhwc(a)) for a in xs])
    out = ops.concat_channels([torch.from_numpy(a) for a in xs])
    check(out, ref, atol=0)


@pytest.mark.parametrize("size", [2, 3])
def test_upsample_nn(size):
    x = np.random.RandomState(4).randn(2, 3, 4, 5).astype(np.float32)
    ref = jops.upsample_nn(jnp.asarray(nhwc(x)), size)
    out = ops.upsample_nn(torch.from_numpy(x), size)
    check(out, ref, atol=0)


# ---------------------------------------------------------------- decode #

ANCHORS = [10.0, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319]


@pytest.mark.parametrize(
    "n,h,w,classes,mask,scale",
    [
        (2, 5, 5, 4, [3, 4, 5], 1.0),
        (1, 3, 4, 2, [0, 1, 2], 4.0),
        (2, 2, 3, 80, [3, 4, 5], 2.0),
    ],
)
def test_decode_ref_matches_pallas_and_jnp(n, h, w, classes, mask, scale):
    p = dict(num=3, classes=classes, total=6, mask=mask, anchors=ANCHORS)
    rng = np.random.RandomState(h * w + classes)
    x_nhwc = (scale * rng.randn(n, h, w, 3 * (5 + classes))).astype(
        np.float32
    )
    xj = jnp.asarray(x_nhwc)
    pallas = jax_decode_fused(xj, p, 160, 128, interpret=True)
    plain = decode_grid_jnp(xj, p, 160, 128)
    out = decode_grid_ref(torch.from_numpy(nchw(x_nhwc).copy()), p, 160, 128)
    for ref in (pallas, plain):
        for o, r in zip(out, ref):
            assert tuple(o.shape) == np.asarray(r).shape
            np.testing.assert_allclose(
                o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6
            )


def test_decode_fused_wrapper_on_cpu_is_the_plain_version():
    p = dict(num=3, classes=4, mask=[0, 1, 2], anchors=ANCHORS)
    x = torch.from_numpy(
        np.random.RandomState(5).randn(2, 27, 3, 3).astype(np.float32)
    )
    before = library.launches("yolo_decode")
    for a, b in zip(decode_fused(x, p, 96, 96), decode_grid_ref(x, p, 96, 96)):
        assert torch.equal(a, b)
    assert library.launches("yolo_decode") == before  # no kernel on the CPU


def test_decode_fused_wrapper_refuses_other_devices():
    p = dict(num=3, classes=4, mask=[0, 1, 2], anchors=ANCHORS)
    x = torch.empty(1, 27, 3, 3, device="meta")
    with pytest.raises(ValueError):
        decode_fused(x, p, 96, 96)
