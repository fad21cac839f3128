"""bf16 serving in the port against bcnn_tpu with the same attributes
(net.compute_dtype = net.act_dtype = bfloat16, as bench.py sets them),
the same weights (through bridge) and the same inputs, on the CPU.

Tolerances, all at the level of bf16 rounding (2^-8 relative):
  - heads: within 2^-6 of the largest value. Each conv's sum is taken in
    another order in the two packages, so a value near a bf16 rounding
    boundary rounds the other way (one ulp, 2^-8 relative) and that
    spreads through the layers after it; measured at 96 px: 1.5 ulps of
    the largest value at the heads, and lid1 bit-equal.
  - detections: the same kept slots; boxes, scores and objectness within
    2^-7 relative + 2^-8. XLA skips some bf16 roundings where a bf16
    value feeds fp32 arithmetic (the exp and sigmoid of the box
    coordinates) and turns a division by a constant into a product with
    its reciprocal; the port rounds as the program is written.
  - decode-everything through K1's route: K1 takes fp32, so the bf16
    head is cast up and its sigmoids and exps are not rounded to bf16;
    against bcnn_tpu's bf16 decode the values then differ by up to one
    bf16 rounding each: the same tolerance.
  - MobileNet-v1: logits within 2^-5 of the largest logit and top-1
    equal. K3 adds the bias and takes the ReLU in fp32 before one bf16
    round, where bcnn_tpu rounds the depthwise sum to bf16, adds the
    bias and rounds again: up to one more rounding at each of 13 layers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnn_tpu import Session as JaxSession
from bcnn_tpu.models import mobilenet_v1 as jax_mobilenet
from bcnn_tpu.ops.yolo_pallas import decode_grid_jnp
from bcnn_tpu.models import yolov3_tiny as jax_tiny
from bcnn_tpu.types import Mode as JaxMode

from bcnn_tpu_torch import Session, bridge
from bcnn_tpu_torch.compile import execute
from bcnn_tpu_torch.models import mobilenet_v1, yolov3_tiny
from bcnn_tpu_torch.ops.yolo_decode import decode_fused
from bcnn_tpu_torch.types import Mode
from tests.test_torch_slice import bn_stats

torch.set_num_threads(1)

BATCH, SIZE, CLASSES = 2, 96, 4
HEAD_TOL = 2.0**-6
DET_RTOL, DET_ATOL = 2.0**-7, 2.0**-8
MB_TOL = 2.0**-5


def bf16_pair(jnet, net, params_np=None, state_np=None):
    for n, dt in ((jnet, jnp.bfloat16), (net, torch.bfloat16)):
        n.compute_dtype = dt
        n.act_dtype = dt
    js = JaxSession(jnet, 0).compile_net()
    if params_np is not None:
        js.params = {k: jnp.asarray(v) for k, v in params_np.items()}
    if state_np is not None:
        js.state = {k: jnp.asarray(v) for k, v in state_np.items()}
    ts = Session(net, 0, device="cpu")
    ts.params, ts.state = bridge.params_from_numpy(
        net,
        {k: np.asarray(v) for k, v in js.params.items()},
        {k: np.asarray(v) for k, v in js.state.items()},
    )
    return js, ts.compile_net()


@pytest.fixture(scope="module")
def yolo_pair():
    jnet = jax_tiny(BATCH, SIZE, SIZE, CLASSES, mode=JaxMode.PREDICT)
    net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES)
    js, ts = bf16_pair(jnet, net, state_np=bn_stats(net.state_specs()))
    x = np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(
        np.float32)
    return js, ts, x


def f32(a):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    return np.asarray(a, np.float32)


def test_bf16_heads_match_bcnn_tpu(yolo_pair):
    js, ts, x = yolo_pair
    names = ["lid16", "lid23", "lid17", "lid24"]
    ref, _ = js.predict_on_batch(x, outputs=names)
    out, _ = ts.predict_on_batch(x, outputs=names)
    assert out[0].dtype == out[1].dtype == torch.bfloat16  # raw heads
    assert out[2].dtype == out[3].dtype == torch.float32  # the YOLO layers
    for name, o, r in zip(names, out, ref):
        o, r = f32(o), f32(r)
        assert o.shape == r.shape and np.isfinite(o).all(), name
        assert r.std() > 0.02, name  # not a degenerate head
        assert np.abs(o - r).max() <= HEAD_TOL * np.abs(r).max(), name


def test_bf16_first_layer_is_bit_equal(yolo_pair):
    """conv + BN + leaky of lid1 in bf16: every rounding as XLA's (the
    0.1 of LRELU and the BN eps rounded to bf16, rsqrt in fp32 then
    rounded once)."""
    js, ts, x = yolo_pair
    (ref,), _ = js.predict_on_batch(x, outputs=["lid1"])
    (out,), _ = ts.predict_on_batch(x, outputs=["lid1"])
    np.testing.assert_array_equal(f32(out), f32(ref))


def same_detections(got, want):
    (b1, p1, o1), (b2, p2, o2) = (tuple(f32(t) for t in d)
                                  for d in (got, want))
    assert (o2 > 0).sum() > 0
    np.testing.assert_array_equal(o1 > 0, o2 > 0)
    for g, w in ((b1, b2), (p1, p2), (o1, o2)):
        np.testing.assert_allclose(g, w, rtol=DET_RTOL, atol=DET_ATOL)


@pytest.mark.parametrize("topk_first", [True, False])
def test_bf16_detections_match_bcnn_tpu(yolo_pair, topk_first):
    js, ts, x = yolo_pair
    want = js.detect_on_batch(x, 0.3, 20, topk_first=topk_first)
    got = ts.detect_on_batch(x, 0.3, 20, topk_first=topk_first)
    assert got[0].dtype == torch.float32
    assert got[1].dtype == got[2].dtype == torch.bfloat16  # as in JAX
    same_detections(got, want)


def test_bf16_decode_through_k1s_route(yolo_pair):
    """The decode-everything branch on the card casts the bf16 heads to
    fp32 for K1 (`decode_fused`; on the CPU its plain version): against
    bcnn_tpu's bf16 decode of the same heads, every candidate's box,
    objectness and scores within one bf16 rounding. (After it, NMS may
    keep other slots among candidates whose bf16 scores tie.)"""
    js, ts, x = yolo_pair
    heads, _ = js.predict_on_batch(x, outputs=["lid16", "lid23"])
    for raw, node in zip(heads, [n for n in ts.net.nodes
                                 if n.type.name == "YOLOV3"]):
        raw = jnp.asarray(raw).astype(jnp.bfloat16)
        want = decode_grid_jnp(raw.transpose(0, 2, 3, 1), node.param, SIZE,
                               SIZE)
        t = torch.from_numpy(np.array(raw.astype(jnp.float32))).to(
            torch.bfloat16)
        got = decode_fused(t.to(torch.float32), node.param, SIZE, SIZE)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(f32(g), f32(w), rtol=DET_RTOL,
                                       atol=DET_ATOL)


def test_act_dtype_alone_keeps_fp32_convs():
    """act_dtype without compute_dtype: bf16 storage, each conv upcasts
    its input and runs in fp32 (bcnn_tpu/ops/conv.py:217-222)."""
    net = yolov3_tiny(1, 64, 64, 2)
    net.act_dtype = torch.bfloat16
    ts = Session(net, 0, device="cpu").compile_net()
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        ex = execute(net, ts.params, ts.state, {"input": x}, Mode.PREDICT)
    for name in ("lid1", "lid14", "lid16", "lid21"):
        assert ex.values[net.get_tensor_index_by_name(name)].dtype == (
            torch.bfloat16), name
    assert ex.values[net.get_tensor_index_by_name("lid17")].dtype == (
        torch.float32)


def test_bf16_mobilenet_matches_bcnn_tpu():
    net = mobilenet_v1(2, 10, Mode.PREDICT, width_mult=0.25)
    p_np, s_np = bridge.he_numpy_weights(net, 0)
    jnet = jax_mobilenet(2, 10, JaxMode.PREDICT, width_mult=0.25)
    js, ts = bf16_pair(jnet, net, p_np, s_np)
    x = np.random.RandomState(1).rand(2, 3, 224, 224).astype(np.float32)
    ref, _ = js.predict_on_batch(x, outputs=["fc", "softmax"])
    out, _ = ts.predict_on_batch(x, outputs=["fc", "softmax"])
    fc, fc_ref = f32(out[0]).reshape(2, -1), f32(ref[0]).reshape(2, -1)
    assert out[0].dtype == torch.float32  # FC outputs stay fp32
    assert fc.std() > 0.05
    assert np.abs(fc - fc_ref).max() <= MB_TOL * np.abs(fc_ref).max()
    np.testing.assert_array_equal(fc.argmax(1), fc_ref.argmax(1))
    np.testing.assert_allclose(f32(out[1]), f32(ref[1]), atol=MB_TOL)
