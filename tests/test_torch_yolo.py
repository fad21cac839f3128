"""The port's detection tail against bcnn_tpu's on identical heads: the
cases of tests/test_detect_batch.py, replayed against JAX, plus NaN,
overflow, ties and max_dets > M.

The same raw heads (NCHW for the port, NHWC for JAX) go into
device_decode_nms, device_detect_topk and both make_detect_fn branches.
Selected candidates and kept slots must be the same; values agree
within rtol 1e-6, atol 1e-7, the tolerance test_detect_batch.py uses
(XLA's and torch's sigmoid and exp may differ by an ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnn_tpu.compile import make_detect_fn as jax_make_detect_fn
from bcnn_tpu.graph import Net as JaxNet
from bcnn_tpu.ops import yolo as jyolo
from bcnn_tpu.ops.yolo_pallas import decode_grid_jnp
from bcnn_tpu.types import Mode as JaxMode

from bcnn_tpu_torch.compile import make_detect_fn
from bcnn_tpu_torch.graph import Net
from bcnn_tpu_torch.ops import yolo as tyolo
from bcnn_tpu_torch.ops.yolo_decode import decode_grid_ref
from bcnn_tpu_torch.types import Mode

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7
ANCHORS = [10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319]
MASKS = ([3, 4, 5], [0, 1, 2])


def _uniform(rng, shapes):
    return [rng.uniform(-4, 4, s).astype(np.float32) for s in shapes]


def case(name):
    """(heads NCHW, classes, max_dets, thresh, net size) of a named case."""
    rng = np.random.RandomState(2)
    if name == "uniform":  # test_topk_first_matches_decode_everything
        return _uniform(rng, [(2, 27, 4, 4), (2, 27, 8, 8)]), 4, 20, 0.4, 128
    if name == "more_dets":  # 60 candidates, 100 slots
        return _uniform(rng, [(1, 27, 2, 2), (1, 27, 4, 4)]), 4, 100, 0.3, 64
    if name == "edge":  # test_topk_first_edge_logits
        raw = np.full((1, 21, 2, 2), -5.0, np.float32)
        raw[0, 4, 0, 0] = np.inf   # anchor 0 at cell (0,0): saturated obj
        raw[0, 4, 1, 1] = 1e-8     # sigmoid rounds to exactly 0.5 in fp32
        return [raw], 2, 4, 0.5, 64
    if name == "nan_inf":
        raw = _uniform(rng, [(2, 21, 3, 3)])[0]
        raw[0, 4, 0, 0] = np.nan      # NaN objectness: never selected
        raw[0, 4 + 7, 1, 2] = -np.inf
        raw[1, 4, 2, 2] = np.inf
        raw[1, 5, 0, 1] = np.nan      # NaN class logit of a candidate
        raw[1, 2 + 14, 1, 1] = 100.0  # exp overflow: box width inf
        raw[1, 4 + 14, 1, 1] = 6.0
        return [raw], 2, 12, 0.5, 96
    if name == "ties":  # equal logits: lower index must win, as lax.top_k
        raw = _uniform(rng, [(2, 27, 4, 4), (2, 27, 2, 2)])
        for r in raw:
            obj = r[:, 4::9]
            obj[...] = np.round(obj)  # a handful of distinct values
        return raw, 4, 16, 0.5, 64
    raise ValueError(name)


CASES = ["uniform", "more_dets", "edge", "nan_inf", "ties"]


def _prms(heads, classes):
    return [
        dict(num=3, classes=classes, total=6, mask=m, anchors=ANCHORS)
        for m, _ in zip(MASKS, heads)
    ]


def _assert_same(port_outs, jax_outs):
    pb, ps, po = (t.numpy() for t in port_outs)
    jb, js, jo = (np.asarray(a) for a in jax_outs)
    assert pb.shape == jb.shape and ps.shape == js.shape
    np.testing.assert_array_equal(po > 0, jo > 0)  # kept slots
    for p, j in ((pb, jb), (ps, js), (po, jo)):
        np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)


def _nhwc(h):
    return jnp.asarray(np.transpose(h, (0, 2, 3, 1)))


@pytest.mark.parametrize("name", CASES)
def test_device_decode_nms_matches_jax(name):
    heads, classes, max_dets, thresh, size = case(name)
    prms = _prms(heads, classes)
    dec = [decode_grid_jnp(_nhwc(h), p, size, size)
           for h, p in zip(heads, prms)]
    b, o, p = (np.concatenate([np.asarray(d[i]) for d in dec], 1)
               for i in range(3))
    ref = jyolo.device_decode_nms(
        jnp.asarray(b), jnp.asarray(o), jnp.asarray(p),
        max_dets=max_dets, thresh=thresh,
    )
    out = tyolo.device_decode_nms(
        torch.from_numpy(b), torch.from_numpy(o), torch.from_numpy(p),
        max_dets=max_dets, thresh=thresh,
    )
    _assert_same(out, ref)


@pytest.mark.parametrize("name", CASES)
def test_device_detect_topk_matches_jax(name, monkeypatch):
    monkeypatch.setenv("BCNN_TOPK_GATHER", "take")
    heads, classes, max_dets, thresh, size = case(name)
    prms = _prms(heads, classes)
    ref = jyolo.device_detect_topk(
        [_nhwc(h) for h in heads], prms, size, size,
        max_dets=max_dets, thresh=thresh,
    )
    out = tyolo.device_detect_topk(
        [torch.from_numpy(h) for h in heads], prms, size, size,
        max_dets=max_dets, thresh=thresh,
    )
    _assert_same(out, ref)
    if name == "edge":
        o = out[2].numpy()[0]
        assert o[0] == 1.0        # +inf logit kept at objectness 1.0
        assert (o > 0).sum() == 1  # the 0.5-boundary candidate dropped


def _heads_net(net_cls, mode, heads, classes):
    """A net whose inputs are the raw heads, each fed to a YOLO layer."""
    net = net_cls(mode)
    n, c, h, w = heads[0].shape
    net.set_input_shape(w, h, c, n)
    names = ["input"]
    for i, hd in enumerate(heads[1:]):
        names.append(f"head{i + 1}")
        net.add_input(hd.shape[3], hd.shape[2], hd.shape[1], names[-1])
    for i, (name, m) in enumerate(zip(names, MASKS)):
        net.add_yolo_layer(3, classes, 4, 6, m, ANCHORS, name, f"yolo{i}")
    batch = dict(zip(names, heads))
    return net, batch


@pytest.mark.parametrize("topk_first", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_make_detect_fn_matches_jax(name, topk_first, monkeypatch):
    monkeypatch.setenv("BCNN_TOPK_GATHER", "take")
    heads, classes, max_dets, thresh, _ = case(name)
    jnet, jbatch = _heads_net(JaxNet, JaxMode.PREDICT, heads, classes)
    ref = jax_make_detect_fn(
        jnet, thresh, max_dets, use_pallas=False, topk_first=topk_first
    )({}, {}, {k: jnp.asarray(v) for k, v in jbatch.items()})
    tnet, tbatch = _heads_net(Net, Mode.PREDICT, heads, classes)
    tbatch = {k: torch.from_numpy(v) for k, v in tbatch.items()}
    # use_pallas on CPU tensors takes the kernel's plain version
    for use_pallas in (False, True):
        out = make_detect_fn(
            tnet, thresh, max_dets, use_pallas=use_pallas,
            topk_first=topk_first,
        )({}, {}, tbatch)
        _assert_same(out, ref)


@pytest.mark.parametrize("name", CASES)
def test_top_k_indices_match_lax(name):
    heads, classes, *_ = case(name)
    v = np.concatenate(
        [h[:, 4::5 + classes].reshape(h.shape[0], -1) for h in heads],
        axis=1,
    )
    v = np.where(np.isnan(v), -np.inf, v).astype(np.float32)
    k = min(10, v.shape[1])
    jv, ji = jax.lax.top_k(jnp.asarray(v), k)
    tv, ti = tyolo._top_k(torch.from_numpy(v), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_top_k_ties_lower_index_first():
    v = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]])
    _, idx = tyolo._top_k(v, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3]]
    _, jidx = jax.lax.top_k(jnp.asarray(v.numpy()), 5)
    assert np.asarray(jidx).tolist() == idx.tolist()


@pytest.mark.parametrize("name", ["uniform", "nan_inf"])
def test_decode_order_and_head(name):
    """The NCHW plain decode gives JAX's (location, anchor) candidate
    order, and yolo_head its activated output."""
    heads, classes, _, _, size = case(name)
    for h, p in zip(heads, _prms(heads, classes)):
        ref = decode_grid_jnp(_nhwc(h), p, size, size)
        out = decode_grid_ref(torch.from_numpy(h), p, size, size)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(
                o.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7
            )
        yj = jyolo.yolo_head(_nhwc(h), 3, classes)
        yt = tyolo.yolo_head(torch.from_numpy(h), 3, classes)
        np.testing.assert_allclose(
            yt.numpy(), np.transpose(np.asarray(yj), (0, 3, 1, 2)),
            rtol=1e-6, atol=1e-7,
        )
