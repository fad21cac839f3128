"""The detection slice end to end: YOLOv3-tiny through bcnn_tpu and
through the port, on the same JAX-initialised weights and inputs.

88 px makes the stride-2 pool lid8 pad 11 -> 6 on the high side. BN
running stats are set from a numpy seed (run_var in [0.5, 1.5], run_mean
in [-0.1, 0.1]) in both packages: the zero stats init_params gives would
multiply every BN layer by rsqrt(1e-6) = 1000. Heads match at rtol 1e-4,
atol 1e-4, the repo's fp32 detection tolerance (docs/STATUS.md)."""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnn_tpu import Session as JaxSession
from bcnn_tpu.models import yolov3_tiny as jax_tiny
from bcnn_tpu.types import Mode as JaxMode

import bcnn_tpu_torch
from bcnn_tpu_torch import Session, bridge
from bcnn_tpu_torch.compile import execute
from bcnn_tpu_torch.graph import Node
from bcnn_tpu_torch.models import yolov3_tiny
from bcnn_tpu_torch.ops.yolo_decode import decode_fused
from bcnn_tpu_torch.types import LayerType, Mode

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-4
BATCH, SIZE, CLASSES = 2, 88, 4
HEADS = ["lid17", "lid24"]


def bn_stats(specs, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for t in specs:
        lo, hi = (0.5, 1.5) if t.key.endswith("_run_var") else (-0.1, 0.1)
        out[t.key] = rng.uniform(lo, hi, t.mem_shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    jnet = jax_tiny(BATCH, SIZE, SIZE, CLASSES, mode=JaxMode.PREDICT)
    js = JaxSession(jnet, 0).compile_net()
    js.state = {
        k: jnp.asarray(v) for k, v in bn_stats(jnet.state_specs()).items()
    }
    net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES)
    ts = Session(net, 0, device="cpu")
    ts.params, ts.state = bridge.params_from_numpy(
        net,
        {k: np.asarray(v) for k, v in js.params.items()},
        {k: np.asarray(v) for k, v in js.state.items()},
    )
    ts.compile_net()
    x = np.random.RandomState(1).rand(BATCH, 3, SIZE, SIZE).astype(np.float32)
    return js, ts, x


def test_heads_match_bcnn_tpu(pair):
    js, ts, x = pair
    ref, _ = js.predict_on_batch(x, outputs=HEADS)
    out, loss = ts.predict_on_batch(x, HEADS)
    assert float(loss) == 0.0
    for o, r in zip(out, ref):
        o = o.numpy()
        assert o.shape == np.asarray(r).shape
        assert np.isfinite(o).all()
        assert o.std() > 0.05  # not a degenerate, near-constant head
        np.testing.assert_allclose(o, np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "topk_first,use_pallas", [(True, None), (False, False), (False, True)]
)
def test_detect_on_batch_matches_bcnn_tpu(pair, topk_first, use_pallas):
    js, ts, x = pair
    ref = js.detect_on_batch(
        x, thresh=0.5, max_dets=20, use_pallas=False, topk_first=topk_first
    )
    out = ts.detect_on_batch(
        x, thresh=0.5, max_dets=20, use_pallas=use_pallas,
        topk_first=topk_first,
    )
    ro = np.asarray(ref[2])
    # the ranking must not hinge on differences inside the tolerance
    for row in ro:
        alive = np.sort(row[row > 0])
        assert alive.size > 3 and np.diff(alive).min() > ATOL
    np.testing.assert_array_equal(out[2].numpy() > 0, ro > 0)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(
            o.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL
        )


def test_no_jax_in_the_port():
    """A 64-px slice through the port in a fresh interpreter loads no
    JAX module."""
    code = textwrap.dedent(
        """
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from bcnn_tpu_torch import Session
        from bcnn_tpu_torch.models import yolov3_tiny
        sess = Session(yolov3_tiny(1, 64, 64, 4), 0, device="cpu")
        sess.compile_net()
        x = np.random.RandomState(0).rand(1, 3, 64, 64).astype(np.float32)
        (y,), _ = sess.predict_on_batch(x)
        assert tuple(y.shape) == (1, 27, 4, 4)
        for topk in (True, False):
            b, s, o = sess.detect_on_batch(x, 0.3, 100, topk_first=topk)
            assert tuple(o.shape) == (1, 100)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "bcnn_tpu.")))
        assert not bad, bad
        print("OK")
        """
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=root, timeout=120,
    )
    assert res.returncode == 0 and res.stdout.strip() == "OK", res.stderr


def test_cuda_session_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(yolov3_tiny(1, 64, 64, 4), 0, device="cuda")


def test_cpu_session_never_launches_the_kernel(pair):
    _, ts, x = pair
    before = decode_fused.launches
    ts.detect_on_batch(x, topk_first=False, use_pallas=True)
    assert decode_fused.launches == before


def test_unported_layer_raises_naming_it():
    net = yolov3_tiny(1, 64, 64, 4)
    net.add_node(Node(type=LayerType.SOFTMAX, src=[2], dst=[2]))
    sess = Session(net, 0, device="cpu").compile_net()
    with pytest.raises(NotImplementedError, match="SOFTMAX"):
        sess.predict_on_batch(np.zeros((1, 3, 64, 64), np.float32))
    with pytest.raises(NotImplementedError):
        execute(net, sess.params, sess.state,
                {"input": torch.zeros(1, 3, 64, 64)}, Mode.TRAIN)


def test_get_tensor_is_the_port_layout(pair):
    js, ts, _ = pair
    w = ts.get_tensor("input_w")
    assert w.shape == (16, 3, 3, 3)  # OIHW
    np.testing.assert_array_equal(
        w, np.transpose(np.asarray(js.get_tensor("input_w")), (3, 2, 0, 1))
    )
    np.testing.assert_array_equal(
        ts.get_tensor("input_run_var"),
        np.asarray(js.get_tensor("input_run_var")),
    )
    with pytest.raises(KeyError):
        ts.get_tensor("lid1")
    assert bcnn_tpu_torch.Mode.PREDICT == 0
