"""The detection slice end to end: YOLOv3-tiny through bcnn_tpu and
through the port, on the same JAX-initialised weights and inputs.

88 px makes the stride-2 pool lid8 pad 11 -> 6 on the high side. BN
running stats are set from a numpy seed (run_var in [0.5, 1.5], run_mean
in [-0.1, 0.1]) in both packages: the zero stats init_params gives would
multiply every BN layer by rsqrt(1e-6) = 1000. Heads match at rtol 1e-4,
atol 1e-4, the repo's fp32 detection tolerance (docs/STATUS.md)."""

import ast
import inspect
import json
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
from bcnn_tpu_torch.ops import library
from bcnn_tpu_torch.types import LayerType, Mode

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-4
BATCH, SIZE, CLASSES = 2, 88, 4
HEADS = ["lid17", "lid24"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the scripts that drive the port on the card, each imported (not run)
CARD_SCRIPTS = ["tools/card_timing.py", "chip_smoke.py",
                "tools/k1k2_compare.py", "tools/k3_compare.py",
                "tools/k4_compare.py", "tools/k5_compare.py",
                "tools/kernel_repeat.py", "tools/upload_compare.py"]


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
    out, loss = ts.predict_on_batch(x, outputs=HEADS)
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


def test_predict_on_batch_signature_matches_bcnn_tpu():
    ref = inspect.signature(JaxSession.predict_on_batch).parameters
    port = inspect.signature(Session.predict_on_batch).parameters
    assert list(port) == list(ref) == ["self", "x", "label", "outputs"]
    assert [p.default for p in port.values()] == [
        p.default for p in ref.values()
    ]
    sess = Session(yolov3_tiny(1, 64, 64, 4), 0, device="cpu").compile_net()
    with pytest.raises(RuntimeError, match="loader"):
        sess.predict_on_batch()  # no data loader set


def test_positional_label_matches_bcnn_tpu():
    """predict_on_batch(x, label) positionally, in VALID, where the YOLO
    layers see the label, gives the same outputs and loss in both
    packages."""
    jnet = jax_tiny(BATCH, 64, 64, CLASSES, mode=JaxMode.VALID)
    js = JaxSession(jnet, 0).compile_net()
    js.state = {
        k: jnp.asarray(v) for k, v in bn_stats(jnet.state_specs()).items()
    }
    net = yolov3_tiny(BATCH, 64, 64, CLASSES, mode=Mode.VALID)
    ts = Session(net, 0, device="cpu")
    ts.params, ts.state = bridge.params_from_numpy(
        net,
        {k: np.asarray(v) for k, v in js.params.items()},
        {k: np.asarray(v) for k, v in js.state.items()},
    )
    ts.compile_net()
    rng = np.random.RandomState(5)
    x = rng.rand(BATCH, 3, 64, 64).astype(np.float32)
    lab = np.zeros((BATCH, 250), np.float32)
    lab[:, :5] = [0.5, 0.4, 0.3, 0.2, 1]
    (r,), r_loss = js.predict_on_batch(x, lab)
    (o,), loss = ts.predict_on_batch(x, lab)
    assert float(loss) == float(r_loss)
    assert o.shape == np.asarray(r).shape == (BATCH, 27, 4, 4)
    np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL,
                               atol=ATOL)


def test_no_jax_in_the_port(tmp_path):
    """A 64-px slice through the port in a fresh interpreter loads no
    JAX module: serving, a training step with rotation augmentation,
    and `bcnn_tpu_torch.parallel` and `multihost` with one data-parallel
    step of a world of one gloo rank on the CPU, one tensor-parallel step
    of `parallel.model_axis` on its 1x1 mesh, a forward of
    `parallel.pipeline`'s Pipeline on two stages, and the int8 study's
    tool (`tools/int8_map_study_torch.py`) imported."""
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
        from bcnn_tpu_torch.types import Mode
        net = yolov3_tiny(2, 64, 64, 4, mode=Mode.TRAIN)
        net.device_augment = dict(rotation_range=10.0, random_fliph=1)
        train = Session(net, 0, device="cpu").compile_net()
        lab = np.zeros((2, 250), np.float32)
        lab[:, :5] = [0.5, 0.5, 0.3, 0.4, 1]
        xu8 = np.random.RandomState(1).randint(0, 256, (2, 3, 64, 64))
        loss = train.train_on_batch(xu8.astype(np.uint8), lab)
        assert bool(torch.isfinite(loss)) and float(loss) > 0
        from bcnn_tpu_torch.parallel import (make_dp_train_step, multihost,
                                             replicate, shard_batch)
        multihost.initialize("file://" + sys.argv[1], 1, 0, backend="gloo")
        mesh = multihost.global_mesh(device="cpu")
        net = yolov3_tiny(2, 64, 64, 4, mode=Mode.TRAIN)
        dp = Session(net, 0, device="cpu").compile_net()
        p, s, o = replicate(mesh, (dp.params, dp.state, dp.opt_state))
        x = np.random.RandomState(2).rand(2, 3, 64, 64).astype(np.float32)
        p, s, o, loss = make_dp_train_step(net, mesh)(
            p, s, o, shard_batch(mesh, {"input": x, "label": lab}))
        assert bool(torch.isfinite(loss)) and o["seen"] == 2
        from bcnn_tpu_torch.parallel import (make_dp_tp_train_step,
                                             make_mesh_2d, model_axis,
                                             shard_train_state)
        mesh2 = make_mesh_2d(dp=1, device="cpu")
        p, s, o = shard_train_state(net, mesh2, dp.params, dp.state,
                                    dp.opt_state)
        p, s, o, loss = make_dp_tp_train_step(net, mesh2)(
            p, s, o, shard_batch(mesh2.batch, {"input": x, "label": lab}))
        assert bool(torch.isfinite(loss)) and model_axis.MODEL_AXIS
        from bcnn_tpu_torch.parallel import Pipeline, pipeline
        pipe = Pipeline(sess.net, [[0], [0]], Mode.PREDICT,
                        output_names=["lid16"], device="cpu")
        (yp,) = pipe.forward(*pipe.shard(sess.params, sess.state),
                             {"input": x[:1]})
        assert tuple(yp.shape) == (1, 27, 2, 2) and pipeline.split_stages
        torch.distributed.destroy_process_group()
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "int8_map_study_torch", "tools/int8_map_study_torch.py")
        study = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(study)
        assert study.parse(["--ckpt", "c.npz", "--device", "cpu"]).batch
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "bcnn_tpu.")))
        assert not bad, bad
        print("OK")
        """
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "store")],
        capture_output=True, text=True, env=env, cwd=root, timeout=120,
    )
    assert res.returncode == 0 and res.stdout.strip() == "OK", res.stderr


@pytest.fixture(scope="module")
def card_imports():
    """One fresh interpreter with no CUDA device imports each card script
    in turn: {path: (error or None, jax modules it loaded, whether CUDA
    was initialised after it)}."""
    code = textwrap.dedent(
        """
        import importlib.util, json, os, sys
        import torch
        out = {}
        for path in sys.argv[1:]:
            name = os.path.splitext(os.path.basename(path))[0]
            before = set(sys.modules)
            try:
                spec = importlib.util.spec_from_file_location(name, path)
                mod = importlib.util.module_from_spec(spec)
                sys.modules[name] = mod
                spec.loader.exec_module(mod)
                err = None
            except Exception as e:
                err = f"{type(e).__name__}: {e}"
            jax = sorted(m for m in set(sys.modules) - before
                         if m == "jax" or m.startswith(("jax.", "bcnn_tpu.")))
            out[path] = (err, jax, torch.cuda.is_initialized())
        print(json.dumps(out))
        """
    )
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code, *CARD_SCRIPTS],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("path", CARD_SCRIPTS)
def test_card_script_imports_without_jax_or_cuda(card_imports, path):
    """Each script that drives the port on the card imports on a machine
    without one, loads no JAX and leaves CUDA uninitialised: the work is
    under its main()."""
    assert card_imports[path] == [None, [], False]


def test_card_timers_live_in_one_module():
    """Every sleep queued before a timed call takes its cycles from
    tools/card_timing.SLEEP_CYCLES, and no card script but
    tools/card_timing.py times with CUDA events (tools/upload_compare.py's
    `timed` excepted: it times a host call's return and sync, not a
    kernel)."""
    paths = ["chip_smoke.py"] + sorted(
        os.path.join("tools", f) for f in os.listdir(os.path.join(ROOT, "tools"))
        if f.endswith(".py"))
    sleeps, events = {}, []
    for path in paths:
        tree = ast.parse(open(os.path.join(ROOT, path)).read())
        shared = path == os.path.join("tools", "card_timing.py") or any(
            isinstance(n, ast.ImportFrom) and n.module == "tools.card_timing"
            and "SLEEP_CYCLES" in [a.name for a in n.names]
            for n in ast.walk(tree))
        for n in ast.walk(tree):
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)):
                continue
            if n.func.attr == "_sleep":
                names = {x.id for x in ast.walk(n) if isinstance(x, ast.Name)}
                sleeps[f"{path}:{n.lineno}"] = (
                    shared and "SLEEP_CYCLES" in names)
            if n.func.attr == "Event" and any(
                    k.arg == "enable_timing" for k in n.keywords):
                events.append(path)
    assert sleeps and all(sleeps.values()), sleeps
    assert set(events) == {os.path.join("tools", "card_timing.py"),
                           os.path.join("tools", "upload_compare.py")}, events


def test_cuda_session_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(yolov3_tiny(1, 64, 64, 4), 0, device="cuda")


def test_cpu_session_never_launches_the_kernel(pair):
    _, ts, x = pair
    before = library.launches("yolo_decode")
    ts.detect_on_batch(x, topk_first=False, use_pallas=True)
    assert library.launches("yolo_decode") == before


def test_unported_layer_raises_naming_it():
    """RESHAPE, the one layer no package runs (the reference declares it
    and implements nothing, bcnn.h:157): the port raises naming it in
    every mode, as bcnn_tpu's executor does."""
    import jax.numpy as jnp

    from bcnn_tpu.compile import execute as jax_execute
    from bcnn_tpu.compile import init_params as jax_init_params
    from bcnn_tpu.graph import Node as JNode
    from bcnn_tpu.models import yolov3_tiny as jax_tiny

    net = yolov3_tiny(1, 64, 64, 4)
    net.add_node(Node(type=LayerType.RESHAPE, src=[2], dst=[2]))
    sess = Session(net, 0, device="cpu").compile_net()
    with pytest.raises(NotImplementedError, match="RESHAPE"):
        sess.predict_on_batch(np.zeros((1, 3, 64, 64), np.float32))
    with pytest.raises(NotImplementedError, match="RESHAPE"):
        execute(net, sess.params, sess.state,
                {"input": torch.zeros(1, 3, 64, 64)}, Mode.TRAIN)
    jnet = jax_tiny(1, 64, 64, 4)
    jnet.add_node(JNode(type=LayerType.RESHAPE, src=[2], dst=[2]))
    jp, js = jax_init_params(jnet, 0)
    with pytest.raises(NotImplementedError, match="RESHAPE"):
        jax_execute(jnet, jp, js, {"input": jnp.zeros((1, 3, 64, 64))},
                    Mode.PREDICT)


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
