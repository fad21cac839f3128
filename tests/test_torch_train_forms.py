"""The forms of the training step in the port against bcnn_tpu on the
CPU, YOLOv3-tiny at 96 px, batch 2, 4 classes, JAX's weights, fp32:
`make_train_step` with remat and with accum_steps, `make_train_scan`,
`make_train_scan_resident` and `make_eval_step`; then, within the port,
the forms against each other (bit for bit where they run the same
operations), the split-phase Session API and the standalone BN layer.

Tolerances against bcnn_tpu, those of tests/test_torch_train.py's
trajectory: losses rtol 1e-4; each parameter's total update within 1e-3
of its largest entry; BN running stats rtol 1e-4, atol 1e-5; the YOLO
stats rtol 1e-4. Measured on this tree: losses within 1.7e-5, updates
within 1.8e-5 of their largest entry, running stats within 1.1e-6
absolute, the stats within 3.4e-5. Where a max-pool window's two
largest inputs tie within the two packages' rounding, the gradient goes
to another input in each, as the ROADMAP's ground rules say; the scan
parity counts such windows first (`_pool_flips`) and asserts there are
none."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bcnn_tpu import learner as jlearner
from bcnn_tpu.compile import execute as jax_execute
from bcnn_tpu.compile import init_params as jax_init_params
from bcnn_tpu.compile import make_eval_step as jax_make_eval_step
from bcnn_tpu.compile import make_train_scan as jax_make_train_scan
from bcnn_tpu.compile import (
    make_train_scan_resident as jax_make_train_scan_resident,
)
from bcnn_tpu.compile import make_train_step as jax_make_train_step
from bcnn_tpu.graph import Net as JaxNet
from bcnn_tpu.models import yolov3_tiny as jax_tiny
from bcnn_tpu.types import Mode as JaxMode

from bcnn_tpu_torch import Session, bridge, learner
from bcnn_tpu_torch import compile as tcompile
from bcnn_tpu_torch.compile import (
    child_generators,
    execute,
    make_eval_step,
    make_train_scan,
    make_train_scan_resident,
    make_train_step,
)
from bcnn_tpu_torch.data import device_augment as tda
from bcnn_tpu_torch.graph import Net
from bcnn_tpu_torch.models import yolov3_tiny
from bcnn_tpu_torch.types import Activation, FillerType, LayerType, Mode

torch.set_num_threads(1)

BATCH, SIZE, CLASSES = 2, 96, 4
ANCHORS = [10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319]
LOSS_RTOL, UPDATE_TOL, STATE_RTOL, STATE_ATOL = 1e-4, 1e-3, 1e-4, 1e-5
AUG = dict(rotation_range=15.0, random_fliph=1, min_contrast=0.8,
           max_contrast=1.2, min_brightness=-20, max_brightness=20)


def _bn_stats(specs, seed=0):
    rng = np.random.RandomState(seed)
    return {
        t.key: rng.uniform(
            *((0.5, 1.5) if t.key.endswith("_run_var") else (-0.1, 0.1)),
            t.mem_shape,
        ).astype(np.float32)
        for t in specs
    }


def _det_labels(rng, n=BATCH, boxes=4):
    lab = np.zeros((n, 50, 5), np.float32)
    for i in range(n):
        for t in range(boxes):
            lab[i, t] = [rng.uniform(0.15, 0.85), rng.uniform(0.15, 0.85),
                         rng.uniform(0.1, 0.5), rng.uniform(0.1, 0.5),
                         rng.randint(CLASSES)]
    return lab.reshape(n, 250)


def _images(rng, *lead):
    return (rng.rand(*lead, 3, SIZE, SIZE) * 2 - 1).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """YOLOv3-tiny TRAIN at 96 px in both packages, JAX's weights."""
    jnet = jax_tiny(BATCH, SIZE, SIZE, CLASSES, mode=JaxMode.TRAIN)
    jp, _ = jax_init_params(jnet, 0)
    params_np = {k: np.asarray(v) for k, v in jp.items()}
    state_np = _bn_stats(jnet.state_specs())
    net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES, mode=Mode.TRAIN)
    return jnet, net, params_np, state_np


def _jax_start(jnet, params_np, state_np):
    jp = {k: jnp.asarray(v) for k, v in params_np.items()}
    js = {k: jnp.asarray(v) for k, v in state_np.items()}
    return jp, js, jlearner.init_opt_state(jnet, jp)


def _port_start(net, params_np, state_np):
    params, state = bridge.params_from_numpy(net, params_np, state_np)
    return params, state, learner.init_opt_state(net, params)


def _check_against(net, params_np, params, state, jp, js):
    """Each parameter's total update and the running stats against
    bcnn_tpu's."""
    for k, v in bridge.params_to_numpy(net, params).items():
        r, r0 = np.asarray(jp[k]), params_np[k]
        np.testing.assert_allclose(
            v - r0, r - r0, rtol=0,
            atol=UPDATE_TOL * np.abs(r - r0).max(), err_msg=k)
    for k, v in bridge.params_to_numpy(net, state).items():
        np.testing.assert_allclose(v, np.asarray(js[k]), rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=k)


def _pool_flips(jnet, net, jp, js, batch):
    """Max-pool windows of the TRAIN forward, on bcnn_tpu's step-start
    weights, that pick another input in each package: a window whose two
    largest inputs lie within the two forwards' rounding of each other
    sends its gradient elsewhere in each (ROADMAP, "Max-pool ties"), so
    the parity checks first that there is none."""
    srcs = [n.src[0] for n in net.nodes if n.type == LayerType.MAXPOOL]
    jvals = jax.jit(lambda p, s, b: {
        i: jax_execute(jnet, p, s, b, JaxMode.TRAIN).values[i]
        for i in srcs})(jp, js, batch)
    params, state = bridge.params_from_numpy(
        net, {k: np.asarray(v) for k, v in jp.items()},
        {k: np.asarray(v) for k, v in js.items()})
    with torch.no_grad():
        tvals = execute(net, params, state,
                        {k: torch.from_numpy(np.array(v))
                         for k, v in batch.items()}, Mode.TRAIN).values
    flips = 0
    for node in net.nodes:
        if node.type != LayerType.MAXPOOL:
            continue
        p, d = node.param, net.tensors[node.dst[0]]
        picks = []
        for v in (torch.from_numpy(np.transpose(
                np.asarray(jvals[node.src[0]]), (0, 3, 1, 2)).copy()),
                  tvals[node.src[0]]):
            ph = max(0, (d.h - 1) * p["stride"] + p["size"] - v.shape[2])
            pw = max(0, (d.w - 1) * p["stride"] + p["size"] - v.shape[3])
            v = F.pad(v, (0, pw, 0, ph), value=float("-inf"))
            picks.append(v.unfold(2, p["size"], p["stride"]).unfold(
                3, p["size"], p["stride"]).flatten(-2).argmax(-1))
        flips += int((picks[0] != picks[1]).sum())
    return flips


def _check_stats(got, ref):
    """Per-layer stats dicts (values of any leading shape)."""
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in g:
            np.testing.assert_allclose(
                np.asarray(g[k], np.float64), np.asarray(r[k], np.float64),
                rtol=1e-4, atol=1e-6, err_msg=k)


# ------------------------------------------------ against bcnn_tpu #


@pytest.mark.parametrize("form", ["remat", "accum_steps"])
def test_step_form_matches_bcnn_tpu(tiny, form):
    """Two steps of make_train_step(remat=True) or (accum_steps=2, with
    net.yolo_stats: the 5-tuple, stats summed over the microbatches)."""
    jnet, net, params_np, state_np = tiny
    kw = {"remat": True} if form == "remat" else {"accum_steps": 2}
    stats = form == "accum_steps"
    jnet.yolo_stats = net.yolo_stats = stats
    try:
        jstep = jax_make_train_step(jnet, **kw)
        step = make_train_step(net, **kw)
        rng = np.random.RandomState(11)
        batches = [(_images(rng, BATCH), _det_labels(rng)) for _ in range(2)]
        jp, js, jo = _jax_start(jnet, params_np, state_np)
        params, state, opt = _port_start(net, params_np, state_np)
        for x, lab in batches:
            jout = jstep(jp, js, jo, {"input": jnp.asarray(x),
                                      "label": jnp.asarray(lab)},
                         jax.random.PRNGKey(0))
            out = step(params, state, opt, {"input": torch.from_numpy(x),
                                            "label": torch.from_numpy(lab)})
            assert len(out) == len(jout) == (5 if stats else 4)
            jp, js, jo = jout[:3]
            params, state, opt = out[:3]
            np.testing.assert_allclose(float(out[3]), float(jout[3]),
                                       rtol=LOSS_RTOL)
            if stats:
                _check_stats(out[4], jout[4])
        _check_against(net, params_np, params, state, jp, js)
        assert opt["seen"] == 2 * BATCH
    finally:
        jnet.yolo_stats = net.yolo_stats = False


@pytest.mark.parametrize("resident", [False, True])
def test_train_scan_matches_bcnn_tpu(tiny, resident):
    """make_train_scan over (K=3, B, ...) staged batches, or
    make_train_scan_resident over a dataset of 5 images and a (3, 2)
    index, with net.yolo_stats: per-step losses and stats (leading K
    axis) against bcnn_tpu's scan, the parameters and running stats
    after the K steps against its steps."""
    jnet, net, params_np, state_np = tiny
    jnet.yolo_stats = net.yolo_stats = True
    try:
        rng = np.random.RandomState(12)
        if resident:
            # seed 12's draw here puts a lid12 window within the two
            # packages' rounding of a tie on step 1 (_pool_flips)
            rng = np.random.RandomState(20)
            data = {"input": _images(rng, 5), "label": _det_labels(rng, 5)}
            idx = np.asarray([[3, 0], [1, 4], [2, 3]], np.int64)
            jscan = jax_make_train_scan_resident(jnet)
            scan = make_train_scan_resident(net)
            jargs = ({k: jnp.asarray(v) for k, v in data.items()},
                     jnp.asarray(idx, jnp.int32))
            jax_batches = [{k: jnp.asarray(v[i]) for k, v in data.items()}
                           for i in idx]
            args = ({k: torch.from_numpy(v) for k, v in data.items()},
                    torch.from_numpy(idx))
        else:
            batches = {"input": _images(rng, 3, BATCH),
                       "label": np.stack([_det_labels(rng)
                                          for _ in range(3)])}
            jscan = jax_make_train_scan(jnet)
            scan = make_train_scan(net)
            jargs = ({k: jnp.asarray(v) for k, v in batches.items()},)
            jax_batches = [{k: jnp.asarray(v[i]) for k, v in batches.items()}
                           for i in range(3)]
            args = ({k: torch.from_numpy(v) for k, v in batches.items()},)
        _, _, _, jlosses, jstats = jscan(
            *_jax_start(jnet, params_np, state_np), *jargs,
            jax.random.PRNGKey(0))
        # bcnn_tpu's scan program rounds apart from its own steps (a
        # max-pool window near a tie flips under XLA's fusion: input_w's
        # update moves by 2.7e-3 of its largest entry), so the parameters
        # are held to its K sequential steps, which the scan equals
        jstep = jax_make_train_step(jnet)
        jp, js, jo = _jax_start(jnet, params_np, state_np)
        for b in jax_batches:
            assert _pool_flips(jnet, net, jp, js, b) == 0
            jp, js, jo = jstep(jp, js, jo, b, jax.random.PRNGKey(0))[:3]
        params, state, opt, losses, stats = scan(
            *_port_start(net, params_np, state_np), *args)
        assert tuple(losses.shape) == (3,)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                                   rtol=LOSS_RTOL)
        assert len(set(losses.tolist())) == 3
        assert all(tuple(v.shape) == (3,) for st in stats
                   for v in st.values())
        _check_stats(stats, jstats)
        _check_against(net, params_np, params, state, jp, js)
        assert opt["seen"] == 3 * BATCH
    finally:
        jnet.yolo_stats = net.yolo_stats = False


def test_eval_step_matches_bcnn_tpu(tiny):
    jnet, net, params_np, state_np = tiny
    rng = np.random.RandomState(13)
    x, lab = _images(rng, BATCH), _det_labels(rng)
    jp, js, _ = _jax_start(jnet, params_np, state_np)
    ref = jax_make_eval_step(jnet)(
        jp, js, {"input": jnp.asarray(x), "label": jnp.asarray(lab)})
    params, state, _ = _port_start(net, params_np, state_np)
    before = {k: v.clone() for k, v in state.items()}
    loss = make_eval_step(net)(params, state, {
        "input": torch.from_numpy(x), "label": torch.from_numpy(lab)})
    assert loss.dim() == 0 and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(ref), rtol=LOSS_RTOL)
    assert all(torch.equal(before[k], state[k]) for k in state)


# ------------------------------------------------- within the port #


def _aug_net():
    net = yolov3_tiny(BATCH, SIZE, SIZE, CLASSES, mode=Mode.TRAIN)
    net.device_augment = AUG
    return net


def _u8(rng, *lead):
    return torch.from_numpy(
        rng.randint(0, 256, (*lead, 3, SIZE, SIZE)).astype(np.uint8))


def _same(a, b):
    for ta, tb in zip(a, b):
        assert ta.keys() == tb.keys()
        for k in ta:
            assert torch.equal(ta[k], tb[k]), k


def test_scan_equals_sequential_steps(tiny):
    """make_train_scan with rotation augmentation: bit-equal to K calls
    of make_train_step, step k drawing from the k-th child generator;
    three K2 draws (sample_params) a step."""
    _, _, params_np, state_np = tiny
    net = _aug_net()
    rng = np.random.RandomState(14)
    xs, labs = _u8(rng, 3, BATCH), torch.from_numpy(
        np.stack([_det_labels(rng) for _ in range(3)]))
    p1, s1, o1 = _port_start(net, params_np, state_np)
    p1, s1, o1, losses = make_train_scan(net)(
        p1, s1, o1, {"input": xs, "label": labs},
        torch.Generator().manual_seed(5))
    step = make_train_step(net)
    p2, s2, o2 = _port_start(net, params_np, state_np)
    seq = []
    for k, gen in enumerate(child_generators(
            torch.Generator().manual_seed(5), 3)):
        p2, s2, o2, loss = step(p2, s2, o2,
                                {"input": xs[k], "label": labs[k]}, gen)
        seq.append(loss)
    assert torch.equal(losses, torch.stack(seq))
    _same([p1, s1, o1["velocity"]], [p2, s2, o2["velocity"]])
    assert o1["seen"] == o2["seen"] == 3 * BATCH


def test_resident_scan_equals_staged_scan(tiny):
    """make_train_scan_resident gathers the staged scan's batches."""
    _, _, params_np, state_np = tiny
    net = _aug_net()
    rng = np.random.RandomState(15)
    data = {"input": _u8(rng, 4), "label": torch.from_numpy(
        _det_labels(rng, 4))}
    idx = torch.tensor([[2, 0], [3, 3]])
    p1, s1, o1 = _port_start(net, params_np, state_np)
    out1 = make_train_scan_resident(net)(
        p1, s1, o1, data, idx, torch.Generator().manual_seed(6))
    p2, s2, o2 = _port_start(net, params_np, state_np)
    out2 = make_train_scan(net)(
        p2, s2, o2, {k: v[idx] for k, v in data.items()},
        torch.Generator().manual_seed(6))
    assert torch.equal(out1[3], out2[3])
    _same([out1[0], out1[1]], [out2[0], out2[1]])


def test_remat_with_rotation_equals_plain_step(tiny, monkeypatch):
    """remat recomputes the forward in the backward but not the
    augmentation: with rotation, the step is bit-equal to the plain one
    and draws once a step (a recompute that drew again would rotate by
    other angles)."""
    _, _, params_np, state_np = tiny
    net = _aug_net()
    draws = []
    real = tda.sample_params
    monkeypatch.setattr(tda, "sample_params",
                        lambda *a: draws.append(a[1]) or real(*a))
    rng = np.random.RandomState(16)
    batch = {"input": _u8(rng, BATCH),
             "label": torch.from_numpy(_det_labels(rng))}
    outs = []
    for remat in (False, True):
        step = make_train_step(net, remat=remat)
        p, s, o = _port_start(net, params_np, state_np)
        for seed in (7, 8):
            p, s, o, loss = step(p, s, o, batch,
                                 torch.Generator().manual_seed(seed))
        outs.append((p, s, o["velocity"], loss))
    assert draws == [BATCH] * 4
    assert torch.equal(outs[0][3], outs[1][3])
    _same(outs[0][:3], outs[1][:3])


def test_accum_steps_semantics(tiny, monkeypatch):
    """accum_steps: a batch it does not divide raises; each microbatch
    draws its own augmentation; the step equals two TRAIN forwards and
    backwards of the halves, the running stats carried from the first to
    the second, their gradients and losses summed with no division, then
    one update."""
    _, _, params_np, state_np = tiny
    net = yolov3_tiny(3, SIZE, SIZE, CLASSES, mode=Mode.TRAIN)
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(net, accum_steps=2)
    net = yolov3_tiny(4, SIZE, SIZE, CLASSES, mode=Mode.TRAIN)
    net.device_augment = AUG
    draws = []
    real = tda.sample_params
    monkeypatch.setattr(tda, "sample_params",
                        lambda *a: draws.append(a[1]) or real(*a))
    rng = np.random.RandomState(17)
    batch = {"input": _u8(rng, 4),
             "label": torch.from_numpy(_det_labels(rng, 4))}
    p, s, o = _port_start(net, params_np, state_np)
    make_train_step(net, accum_steps=2)(p, s, o, batch,
                                        torch.Generator().manual_seed(9))
    assert draws == [2, 2]

    net.device_augment = None
    x = {"input": torch.from_numpy(_images(rng, 4)),
         "label": batch["label"]}
    p, s, o = _port_start(net, params_np, state_np)
    p, s, o, loss = make_train_step(net, accum_steps=2)(p, s, o, x)

    rp, state, ro = _port_start(net, params_np, state_np)
    leaves = {k: v.detach().requires_grad_(True) for k, v in rp.items()}
    ref_loss = 0.0
    for half in (slice(0, 2), slice(2, 4)):
        ex = execute(net, leaves, state,
                     {k: v[half] for k, v in x.items()}, Mode.TRAIN)
        ex.surrogate.backward()
        state = ex.state
        ref_loss = ref_loss + sum(ex.metrics) / len(ex.metrics)
    grads = {t.key: leaves[t.key].grad for t in net.param_specs()
             if t.trainable}
    rp, ro = learner.apply_updates(net, rp, grads, ro)
    assert torch.equal(loss, ref_loss)
    _same([p, s, o["velocity"]], [rp, state, ro["velocity"]])


def test_split_phase_equals_train_on_batch(tiny):
    """Session.forward / backward / update: bit-equal to train_on_batch
    without augmentation."""
    _, net, params_np, state_np = tiny
    net.device_augment = None
    rng = np.random.RandomState(18)
    x, lab = _images(rng, BATCH), _det_labels(rng)
    sessions = []
    for _ in range(2):
        sess = Session(net, 0, device="cpu")
        sess.params, sess.state = bridge.params_from_numpy(
            net, params_np, state_np)
        sessions.append(sess.compile_net())
    a, b = sessions
    with pytest.raises(RuntimeError, match="forward"):
        b.backward()
    for _ in range(2):
        la = a.train_on_batch(x, lab)
        lb = b.forward(x, lab)
        grads = b.backward()
        b.update()
        assert torch.equal(la, lb)
        assert set(grads) == {t.key for t in net.param_specs()
                              if t.trainable}
    _same([a.params, a.state, a.opt_state["velocity"]],
          [b.params, b.state, b.opt_state["velocity"]])
    with pytest.raises(RuntimeError, match="forward"):
        b.backward()  # the record is spent

    # outside TRAIN: no record, no state change
    net.set_mode(Mode.VALID)
    try:
        before = {k: t.clone() for k, t in b.state.items()}
        b.forward(x, lab)
        assert all(torch.equal(before[k], b.state[k]) for k in before)
        with pytest.raises(RuntimeError, match="forward"):
            b.backward()
    finally:
        net.set_mode(Mode.TRAIN)


def test_only_qat_is_left_unported(tiny):
    """net.qat, the last attribute the port refused, is ported: no list
    of refused attributes is left, and a QAT net compiles with its
    ranges in the state, one 0-d zero a watched tensor."""
    assert not hasattr(tcompile, "_UNPORTED")
    assert not hasattr(tcompile, "refuse_unported")
    assert Session(tiny[1], 0, device="cpu").last_yolo_stats is None
    net = yolov3_tiny(1, 64, 64, 2, mode=Mode.TRAIN)
    net.qat = True
    sess = Session(net, 0, device="cpu").compile_net()
    ranges = {k: v for k, v in sess.state.items()
              if k.startswith("qat_amax/")}
    # every conv's input and the route concat's two (bcnn_tpu's count)
    assert len(ranges) == 15
    assert all(v.shape == () and float(v) == 0 for v in ranges.values())


# ------------------------------------------- the standalone BN layer #


def _bn_net(cls, mode):
    net = cls(mode)
    net.set_input_shape(12, 12, 3, 2)
    if mode != Mode.PREDICT:
        net.set_sgd_optimizer(0.01, 0.9)
    net.add_convolutional_layer(8, 3, 1, 1, 1, 0, FillerType.XAVIER,
                                Activation.NONE, 0, "input", "c1")
    net.add_batchnorm_layer("c1", "b1")
    net.add_convolutional_layer(27, 1, 1, 0, 1, 0, FillerType.XAVIER,
                                Activation.NONE, 0, "b1", "c2")
    net.add_yolo_layer(3, CLASSES, 4, 6, [0, 1, 2],
                       [float(a) for a in ANCHORS], "c2", "y")
    return net


def test_batchnorm_layer_graph_matches_bcnn_tpu():
    ref, port = _bn_net(JaxNet, JaxMode.TRAIN), _bn_net(Net, Mode.TRAIN)
    rn, pn = ref.nodes[1], port.nodes[1]
    assert pn.type == LayerType.BATCHNORM and rn.type.name == "BATCHNORM"
    assert pn.src == rn.src and pn.dst == rn.dst and pn.param == rn.param
    for i in pn.src[1:]:
        a, b = ref.tensors[i], port.tensors[i]
        assert (a.key, a.kind.name, a.trainable) == (
            b.key, b.kind.name, b.trainable)
        assert tuple(a.mem_shape) == tuple(b.mem_shape)
    with pytest.raises(ValueError, match="first layer"):
        Net(Mode.TRAIN).add_batchnorm_layer("input", "b")


@pytest.mark.parametrize("case", ["predict", "predict_bf16", "train_act16"])
def test_batchnorm_layer_matches_bcnn_tpu(case):
    """The standalone BN layer's output against bcnn_tpu's: PREDICT in
    fp32 and with compute_dtype = act_dtype = bf16 (per-channel affine in
    fp32), and a TRAIN forward and backward with compute_dtype =
    train_act_dtype = bf16 (BN in fp32 on the upcast input, its stats
    fp32)."""
    train = case == "train_act16"
    jnet = _bn_net(JaxNet, JaxMode.TRAIN if train else JaxMode.PREDICT)
    net = _bn_net(Net, Mode.TRAIN if train else Mode.PREDICT)
    if case != "predict":
        jnet.compute_dtype = jnp.bfloat16
        net.compute_dtype = torch.bfloat16
        if train:
            jnet.train_act_dtype, net.train_act_dtype = (
                jnp.bfloat16, torch.bfloat16)
        else:
            jnet.act_dtype, net.act_dtype = jnp.bfloat16, torch.bfloat16
    jp, _ = jax_init_params(jnet, 0)
    params_np = {k: np.asarray(v) for k, v in jp.items()}
    rng = np.random.RandomState(19)
    params_np["c1_scales"] = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    params_np["c1_b"] = rng.randn(8).astype(np.float32)
    state_np = _bn_stats(jnet.state_specs())
    x = rng.randn(2, 3, 12, 12).astype(np.float32)
    lab = _det_labels(rng)
    jmode = JaxMode.TRAIN if train else JaxMode.PREDICT
    b1 = net.get_tensor_index_by_name("b1")

    def jfwd(p):
        ex = jax_execute(jnet, p, {k: jnp.asarray(v)
                                   for k, v in state_np.items()},
                         {"input": jnp.asarray(x), "label": jnp.asarray(lab)},
                         jmode)
        return ex.surrogate, (ex.values[b1], ex.state)

    jparams = {k: jnp.asarray(v) for k, v in params_np.items()}
    (_, (jb1, jstate)), jgrads = jax.jit(
        jax.value_and_grad(jfwd, has_aux=True))(jparams)
    params, state = bridge.params_from_numpy(net, params_np, state_np)
    leaves = {k: v.requires_grad_(train) for k, v in params.items()}
    with torch.set_grad_enabled(train):
        ex = execute(net, leaves, state, {"input": torch.from_numpy(x),
                                          "label": torch.from_numpy(lab)},
                     Mode.TRAIN if train else Mode.PREDICT)
    got = ex.values[b1]
    assert str(got.dtype).split(".")[1] == str(jb1.dtype)
    ref = np.transpose(np.asarray(jb1, np.float32), (0, 3, 1, 2))
    tol = 2.0 ** -7 if case != "predict" else 1e-5
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=0,
                               atol=tol * np.abs(ref).max())
    if train:
        for k, v in ex.state.items():
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), np.asarray(jstate[k]),
                                       rtol=1e-3, atol=1e-5, err_msg=k)
        ex.surrogate.backward()
        g = bridge.params_to_numpy(net, {k: v.grad for k, v in
                                         leaves.items()})
        for k in ("input_w", "c1_scales", "c1_b", "b1_w"):
            r = np.asarray(jgrads[k])
            cos = float((g[k].ravel() @ r.ravel())
                        / (np.linalg.norm(g[k]) * np.linalg.norm(r)))
            assert cos > 0.999, (k, cos)
