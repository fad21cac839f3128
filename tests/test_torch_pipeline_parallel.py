"""The pipeline stages of the port (`bcnn_tpu_torch.parallel.pipeline`:
`split_stages`, `stage_io`, `Pipeline`) against `bcnn_tpu.parallel.
pipeline`, and the executor's range form (`compile._Executor.run(lo, hi,
taps_in)`) against its whole-graph run.

One cluster of 3 gloo ranks (tests/torch_parallel_ranks.py) starts once
for the module and runs every case of tests/test_pipeline.py:76-455 on
the same nets, batches and stage layouts (a stage a rank, and the DP x
PP layout [[0, 1], [2]]), while this process computes bcnn_tpu's
Pipeline on as many of the faked CPU devices of tests/conftest.py, on
the same weights (bcnn_tpu's `init_params`, through
`bridge.params_from_numpy`). Other cases run in this process: the
split and the IO sets on five nets for 1 to 6 stages, the range form,
the executor's dtypes, a pipeline whose stages all sit on rank 0
(YOLOv3-tiny at 96 px, batch 4, with dropout) and the settings the
Pipeline refuses.

Bounds (tests/test_pipeline.py's): losses rtol 1e-5; parameters rtol
1e-5, atol 1e-6 (lenet at one microbatch, the BN-free net, 1F1B) or
rtol 1e-4 with atol 1e-5 (the branched net, DP x PP) or 1e-6 (the BN
nets); running stats rtol 1e-4, atol 1e-6. Against bcnn_tpu a forward
is held within rtol 1e-4, atol 1e-6 (the port's fp32 forward bound,
tests/test_torch_parallel.py) where bcnn_tpu holds its own bit for bit,
and the port's pipeline is held to the port's one-device programs as
bcnn_tpu's is to its own: bit for bit for a forward on one microbatch,
within rtol 1e-6, atol 1e-6 on four, and its training steps to
`make_train_step(accum_steps=k)` within the bounds above. An int8
forward returns its int8-flow outputs as codes, as bcnn_tpu's does:
bit-equal to the port's one-device codes, and within
tests/test_torch_quant.HEAD_TOL of bcnn_tpu's largest value. 1F1B and
GPipe are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcnn_tpu as bt
from bcnn_tpu import learner as jlearner
from bcnn_tpu import models as jmodels
from bcnn_tpu.compile import init_params as jax_init_params
from bcnn_tpu.ops import quant as jq
from bcnn_tpu.parallel import pipeline as jpp

from bcnn_tpu_torch import bridge, models
from bcnn_tpu_torch.compile import (_Executor, execute, make_train_step,
                                    value_dtypes)
from bcnn_tpu_torch.learner import init_opt_state
from bcnn_tpu_torch.parallel import Pipeline, pipeline as tpp
from bcnn_tpu_torch.types import LayerType, Mode
from tests import torch_parallel_ranks as tr
from tests.test_torch_quant import HEAD_TOL
from tests.test_torch_train_shortcut import assert_updates, det_labels

torch.set_num_threads(1)

WORLD = 3
B = tr.PP_BATCH
FWD_RTOL, FWD_ATOL = 1e-4, 1e-6
LOSS_RTOL = 1e-5
STATE_RTOL, STATE_ATOL = 1e-4, 1e-6
SPLIT_NETS = ("lenet", "cifar10_resnet", "yolov3_tiny", "mobilenet_v1",
              "resnet18")
REFUSED = {"device_augment": {"random_fliph": 1}, "accum_steps": 2,
           "yolo_stats": True, "qat": True}


# ------------------------------------------------------------ inputs #


def jax_net(name):
    return tr.build_net(bt, jmodels, name)


def port_net(name):
    return tr.build_net(__import__("bcnn_tpu_torch"), models, name)


def weights(name):
    """bcnn_tpu's init_params of the net, numpy (its layout)."""
    p, s = jax_init_params(jax_net(name), 0)
    return ({k: np.asarray(v) for k, v in p.items()},
            {k: np.asarray(v) for k, v in s.items()})


def mnist_batch(rng, n=B):
    lab = rng.randint(0, 10, n)
    x = rng.randn(n, 1, 28, 28).astype(np.float32) * 0.1
    for i, c in enumerate(lab):
        x[i, 0, c:c + 8, c:c + 8] += 1.0
    y = np.zeros((n, 10, 1, 1), np.float32)
    y[np.arange(n), lab] = 1.0
    return x, y


def cifar_batch(rng, n=B):
    x = rng.randn(n, 3, 32, 32).astype(np.float32) * 0.1
    y = np.zeros((n, 10, 1, 1), np.float32)
    y[np.arange(n), rng.randint(0, 10, n)] = 1.0
    return x, y


def noise_batch(rng, n=B):
    x = rng.randn(n, 3, 16, 16).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)].reshape(
        n, 10, 1, 1)
    return x, y


def quadrant_batch(rng, n=B):
    lab = rng.randint(0, 4, n)
    x = rng.randn(n, 3, 16, 16).astype(np.float32) * 0.1
    for i, c in enumerate(lab):
        r, col = divmod(int(c), 2)
        x[i, :, r * 8:(r + 1) * 8, col * 8:(col + 1) * 8] += 1.5
    y = np.zeros((n, 10, 1, 1), np.float32)
    y[np.arange(n), lab] = 1.0
    return x, y


def mobilenet_quant(w, x):
    jnet = jax_net("mobilenet")
    jp = {k: jnp.asarray(v) for k, v in w[0].items()}
    js = {k: jnp.asarray(v) for k, v in w[1].items()}
    return {"act_scales": jq.calibrate(jnet, jp, js, [x]),
            "weights": jax.tree.map(np.asarray,
                                    jq.quantize_weights(jnet, jp))}


def int8_flow_name(quant):
    """A tensor of MobileNet-v1's int8 flow (its int8 codes cross a
    stage boundary)."""
    from bcnn_tpu_torch.ops.quant import plan_int8_flow

    net = port_net("mobilenet")
    flow = plan_int8_flow(net, bridge.quant_from_numpy(net, quant))
    return net.tensors[sorted(flow)[5]].name


# the dropout net's stages (conv + BN | dropout | FC, softmax, cost) on
# the ranks, each seeding torch's default generator with DROP_SEED + rank
DROP_CUTS, DROP_SEED = [(0, 1), (1, 2), (2, 5)], 1
# every training case: (net, stages, n_micro, batches key, warm, bounds);
# None: tests/test_torch_train_shortcut.assert_updates against a float64
# run of the same steps
TRAIN = {
    "lenet": ("pp_lenet", [[0], [1]], 1, "mnist3", False, None),
    "cifar": ("pp_cifar", [[0], [1], [2]], 1, "cifar2", False,
              (1e-4, 1e-5)),
    "bnfree": ("pp_bnfree", [[0], [1]], 4, "noise2", False, (1e-5, 1e-6)),
    "dp_pp": ("pp_lenet", [[0, 1], [2]], 1, "mnist1", False, (1e-4, 1e-5)),
    "bn_accum": ("pp_bn", [[0], [1]], 4, "quad2", False, (1e-4, 1e-6)),
    "bn_frozen": ("pp_bn_frozen", [[0], [1]], 4, "quad2b", True,
                  (1e-4, 1e-6)),
}


def make_inputs():
    inp = {n: weights(n) for n in ("pp_lenet", "pp_cifar", "pp_bnfree",
                                   "pp_bn", "pp_bn_frozen")}
    inp["mobilenet"] = bridge.he_numpy_weights(port_net("mobilenet"), 3)
    inp["pp_dropout"] = bridge.he_numpy_weights(port_net("pp_dropout"), 3)
    rng = np.random.RandomState(9)
    inp["drop_batch"] = (rng.randn(B, 3, 8, 8).astype(np.float32),
                         noise_batch(rng)[1])
    inp["batches"] = {
        "mnist3": [mnist_batch(np.random.RandomState(2)) for _ in range(3)],
        "cifar2": [cifar_batch(np.random.RandomState(3)) for _ in range(2)],
        "noise2": [noise_batch(np.random.RandomState(4)) for _ in range(2)],
        "noise1": [noise_batch(np.random.RandomState(6))],
        "mnist1": [mnist_batch(np.random.RandomState(5))],
        "quad2": [quadrant_batch(np.random.RandomState(5))
                  for _ in range(2)],
        "quad2b": [quadrant_batch(np.random.RandomState(6))
                   for _ in range(2)],
    }
    rng = np.random.RandomState(7)
    inp["converge"] = [quadrant_batch(rng) for _ in range(80)]
    inp["fwd_x"] = mnist_batch(np.random.RandomState(0))[0]
    inp["fwd_x4"] = mnist_batch(np.random.RandomState(1))[0]
    inp["mb_x"] = np.random.RandomState(8).rand(
        tr.MB_BATCH, 3, tr.MB_SIZE, tr.MB_SIZE).astype(np.float32)
    inp["quant"] = mobilenet_quant(inp["mobilenet"], inp["mb_x"])
    inp["flow_out"] = int8_flow_name(inp["quant"])
    return inp


def rank_cases(inp):
    def w(name):
        return {"p": inp[name][0], "s": inp[name][1]}

    cases = {
        name: dict(kind="pipeline", net=net, stages=stages, n_micro=nm,
                   batches=inp["batches"][bkey], warm=warm, **w(net))
        for name, (net, stages, nm, bkey, warm, _) in TRAIN.items()}
    cases["1f1b"] = dict(kind="pipeline", net="pp_bnfree",
                         stages=[[0], [1]], n_micro=4,
                         schedules=("1f1b", "gpipe"),
                         batches=inp["batches"]["noise1"], **w("pp_bnfree"))
    cases["converge"] = dict(kind="pipeline", net="pp_bn_frozen",
                             stages=[[1], [2]], n_micro=2, warm=True,
                             batches=inp["converge"], **w("pp_bn_frozen"))
    cases["fwd3"] = dict(kind="pipeline", net="pp_lenet_predict",
                         stages=[[0], [1], [2]], x=inp["fwd_x"],
                         outputs=["softmax"], **w("pp_lenet"))
    cases["fwd_micro"] = dict(kind="pipeline", net="pp_lenet_predict",
                              stages=[[0], [1]], n_micro=4, x=inp["fwd_x4"],
                              outputs=["softmax"], **w("pp_lenet"))
    cases["fwd_int8"] = dict(kind="pipeline", net="mobilenet",
                             stages=[[0], [1, 2]], x=inp["mb_x"],
                             quant=inp["quant"],
                             outputs=[inp["flow_out"], "fc", "softmax"],
                             **w("mobilenet"))
    cases["dropout"] = dict(kind="pipeline", net="pp_dropout",
                            stages=[[0], [1], [2]], boundaries=DROP_CUTS,
                            n_micro=2, default_seed=DROP_SEED,
                            batches=[inp["drop_batch"]], **w("pp_dropout"))
    return cases


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


@pytest.fixture(scope="module")
def cluster(inputs, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("pipeline3"))
    c = tr.launch(WORLD, rank_cases(inputs), workdir)
    yield c
    c.results()


def ranks(cluster, case):
    """Every rank's outputs of `case`, checked equal across the ranks (the
    gathered trees, the losses and the forwards' outputs)."""
    outs = [r[case] for r in cluster.results()]
    for o in outs[1:]:
        for a, b in zip(o.get("outs", []), outs[0].get("outs", [])):
            np.testing.assert_array_equal(a, b)
        for sched, res in o.items():
            if not isinstance(res, dict):
                continue
            for key in ("params", "state"):
                for k, v in res[key].items():
                    np.testing.assert_array_equal(
                        v, outs[0][sched][key][k], err_msg=k)
            np.testing.assert_array_equal(res["losses"],
                                          outs[0][sched]["losses"])
    return outs


# ------------------------------------------------------- references #


def jax_pipeline(name, w, stages, n_micro, batches, warm=False,
                 schedule="gpipe"):
    """bcnn_tpu's Pipeline steps on the faked CPU devices (stage ranks as
    device indices): (params, state, losses), numpy."""
    jnet = jax_net(name)
    devs = jax.devices()
    pipe = jpp.Pipeline(jnet, [[devs[r] for r in rs] for rs in stages],
                        bt.Mode.TRAIN, n_microbatches=n_micro,
                        schedule=schedule)
    jp = {k: jnp.asarray(v) for k, v in w[0].items()}
    s = tr.warm(w[1]) if warm else w[1]
    js = {k: jnp.asarray(v) for k, v in s.items()}
    ps, ss, os_ = pipe.shard(jp, js, jlearner.init_opt_state(jnet, jp))
    key = jax.random.PRNGKey(17)
    losses = []
    for i, (x, y) in enumerate(batches):
        ps, ss, os_, loss = pipe.train_on_batch(
            ps, ss, os_, {"input": x, "label": y}, jax.random.fold_in(key, i))
        losses.append(float(loss))
    return ({k: np.asarray(v) for k, v in pipe.gather(ps).items()},
            {k: np.asarray(v) for k, v in pipe.gather(ss).items()},
            np.asarray(losses))


def port_steps(name, w, batches, accum, warm=False, dtype=torch.float32):
    """The port's one-device make_train_step(accum_steps=accum), in
    dtype."""
    net = port_net(name)
    params, state = bridge.params_from_numpy(
        net, w[0], tr.warm(w[1]) if warm else w[1])
    params = {k: v.to(dtype) for k, v in params.items()}
    state = {k: v.to(dtype) for k, v in state.items()}
    opt = init_opt_state(net, params)
    step = make_train_step(net, accum_steps=accum)
    losses = []
    for x, y in batches:
        params, state, opt, loss = step(params, state, opt, {
            "input": torch.from_numpy(x).to(dtype),
            "label": torch.from_numpy(y).to(dtype)})
        losses.append(float(loss))
    return (bridge.params_to_numpy(net, params),
            bridge.params_to_numpy(net, state), np.asarray(losses))


def close(got, ref, rtol, atol):
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


# ------------------------------------------------------ split and IO #


def split_net(pkg, mods, name, mode):
    if name == "lenet":
        return mods.lenet_mnist(8, mode)
    if name == "cifar10_resnet":
        return mods.cifar10_resnet(8, mode)
    if name == "yolov3_tiny":
        return mods.yolov3_tiny(2, 416, 416, 80, mode=mode)
    if name == "mobilenet_v1":
        return mods.mobilenet_v1(2, 1000, mode)
    return mods.resnet18(2, 1000, mode)


@pytest.mark.parametrize("mode", ["TRAIN", "PREDICT"])
@pytest.mark.parametrize("name", SPLIT_NETS)
def test_split_and_io_equal_bcnn_tpus(name, mode):
    """split_stages, stage_io (every set of every stage, the routing taps
    included) and the metric counts equal bcnn_tpu's, for 1 to 6
    stages."""
    jnet = split_net(bt, jmodels, name, getattr(bt.Mode, mode))
    net = split_net(None, models, name, getattr(Mode, mode))
    for n in range(1, 7):
        ranges = tpp.split_stages(net, n)
        assert ranges == jpp.split_stages(jnet, n), (name, n)
        mine = tpp.stage_io(net, ranges, getattr(Mode, mode))
        want = jpp.stage_io(jnet, ranges, getattr(bt.Mode, mode))
        for a, b in zip(mine, want):
            assert vars(a) == vars(b), (name, n)
        assert [tpp._metric_count(net, lo, hi, getattr(Mode, mode))
                for lo, hi in ranges] == [
            jpp._metric_count(jnet, lo, hi, getattr(bt.Mode, mode))
            for lo, hi in ranges]
    if name == "cifar10_resnet" and mode == "TRAIN":
        taps = tpp.stage_io(net, tpp.split_stages(net, 3), Mode.TRAIN)
        assert any(io.taps_in for io in taps)


def test_split_stages_contiguous_cover():
    net = models.lenet_mnist(8)
    for n_stages in (1, 2, 3, 4):
        ranges = tpp.split_stages(net, n_stages)
        assert len(ranges) == n_stages
        assert ranges[0][0] == 0 and ranges[-1][1] == len(net.nodes)
        for (a, b), (c, d) in zip(ranges, ranges[1:]):
            assert b == c and a < b and c < d
    with pytest.raises(ValueError):
        tpp.split_stages(net, len(net.nodes) + 1)


def test_stage_io_boundary_sets():
    net = models.lenet_mnist(8)
    ios = tpp.stage_io(net, tpp.split_stages(net, 2), Mode.TRAIN)
    assert 0 in ios[0].ext_in
    assert ios[0].pipe_in == []
    assert ios[1].pipe_in == ios[0].pipe_out and ios[0].pipe_out
    assert 1 in ios[1].ext_in
    all_keys = ios[0].param_keys + ios[1].param_keys
    assert len(all_keys) == len(set(all_keys))


# -------------------------------------------------------- range form #


@pytest.fixture(scope="module")
def resnet_run():
    """cifar10_resnet in TRAIN at batch 8 run whole: its weights, batch,
    surrogate's gradients, loss, outputs and running stats."""
    net = models.cifar10_resnet(B)
    w = bridge.he_numpy_weights(net, 1)
    x, y = cifar_batch(np.random.RandomState(9))
    batch = {"input": torch.from_numpy(x), "label": torch.from_numpy(y)}
    params, state = bridge.params_from_numpy(net, *w)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    ex = execute(net, leaves, state, batch, Mode.TRAIN)
    ex.surrogate.backward()
    return net, w, batch, ex, {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("cut", range(1, 25))
def test_range_form_train_equals_whole_run(resnet_run, cut):
    """Nodes [0, cut) then [cut, n) with the values and routing taps
    carried across: the loss, every output, the running stats and every
    gradient bit for bit those of run()."""
    net, w, batch, whole, grads = resnet_run
    assert len(net.nodes) == 25
    params, state = bridge.params_from_numpy(net, *w)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    a = _Executor(net, leaves, state, Mode.TRAIN)
    a.values.update({0: batch["input"], 1: batch["label"]})
    a.run(0, cut)
    b = _Executor(net, leaves, a.state, Mode.TRAIN)
    b.values.update(a.values)
    b.run(cut, None, taps_in=a.taps)
    sur = [s for s in (a.surrogate, b.surrogate) if s is not None]
    sum(sur).backward()
    assert torch.equal(torch.stack(a.metrics + b.metrics),
                       torch.stack(whole.metrics))
    for i, v in whole.values.items():
        assert torch.equal(b.values[i], v), net.tensors[i].name
    for k, v in whole.state.items():
        assert torch.equal(b.state[k], v), k
    for k, g in grads.items():
        assert torch.equal(leaves[k].grad, g), k
    assert set(b.taps) >= set(a.taps)


@pytest.mark.parametrize("cut", [3, 8, 14, 20, 27])
def test_range_form_int8_predict(inputs, cut):
    """The int8 MobileNet-v1 (bcnn_tpu's PTQ dict) in PREDICT cut at
    `cut`: every value, int8 codes included, bit for bit run()'s."""
    net = port_net("mobilenet")
    net.quant = bridge.quant_from_numpy(net, inputs["quant"])
    params, state = bridge.params_from_numpy(net, *inputs["mobilenet"])
    x = torch.from_numpy(inputs["mb_x"])
    with torch.inference_mode():
        whole = execute(net, params, state, {"input": x}, Mode.PREDICT)
        a = _Executor(net, params, state, Mode.PREDICT)
        a.values[0] = x
        a.run(0, cut)
        b = _Executor(net, params, state, Mode.PREDICT)
        b.values.update(a.values)
        b.run(cut)
    assert sum(v.dtype == torch.int8 for v in whole.values.values()) > 10
    for i, v in whole.values.items():
        assert b.values[i].dtype == v.dtype and torch.equal(b.values[i], v)


# ------------------------------------------------ the executor's dtypes #


def _dtype_nets():
    tiny = models.yolov3_tiny(2, 64, 64, 4, mode=Mode.TRAIN)
    yield "tiny train fp32", tiny, Mode.TRAIN
    tiny = models.yolov3_tiny(2, 64, 64, 4, mode=Mode.TRAIN)
    tiny.compute_dtype = tiny.train_act_dtype = torch.bfloat16
    yield "tiny train bf16", tiny, Mode.TRAIN
    res = models.cifar10_resnet(4)
    res.compute_dtype = res.train_act_dtype = torch.bfloat16
    yield "resnet train bf16", res, Mode.TRAIN
    for dt in (None, torch.bfloat16):
        for make in (lambda: models.yolov3_tiny(2, 64, 64, 4),
                     lambda: models.mobilenet_v1(2, 10, width_mult=0.25)):
            net = make()
            net.compute_dtype = net.act_dtype = dt
            yield f"predict {dt}", net, Mode.PREDICT


@pytest.mark.parametrize("case", range(7))
def test_value_dtypes_match_the_executor(case):
    """compile.value_dtypes gives the dtype each produced tensor has,
    fp32 and bf16, TRAIN and PREDICT (the int8 flow in the forward
    cases)."""
    label, net, mode = list(_dtype_nets())[case]
    params, state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0))
    t0 = net.tensors[0]
    x = torch.rand(net.batch_size, t0.c, t0.h, t0.w)
    with torch.no_grad():
        ex = execute(net, params, state, {"input": x}, mode)
    want = value_dtypes(net, mode)
    for i, v in ex.values.items():
        if i in want:
            assert v.dtype == want[i], (label, net.tensors[i].name)


def test_value_dtypes_int8_flow(inputs):
    net = port_net("mobilenet")
    net.quant = bridge.quant_from_numpy(net, inputs["quant"])
    params, state = bridge.params_from_numpy(net, *inputs["mobilenet"])
    with torch.no_grad():
        ex = execute(net, params, state,
                     {"input": torch.from_numpy(inputs["mb_x"])},
                     Mode.PREDICT)
    want = value_dtypes(net, Mode.PREDICT)
    assert torch.int8 in want.values()
    for i, v in ex.values.items():
        if i in want:
            assert v.dtype == want[i], net.tensors[i].name


# ------------------------------------------------------------ forward #


def port_forward(net_name, w, x, outputs, quant=None):
    """The port's one-device forward, each output as the executor holds
    it (an int8-flow one as its codes)."""
    net = port_net(net_name)
    if quant is not None:
        net.quant = bridge.quant_from_numpy(net, quant)
    params, state = bridge.params_from_numpy(net, *w)
    with torch.inference_mode():
        ex = execute(net, params, state, {"input": torch.from_numpy(x)},
                     Mode.PREDICT)
        return [ex.values[net.get_tensor_index_by_name(o)].numpy()
                for o in outputs]


def jax_forward(net_name, w, x, stages, outputs, n_micro=1, quant=None):
    jnet = jax_net(net_name)
    if quant is not None:
        jnet.quant = quant
    devs = jax.devices()
    pipe = jpp.Pipeline(jnet, [[devs[r] for r in rs] for rs in stages],
                        mode=bt.Mode.PREDICT, n_microbatches=n_micro,
                        output_names=outputs)
    ps, ss = pipe.shard({k: jnp.asarray(v) for k, v in w[0].items()},
                        {k: jnp.asarray(v) for k, v in w[1].items()})
    return [np.asarray(o) for o in pipe.forward(ps, ss, {"input": x})]


def test_pp_forward_matches_single_device(cluster, inputs):
    """3 stages, one microbatch: bit for bit the port's one-device
    forward, and within the fp32 forward bound of bcnn_tpu's Pipeline."""
    w, x = inputs["pp_lenet"], inputs["fwd_x"]
    got = ranks(cluster, "fwd3")[0]["outs"][0]
    (one,) = port_forward("pp_lenet_predict", w, x, ["softmax"])
    np.testing.assert_array_equal(got, one)
    (ref,) = jax_forward("pp_lenet_predict", w, x, [[0], [1], [2]],
                         ["softmax"])
    np.testing.assert_allclose(got, ref, rtol=FWD_RTOL, atol=FWD_ATOL)


def test_pp_forward_microbatched(cluster, inputs):
    """2 stages, 4 microbatches: PREDICT has no batch coupling."""
    w, x = inputs["pp_lenet"], inputs["fwd_x4"]
    got = ranks(cluster, "fwd_micro")[0]["outs"][0]
    (one,) = port_forward("pp_lenet_predict", w, x, ["softmax"])
    np.testing.assert_allclose(got, one, rtol=1e-6, atol=1e-6)
    (ref,) = jax_forward("pp_lenet_predict", w, x, [[0], [1]], ["softmax"],
                         n_micro=4)
    np.testing.assert_allclose(got, ref, rtol=FWD_RTOL, atol=FWD_ATOL)


def test_pp_forward_int8_with_a_data_parallel_stage(cluster, inputs):
    """int8 MobileNet-v1 on [[0], [1, 2]] (the second stage's microbatch
    striped over two ranks): an int8-flow output comes back as its int8
    codes, as bcnn_tpu's Pipeline returns it, bit for bit the port's
    one-device codes; fc and softmax likewise; each within HEAD_TOL of
    bcnn_tpu's Pipeline's largest value."""
    outs = [inputs["flow_out"], "fc", "softmax"]
    res = ranks(cluster, "fwd_int8")[0]
    assert res["dtypes"] == ["torch.int8", "torch.float32", "torch.float32"]
    one = port_forward("mobilenet", inputs["mobilenet"], inputs["mb_x"], outs,
                       inputs["quant"])
    ref = jax_forward("mobilenet", inputs["mobilenet"], inputs["mb_x"],
                      [[0], [1, 2]], outs, quant=inputs["quant"])
    assert ref[0].dtype == np.int8
    for g, o, r in zip(res["outs"], one, ref):
        np.testing.assert_array_equal(g, o)
        g, r = g.astype(np.float64), r.astype(np.float64)
        assert np.abs(g - r).max() <= HEAD_TOL * np.abs(r).max()
    assert np.abs(res["outs"][0]).max() > 0


# ----------------------------------------------------------- training #


@pytest.mark.parametrize("case", list(TRAIN))
def test_pp_train_matches_bcnn_tpu(cluster, inputs, case):
    """Each training case of tests/test_pipeline.py on the ranks: lenet on
    2 stages at one microbatch (3 steps); cifar10_resnet on 3 stages with
    cross-stage routing taps (2 steps); the BN-free net at 4 microbatches
    (2 steps); DP x PP [[0, 1], [2]] (1 step); the BN net at 4
    microbatches (2 steps) and with frozen stats from warm running
    stats. Held to bcnn_tpu's Pipeline and to the port's own
    make_train_step(accum_steps=n_micro): losses, parameters, running
    stats. lenet's three steps leave either package's fp32 parameters
    1.2e-4 to 4.8e-4 of the largest update from a float64 run of the
    same steps, over the 1e-5 bound, so there the update (the params
    after the steps, less the start) is held to bcnn_tpu's and to that
    float64 run by `assert_updates` (tests/test_torch_train_shortcut.py),
    each running stat to bcnn_tpu's within its bound or twice bcnn_tpu's
    own distance to the float64 run, and the port's pipeline to the
    port's one-device steps at rtol 1e-5, atol 1e-6."""
    name, stages, n_micro, bkey, warm, bound = TRAIN[case]
    rtol, atol = bound or (1e-5, 1e-6)
    w, batches = inputs[name], inputs["batches"][bkey]
    got = ranks(cluster, case)[0]["gpipe"]
    assert all(s == len(batches) * B for s in got["seen"])
    jp, js, jl = jax_pipeline(name, w, stages, n_micro, batches, warm)
    np.testing.assert_allclose(got["losses"], jl, rtol=LOSS_RTOL)
    if bound is None:
        net = port_net(name)
        exact, exact_s, _ = port_steps(name, w, batches, n_micro, warm,
                                       torch.float64)
        params, _ = bridge.params_from_numpy(net, got["params"], w[1])
        assert_updates(net, w[0], w[1], None, None, params, jp, exact=exact)
        for k, v in js.items():
            lim = max(STATE_RTOL * np.abs(v).max() + STATE_ATOL,
                      2 * np.abs(v - exact_s[k]).max())
            assert np.abs(got["state"][k] - v).max() <= lim, k
    else:
        close(got["params"], jp, rtol, atol)
        close(got["state"], js, STATE_RTOL, STATE_ATOL)
    op, os_, ol = port_steps(name, w, batches, n_micro, warm)
    np.testing.assert_allclose(got["losses"], ol, rtol=LOSS_RTOL)
    close(got["params"], op, rtol, atol)
    close(got["state"], os_, STATE_RTOL, STATE_ATOL)


def test_pp_1f1b_schedule_identical_to_gpipe(cluster, inputs):
    """1F1B frees each microbatch's stash after its backward: bit for bit
    GPipe's numbers, and within the bounds of bcnn_tpu's 1F1B pipeline
    (the BN-free net, 4 microbatches, one step)."""
    res = ranks(cluster, "1f1b")[0]
    a, b = res["1f1b"], res["gpipe"]
    for key in ("params", "state"):
        for k, v in a[key].items():
            np.testing.assert_array_equal(v, b[key][k], err_msg=k)
    np.testing.assert_array_equal(a["losses"], b["losses"])
    w, batches = inputs["pp_bnfree"], inputs["batches"]["noise1"]
    jp, _, jl = jax_pipeline("pp_bnfree", w, [[0], [1]], 4, batches,
                             schedule="1f1b")
    np.testing.assert_allclose(a["losses"], jl, rtol=LOSS_RTOL)
    close(a["params"], jp, 1e-5, 1e-6)


def test_pp_microbatched_bn_net_converges(cluster):
    """Microbatched PP with frozen-stats BN trains: the loss of the last 5
    of 80 steps under 0.12 of the first 5's (stages on ranks 1 and 2,
    rank 0 idle)."""
    losses = ranks(cluster, "converge")[0]["gpipe"]["losses"]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first * 0.12, (first, last)


# ------------------------------------------- one process, all on rank 0 #


def tiny_dropout():
    """YOLOv3-tiny at 96 px, batch 4, 4 classes, with dropout (rate 0.3)
    on lid13, in place, before the 1x1 conv that reads it."""
    net = models.yolov3_tiny(4, 96, 96, 4, mode=Mode.TRAIN)
    net.add_dropout_layer(0.3, "lid13")
    pos = next(i for i, n in enumerate(net.nodes)
               if n.dst and net.tensors[n.dst[0]].name == "lid13")
    net.nodes.insert(pos + 1, net.nodes.pop())
    return net


@pytest.fixture(scope="module")
def tiny_case():
    net = tiny_dropout()
    w = bridge.he_numpy_weights(net, 3)
    rng = np.random.RandomState(11)
    x = (rng.rand(4, 3, 96, 96) * 2 - 1).astype(np.float32)
    return net, w, {"input": x, "label": det_labels(rng, 4, classes=4)}


@pytest.mark.parametrize("n_micro,schedule",
                         [(1, "gpipe"), (2, "gpipe"), (2, "1f1b")])
def test_one_process_pipeline_equals_accumulation(tiny_case, n_micro,
                                                  schedule):
    """Every stage on rank 0, no process group: 3 stages of YOLOv3-tiny
    with dropout equal the port's make_train_step(accum_steps=n_micro)
    under the same generator (the same masks: each microbatch's seed
    drawn from its child generator), parameters and running stats bit
    for bit, the loss within rtol 1e-6 (a sum over n, not a sum of
    means); every recompute bit-equal to its first forward."""
    net, w, batch = tiny_case
    params, state = bridge.params_from_numpy(net, *w)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p1, s1, _, l1 = make_train_step(net, accum_steps=n_micro)(
        {k: v.clone() for k, v in params.items()}, dict(state),
        init_opt_state(net, params), tb, torch.Generator().manual_seed(5))
    pipe = Pipeline(net, [[0]] * 3, Mode.TRAIN, n_microbatches=n_micro,
                    schedule=schedule, device="cpu")
    pipe._check_recompute = True
    assert any(n.type == LayerType.DROPOUT
               for n in net.nodes[slice(*pipe.ranges[1])] +
               net.nodes[slice(*pipe.ranges[2])])
    ps, ss, os_ = pipe.shard(params, state, init_opt_state(net, params))
    ps, ss, os_, loss = pipe.train_on_batch(
        ps, ss, os_, batch, torch.Generator().manual_seed(5))
    got_p, got_s = pipe.gather(ps), pipe.gather(ss)
    for k, v in p1.items():
        assert torch.equal(got_p[k], v), k
    for k, v in s1.items():
        assert torch.equal(got_s[k], v), k
    np.testing.assert_allclose(float(loss), float(l1), rtol=1e-6)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_dropout_without_a_generator_recomputes_the_forward(tiny_case,
                                                            n_micro):
    """With no generator, a net with dropout draws each microbatch's seed
    from torch's default generator, so each recompute draws its forward's
    masks: every recompute is bit-equal to its forward; one microbatch
    equals make_train_step under a generator in the default one's state,
    bit for bit; at two, 1F1B equals GPipe under the same default
    state."""
    net, w, batch = tiny_case
    params, state = bridge.params_from_numpy(net, *w)

    def piped(schedule):
        pipe = Pipeline(net, [[0]] * 3, Mode.TRAIN, n_microbatches=n_micro,
                        schedule=schedule, device="cpu")
        pipe._check_recompute = True
        ps, ss, os_ = pipe.shard(params, state, init_opt_state(net, params))
        torch.manual_seed(21)
        ps, ss, _, loss = pipe.train_on_batch(ps, ss, os_, batch)
        return pipe.gather(ps), pipe.gather(ss), float(loss)

    got_p, got_s, loss = piped("gpipe")
    if n_micro == 1:
        want_p, want_s, _, want_l = make_train_step(net)(
            {k: v.clone() for k, v in params.items()}, dict(state),
            init_opt_state(net, params),
            {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.Generator().manual_seed(21))
        want_l = float(want_l)
    else:
        want_p, want_s, want_l = piped("1f1b")
    for k, v in want_p.items():
        assert torch.equal(got_p[k], v), k
    for k, v in want_s.items():
        assert torch.equal(got_s[k], v), k
    np.testing.assert_allclose(loss, want_l, rtol=1e-6)


def test_dropout_without_a_generator_on_the_ranks(cluster, inputs):
    """With no generator, rank 0's default-generator seeds are broadcast:
    a dropout net on 3 ranks (dropout alone on rank 1), each rank's
    default generator seeded apart, equals, bit for bit, the one-process
    pipeline on the same cuts under rank 0's default seed; every
    recompute bit-equal to its forward."""
    outs = ranks(cluster, "dropout")
    net = port_net("pp_dropout")
    pipe = Pipeline(net, [[0]] * 3, Mode.TRAIN, n_microbatches=2,
                    boundaries=DROP_CUTS, device="cpu")
    params, state = bridge.params_from_numpy(net, *inputs["pp_dropout"])
    ps, ss, os_ = pipe.shard(params, state, init_opt_state(net, params))
    x, y = inputs["drop_batch"]
    torch.manual_seed(DROP_SEED)
    ps, ss, _, loss = pipe.train_on_batch(ps, ss, os_,
                                          {"input": x, "label": y})
    got = outs[0]["gpipe"]
    for key, tree in (("params", ps), ("state", ss)):
        mine = bridge.params_to_numpy(net, pipe.gather(tree))
        for k, v in mine.items():
            np.testing.assert_array_equal(got[key][k], v, err_msg=k)
    np.testing.assert_array_equal(got["losses"], [float(loss)])


# --------------------------------------------------------- refusals #


@pytest.mark.parametrize("attr", list(REFUSED))
def test_pipeline_refuses_what_bcnn_tpu_drops(attr):
    """A TRAIN Pipeline raises on each setting bcnn_tpu's drops, naming
    it; net.qat raises outside PREDICT only (the executor ignores it
    there)."""
    net = models.lenet_mnist(8)
    setattr(net, attr, REFUSED[attr])
    with pytest.raises(ValueError, match=f"net.{attr}"):
        Pipeline(net, [[0], [0]], Mode.TRAIN, device="cpu")
    if attr == "qat":
        pnet = models.lenet_mnist(8, Mode.PREDICT)
        pnet.qat = True
        Pipeline(pnet, [[0], [0]], Mode.PREDICT, device="cpu")
        with pytest.raises(ValueError, match="net.qat"):
            Pipeline(pnet, [[0], [0]], Mode.VALID, device="cpu")


def test_pipeline_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Pipeline(models.lenet_mnist(8), [[0], [0]], Mode.TRAIN)
    with pytest.raises(ValueError, match="rank 0"):
        Pipeline(models.lenet_mnist(8), [[0], [1]], Mode.TRAIN,
                 device="cpu")
