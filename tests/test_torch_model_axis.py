"""The model axis of the port's `parallel` (`bcnn_tpu_torch.parallel.
model_axis`) on gloo ranks on the CPU, each form held against
bcnn_tpu.parallel's counterpart (`make_mesh_2d`, `tp_param_specs`,
`shard_train_state`, `make_dp_tp_train_step`, `make_dp_sp_train_step`,
`make_spatial_forward`) on a CPU mesh of the same shape, D of the 8
faked CPU devices of tests/conftest.py.

One cluster of 4 gloo ranks (its 2x2 and 1x4 meshes) and one of 2
(1x2) start once for the module (tests/torch_parallel_ranks.py) and run
every case while this process computes the references.

Nets: lenet_mnist at batch 16 on bcnn_tpu's init_params weights;
YOLOv3-tiny at 96 px, batch 4, on `bridge.he_numpy_weights` (its 3-row
stage: fewer rows than 4 model ranks, so held whole there, and 6, 12,
... rows cut unevenly); cifar10_convnet, MobileNet-v1 at width 0.25
(96 px) and YOLOv3-tiny (96 px, int8 on bcnn_tpu's PTQ dict) served
at batch 2 by the spatial forward.

Bounds:
  - lenet's steps against bcnn_tpu's: the loss rtol 1e-4, the params
    rtol 1e-4, atol 1e-5 (tests/test_parallel.py:262-365 holds
    bcnn_tpu's own to one device so); the shard shapes of
    shard_train_state as `:313-319` checks them;
  - YOLOv3-tiny's steps under tests/test_torch_train_shortcut.
    assert_updates's rule, against a float64 run of the same step that
    takes the ranks' own kink sides and max-pool picks (`replay.impose`;
    a channel slice or a band of rows of each rank's choices, joined)
    and against bcnn_tpu's program; the running stats rtol 1e-4, atol
    1e-5;
  - every rank's parameters equal, bit for bit: a shard to the shards of
    its model index on the other batch ranks, a replicated tensor to
    every rank's;
  - the spatial forward: fp32 against bcnn_tpu rtol 1e-4, atol 1e-5
    (`tests/test_parallel.py:146-162`) and against the port's one-device
    forward; int8 bit for bit the port's one-device int8 forward, and
    within tests/test_torch_quant.HEAD_TOL of bcnn_tpu's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnn_tpu import learner as jlearner
from bcnn_tpu import parallel as jpar
from bcnn_tpu.ops import quant as jq
from jax.sharding import NamedSharding, PartitionSpec as P

from bcnn_tpu_torch import bridge, replay
from bcnn_tpu_torch.compile import execute, output_value
from bcnn_tpu_torch.types import LayerType, Mode
from tests import torch_parallel_ranks as tr
from tests.test_torch_parallel import (hold, hold_state, jax_net,
                                       lenet_batch, port_net, port_steps)
from tests.test_torch_quant import HEAD_TOL
from tests.test_torch_train_shortcut import LOSS_RTOL, det_labels

torch.set_num_threads(1)

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
# (world, dp): the 2x2 and 1x4 meshes of the 4-rank cluster, the 1x2 one
# of the 2-rank cluster
MESHES = [(4, 2), (4, 1), (2, 1)]
SPEC_NETS = ("lenet", "cifar", "tiny96", "mobilenet96")
FWD_NETS = ("cifar", "mobilenet96", "tiny8")
REFUSED = ("device_augment", "remat", "accum_steps", "yolo_stats")


# ------------------------------------------------------------ inputs #


def weights(name):
    if name == "lenet":
        from bcnn_tpu.compile import init_params

        p, s = init_params(jax_net(name), 0)
        return ({k: np.asarray(v) for k, v in p.items()},
                {k: np.asarray(v) for k, v in s.items()})
    return bridge.he_numpy_weights(port_net(name), 3)


def yolo_outputs(name):
    net = port_net(name)
    return [net.tensors[n.src[0]].name for n in net.nodes
            if n.type == LayerType.YOLOV3]


def make_inputs():
    rng = np.random.RandomState(0)
    inp = {n: weights(n) for n in ("lenet", "tiny96", "cifar",
                                   "mobilenet96", "tiny96p")}
    x = (rng.rand(tr.TINY_BATCH, 3, tr.AXIS_SIZE, tr.AXIS_SIZE) * 2
         - 1).astype(np.float32)
    inp["batches"] = {
        "lenet": [lenet_batch(rng)],
        "tiny96": [(x, det_labels(rng, tr.TINY_BATCH,
                                  classes=tr.TINY_CLASSES))],
    }
    inp["fwd_x"] = {
        "cifar": rng.randn(tr.FWD_BATCH, 3, 32, 32).astype(np.float32),
        "mobilenet96": rng.rand(tr.FWD_BATCH, 3, tr.AXIS_SIZE,
                                tr.AXIS_SIZE).astype(np.float32),
        "tiny8": rng.rand(tr.FWD_BATCH, 3, tr.AXIS_SIZE,
                          tr.AXIS_SIZE).astype(np.float32),
    }
    jnet = jax_net("tiny96p")
    jp = {k: jnp.asarray(v) for k, v in inp["tiny96p"][0].items()}
    js = {k: jnp.asarray(v) for k, v in inp["tiny96p"][1].items()}
    inp["quant"] = {
        "act_scales": jq.calibrate(jnet, jp, js, [inp["fwd_x"]["tiny8"]]),
        "weights": jax.tree.map(np.asarray, jq.quantize_weights(jnet, jp))}
    return inp


FWD_SPEC = {"cifar": ("cifar", ["softmax"]),
            "mobilenet96": ("mobilenet96", ["fc", "softmax"]),
            "tiny8": ("tiny96p", None)}


def rank_cases(inp, world):
    def w(name):
        return {"p": inp[name][0], "s": inp[name][1]}

    dps = [dp for wd, dp in MESHES if wd == world]
    cases = {}
    for dp in dps:
        cases[f"specs/{dp}"] = dict(kind="tp_specs", dp=dp, nets=SPEC_NETS)
        for form in ("tp", "sp"):
            for name in ("lenet", "tiny96"):
                if form == "tp" and dp == 1 and world == 4:
                    continue  # TP is held on 2x2 and 1x2
                if name == "lenet" and dp == 1 and world == 4:
                    continue
                cases[f"{form}/{name}/{dp}"] = dict(
                    kind="model_step", form=form, dp=dp, net=name,
                    batches=inp["batches"][name], **w(name))
    for key, (net, outs) in FWD_SPEC.items():
        cases[f"fwd/{key}"] = dict(
            kind="spatial_forward", net=net, x=inp["fwd_x"][key],
            outputs=outs or yolo_outputs(net), **w(net),
            quant=inp["quant"] if key == "tiny8" else None)
    if world == 4:
        cases["refusals"] = dict(kind="model_refusals", dp=2)
    return cases


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


@pytest.fixture(scope="module")
def clusters(inputs, tmp_path_factory):
    out = {}
    for world in (4, 2):
        workdir = str(tmp_path_factory.mktemp(f"axis{world}"))
        out[world] = tr.launch(world, rank_cases(inputs, world), workdir)
    yield out
    for c in out.values():
        c.results()


def ranks(clusters, world, case):
    """Every rank's outputs of `case`, with the ranks' parameters checked
    equal: each local tensor to those of the ranks of its model index,
    and every joined one to rank 0's."""
    outs = [r[case] for r in clusters[world].results()]
    for r, o in enumerate(outs[1:], 1):
        for key in ("params", "state"):
            for k, v in o.get(key, {}).items():
                np.testing.assert_array_equal(
                    v, outs[0][key][k], err_msg=f"rank {r} {key} {k}")
        for a, b in zip(o.get("outs", []), outs[0].get("outs", [])):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}")
    for o in outs:
        if "raw" not in o:
            continue
        peer = next(p for p in outs if p["coords"][1] == o["coords"][1])
        for k, v in o["raw"].items():
            np.testing.assert_array_equal(v, peer["raw"][k], err_msg=k)
    return outs


def imposed(outs, full, dp):
    """`replay.impose` of the ranks' recorded choices joined into the
    global batch's: for each call, each row of the mesh's ranks' choices
    joined along the dimension they cut (channels under TP, rows under
    SP; a whole one taken from the row's first rank), then the rows in
    batch order. full: the one-device run's choices, for their shapes."""
    m = len(outs) // dp

    def join(kind, i):
        shape = full[kind][i].shape
        rows = []
        for b in range(dp):
            parts = [o["choices"][kind][i] for o in outs[b * m:(b + 1) * m]]
            p0 = parts[0]
            if p0.ndim > 1 and p0.shape[1] < shape[1]:
                rows.append(np.concatenate(parts, axis=1))
            elif p0.ndim > 2 and p0.shape[2] < shape[2]:
                rows.append(np.concatenate(parts, axis=2))
            else:
                rows.append(p0)
        got = np.concatenate(rows)
        assert got.shape == tuple(shape), (kind, i, got.shape, shape)
        return torch.from_numpy(got)

    return replay.impose(replay.Choices(
        kinks=[join("kinks", i) for i in range(len(full["kinks"]))],
        picks=[join("picks", i) for i in range(len(full["picks"]))]))


def one_device_choices(name, w, batches):
    """The port's one-device fp32 choices of the steps (shapes only are
    used)."""
    from bcnn_tpu_torch.compile import make_train_step
    from bcnn_tpu_torch.learner import init_opt_state

    net = port_net(name)
    params, state = bridge.params_from_numpy(net, *w)
    opt = init_opt_state(net, params)
    step = make_train_step(net)
    choices = replay.Choices()
    with replay.record(choices):
        for x, y in batches:
            params, state, opt, _ = step(params, state, opt, {
                "input": torch.from_numpy(x), "label": torch.from_numpy(y)})
    return {"kinks": choices.kinks, "picks": choices.picks}


# ------------------------------------------------------- references #


def jmesh2(world, dp):
    return jpar.make_mesh_2d(jax.devices()[:world], dp=dp)


def jax_model_steps(name, w, batches, world, dp, form):
    """bcnn_tpu's DPxTP or DPxSP steps on a (dp, world / dp) CPU mesh:
    (params, state, losses, the TP params' shard shapes), numpy."""
    jnet = jax_net(name)
    mesh = jmesh2(world, dp)
    jp = {k: jnp.array(v) for k, v in w[0].items()}
    js = {k: jnp.array(v) for k, v in w[1].items()}
    jo = jlearner.init_opt_state(jnet, jp)
    repl = NamedSharding(mesh, P())
    lab_sh = NamedSharding(mesh, P("batch"))
    if form == "tp":
        step = jpar.make_dp_tp_train_step(jnet, mesh)
        jp, js, jo = jpar.shard_train_state(jnet, mesh, jp, js, jo)
        in_sh = lab_sh
    else:
        step = jpar.make_dp_sp_train_step(jnet, mesh)
        jp, js, jo = (jax.tree.map(lambda v: jax.device_put(v, repl), t)
                      for t in (jp, js, jo))
        in_sh = NamedSharding(mesh, P("batch", None, "model", None))
    key = jax.device_put(jax.random.PRNGKey(0), repl)
    losses = []
    for x, y in batches:
        jp, js, jo, loss = step(jp, js, jo, {
            "input": jax.device_put(x, in_sh),
            "label": jax.device_put(y, lab_sh)}, key)
        losses.append(float(loss))
    shards = {k: {s.data.shape for s in v.addressable_shards}
              for k, v in jp.items()}
    return ({k: np.asarray(v) for k, v in jp.items()},
            {k: np.asarray(v) for k, v in js.items()}, np.asarray(losses),
            shards)


# ------------------------------------------------------------ tests #


@pytest.mark.parametrize("world,dp", MESHES)
def test_tp_param_specs(clusters, world, dp):
    """tp_param_specs shards the keys bcnn_tpu's shards, key for key, on
    the four nets (YOLOv3-tiny's 255-channel heads stay replicated, and
    MobileNet-v1's depthwise weights are sharded), each along the output
    channels of the port's layout."""
    got = ranks(clusters, world, f"specs/{dp}")[0]
    mesh = jmesh2(world, dp)
    for name in SPEC_NETS:
        jnet = jax_net(name)
        jp, js = jpar.tp_param_specs(jnet, mesh)
        want_p = {k for k, s in jp.items() if s != P()}
        want_s = {k for k, s in js.items() if s != P()}
        assert set(got[name][0]) == want_p, name
        assert set(got[name][1]) == want_s, name
        assert want_p, name
        net = port_net(name)
        heads = {net.tensors[n.src[1]].key for n in net.nodes
                 if n.type == LayerType.CONV2D and n.param["num"] == 255}
        assert not heads & want_p
        if name == "mobilenet96":
            dw = {net.tensors[n.src[1]].key for n in net.nodes
                  if n.type == LayerType.DEPTHWISE_CONV2D}
            assert dw and dw <= want_p
        wtype = {net.tensors[n.src[1]].key: n.type for n in net.nodes
                 if len(n.src) > 1}
        for k, d in got[name][0].items():
            assert d == (1 if wtype.get(k) in (LayerType.FULL_CONNECTED,
                                               LayerType.TRANSPOSE_CONV2D)
                         else 0), k


@pytest.mark.parametrize("world,dp", [(4, 2), (2, 1)])
@pytest.mark.parametrize("form", ["tp", "sp"])
def test_model_step_lenet(clusters, inputs, form, world, dp):
    """One make_dp_tp_train_step / make_dp_sp_train_step step of lenet
    against bcnn_tpu's on a mesh of the same shape; under TP the shards
    are the output-channel slices bcnn_tpu's are."""
    w, batches = inputs["lenet"], inputs["batches"]["lenet"]
    outs = ranks(clusters, world, f"{form}/lenet/{dp}")
    out = outs[0]
    jp, js, jl, shards = jax_model_steps("lenet", w, batches, world, dp,
                                         form)
    assert out["seen"] == tr.LENET_BATCH
    np.testing.assert_allclose(out["losses"], jl, rtol=1e-4)
    for k, v in jp.items():
        np.testing.assert_allclose(out["params"][k], v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    hold_state(out["state"], js)
    if form == "tp":
        m = world // dp
        full = {k: v.shape for k, v in w[0].items()}
        sharded = [k for k, v in out["local"].items()
                   if int(np.prod(v)) != int(np.prod(full[k]))]
        assert sharded
        for k in sharded:
            f = full[k]
            if len(f) == 4:  # HWIO there, OIHW here
                assert (f[0], f[1], f[2], f[3] // m) in shards[k], k
                assert out["local"][k] == (f[3] // m, f[2], f[0], f[1]), k
            else:
                assert tuple(out["local"][k]) in shards[k], k


@pytest.mark.parametrize("world,dp,form", [
    (4, 2, "tp"), (2, 1, "tp"), (4, 2, "sp"), (4, 1, "sp"), (2, 1, "sp")])
def test_model_step_tiny(clusters, inputs, form, world, dp):
    """One YOLOv3-tiny step at 96 px, batch 4 (BN, the route and
    upsample, the size-2 stride-1 pool, both YOLO losses): every update
    against the float64 run of the ranks' own choices and against
    bcnn_tpu's program (`assert_updates`), the loss rtol LOSS_RTOL, the
    running stats. Under SP on 4 model ranks the 3-row stage runs whole
    and the 6-row one in bands of 1 and 2 rows."""
    name = "tiny96"
    w, batches = inputs[name], inputs["batches"][name]
    outs = ranks(clusters, world, f"{form}/{name}/{dp}")
    out = outs[0]
    full = one_device_choices(name, w, batches)
    exact, _, _ = port_steps(name, w, batches, torch.float64,
                             imposed(outs, full, dp))
    jp, js, jl, _ = jax_model_steps(name, w, batches, world, dp, form)
    hold(name, w, out["params"], jp, exact, out["losses"], jl)
    one, one_s, one_l = port_steps(name, w, batches)
    hold(name, w, out["params"], one, exact, out["losses"], one_l)
    hold_state(out["state"], js)
    hold_state(out["state"], one_s)
    np.testing.assert_allclose(out["losses"], jl, rtol=LOSS_RTOL)


def port_forward(name, w, x, outputs, quant=None):
    net = port_net(name)
    if quant is not None:
        net.quant = bridge.quant_from_numpy(net, quant)
    params, state = bridge.params_from_numpy(net, *w)
    with torch.inference_mode():
        ex = execute(net, params, state, {"input": torch.from_numpy(x)},
                     Mode.PREDICT)
        return [output_value(ex, net.get_tensor_index_by_name(o)).numpy()
                for o in outputs]


@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("key", FWD_NETS)
def test_spatial_forward(clusters, inputs, key, world):
    """make_spatial_forward over `world` bands: every rank returns the
    whole outputs, against bcnn_tpu's make_spatial_forward on as many
    devices and the port's one-device forward (fp32 within rtol 1e-4;
    int8 bit for bit the port's, on K4 and K5's plain versions here)."""
    name, outs = FWD_SPEC[key]
    outs = outs or yolo_outputs(name)
    w, x = inputs[name], inputs["fwd_x"][key]
    quant = inputs["quant"] if key == "tiny8" else None
    got = ranks(clusters, world, f"fwd/{key}")[0]["outs"]
    one = port_forward(name, w, x, outs, quant)
    jnet = jax_net(name)
    if quant is not None:
        jnet.quant = quant
    ref = jpar.make_spatial_forward(jnet, jpar.make_mesh(
        jax.devices()[:world]), outs)(
        {k: jnp.asarray(v) for k, v in w[0].items()},
        {k: jnp.asarray(v) for k, v in w[1].items()}, x)
    for g, o, r in zip(got, one, ref):
        r = np.asarray(r).reshape(g.shape)
        assert np.isfinite(g).all() and np.abs(g).max() > 0
        if quant is None:
            np.testing.assert_allclose(g, o, rtol=FWD_RTOL, atol=FWD_ATOL)
            np.testing.assert_allclose(g, r, rtol=FWD_RTOL, atol=FWD_ATOL)
        else:
            np.testing.assert_array_equal(g, o)
            assert np.abs(g - r).max() <= HEAD_TOL * np.abs(r).max()


def test_model_steps_refuse_what_bcnn_tpu_drops(clusters):
    """Both steps raise on each setting bcnn_tpu's
    `_make_sharded_train_step` drops, naming it."""
    got = ranks(clusters, 4, "refusals")[0]
    for (maker, attr), msg in got.items():
        assert msg is not None and f"net.{attr}" in msg, (maker, attr)
        assert maker in msg
    assert len(got) == 2 * len(REFUSED)
