"""Data parallelism of the port (`bcnn_tpu_torch.parallel`) on gloo ranks
on the CPU, each form held twice: against bcnn_tpu's counterpart
(`parallel.make_dp_train_step`, `make_dp_forward`, `make_dp_train_scan`,
`make_dp_train_scan_resident`, `make_dp_train_scan_resident_sharded`,
`make_zero1_train_step`, `make_fsdp_train_step`, `Session(mesh=)`) on a
mesh of the same size, D of the 8 faked CPU devices of
tests/conftest.py; and against the port's one-rank run of the global
batch (`compile.make_train_step` and its kin, `Session`).

One cluster of 2 and one of 4 gloo ranks (tests/torch_parallel_ranks.py)
start once for the module and run every case while this process
computes the references.

Nets: lenet_mnist at batch 16 on bcnn_tpu's init_params weights; the
lifted-structure net at batch 8 (the coupled loss), a dropout net at
batch 8, YOLOv3-tiny at 64 px, batch 4 (BN and the YOLO loss) and
MobileNet-v1 at width 0.25, 64 px, batch 4 (forward only, fp32 and
int8: on the CPU the plain versions of K3, K4 and K5), on
`bridge.he_numpy_weights`. The nets' own fillers
fade MobileNet-v1's activations; they put a YOLOv3-tiny max-pool window
or YOLO choice within rounding of a tie, so that an fp32 run and a
float64 one part within two steps; and they start the lifted net's
embedding bias at 0, whose exact gradient is 0 (the loss is the same for
every shift of all the embeddings), so that fp32's rounding is its whole
update and no float32 spacing of the parameter bounds it. Batches come
from numpy seeds; bcnn_tpu's augmentation draws are handed to the port
where a form is held to bcnn_tpu (its own draws otherwise: each rank
draws the global batch's and takes its stripe, so D ranks equal one).

Bounds:
  - forwards: against bcnn_tpu rtol 1e-4 (atol 1e-6) in fp32, and in
    int8 within tests/test_torch_quant.HEAD_TOL of the largest value,
    the port's own int8 bound there; against the port's one-rank forward
    bit for bit;
  - training: losses rtol LOSS_RTOL (1e-4); every parameter's update
    under tests/test_torch_train_shortcut.assert_updates's rule: within
    UPDATE_TOL (1e-3) of its largest entry from a float64 run of the
    same steps and draws (the port's one-rank run in float64, taking
    the ranks' own kink sides and max-pool picks, `replay.impose`: a
    window whose inputs tie within rounding picks another input under
    another order of BN's sums, and moves the convs above it by
    percents, as chip_smoke.py's replayed steps find on the card), and
    within UPDATE_TOL of the reference's (bcnn_tpu's program, or the
    port's one-rank run) or twice the reference's own distance to the
    float64 run where that is wider; the running stats rtol 1e-4, atol
    1e-5 (tests/test_torch_train_forms.py); every rank's parameters bit
    for bit equal to rank 0's. With Adam an element whose gradient lies
    near its rounding takes an update of about the rate whatever its
    size, so fp32's rounding moves it by a share of the largest update:
    two Adam steps of lenet land up to 7.3e-3 of it from float64 on one
    device, bcnn_tpu's up to 8.4e-3, on whichever tensor holds such an
    element. The FSDP Adam run's update is held within twice the port's
    one-rank fp32 run's worst distance to float64, as a share of each
    tensor's largest update (or UPDATE_TOL), and to its references by
    the losses and `seen`;
  - bf16 + act16: each update gap per tensor (1 - cosine, max|d| over
    the rms, tests/test_torch_train_bf16.grad_gaps) at most NOISE_RATIO
    (2) times the bf16 step's own gap to the fp32 step of the same batch,
    where bf16's own noise is what separates two orders of summation.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcnn_tpu as bt
from bcnn_tpu import learner as jlearner
from bcnn_tpu import models as jmodels
from bcnn_tpu import parallel as jpar
from bcnn_tpu.compile import init_params as jax_init_params
from bcnn_tpu.data import device_augment as jda
from bcnn_tpu.ops import norm as jnorm
from bcnn_tpu.ops import quant as jq
from jax.sharding import NamedSharding, PartitionSpec as P

from bcnn_tpu_torch import Session, bridge, ops, replay
from bcnn_tpu_torch.compile import (execute, make_train_scan,
                                    make_train_scan_resident, make_train_step,
                                    output_value)
from bcnn_tpu_torch.data import ShardedEpochIndexStream
from bcnn_tpu_torch.learner import init_opt_state
from bcnn_tpu_torch.types import Mode
from tests import torch_parallel_ranks as tr
from tests.test_torch_quant import HEAD_TOL
from tests.test_torch_train_bf16 import NOISE_RATIO, grad_gaps
from tests.test_torch_train_shortcut import (LOSS_RTOL, UPDATE_TOL,
                                             assert_updates, det_labels)

torch.set_num_threads(1)

STATE_RTOL, STATE_ATOL = 1e-4, 1e-5
FWD_RTOL, FWD_ATOL = 1e-4, 1e-6
WORLDS = (2, 4)
K = 2  # steps of the resident scans
N_DATA = 8  # records of the resident dataset (divides by 2 and 4)
SCAN_K = 3


# ------------------------------------------------------------ inputs #


def lenet_batch(rng, n=tr.LENET_BATCH):
    lab = rng.randint(0, 10, n)
    x = rng.randn(n, 1, 28, 28).astype(np.float32) * 0.1
    for i, c in enumerate(lab):
        x[i, 0, c:c + 8, c:c + 8] += 1.0
    y = np.zeros((n, 10, 1, 1), np.float32)
    y[np.arange(n), lab] = 1.0
    return x, y


def lifted_batch(rng, n=tr.LIFTED_BATCH):
    x = rng.randn(n, 3, 8, 8).astype(np.float32)
    y = np.zeros((n, 6, 1, 1), np.float32)
    y[np.arange(n), np.arange(n) % 3] = 1.0  # every class a pair or more
    return x, y


def tiny_batch(rng, n=tr.TINY_BATCH):
    x = (rng.rand(n, 3, tr.TINY_SIZE, tr.TINY_SIZE) * 2 - 1).astype(
        np.float32)
    return x, det_labels(rng, n, classes=tr.TINY_CLASSES)


def jax_net(name):
    return tr.build_net(bt, jmodels, name)


def port_net(name, **spec):
    return tr._port_net(dict(spec, net=name))


def weights(name):
    """(params, state) in bcnn_tpu's layout, numpy."""
    if name in ("tiny", "mobilenet", "lifted", "dropout"):
        return bridge.he_numpy_weights(port_net(name), 3)
    p, s = jax_init_params(jax_net(name), 0)
    return ({k: np.asarray(v) for k, v in p.items()},
            {k: np.asarray(v) for k, v in s.items()})


def jax_draws(seed, k_steps, n):
    """bcnn_tpu's augmentation draws of a K-step resident scan keyed
    PRNGKey(seed): step k splits its key, the second half samples the
    global batch's parameters (`bcnn_tpu/compile.py:860-871`)."""
    cfg = dict(tr.AUG, _img_h=tr.TINY_SIZE, _img_w=tr.TINY_SIZE)
    out = []
    for key in jax.random.split(jax.random.PRNGKey(seed), k_steps):
        _, akey = jax.random.split(key)
        out.append({k: np.asarray(v) for k, v in
                    jda.sample_params(akey, n, cfg).items()})
    return out


def make_inputs():
    rng = np.random.RandomState(0)
    inp = {name: weights(name) for name in
           ("lenet", "tiny", "lifted", "mobilenet", "dropout")}
    inp["batches"] = {
        "lenet": [lenet_batch(rng)],
        "lifted": [lifted_batch(rng)],
        "tiny": [tiny_batch(rng)],
    }
    x = rng.randn(tr.LIFTED_BATCH, 3, 8, 8).astype(np.float32)
    y = np.zeros((tr.LIFTED_BATCH, 10, 1, 1), np.float32)
    y[np.arange(tr.LIFTED_BATCH), rng.randint(0, 10, tr.LIFTED_BATCH)] = 1.0
    inp["dropout_batches"] = [(x, y)]
    inp["fsdp"] = [lenet_batch(rng) for _ in range(2)]
    inp["scan"] = [lenet_batch(rng) for _ in range(SCAN_K)]
    inp["session"] = [lenet_batch(rng) for _ in range(4)]
    data = rng.randint(0, 256, (N_DATA, 3, tr.TINY_SIZE, tr.TINY_SIZE))
    inp["data"] = (data.astype(np.uint8),
                   det_labels(rng, N_DATA, classes=tr.TINY_CLASSES))
    inp["idx"] = rng.randint(0, N_DATA, (K, tr.TINY_BATCH)).astype(np.int64)
    inp["draws"] = jax_draws(11, K, tr.TINY_BATCH)
    x = rng.rand(tr.MB_BATCH, 3, tr.MB_SIZE, tr.MB_SIZE).astype(np.float32)
    inp["mb_x"] = x
    inp["quant"] = mobilenet_quant(inp["mobilenet"], x)
    inp["bn"] = dict(
        x=rng.randn(8, 6, 5, 5).astype(np.float32) * 2 + 0.5,
        g=rng.randn(8, 6, 5, 5).astype(np.float32),
        scales=rng.uniform(0.8, 1.2, 6).astype(np.float32),
        biases=rng.uniform(-0.1, 0.1, 6).astype(np.float32),
        rm=rng.uniform(-0.1, 0.1, 6).astype(np.float32),
        rv=rng.uniform(0.5, 1.5, 6).astype(np.float32))
    return inp


def mobilenet_quant(w, x):
    """bcnn_tpu's PTQ dict of MobileNet-v1 (calibrate on x,
    quantize_weights), numpy, as tests/test_torch_quant_layers.py makes
    it."""
    jnet = jax_net("mobilenet")
    jp = {k: jnp.asarray(v) for k, v in w[0].items()}
    js = {k: jnp.asarray(v) for k, v in w[1].items()}
    return {"act_scales": jq.calibrate(jnet, jp, js, [x]),
            "weights": jax.tree.map(np.asarray,
                                    jq.quantize_weights(jnet, jp))}


def sharded_idx(d):
    """(K, D, B/D) local indices of a ShardedEpochIndexStream, and the
    global (K, B) indices of the same samples (shard s's local i is
    global s * N/D + i)."""
    local = ShardedEpochIndexStream(N_DATA, tr.TINY_BATCH, d, seed=5).next(K)
    glob = (local.astype(np.int64)
            + (np.arange(d) * (N_DATA // d))[None, :, None]).reshape(K, -1)
    return local, glob


def rank_cases(inp, d, workdir):
    def w(name):
        return {"p": inp[name][0], "s": inp[name][1]}

    data_x, data_y = inp["data"]
    res = dict(kind="resident", net="tiny", aug=tr.AUG, data_x=data_x,
               data_y=data_y, gen=7, **w("tiny"))
    local, _ = sharded_idx(d)
    cases = {
        **{f"step/{n}": dict(kind="step", net=n, batches=b, **w(n))
           for n, b in inp["batches"].items()},
        "step/dropout": dict(kind="step", net="dropout", gen=9,
                             batches=inp["dropout_batches"], **w("dropout")),
        "step/act16": dict(kind="step", net="lenet", bf16=True,
                           batches=inp["batches"]["lenet"], **w("lenet")),
        "zero1": dict(kind="step", net="lenet", zero=1,
                      batches=inp["batches"]["lenet"], **w("lenet")),
        **{f"fsdp/{opt}": dict(kind="step", net="lenet", zero=3,
                               adam=opt == "adam", batches=inp["fsdp"],
                               **w("lenet"))
           for opt in ("sgd", "adam")},
        "scan": dict(kind="scan", net="lenet", gen=5,
                     xs=np.stack([b[0] for b in inp["scan"]]),
                     ys=np.stack([b[1] for b in inp["scan"]]),
                     **w("lenet")),
        "resident/own": dict(res, idx=inp["idx"]),
        "resident/bcnn_tpu": dict(res, idx=inp["idx"], draws=inp["draws"]),
        "sharded/own": dict(res, idx=local, sharded=True),
        "sharded/bcnn_tpu": dict(res, idx=local, sharded=True,
                                 draws=inp["draws"]),
        "forward/fp32": dict(kind="forward", net="mobilenet",
                             x=inp["mb_x"], outputs=["fc", "softmax"],
                             **w("mobilenet")),
        "forward/int8": dict(kind="forward", net="mobilenet",
                             x=inp["mb_x"], outputs=["fc", "softmax"],
                             quant=inp["quant"], **w("mobilenet")),
        "session": dict(kind="session", net="lenet",
                        batches=inp["session"][:2], scan=inp["session"][2:],
                        ckpt=os.path.join(workdir, "session.npz"),
                        **w("lenet")),
        "bn": dict(kind="bn", **inp["bn"]),
    }
    if d == 2:
        cases["refusals"] = dict(kind="refusals")
    return cases


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


@pytest.fixture(scope="module")
def clusters(inputs, tmp_path_factory):
    out = {}
    for d in WORLDS:
        workdir = str(tmp_path_factory.mktemp(f"ranks{d}"))
        out[d] = tr.launch(d, rank_cases(inputs, d, workdir), workdir)
    yield out
    for c in out.values():
        c.results()  # joined, whatever the tests did


def imposed(outs):
    """`replay.impose` of the ranks' recorded choices, each rank's stripe
    in rank order: the global batch's."""
    ch = outs[0]["choices"]
    return replay.impose(replay.Choices(
        kinks=[torch.from_numpy(np.concatenate(
            [o["choices"]["kinks"][i] for o in outs]))
            for i in range(len(ch["kinks"]))],
        picks=[torch.from_numpy(np.concatenate(
            [o["choices"]["picks"][i] for o in outs]))
            for i in range(len(ch["picks"]))]))


def ranks(clusters, d, case):
    """Every rank's outputs of `case`; the parameters (and the
    forwards' outputs) bit for bit equal across the ranks."""
    outs = [r[case] for r in clusters[d].results()]
    for r, o in enumerate(outs[1:], 1):
        for key in ("params", "state"):
            for k, v in o.get(key, {}).items():
                np.testing.assert_array_equal(
                    v, outs[0][key][k], err_msg=f"rank {r} {key} {k}")
        for a, b in zip(o.get("outs", []), outs[0].get("outs", [])):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r}")
    return outs


# ------------------------------------------------------- references #


def jmesh(d):
    return jpar.make_mesh(jax.devices()[:d])


def jax_steps(name, w, batches, d, maker=jpar.make_dp_train_step, zero=0,
              adam=False, bf16=False):
    """bcnn_tpu's DP (or ZeRO) steps on a mesh of d: (params, state,
    losses), numpy."""
    jnet = jax_net(name)
    if adam:
        jnet.learner.optimizer = bt.Optimizer.ADAM
    if bf16:
        jnet.compute_dtype = jnet.train_act_dtype = jnp.bfloat16
    mesh = jmesh(d)
    jp = {k: jnp.array(v) for k, v in w[0].items()}
    js = {k: jnp.array(v) for k, v in w[1].items()}
    jo = jlearner.init_opt_state(jnet, jp)
    if zero:
        jp, js, jo = jpar.shard_zero_state(jnet, mesh, jp, js, jo,
                                           params_too=zero == 3)
    else:
        jp, js, jo = (jpar.replicate(mesh, t) for t in (jp, js, jo))
    step = maker(jnet, mesh)
    key = jpar.replicate(mesh, jax.random.PRNGKey(0))
    losses = []
    for x, y in batches:
        jp, js, jo, loss = step(jp, js, jo, jpar.shard_batch(
            mesh, {"input": x, "label": y}), key)
        losses.append(float(loss))
    return ({k: np.asarray(v) for k, v in jp.items()},
            {k: np.asarray(v) for k, v in js.items()}, np.asarray(losses))


def port_start(net, w, dtype=torch.float32):
    params, state = bridge.params_from_numpy(net, *w)
    params = {k: v.to(dtype) for k, v in params.items()}
    state = {k: v.to(dtype) for k, v in state.items()}
    return params, state, init_opt_state(net, params)


def to_np(net, tree):
    return bridge.params_to_numpy(net, {k: v.detach() for k, v in
                                        tree.items()})


def port_steps(name, w, batches, dtype=torch.float32, choices=None,
               gen=None, **spec):
    """The port's one-rank steps of the global batches: (params, state,
    losses) in bcnn_tpu's layout; float64 for a reference, under
    `choices` (`imposed`); each step's generator seeded `gen`."""
    net = port_net(name, **spec)
    params, state, opt = port_start(net, w, dtype)
    step = make_train_step(net)
    losses = []
    with choices or contextlib.nullcontext():
        for x, y in batches:
            params, state, opt, loss = step(
                params, state, opt, {"input": torch.from_numpy(x),
                                     "label": torch.from_numpy(y)},
                None if gen is None else torch.Generator().manual_seed(gen))
            losses.append(float(loss))
    return to_np(net, params), to_np(net, state), np.asarray(losses)


def hold(name, w, got, ref, exact, losses=None, ref_losses=None):
    """`got` (the ranks' params) against `ref` under assert_updates's rule
    with the float64 run `exact`; losses rtol LOSS_RTOL."""
    net = port_net(name)
    params, _ = bridge.params_from_numpy(net, got, w[1])
    assert_updates(net, w[0], w[1], None, None, params, ref, exact=exact)
    if losses is not None:
        np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)


def hold_noise(w, got, one, exact):
    """Each update within a share of its largest entry of the float64
    run `exact`'s: twice the one-rank fp32 run's worst share over the
    tensors, or UPDATE_TOL (or a float32 spacing of the parameter),
    whichever is wider."""
    def share(a, k):
        m = np.abs(exact[k] - w[0][k]).max()
        return np.abs(a[k] - exact[k]).max() / m if m else 0.0

    tol = max(UPDATE_TOL, 2 * max(share(one, k) for k in one))
    for k, v in got.items():
        r0 = w[0][k]
        du64 = exact[k] - r0
        lim = max(tol * np.abs(du64).max(), np.spacing(np.abs(r0).max()))
        np.testing.assert_allclose(v - r0, du64, rtol=0, atol=lim,
                                   err_msg=k)


def hold_state(got, ref):
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=k)


# ------------------------------------------------------------ tests #


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("name", ["lenet", "tiny", "lifted"])
def test_dp_step(clusters, inputs, name, d):
    """One make_dp_train_step step: the global loss (the lifted loss over
    the whole batch), the update (the gradient a SUM over the ranks, the
    lifted loss's counted once), BN's running stats of the global batch,
    `seen` the global count."""
    w, batches = inputs[name], inputs["batches"][name]
    outs = ranks(clusters, d, f"step/{name}")
    out = outs[0]
    assert out["seen"] == len(batches) * port_net(name).batch_size
    exact, _, _ = port_steps(name, w, batches, torch.float64, imposed(outs))
    one, one_s, one_l = port_steps(name, w, batches)
    jp, js, jl = jax_steps(name, w, batches, d)
    hold(name, w, out["params"], one, exact, out["losses"], one_l)
    hold(name, w, out["params"], jp, exact, out["losses"], jl)
    hold_state(out["state"], one_s)
    hold_state(out["state"], js)


@pytest.mark.parametrize("d", WORLDS)
def test_dp_step_dropout(clusters, inputs, d):
    """A DP step through dropout: each rank's keep mask is its stripe of
    the one drawn for the global batch from the step's seed, so the step
    equals the one-rank step with the same generator (bcnn_tpu draws
    its masks with threefry, the port with philox: no mask of its to
    compare)."""
    w, batches = inputs["dropout"], inputs["dropout_batches"]
    outs = ranks(clusters, d, "step/dropout")
    out = outs[0]
    exact, _, _ = port_steps("dropout", w, batches, torch.float64,
                             imposed(outs), gen=9)
    one, one_s, one_l = port_steps("dropout", w, batches, gen=9)
    hold("dropout", w, out["params"], one, exact, out["losses"], one_l)
    hold_state(out["state"], one_s)
    # a different mask would move the update by far more than the bound
    other, _, _ = port_steps("dropout", w, batches, gen=10)
    assert max(np.abs(other[k] - one[k]).max() for k in one) > 1e-4


@pytest.mark.parametrize("d", WORLDS)
def test_dp_step_act16(clusters, inputs, d):
    """The DP step at bf16 + act16 (`tests/test_parallel.py:80`): BN's
    global statistics summed in fp32 and rounded to bf16 as torch.mean
    rounds them; each update within bf16's own noise of the one-rank
    bf16 step's and of bcnn_tpu's DP act16 step's."""
    w, batches = inputs["lenet"], inputs["batches"]["lenet"]
    out = ranks(clusters, d, "step/act16")[0]
    one32, _, _ = port_steps("lenet", w, batches)
    one16, _, l16 = port_steps("lenet", w, batches, bf16=True)
    jp, _, jl = jax_steps("lenet", w, batches, d, bf16=True)
    np.testing.assert_allclose(out["losses"], l16, rtol=2.0 ** -7)
    np.testing.assert_allclose(out["losses"], jl, rtol=2.0 ** -7)

    def upd(p):
        return {k: p[k] - w[0][k] for k in p}

    noise = grad_gaps(upd(one32), upd(one16))
    for ref in (one16, jp):
        for k, (cos_gap, rms_gap) in grad_gaps(upd(ref),
                                               upd(out["params"])).items():
            c0, r0 = noise[k]
            assert cos_gap <= NOISE_RATIO * c0, (k, cos_gap, c0)
            assert rms_gap <= NOISE_RATIO * r0, (k, rms_gap, r0)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("prec", ["fp32", "int8"])
def test_dp_forward(clusters, inputs, prec, d):
    """make_dp_forward of MobileNet-v1: every rank returns the global
    batch's fc and softmax, within the bounds above of the port's
    one-rank forward and of bcnn_tpu's make_dp_forward, and bit for bit
    the port's one-rank forward of each rank's stripe (int8: of the
    global batch too, its sums being exact)."""
    w, x = inputs["mobilenet"], inputs["mb_x"]
    outs = ranks(clusters, d, f"forward/{prec}")[0]["outs"]
    net = port_net("mobilenet")
    jnet = jax_net("mobilenet")
    if prec == "int8":
        net.quant = bridge.quant_from_numpy(net, inputs["quant"])
        jnet.quant = inputs["quant"]
    params, state = bridge.params_from_numpy(net, *w)

    def forward(xs):
        with torch.inference_mode():
            ex = execute(net, params, state, {"input": torch.from_numpy(xs)},
                         Mode.PREDICT)
            return [output_value(ex, net.get_tensor_index_by_name(n)).numpy()
                    for n in ("fc", "softmax")]

    one = forward(x)
    stripes = [np.concatenate(o) for o in zip(
        *(forward(xs) for xs in np.split(x, d)))]
    mesh = jmesh(d)
    ref = jpar.make_dp_forward(jnet, mesh, ["fc", "softmax"],
                               bt.Mode.PREDICT)(
        jpar.replicate(mesh, {k: jnp.asarray(v) for k, v in w[0].items()}),
        jpar.replicate(mesh, {k: jnp.asarray(v) for k, v in w[1].items()}),
        jpar.shard_batch(mesh, {"input": x}))
    for got, o, st, r in zip(outs, one, stripes, ref):
        r = np.asarray(r).reshape(got.shape)
        assert got.shape[0] == tr.MB_BATCH and np.isfinite(got).all()
        np.testing.assert_array_equal(got, st)
        if prec == "fp32":
            np.testing.assert_allclose(got, o, rtol=FWD_RTOL, atol=FWD_ATOL)
            np.testing.assert_allclose(got, r, rtol=FWD_RTOL, atol=FWD_ATOL)
        else:
            np.testing.assert_array_equal(got, o)
            assert np.abs(got - r).max() <= HEAD_TOL * np.abs(r).max()


@pytest.mark.parametrize("d", WORLDS)
def test_dp_scan(clusters, inputs, d):
    """make_dp_train_scan of 3 staged steps against make_train_scan and
    bcnn_tpu's make_dp_train_scan."""
    w, batches = inputs["lenet"], inputs["scan"]
    outs = ranks(clusters, d, "scan")
    out = outs[0]
    xs = np.stack([b[0] for b in batches])
    ys = np.stack([b[1] for b in batches])

    def port(dtype, choices=None):
        net = port_net("lenet")
        params, state, opt = port_start(net, w, dtype)
        with choices or contextlib.nullcontext():
            params, state, opt, losses = make_train_scan(net)(
                params, state, opt, {"input": torch.from_numpy(xs),
                                     "label": torch.from_numpy(ys)},
                torch.Generator().manual_seed(5))
        return to_np(net, params), to_np(net, state), losses.numpy()

    exact, _, _ = port(torch.float64, imposed(outs))
    one, one_s, one_l = port(torch.float32)
    jnet = jax_net("lenet")
    mesh = jmesh(d)
    ksh = NamedSharding(mesh, P(None, "batch"))
    jp, js, _, jl = jpar.make_dp_train_scan(jnet, mesh)(
        *(jpar.replicate(mesh, t) for t in (
            {k: jnp.array(v) for k, v in w[0].items()},
            {k: jnp.array(v) for k, v in w[1].items()},
            jlearner.init_opt_state(
                jnet, {k: jnp.array(v) for k, v in w[0].items()}))),
        jax.device_put(jnp.asarray(xs), ksh),
        jax.device_put(jnp.asarray(ys), ksh), jax.random.PRNGKey(0))
    assert out["seen"] == SCAN_K * tr.LENET_BATCH
    hold("lenet", w, out["params"], one, exact, out["losses"], one_l)
    hold("lenet", w, out["params"], {k: np.asarray(v) for k, v in
                                     jp.items()}, exact, out["losses"],
         np.asarray(jl))
    hold_state(out["state"], one_s)


def port_resident(inputs, w, idx, dtype, draws=None, choices=None):
    """The port's one-rank make_train_scan_resident with rotation on the
    whole dataset, its own draws (generator seed 7) or bcnn_tpu's, under
    `choices`."""
    net = port_net("tiny", aug=tr.AUG)
    params, state, opt = port_start(net, w, dtype)
    data_x, data_y = inputs["data"]
    ds = {"input": torch.from_numpy(data_x), "label": torch.from_numpy(data_y)}
    with choices or contextlib.nullcontext():
        params, state, opt, losses = tr._with_draws(
            {"draws": draws}, lambda: make_train_scan_resident(net)(
                params, state, opt, ds, torch.from_numpy(idx),
                torch.Generator().manual_seed(7)))
    return to_np(net, params), to_np(net, state), losses.numpy()


def jax_resident(inputs, w, d, idx, sharded):
    """bcnn_tpu's replicated or sharded resident DP scan with rotation,
    keyed PRNGKey(11) (the draws `jax_draws` reproduces)."""
    jnet = jax_net("tiny")
    jnet.device_augment = dict(tr.AUG)
    mesh = jmesh(d)
    data_x, data_y = inputs["data"]
    jp = {k: jnp.array(v) for k, v in w[0].items()}
    start = [jpar.replicate(mesh, t) for t in (
        jp, {k: jnp.array(v) for k, v in w[1].items()},
        jlearner.init_opt_state(jnet, jp))]
    if sharded:
        ds = jpar.shard_resident_dataset(mesh, {"input": data_x,
                                                "label": data_y})
        ish = NamedSharding(mesh, P(None, "batch", None))
        scan = jpar.make_dp_train_scan_resident_sharded(jnet, mesh)
    else:
        ds = jpar.replicate(mesh, {"input": data_x, "label": data_y})
        ish = NamedSharding(mesh, P(None, "batch"))
        scan = jpar.make_dp_train_scan_resident(jnet, mesh)
    jp, js, _, jl = scan(*start, ds, jax.device_put(
        jnp.asarray(idx, jnp.int32), ish), jax.random.PRNGKey(11))
    return ({k: np.asarray(v) for k, v in jp.items()},
            {k: np.asarray(v) for k, v in js.items()}, np.asarray(jl))


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("draws", ["own", "bcnn_tpu"])
def test_resident_scan(clusters, inputs, draws, d):
    """make_dp_train_scan_resident, the dataset replicated, rotation 10
    on YOLOv3-tiny: with the ranks' own draws against the one-rank scan
    (the same draws: each rank takes its stripe of the global batch's),
    with bcnn_tpu's against its make_dp_train_scan_resident."""
    w, idx = inputs["tiny"], inputs["idx"]
    outs = ranks(clusters, d, f"resident/{draws}")
    out = outs[0]
    assert out["dataset_shapes"]["input"] == (N_DATA, 3, tr.TINY_SIZE,
                                              tr.TINY_SIZE)
    dr = inputs["draws"] if draws == "bcnn_tpu" else None
    exact, _, _ = port_resident(inputs, w, idx, torch.float64, dr,
                                imposed(outs))
    if draws == "own":
        ref, ref_s, ref_l = port_resident(inputs, w, idx, torch.float32)
    else:
        ref, ref_s, ref_l = jax_resident(inputs, w, d, idx, sharded=False)
    hold("tiny", w, out["params"], ref, exact, out["losses"], ref_l)
    hold_state(out["state"], ref_s)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("draws", ["own", "bcnn_tpu"])
def test_sharded_resident_scan(clusters, inputs, draws, d):
    """make_dp_train_scan_resident_sharded: each rank holds N/D records
    (its bytes a D-th of the dataset's), gathers its stripe of every
    stratified batch from them, and trains as the replicated feed does
    on the same samples (the one-rank scan on their global indices), or
    as bcnn_tpu's sharded scan with its draws."""
    w = inputs["tiny"]
    local, glob = sharded_idx(d)
    outs = ranks(clusters, d, f"sharded/{draws}")
    out = outs[0]
    total = sum(a.nbytes for a in inputs["data"])
    assert out["dataset_bytes"] * d == total
    assert out["dataset_shapes"]["input"] == (1, N_DATA // d, 3,
                                              tr.TINY_SIZE, tr.TINY_SIZE)
    dr = inputs["draws"] if draws == "bcnn_tpu" else None
    exact, _, _ = port_resident(inputs, w, glob, torch.float64, dr,
                                imposed(outs))
    if draws == "own":
        ref, ref_s, ref_l = port_resident(inputs, w, glob, torch.float32)
    else:
        ref, ref_s, ref_l = jax_resident(inputs, w, d, local, sharded=True)
    hold("tiny", w, out["params"], ref, exact, out["losses"], ref_l)
    hold_state(out["state"], ref_s)


@pytest.mark.parametrize("d", WORLDS)
def test_zero1_step(clusters, inputs, d):
    """make_zero1_train_step: each rank holds a D-th of the momentum
    slots of every tensor with a divisible dimension, and the step equals
    the DP step's (one-rank and bcnn_tpu's make_zero1_train_step)."""
    w, batches = inputs["lenet"], inputs["batches"]["lenet"]
    outs = ranks(clusters, d, "zero1")
    out = outs[0]
    net = port_net("lenet")
    full = {t.key: tuple(t.mem_shape) for t in net.param_specs()}
    big = max(full, key=lambda k: np.prod(full[k]))
    assert np.prod(out["local_shapes"]["opt"][big]) * d == np.prod(full[big])
    assert out["local_shapes"]["params"][big] == full[big]
    exact, _, _ = port_steps("lenet", w, batches, torch.float64,
                             imposed(outs))
    one, _, one_l = port_steps("lenet", w, batches)
    jp, _, jl = jax_steps("lenet", w, batches, d,
                          maker=jpar.make_zero1_train_step, zero=1)
    hold("lenet", w, out["params"], one, exact, out["losses"], one_l)
    hold("lenet", w, out["params"], jp, exact, out["losses"], jl)


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fsdp_two_steps(clusters, inputs, opt, d):
    """make_fsdp_train_step, two steps with SGD or Adam: each rank holds
    a D-th of the largest weight and of its slots; the steps equal the
    DP steps (one-rank, and bcnn_tpu's make_fsdp_train_step), `seen`
    included. Adam is held as the module's docstring says."""
    adam = opt == "adam"
    w, batches = inputs["lenet"], inputs["fsdp"]
    outs = ranks(clusters, d, f"fsdp/{opt}")
    out = outs[0]
    net = port_net("lenet")
    full = {t.key: tuple(t.mem_shape) for t in net.param_specs()}
    big = max(full, key=lambda k: np.prod(full[k]))
    assert np.prod(out["local_shapes"]["params"][big]) * d == np.prod(
        full[big])
    assert np.prod(out["local_shapes"]["opt"][big]) * d == np.prod(full[big])
    assert out["seen"] == 2 * tr.LENET_BATCH
    exact, _, _ = port_steps("lenet", w, batches, torch.float64,
                             imposed(outs), adam=adam)
    one, _, one_l = port_steps("lenet", w, batches, adam=adam)
    jp, _, jl = jax_steps("lenet", w, batches, d,
                          maker=jpar.make_fsdp_train_step, zero=3,
                          adam=adam)
    if adam:
        np.testing.assert_allclose(out["losses"], one_l, rtol=LOSS_RTOL)
        np.testing.assert_allclose(out["losses"], jl, rtol=LOSS_RTOL)
        hold_noise(w, out["params"], one, exact)
        return
    hold("lenet", w, out["params"], one, exact, out["losses"], one_l)
    hold("lenet", w, out["params"], jp, exact, out["losses"], jl)


@pytest.mark.parametrize("d", WORLDS)
def test_session_mesh(clusters, inputs, d):
    """Session(net, seed, mesh=): compile_net replicates, train_on_batch
    shards two global batches, train_scan_on_batches(2) runs the DP scan
    on two loader batches; against a one-device Session and bcnn_tpu's
    Session(mesh=) making the same calls. The checkpoint the ranks wrote
    (rank 0) reloads bit for bit, and a VALID prediction runs."""
    w, batches = inputs["lenet"], inputs["session"]
    outs = ranks(clusters, d, "session")
    out = outs[0]
    assert out["step_count"] == 4 and out["seen"] == 4 * tr.LENET_BATCH
    for key in ("params", "state"):
        for k, v in out[key].items():
            np.testing.assert_array_equal(out["reloaded"][key][k], v)

    class Loader:
        def __init__(self):
            self.b = list(batches[2:])

        def next_batch(self):
            return self.b.pop(0)

    def port(dtype, choices=None):
        net = port_net("lenet")
        sess = Session(net, 0, device="cpu")
        sess.params, sess.state = (
            {k: v.to(dtype) for k, v in t.items()}
            for t in bridge.params_from_numpy(net, *w))
        sess.compile_net()
        with choices or contextlib.nullcontext():
            losses = [float(sess.train_on_batch(x, y))
                      for x, y in batches[:2]]
            sess.loader = Loader()
            scan = sess.train_scan_on_batches(2)
        return to_np(net, sess.params), np.asarray(losses), scan, sess

    exact, _, _, _ = port(torch.float64, imposed(outs))
    one, one_l, one_scan, one_sess = port(torch.float32)
    js = bt.Session(jax_net("lenet"), 0, mesh=jmesh(d)).compile_net()
    js.params = jpar.replicate(js.mesh, {k: jnp.array(v)
                                         for k, v in w[0].items()})
    js.state = jpar.replicate(js.mesh, {k: jnp.array(v)
                                        for k, v in w[1].items()})
    js.opt_state = jpar.replicate(js.mesh, jlearner.init_opt_state(
        js.net, {k: jnp.array(v) for k, v in w[0].items()}))
    jl = [float(js.train_on_batch(x, y)) for x, y in batches[:2]]
    js.loader = Loader()
    j_scan = js.train_scan_on_batches(2)
    jp = {k: np.asarray(v) for k, v in js.params.items()}
    hold("lenet", w, out["params"], one, exact, out["losses"], one_l)
    hold("lenet", w, out["params"], jp, exact, out["losses"], jl)
    np.testing.assert_allclose(out["scan_loss"], one_scan, rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["scan_loss"], j_scan, rtol=LOSS_RTOL)
    prob, err = out["valid"]
    assert prob.shape == (tr.LENET_BATCH, 10, 1, 1) and np.isfinite(err)


@pytest.mark.parametrize("d", WORLDS)
def test_global_bn_statistics(clusters, inputs, d):
    """ops.batch_norm_train on each rank's stripe under the mesh: the
    normalized output, the running stats and the input gradient are the
    global batch's, as one device computes them (fp32: rtol 1e-5; bf16:
    within one bf16 rounding, 2^-7, of the largest value), and as
    bcnn_tpu's batch_norm computes them on the whole batch."""
    b = inputs["bn"]
    outs = ranks(clusters, d, "bn")
    x = torch.from_numpy(b["x"])
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
        xi = x.to(dtype).detach().clone().requires_grad_()
        y, nm, nv = ops.batch_norm_train(
            xi, *(torch.from_numpy(b[k]) for k in
                  ("scales", "biases", "rm", "rv")))
        (y.float() * torch.from_numpy(b["g"]).to(dtype).float()).sum(
        ).backward()
        got = {k: np.concatenate([o[str(dtype)][k] for o in outs])
               for k in ("y", "dx")}
        for k, want in (("y", y), ("dx", xi.grad)):
            want = want.detach().float().numpy()
            assert np.abs(got[k] - want).max() <= tol * np.abs(want).max(), k
        for k, want in (("mean", nm), ("var", nv)):
            for o in outs:
                np.testing.assert_allclose(o[str(dtype)][k],
                                           want.float().numpy(),
                                           rtol=tol, atol=tol)
    jy, jm, jv = jnorm.batch_norm(
        jnp.asarray(np.transpose(b["x"], (0, 2, 3, 1))),
        *(jnp.asarray(b[k]) for k in ("scales", "biases", "rm", "rv")),
        training=True)
    np.testing.assert_allclose(
        np.concatenate([o["torch.float32"]["y"] for o in outs]),
        np.transpose(np.asarray(jy), (0, 3, 1, 2)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[0]["torch.float32"]["mean"],
                               np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[0]["torch.float32"]["var"],
                               np.asarray(jv), rtol=1e-5, atol=1e-6)


def test_dp_programs_refuse_what_bcnn_tpu_drops(clusters):
    """bcnn_tpu's DP step, scan, ZeRO-1 and FSDP call execute bare
    (`bcnn_tpu/parallel/mesh.py:73-75`): the port's raise on
    net.device_augment, remat, accum_steps and yolo_stats; the resident
    scans take device_augment and raise on the other three; net.qat and
    net.bn_frozen_stats run in every one (ROADMAP Queue 3)."""
    out = ranks(clusters, 2, "refusals")[0]
    resident = ("make_dp_train_scan_resident",
                "make_dp_train_scan_resident_sharded")
    for (maker, attr), msg in out.items():
        taken = attr in ("qat", "bn_frozen_stats") or (
            attr == "device_augment" and maker in resident)
        if taken:
            assert msg is None, (maker, attr, msg)
        else:
            assert msg is not None and f"net.{attr}" in msg, (maker, attr)
    assert len(out) == 6 * 6
