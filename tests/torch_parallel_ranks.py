"""The rank side of tests/test_torch_parallel.py,
tests/test_torch_multihost.py and tests/test_torch_model_axis.py (the
`model_axis` cases, on the 2-D meshes of `make_mesh_2d`, made once a
process): D gloo ranks on the CPU, started with
torch.multiprocessing (spawn), each running a list of cases through
`bcnn_tpu_torch.parallel` and writing its results for the test process
to hold against bcnn_tpu and the port's one-rank run; and the
`Pipeline` cases of tests/test_torch_pipeline_parallel.py (stages over
the world's global ranks). Not a pytest
module (no test_ prefix); it imports no JAX, and the test modules import
it for the nets and the launcher.

A cluster: `launch(world, cases, workdir)` writes the cases (plain
numpy inputs) to workdir, starts `world` ranks that join one process
group through a file store there, and returns a `Cluster` whose
`results()` waits for them and gives each rank's {case name: outputs}.
Collectives time out after TIMEOUT_S, and a rank that fails writes its
traceback, so a broken case ends the cluster instead of hanging it.
"""

from __future__ import annotations

import datetime
import os
import traceback

import numpy as np
import torch

TIMEOUT_S = 120
LENET_BATCH = 16
TINY_BATCH, TINY_SIZE, TINY_CLASSES = 4, 64, 4
LIFTED_BATCH = 8
MB_BATCH, MB_SIZE, MB_CLASSES = 4, 64, 10
PP_BATCH = 8  # the pipeline's nets (tests/test_pipeline.py)
AXIS_SIZE, FWD_BATCH = 96, 2  # the model axis's YOLOv3-tiny and forwards
# the device augmentation of the resident scans: rotation (K2's shear
# chain; its plain version on the CPU), a flip, contrast and brightness
AUG = dict(rotation_range=10.0, random_fliph=1, min_contrast=0.8,
           max_contrast=1.2, min_brightness=-20, max_brightness=20)


def lifted_net(pkg, batch=LIFTED_BATCH):
    """A conv with BN and an FC embedding of 6 under the lifted-structure
    loss: its pairs couple the whole batch."""
    A, F = pkg.Activation, pkg.FillerType
    net = pkg.Net(pkg.Mode.TRAIN)
    net.set_input_shape(8, 8, 3, batch)
    net.set_sgd_optimizer(0.01, 0.9)
    net.add_convolutional_layer(8, 3, 1, 1, 1, 1, F.XAVIER, A.RELU, 0,
                                "input", "c1")
    net.add_fullc_layer(6, F.XAVIER, A.NONE, 0, "c1", "emb")
    net.add_cost_layer(pkg.Loss.LIFTED_STRUCT, pkg.Metric.SSE, 1.0, "emb")
    return net


def dropout_net(pkg, batch=LIFTED_BATCH):
    """A conv with BN, dropout at rate 0.3, an FC of 10 under softmax and
    the euclidean cost: each rank's mask is its stripe of the global
    batch's."""
    A, F = pkg.Activation, pkg.FillerType
    net = pkg.Net(pkg.Mode.TRAIN)
    net.set_input_shape(8, 8, 3, batch)
    net.set_sgd_optimizer(0.01, 0.9)
    net.add_convolutional_layer(8, 3, 1, 1, 1, 1, F.XAVIER, A.RELU, 0,
                                "input", "c1")
    net.add_dropout_layer(0.3, "c1")
    net.add_fullc_layer(10, F.XAVIER, A.NONE, 0, "c1", "fc")
    net.add_softmax_layer("fc", "softmax")
    net.add_cost_layer(pkg.Loss.EUCLIDEAN, pkg.Metric.ERROR_RATE, 1.0,
                       "softmax")
    return net


def bn_free_net(pkg, batch=PP_BATCH):
    """Conv/pool/fc stack with no batch-coupled op
    (tests/test_pipeline.py:53-68)."""
    A, F = pkg.Activation, pkg.FillerType
    net = pkg.Net(pkg.Mode.TRAIN)
    net.set_input_shape(16, 16, 3, batch)
    net.set_sgd_optimizer(learning_rate=0.01, momentum=0.9)
    X, R = F.XAVIER, A.RELU
    net.add_convolutional_layer(16, 3, 1, 1, 1, 0, X, R, 0, "input", "c1")
    net.add_maxpool_layer(2, 2, pkg.Padding.SAME, "c1", "p1")
    net.add_convolutional_layer(32, 3, 1, 1, 1, 0, X, R, 0, "p1", "c2")
    net.add_maxpool_layer(2, 2, pkg.Padding.SAME, "c2", "p2")
    net.add_fullc_layer(64, X, R, 0, "p2", "fc1")
    net.add_fullc_layer(10, X, A.NONE, 0, "fc1", "fc2")
    net.add_softmax_layer("fc2", "sm")
    net.add_cost_layer(pkg.Loss.EUCLIDEAN, pkg.Metric.SSE, 1.0, "sm",
                       "label", "cost")
    return net


def bn_net(pkg, batch=PP_BATCH, frozen=False):
    """Conv + BN stack (tests/test_pipeline.py:316-330)."""
    A, F = pkg.Activation, pkg.FillerType
    net = pkg.Net(pkg.Mode.TRAIN)
    net.set_input_shape(16, 16, 3, batch)
    net.set_sgd_optimizer(learning_rate=0.01, momentum=0.9)
    X, R = F.XAVIER, A.RELU
    net.add_convolutional_layer(16, 3, 1, 1, 1, 1, X, R, 0, "input", "c1")
    net.add_maxpool_layer(2, 2, pkg.Padding.SAME, "c1", "p1")
    net.add_convolutional_layer(32, 3, 1, 1, 1, 1, X, R, 0, "p1", "c2")
    net.add_fullc_layer(10, X, A.NONE, 0, "c2", "fc")
    net.add_softmax_layer("fc", "sm")
    net.add_cost_layer(pkg.Loss.EUCLIDEAN, pkg.Metric.SSE, 1.0, "sm",
                       "label", "cost")
    if frozen:
        net.bn_frozen_stats = True
    return net


def build_net(pkg, models, name):
    """The test nets in either package (`pkg`, its `models`)."""
    # the pipeline's (tests/test_torch_pipeline_parallel.py)
    if name == "pp_lenet":
        return models.lenet_mnist(PP_BATCH)
    if name == "pp_lenet_predict":
        return models.lenet_mnist(PP_BATCH, pkg.Mode.PREDICT)
    if name == "pp_cifar":
        return models.cifar10_resnet(PP_BATCH)
    if name == "pp_bnfree":
        return bn_free_net(pkg)
    if name in ("pp_bn", "pp_bn_frozen"):
        return bn_net(pkg, frozen=name == "pp_bn_frozen")
    if name == "pp_dropout":
        return dropout_net(pkg, PP_BATCH)
    if name == "lenet":
        return models.lenet_mnist(LENET_BATCH)
    if name == "tiny":
        return models.yolov3_tiny(TINY_BATCH, TINY_SIZE, TINY_SIZE,
                                  TINY_CLASSES, mode=pkg.Mode.TRAIN)
    if name == "lifted":
        return lifted_net(pkg)
    if name == "dropout":
        return dropout_net(pkg)
    if name == "mobilenet":
        net = models.mobilenet_v1(MB_BATCH, MB_CLASSES, pkg.Mode.PREDICT,
                                  width_mult=0.25)
        net.resize(MB_SIZE, MB_SIZE)
        return net
    # the model axis's nets (tests/test_torch_model_axis.py)
    if name == "tiny96":
        return models.yolov3_tiny(TINY_BATCH, AXIS_SIZE, AXIS_SIZE,
                                  TINY_CLASSES, mode=pkg.Mode.TRAIN)
    if name == "tiny96p":
        return models.yolov3_tiny(FWD_BATCH, AXIS_SIZE, AXIS_SIZE,
                                  TINY_CLASSES, mode=pkg.Mode.PREDICT)
    if name == "cifar":
        return models.cifar10_convnet(batch_size=FWD_BATCH,
                                      mode=pkg.Mode.PREDICT)
    if name == "mobilenet96":
        net = models.mobilenet_v1(FWD_BATCH, MB_CLASSES, pkg.Mode.PREDICT,
                                  width_mult=0.25)
        net.resize(AXIS_SIZE, AXIS_SIZE)
        return net
    raise ValueError(name)


# -------------------------------------------------------------- launcher #


class Cluster:
    def __init__(self, procs, workdir, world):
        self.procs, self.workdir, self.world = procs, workdir, world
        self._out = None

    def results(self, timeout=600):
        """Each rank's {case: outputs}; raises with the ranks' tracebacks
        if one failed."""
        if self._out is not None:
            return self._out
        for p in self.procs:
            p.join(timeout)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()
        errs = []
        for r in range(self.world):
            path = os.path.join(self.workdir, f"error{r}.txt")
            if os.path.exists(path):
                errs.append(f"rank {r}:\n" + open(path).read())
        codes = [p.exitcode for p in self.procs]
        if errs or any(codes):
            raise RuntimeError(f"ranks exited {codes}\n" + "\n".join(errs))
        self._out = [torch.load(os.path.join(self.workdir, f"rank{r}.pt"),
                                weights_only=False)
                     for r in range(self.world)]
        return self._out


def launch(world, cases, workdir) -> Cluster:
    """Start `world` gloo ranks running `cases` ({name: spec}) in
    workdir; returns at once."""
    os.makedirs(workdir, exist_ok=True)
    torch.save(cases, os.path.join(workdir, "cases.pt"))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, workdir),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return Cluster(procs, workdir, world)


def _rank_main(rank, world, workdir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        from bcnn_tpu_torch.parallel import multihost

        multihost.initialize(f"file://{workdir}/store", world, rank,
                             backend="gloo",
                             timeout=datetime.timedelta(seconds=TIMEOUT_S))
        mesh = multihost.global_mesh(device="cpu")
        cases = torch.load(os.path.join(workdir, "cases.pt"),
                           weights_only=False)
        out = {name: CASES[spec["kind"]](mesh, spec, workdir)
               for name, spec in cases.items()}
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ----------------------------------------------------------- the cases #


def _port_net(spec):
    import bcnn_tpu_torch as tt
    from bcnn_tpu_torch import models
    from bcnn_tpu_torch.types import Optimizer

    net = build_net(tt, models, spec["net"])
    if spec.get("adam"):
        net.learner.optimizer = Optimizer.ADAM
    if spec.get("bf16"):
        net.compute_dtype = net.train_act_dtype = torch.bfloat16
    if spec.get("aug"):
        net.device_augment = dict(spec["aug"])
    return net


def _np(net, tree):
    from bcnn_tpu_torch import bridge

    return bridge.params_to_numpy(net, {k: v.detach().cpu()
                                        for k, v in tree.items()})


def _start(net, spec, mesh, zero=0):
    """(params, state, opt_state) of the spec's numpy weights, placed as
    `zero` asks."""
    from bcnn_tpu_torch import bridge
    from bcnn_tpu_torch.learner import init_opt_state
    from bcnn_tpu_torch.parallel import replicate, shard_zero_state

    params, state = bridge.params_from_numpy(net, spec["p"], spec["s"])
    opt = init_opt_state(net, params)
    if zero:
        return shard_zero_state(net, mesh, params, state, opt,
                                params_too=zero == 3)
    return replicate(mesh, (params, state, opt))


def _gen(spec):
    seed = spec.get("gen")
    return None if seed is None else torch.Generator().manual_seed(seed)


def _recorded(fn):
    """fn() under `replay.record`: (its result, this rank's kink sides
    and max-pool picks, numpy, in call order)."""
    from bcnn_tpu_torch import replay

    choices = replay.Choices()
    with replay.record(choices):
        out = fn()
    return out, {"kinks": [c.numpy() for c in choices.kinks],
                 "picks": [c.numpy() for c in choices.picks]}


def _finish(net, mesh, params, state, opt, losses, zero=0, choices=None):
    from bcnn_tpu_torch.parallel import gather_zero_state

    local = {"params": {k: tuple(v.shape) for k, v in params.items()},
             "opt": {k: tuple(v.shape)
                     for name in ("velocity", "adam_m", "adam_v")
                     for k, v in opt[name].items()}}
    if zero:
        params, state, opt = gather_zero_state(net, mesh, params, state, opt)
    return {"params": _np(net, params), "state": _np(net, state),
            "losses": np.asarray([float(v) for v in losses]),
            "seen": int(opt["seen"]), "local_shapes": local,
            "choices": choices}


def case_step(mesh, spec, workdir):
    """Steps of make_dp_train_step (zero 0), make_zero1_train_step (1) or
    make_fsdp_train_step (3) on each batch of spec["batches"]."""
    from bcnn_tpu_torch.parallel import (make_dp_train_step,
                                         make_fsdp_train_step,
                                         make_zero1_train_step, shard_batch)

    net = _port_net(spec)
    zero = spec.get("zero", 0)
    step = {0: make_dp_train_step, 1: make_zero1_train_step,
            3: make_fsdp_train_step}[zero](net, mesh)
    params, state, opt = _start(net, spec, mesh, zero)

    def run(params, state, opt):
        losses = []
        for x, lab in spec["batches"]:
            params, state, opt, loss = step(
                params, state, opt,
                shard_batch(mesh, {"input": x, "label": lab}), _gen(spec))
            losses.append(loss)
        return params, state, opt, losses

    (params, state, opt, losses), choices = _recorded(
        lambda: run(params, state, opt))
    return _finish(net, mesh, params, state, opt, losses, zero, choices)


def case_scan(mesh, spec, workdir):
    """make_dp_train_scan over staged (K, B, ...) batches."""
    from bcnn_tpu_torch.parallel import make_dp_train_scan, shard_batch

    net = _port_net(spec)
    params, state, opt = _start(net, spec, mesh)
    xs = shard_batch(mesh, {"input": spec["xs"], "label": spec["ys"]},
                     axis=1)
    (params, state, opt, losses), choices = _recorded(
        lambda: make_dp_train_scan(net, mesh)(
            params, state, opt, xs["input"], xs["label"], _gen(spec)))
    return _finish(net, mesh, params, state, opt, losses, choices=choices)


class _Draws:
    """sample_params replaced by the given per-call draws (bcnn_tpu's,
    for the global batch), in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, generator, n, cfg, hw=None):
        d = self.draws.pop(0)
        assert len(d["theta"]) == n, (len(d["theta"]), n)
        return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _with_draws(spec, fn):
    from bcnn_tpu_torch.data import device_augment as tda

    if spec.get("draws") is None:
        return fn()
    real = tda.sample_params
    tda.sample_params = _Draws(spec["draws"])
    try:
        return fn()
    finally:
        tda.sample_params = real


def case_resident(mesh, spec, workdir):
    """make_dp_train_scan_resident: the dataset replicated, the (K, B)
    index striped; or, with spec["sharded"], shard_resident_dataset and
    make_dp_train_scan_resident_sharded on (K, D, B/D) local indices.
    Also this rank's bytes of the dataset."""
    from bcnn_tpu_torch.parallel import (make_dp_train_scan_resident,
                                         make_dp_train_scan_resident_sharded,
                                         replicate, shard_batch,
                                         shard_resident_dataset)

    net = _port_net(spec)
    params, state, opt = _start(net, spec, mesh)
    data = {"input": spec["data_x"], "label": spec["data_y"]}
    if spec.get("sharded"):
        ds = shard_resident_dataset(mesh, data)
        scan = make_dp_train_scan_resident_sharded(net, mesh)
    else:
        ds = replicate(mesh, data)
        scan = make_dp_train_scan_resident(net, mesh)
    idx = shard_batch(mesh, torch.from_numpy(spec["idx"]).to(torch.int64),
                      axis=1)
    (params, state, opt, losses), choices = _recorded(
        lambda: _with_draws(spec, lambda: scan(params, state, opt, ds, idx,
                                               _gen(spec))))
    out = _finish(net, mesh, params, state, opt, losses, choices=choices)
    out["dataset_bytes"] = sum(v.numel() * v.element_size()
                               for v in ds.values())
    out["dataset_shapes"] = {k: tuple(v.shape) for k, v in ds.items()}
    return out


def case_forward(mesh, spec, workdir):
    """make_dp_forward in PREDICT, fp32 or, with spec["quant"] (a
    bcnn_tpu quant dict), int8."""
    from bcnn_tpu_torch import bridge
    from bcnn_tpu_torch.parallel import make_dp_forward, replicate, \
        shard_batch
    from bcnn_tpu_torch.types import Mode

    net = _port_net(spec)
    if spec.get("quant") is not None:
        net.quant = bridge.quant_from_numpy(net, spec["quant"])
    params, state = replicate(mesh, bridge.params_from_numpy(
        net, spec["p"], spec["s"]))
    outs = make_dp_forward(net, mesh, spec["outputs"], Mode.PREDICT)(
        params, state, shard_batch(mesh, {"input": spec["x"]}))
    return {"outs": [o.numpy() for o in outs]}


class _Batches:
    def __init__(self, batches):
        self.batches = list(batches)

    def next_batch(self):
        return self.batches.pop(0)


def case_session(mesh, spec, workdir):
    """Session(mesh=, zero=): compile_net, train_on_batch on each of
    spec["batches"], train_scan_on_batches over spec["scan"] (replicated
    state only), a checkpoint to spec["ckpt"] (rank 0 writes it), a
    second session that loads it, and a VALID prediction."""
    from bcnn_tpu_torch import Session, bridge
    from bcnn_tpu_torch.types import Mode

    net = _port_net(spec)
    zero = spec.get("zero", 0)
    sess = Session(net, 0, mesh=mesh, zero=zero)
    sess.params, sess.state = bridge.params_from_numpy(net, spec["p"],
                                                       spec["s"])
    sess.compile_net()

    def run():
        losses = [float(sess.train_on_batch(x, lab))
                  for x, lab in spec["batches"]]
        scan_loss = None
        if spec.get("scan"):
            sess.loader = _Batches(spec["scan"])
            scan_loss = sess.train_scan_on_batches(len(spec["scan"]))
        return losses, scan_loss

    (losses, scan_loss), choices = _recorded(run)
    out = _finish(net, mesh, sess.params, sess.state, sess.opt_state,
                  losses, zero, choices)
    out["scan_loss"] = scan_loss
    out["step_count"] = sess._step_count
    sess.save_checkpoint(spec["ckpt"])
    again = Session(_port_net(spec), 0, mesh=mesh, zero=zero).compile_net()
    again.load_checkpoint(spec["ckpt"])
    out["reloaded"] = _finish(net, mesh, again.params, again.state,
                              again.opt_state, [], zero)
    net.set_mode(Mode.VALID)
    x, lab = spec["batches"][0]
    (prob,), err = sess.predict_on_batch(x, lab)
    out["valid"] = (prob.numpy(), float(err))
    return out


def case_resume(mesh, spec, workdir):
    """Session(mesh=, zero=) from a checkpoint (spec["load"]) or from the
    spec's weights: train_on_batch on each batch, then, with
    spec["save"], a checkpoint."""
    from bcnn_tpu_torch import Session, bridge

    net = _port_net(spec)
    zero = spec.get("zero", 0)
    sess = Session(net, 0, mesh=mesh, zero=zero)
    if spec.get("load"):
        sess.compile_net()
        sess.load_checkpoint(spec["load"])
    else:
        sess.params, sess.state = bridge.params_from_numpy(net, spec["p"],
                                                           spec["s"])
        sess.compile_net()
    losses, choices = _recorded(lambda: [float(sess.train_on_batch(x, lab))
                                         for x, lab in spec["batches"]])
    if spec.get("save"):
        sess.save_checkpoint(spec["save"])
    out = _finish(net, mesh, sess.params, sess.state, sess.opt_state,
                  losses, zero, choices)
    out["step_count"] = sess._step_count
    return out


def case_loader(mesh, spec, workdir):
    """multihost.shard_loader over MNIST files: each rank reads its
    stripe of every global batch (a loader net of batch B/D) and
    host_local_batch places it for the DP step of the global net."""
    import bcnn_tpu_torch as tt
    from bcnn_tpu_torch import models
    from bcnn_tpu_torch.data.loaders import MnistLoader
    from bcnn_tpu_torch.parallel import (make_dp_train_step, multihost,
                                         replicate)
    from bcnn_tpu_torch import bridge
    from bcnn_tpu_torch.learner import init_opt_state

    gbatch = spec["batch"]
    start, local = multihost.process_batch_slice(gbatch)
    net = build_net(tt, models, "lenet")
    loader_net = models.lenet_mnist(local)
    loader = multihost.shard_loader(
        MnistLoader(loader_net, spec["img"], spec["lbl"]))
    params, state = bridge.params_from_numpy(net, spec["p"], spec["s"])
    params, state, opt = replicate(
        mesh, (params, state, init_opt_state(net, params)))
    step = make_dp_train_step(net, mesh)
    rows = []

    def run(params, state, opt):
        losses = []
        for _ in range(spec["steps"]):
            x, y = loader.next_batch()
            rows.append(np.asarray(x))
            batch = multihost.host_local_batch(mesh, x,
                                               y.reshape(local, -1, 1, 1))
            params, state, opt, loss = step(params, state, opt, batch)
            losses.append(loss)
        return params, state, opt, losses

    (params, state, opt, losses), choices = _recorded(
        lambda: run(params, state, opt))
    out = _finish(net, mesh, params, state, opt, losses, choices=choices)
    out["rows"] = rows
    out["slice"] = (start, local)
    return out


def case_bn(mesh, spec, workdir):
    """ops.batch_norm_train on this rank's stripe under the mesh's
    reduce: the normalized stripe, the new running stats, and the
    stripe's input gradient of sum(y * g)."""
    from bcnn_tpu_torch import ops

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = mesh.stripe(torch.from_numpy(spec["x"])).to(dtype)
        g = mesh.stripe(torch.from_numpy(spec["g"])).to(dtype)
        x.requires_grad_()
        sc, bi, rm, rv = (torch.from_numpy(spec[k]) for k in
                          ("scales", "biases", "rm", "rv"))
        y, nm, nv = ops.batch_norm_train(x, sc, bi, rm, rv,
                                         reduce=mesh.all_reduce)
        (y.float() * g.float()).sum().backward()
        out[str(dtype)] = {"y": y.detach().float().numpy(),
                           "mean": nm.float().numpy(),
                           "var": nv.float().numpy(),
                           "dx": x.grad.float().numpy()}
    return out


def case_refusals(mesh, spec, workdir):
    """The message each DP program raises on each setting bcnn_tpu's
    drops, or None where it takes it."""
    from bcnn_tpu_torch import parallel

    makers = {
        "make_dp_train_step": parallel.make_dp_train_step,
        "make_dp_train_scan": parallel.make_dp_train_scan,
        "make_zero1_train_step": parallel.make_zero1_train_step,
        "make_fsdp_train_step": parallel.make_fsdp_train_step,
        "make_dp_train_scan_resident": parallel.make_dp_train_scan_resident,
        "make_dp_train_scan_resident_sharded":
            parallel.make_dp_train_scan_resident_sharded,
    }
    settings = {"device_augment": {"random_fliph": 1}, "remat": True,
                "accum_steps": 2, "yolo_stats": True, "qat": True,
                "bn_frozen_stats": True}
    out = {}
    for name, make in makers.items():
        for attr, value in settings.items():
            net = _port_net({"net": "lenet"})
            setattr(net, attr, value)
            try:
                make(net, mesh)
                out[(name, attr)] = None
            except ValueError as e:
                out[(name, attr)] = str(e)
    return out


# ------------------------------------------------- the model axis #

_MESH2 = {}


def _mesh2(dp):
    """The (dp, world / dp) mesh, made once a rank process (every rank
    makes the same ones in the same order)."""
    from bcnn_tpu_torch.parallel import make_mesh_2d

    if dp not in _MESH2:
        _MESH2[dp] = make_mesh_2d(dp=dp, device="cpu")
    return _MESH2[dp]


def case_tp_specs(mesh, spec, workdir):
    """The keys tp_param_specs shards, per net: (params, state)."""
    import bcnn_tpu_torch as tt
    from bcnn_tpu_torch import models
    from bcnn_tpu_torch.parallel import tp_param_specs

    m2 = _mesh2(spec["dp"])
    out = {}
    for name in spec["nets"]:
        ps, ss = tp_param_specs(build_net(tt, models, name), m2)
        out[name] = ({k: d for k, d in ps.items() if d is not None},
                     {k: d for k, d in ss.items() if d is not None})
    return out


def case_model_step(mesh, spec, workdir):
    """Steps of make_dp_tp_train_step (form "tp": state from
    shard_train_state, batch shard_batch over the batch axis, the state
    joined by gather_train_state) or make_dp_sp_train_step ("sp":
    replicated state, batch shard_spatial) on the (dp, D / dp) mesh."""
    from bcnn_tpu_torch import bridge
    from bcnn_tpu_torch.learner import init_opt_state
    from bcnn_tpu_torch.parallel import (gather_train_state,
                                         make_dp_sp_train_step,
                                         make_dp_tp_train_step, replicate,
                                         shard_batch, shard_spatial,
                                         shard_train_state)

    m2 = _mesh2(spec["dp"])
    net = _port_net(spec)
    params, state = bridge.params_from_numpy(net, spec["p"], spec["s"])
    opt = init_opt_state(net, params)
    if spec["form"] == "tp":
        step = make_dp_tp_train_step(net, m2)
        params, state, opt = shard_train_state(net, m2, params, state, opt)

        def shard(b):
            return shard_batch(m2.batch, b)
    else:
        step = make_dp_sp_train_step(net, m2)
        params, state, opt = replicate(m2.world, (params, state, opt))

        def shard(b):
            return shard_spatial(net, m2, b)

    def run(params, state, opt):
        losses = []
        for x, lab in spec["batches"]:
            params, state, opt, loss = step(
                params, state, opt, shard({"input": x, "label": lab}))
            losses.append(loss)
        return params, state, opt, losses

    (params, state, opt, losses), choices = _recorded(
        lambda: run(params, state, opt))
    raw = {k: v.detach().numpy().copy() for k, v in params.items()}
    local = {k: tuple(v.shape) for k, v in params.items()}
    if spec["form"] == "tp":
        params, state, opt = gather_train_state(net, m2, params, state, opt)
    return {"params": _np(net, params), "state": _np(net, state),
            "losses": np.asarray([float(v) for v in losses]),
            "seen": int(opt["seen"]), "raw": raw, "local": local,
            "coords": m2.coords, "choices": choices}


def case_spatial_forward(mesh, spec, workdir):
    """make_spatial_forward over the world's ranks (the 1-D mesh), fp32
    or, with spec["quant"], int8."""
    from bcnn_tpu_torch import bridge
    from bcnn_tpu_torch.parallel import make_spatial_forward, replicate

    net = _port_net(spec)
    if spec.get("quant") is not None:
        net.quant = bridge.quant_from_numpy(net, spec["quant"])
    params, state = replicate(mesh, bridge.params_from_numpy(
        net, spec["p"], spec["s"]))
    outs = make_spatial_forward(net, mesh, spec["outputs"])(
        params, state, spec["x"])
    return {"outs": [o.numpy() for o in outs]}


def case_model_refusals(mesh, spec, workdir):
    """The message each model-axis step raises on each setting
    bcnn_tpu's drops, or None where it takes it."""
    from bcnn_tpu_torch import parallel

    m2 = _mesh2(spec["dp"])
    makers = {"make_dp_tp_train_step": parallel.make_dp_tp_train_step,
              "make_dp_sp_train_step": parallel.make_dp_sp_train_step}
    settings = {"device_augment": {"random_fliph": 1}, "remat": True,
                "accum_steps": 2, "yolo_stats": True}
    out = {}
    for name, make in makers.items():
        for attr, value in settings.items():
            net = _port_net({"net": "lenet"})
            setattr(net, attr, value)
            try:
                make(net, m2)
                out[(name, attr)] = None
            except ValueError as e:
                out[(name, attr)] = str(e)
    return out


# ------------------------------------------------------- the pipeline #


def warm(state):
    """Non-degenerate running stats (frozen BN divides by run_var + eps),
    tests/test_pipeline.py:333-340."""
    return {k: (np.ones_like(v) if "run_var" in k else v)
            for k, v in state.items()}


def case_pipeline(mesh, spec, workdir):
    """`Pipeline` over spec["stages"] (global ranks): with spec["x"], one
    PREDICT forward of spec["outputs"] (fp32, or int8 on spec["quant"]);
    else TRAIN steps on each of spec["batches"] under each schedule of
    spec["schedules"], from spec's weights (run_var set to 1 with
    spec["warm"]): the gathered params and state, the losses. With
    spec["default_seed"], each rank seeds torch's default generator with
    it plus its rank, and the steps take no generator (each recompute
    checked bit-equal to its forward); spec["boundaries"] fixes the
    cuts."""
    import bcnn_tpu_torch as tt
    from bcnn_tpu_torch import bridge, models
    from bcnn_tpu_torch.learner import init_opt_state
    from bcnn_tpu_torch.parallel import Pipeline
    from bcnn_tpu_torch.types import Mode

    net = build_net(tt, models, spec["net"])
    s_np = warm(spec["s"]) if spec.get("warm") else spec["s"]
    if spec.get("x") is not None:
        if spec.get("quant") is not None:
            net.quant = bridge.quant_from_numpy(net, spec["quant"])
        pipe = Pipeline(net, spec["stages"], Mode.PREDICT,
                        n_microbatches=spec.get("n_micro", 1),
                        output_names=spec["outputs"], device="cpu")
        ps, ss = pipe.shard(*bridge.params_from_numpy(net, spec["p"], s_np))
        outs = pipe.forward(ps, ss, {"input": spec["x"]})
        return {"outs": [o.numpy() for o in outs],
                "dtypes": [str(o.dtype) for o in outs]}
    out = {}
    for schedule in spec.get("schedules", ("gpipe",)):
        pipe = Pipeline(net, spec["stages"], Mode.TRAIN,
                        n_microbatches=spec.get("n_micro", 1),
                        boundaries=spec.get("boundaries"),
                        schedule=schedule, device="cpu")
        if spec.get("default_seed") is not None:
            torch.manual_seed(spec["default_seed"] + pipe.rank)
            pipe._check_recompute = True
        params, state = bridge.params_from_numpy(net, spec["p"], s_np)
        ps, ss, os_ = pipe.shard(params, state,
                                 init_opt_state(net, params))
        losses = []
        for x, y in spec["batches"]:
            ps, ss, os_, loss = pipe.train_on_batch(
                ps, ss, os_, {"input": x, "label": y})
            losses.append(float(loss))
        out[schedule] = {
            "params": _np(net, pipe.gather(ps)),
            "state": _np(net, pipe.gather(ss)),
            "losses": np.asarray(losses),
            "seen": [o["seen"] for o in os_ if o is not None]}
    return out


CASES = {
    "pipeline": case_pipeline,
    "tp_specs": case_tp_specs,
    "model_step": case_model_step,
    "spatial_forward": case_spatial_forward,
    "model_refusals": case_model_refusals,
    "step": case_step,
    "scan": case_scan,
    "resident": case_resident,
    "forward": case_forward,
    "session": case_session,
    "resume": case_resume,
    "loader": case_loader,
    "bn": case_bn,
    "refusals": case_refusals,
}
