"""bcnn_tpu_torch.replay on the CPU: a run's kink sides and max-pool
picks recorded and imposed on another run, and the SGD update that
chip_smoke.py's card-vs-CPU steps, tools/f3_float64.py and the float64
checks of tests/test_torch_train*.py take from it.

A run that imposes its own record computes what it computed: the update
is held bit for bit, or within 1e-5 of each tensor's largest entry where
max-pool windows overlap. An imposed side or pick is checked against
the layer recomputed by hand, forward and gradient."""

import numpy as np
import pytest
import torch

from bcnn_tpu_torch import Net, bridge, replay
from bcnn_tpu_torch.compile import execute
from bcnn_tpu_torch.models import resnet18, yolov3_tiny
from bcnn_tpu_torch.types import (Activation, FillerType, Loss, Metric,
                                  Mode, Padding)

torch.set_num_threads(1)


def small_net(act):
    """conv (act) -> maxpool 2/2 -> conv (act) -> FC -> euclidean cost,
    at 12 px, batch 2."""
    net = Net(Mode.TRAIN)
    net.set_input_shape(12, 12, 3, 2)
    net.set_sgd_optimizer(0.01, 0.9)
    X = FillerType.XAVIER
    net.add_convolutional_layer(6, 3, 1, 1, 1, 0, X, act, 0, "input", "c1")
    net.add_maxpool_layer(2, 2, Padding.SAME, "c1", "p1")
    net.add_convolutional_layer(4, 3, 1, 1, 1, 0, X, act, 0, "p1", "c2")
    net.add_fullc_layer(3, X, Activation.NONE, 0, "c2", "f")
    net.add_cost_layer(Loss.EUCLIDEAN, Metric.SSE, 1.0, "f", "label",
                       "cost")
    return net


def seeded(net, seed=0):
    params, state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, seed))
    rng = np.random.RandomState(seed + 1)
    t = net.tensors[0]
    x = torch.from_numpy(rng.randn(net.batch_size, t.c, t.h, t.w).astype(
        np.float32))
    lab = torch.from_numpy(rng.rand(net.batch_size, *(
        net.tensors[1].c, net.tensors[1].h, net.tensors[1].w)).astype(
            np.float32).reshape(net.batch_size, -1))
    return params, state, {"input": x, "label": lab}


NETS = {
    "leaky_pool": lambda: small_net(Activation.LRELU),
    "relu_pool": lambda: small_net(Activation.RELU),
    "yolov3_tiny_64": lambda: yolov3_tiny(2, 64, 64, 3, mode=Mode.TRAIN),
    "resnet18_32": lambda: resnet18(2, 10, mode=Mode.TRAIN).resize(32, 32),
}


def yolo_batch(net, batch):
    """Box labels for a YOLO net (its label tensor is (B, 250))."""
    rng = np.random.RandomState(5)
    lab = np.zeros((net.batch_size, 50, 5), np.float32)
    for i in range(net.batch_size):
        for t in range(3):
            lab[i, t] = [*rng.uniform(0.2, 0.8, 2), *rng.uniform(0.1, 0.4, 2),
                         rng.randint(3)]
    batch["label"] = torch.from_numpy(lab.reshape(net.batch_size, 250))
    return batch


@pytest.mark.parametrize("name", list(NETS))
def test_imposing_a_run_s_own_record_changes_nothing(name):
    """Record a run's choices, impose them on a second run from the same
    weights and batch: as many choices as the net has kinked and max-pool
    layers, none left over; recording changes no bit of the update, and
    imposing changes none where no two max-pool windows overlap. Where
    they overlap (YOLOv3-tiny's size-2 stride-1 pool) the imposed pool's
    backward sums a position's windows in another order than
    F.max_pool2d's: within 1e-5 of each tensor's largest entry."""
    net = NETS[name]()
    params, state, batch = seeded(net)
    if name.startswith("yolo"):
        batch = yolo_batch(net, batch)
    made = replay.Choices()
    u0, _ = replay.sgd_update(net, params, state, batch,
                              choices=replay.record(made))
    assert len(made.kinks) == len(replay.kinked_nodes(net)) > 0
    assert len(made.picks) == len(replay.pooling_nodes(net))
    u1, _ = replay.sgd_update(net, params, state, batch,
                              choices=replay.impose(made))
    plain, _ = replay.sgd_update(net, params, state, batch)
    assert u0.keys() == u1.keys() == plain.keys()
    overlap = any(n.param["size"] > n.param["stride"] for n in net.nodes
                  if n.type.name == "MAXPOOL")
    for k in u0:
        assert torch.equal(u0[k], plain[k]), k
        if overlap:
            torch.testing.assert_close(u1[k], u0[k], rtol=0, atol=1e-5 * float(
                u0[k].abs().max()), msg=k)
        else:
            assert torch.equal(u1[k], u0[k]), k


@pytest.mark.parametrize("act", [Activation.LRELU, Activation.RELU],
                         ids=["lrelu", "relu"])
def test_imposed_kinks_take_the_given_side(act):
    """Every kink side flipped: the first conv's output is slope * x where
    its input x > 0 and x where x <= 0, and the conv's weight gradient is
    the one that the flipped slopes make of the gradient at that
    output."""
    net = small_net(act)
    params, state, batch = seeded(net)
    made = replay.Choices()
    with replay.record(made):
        execute(net, params, state, batch, Mode.TRAIN)
    flipped = replay.Choices([~k for k in made.kinks], made.picks)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    with replay.impose(flipped):
        ex = execute(net, leaves, state, batch, Mode.TRAIN)
    y = ex.values[net.nodes[0].dst[0]]
    wk, bk = (net.tensors[i].key for i in net.nodes[0].src[1:])
    g_y, g_w = torch.autograd.grad(ex.surrogate, [y, leaves[wk]])

    w = params[wk].clone().requires_grad_()
    pre = torch.nn.functional.conv2d(batch["input"], w, params[bk], 1, 1)
    slope = replay.KINKED[act]
    assert torch.equal(pre > 0, ~flipped.kinks[0])
    torch.testing.assert_close(y, torch.where(pre > 0, slope * pre, pre),
                               rtol=1e-6, atol=1e-6)
    (want,) = torch.autograd.grad(
        pre, w, g_y * torch.where(pre > 0, slope, 1.0))
    torch.testing.assert_close(g_w, want, rtol=1e-5, atol=1e-6)


def test_imposed_picks_route_the_gradient():
    """Every max-pool window given the last input of its window: the
    layer outputs that input, and the gradient reaching the pool's input
    is nonzero only there."""
    net = small_net(Activation.LRELU)
    params, state, batch = seeded(net)
    made = replay.Choices()
    with replay.record(made):
        execute(net, params, state, batch, Mode.TRAIN)
    last = replay.Choices(made.kinks, [torch.full_like(p, 3)
                                       for p in made.picks])
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    with replay.impose(last):
        ex = execute(net, leaves, state, batch, Mode.TRAIN)
    v = ex.values[net.nodes[1].src[0]]
    out = ex.values[net.nodes[1].dst[0]]
    torch.testing.assert_close(out, v[:, :, 1::2, 1::2], rtol=0, atol=0)
    (g,) = torch.autograd.grad(ex.surrogate, v)
    mask = torch.zeros_like(v, dtype=torch.bool)
    mask[:, :, 1::2, 1::2] = True
    assert (g[~mask] == 0).all()
    assert (g[mask] != 0).any()


def test_impose_refuses_another_net_s_record():
    """A record taken on one net does not fit another: ValueError, and
    the executor's ops are restored."""
    from bcnn_tpu_torch import ops

    a, b = small_net(Activation.LRELU), yolov3_tiny(2, 64, 64, 3,
                                                    mode=Mode.TRAIN)
    params, state, batch = seeded(a)
    made = replay.Choices()
    with replay.record(made):
        execute(a, params, state, batch, Mode.TRAIN)
    pb, sb, bb = seeded(b)
    bb = yolo_batch(b, bb)
    act, pool = ops.apply_activation, ops.maxpool
    with pytest.raises(ValueError):
        replay.sgd_update(b, pb, sb, bb, choices=replay.impose(made))
    assert (ops.apply_activation, ops.maxpool) == (act, pool)
    made.kinks.append(made.kinks[-1])
    with pytest.raises(ValueError, match="fewer choices"):
        replay.sgd_update(a, params, state, batch,
                          choices=replay.impose(made))


def test_float64_replay_of_a_float32_run():
    """A float32 run's choices imposed on a float64 run: the float64 run
    then takes every one of them (its own record under the imposed ops
    is the float32 one), and its update is within 1e-3 of each tensor's
    largest entry of the float32 update on this net, where only
    rounding parts them."""
    net = small_net(Activation.LRELU)
    params, state, batch = seeded(net, seed=3)
    made = replay.Choices()
    u32, _ = replay.sgd_update(net, params, state, batch,
                               choices=replay.record(made))
    u64, _ = replay.sgd_update(net, params, state, batch, torch.float64,
                               choices=replay.impose(made))
    for k, v in u64.items():
        scale = float(v.abs().max())
        assert float((u32[k] - v).abs().max()) <= 1e-3 * scale, k


def test_imposed_codes_are_held_to_the_run_s_own_values():
    """Under net.qat a float32 run's fake-quant codes imposed on a float64
    run: `boundary` counts, per fake-quant call, the codes the float64
    run rounds the other way (here none or a few, of some thousands). A
    code moved one step off its value, or an inside mask flipped away
    from 127 s, is refused with ValueError."""
    net = small_net(Activation.LRELU)
    net.qat = True
    params, state, batch = seeded(net, seed=4)
    made = replay.Choices()
    replay.sgd_update(net, params, state, batch, choices=replay.record(made))
    assert len(made.codes) == 6  # two convs and the FC, x then w each
    replay.sgd_update(net, params, state, batch, torch.float64,
                      choices=replay.impose(made))
    total = sum(c.numel() for c in made.codes)
    assert len(made.boundary) == 6 and sum(made.boundary) <= total // 1000
    # a code one step from its value: the first conv's input, where a
    # code of 0 sits inside (-127, 127)
    j = int(made.codes[0].flatten().abs().argmin())
    made.codes[0].view(-1)[j] += 1
    with pytest.raises(ValueError, match="fake quant 0"):
        replay.sgd_update(net, params, state, batch, torch.float64,
                          choices=replay.impose(made))
    made.codes[0].view(-1)[j] -= 1
    made.inside[2].view(-1)[j % made.inside[2].numel()] = False
    with pytest.raises(ValueError, match="fake quant 2"):
        replay.sgd_update(net, params, state, batch, torch.float64,
                          choices=replay.impose(made))


def test_record_when_keeps_the_calls_it_selects():
    """record(when=...) keeps the choices of the calls for which when()
    holds: a pass without autograd is recorded, a pass with it is not,
    and what is kept equals a plain record of the first pass."""
    net = small_net(Activation.LRELU)
    params, state, batch = seeded(net)
    every, some = replay.Choices(), replay.Choices()
    with replay.record(every):
        with torch.no_grad():
            execute(net, params, state, batch, Mode.TRAIN)
    with replay.record(some, when=lambda: not torch.is_grad_enabled()):
        with torch.no_grad():
            execute(net, params, state, batch, Mode.TRAIN)
        execute(net, params, state, batch, Mode.TRAIN)
    assert len(some.kinks) == len(every.kinks) == 2
    for a, b in zip(some.kinks + some.picks, every.kinks + every.picks):
        assert torch.equal(a, b)


def test_sgd_update_accumulates_as_the_step_does():
    """sgd_update(accum_steps=2) gives make_train_step(accum_steps=2)'s
    update bit for bit, and a float64 one that imposes the step's own
    choices lies within 1e-3 of each tensor's largest entry (the repo's
    fp32-against-float64 bound, tests/test_torch_train_shortcut.py)."""
    from bcnn_tpu_torch.compile import make_train_step
    from bcnn_tpu_torch.learner import init_opt_state

    net = yolov3_tiny(4, 64, 64, 3, mode=Mode.TRAIN)
    params, state, _ = seeded(net)
    rng = np.random.RandomState(5)
    lab = np.zeros((4, 50, 5), np.float32)
    lab[:, 0] = [0.5, 0.5, 0.3, 0.4, 1]
    batch = {"input": torch.from_numpy(
        rng.randn(4, 3, 64, 64).astype(np.float32)),
        "label": torch.from_numpy(lab.reshape(4, 250))}
    p = {k: v.clone() for k, v in params.items()}
    choices = replay.Choices()
    with replay.record(choices):
        p, _, _, _ = make_train_step(net, accum_steps=2)(
            p, dict(state), init_opt_state(net, p), batch)
    upd, _ = replay.sgd_update(net, params, state, batch, accum_steps=2)
    exact, _ = replay.sgd_update(net, params, state, batch, torch.float64,
                                 choices=replay.impose(choices),
                                 accum_steps=2)
    for k, u in upd.items():
        assert torch.equal(p[k] - params[k], u), k
        scale = float(exact[k].abs().max())
        assert float((u - exact[k]).abs().max()) <= 1e-3 * scale, k
    with pytest.raises(ValueError):
        replay.sgd_update(net, params, state, batch, seed=1, accum_steps=2)
