"""Multi-process training with the port (`bcnn_tpu_torch.parallel.
multihost`, `Session(mesh=, zero=)` checkpoints) on gloo ranks on the
CPU, after tests/test_multihost_process.py: per-process loaders that
read only their stripe of the MNIST stream (`shard_loader`,
`host_local_batch`), and a checkpoint written by a cluster of 2 ranks
(ZeRO-1: the slots gathered, rank 0 writing bcnn_tpu's single-device
`.npz`) resumed by a fresh cluster of 2 (ZeRO-1), by one of 4 (FSDP:
the elastic case) and by one device.

Each run is held to the uninterrupted trajectory: the port's one-rank
steps of the same global batches, and bcnn_tpu's make_dp_train_step on
a mesh of the same size, under tests/test_torch_parallel.py's bounds
(losses rtol 1e-4; updates under assert_updates's rule, the float64 run
taking the ranks' recorded kink sides and max-pool picks).
"""

import numpy as np
import pytest
import torch

from bcnn_tpu import checkpoint as jckpt
from bcnn_tpu.data.loaders import MnistLoader as JaxMnistLoader
from bcnn_tpu_torch import Session, bridge
from bcnn_tpu_torch.data.loaders import MnistLoader
from bcnn_tpu_torch.parallel import Mesh, multihost
from tests import torch_parallel_ranks as tr
from tests.test_data import write_mnist
from tests.test_torch_parallel import (hold, imposed, jax_net, jax_steps,
                                       lenet_batch, port_net, port_steps,
                                       ranks, weights)
from tests.test_torch_train_shortcut import LOSS_RTOL

torch.set_num_threads(1)

LOADER_STEPS = 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Cluster A (2 ranks) reads the stream and trains 2 ZeRO-1 steps
    from the weights, then checkpoints; beside it a 4-rank cluster reads
    the stream. Then B (2 ranks, ZeRO-1) and C (4 ranks, FSDP) resume
    from A's file and train 2 more steps each."""
    base = tmp_path_factory.mktemp("multihost")
    img, lbl, _, _ = write_mnist(base, n=40)
    w = weights("lenet")
    rng = np.random.RandomState(3)
    batches = [lenet_batch(rng) for _ in range(4)]
    ckpt = str(base / "a.npz")

    def loader_case():
        return dict(kind="loader", batch=tr.LENET_BATCH, img=img, lbl=lbl,
                    steps=LOADER_STEPS, p=w[0], s=w[1])

    a = tr.launch(2, {"loader": loader_case(),
                      "resume": dict(kind="resume", net="lenet", zero=1,
                                     p=w[0], s=w[1], batches=batches[:2],
                                     save=ckpt)}, str(base / "a"))
    l4 = tr.launch(4, {"loader": loader_case()}, str(base / "l4"))
    a.results()
    resume = dict(kind="resume", net="lenet", load=ckpt,
                  batches=batches[2:])
    b = tr.launch(2, {"resume": dict(resume, zero=1)}, str(base / "b"))
    c = tr.launch(4, {"resume": dict(resume, zero=3)}, str(base / "c"))
    return dict(clusters={"A": {2: a}, "L": {2: a, 4: l4}, "B": {2: b},
                          "C": {4: c}},
                w=w, batches=batches, img=img, lbl=lbl, ckpt=ckpt)


def mnist_batches(runs, batch):
    """The first LOADER_STEPS global batches of one process reading the
    whole stream."""
    net = port_net("lenet")
    loader = MnistLoader(net, runs["img"], runs["lbl"])
    out = [loader.next_batch() for _ in range(LOADER_STEPS)]
    return [(x, y.reshape(batch, -1, 1, 1)) for x, y in out]


@pytest.mark.parametrize("d", [2, 4])
def test_shard_loader_stripes(runs, d):
    """Each rank's loader (batch B/D, `shard_loader`) reads rows
    rank*B/D to (rank+1)*B/D of every global batch of the sequential
    stream (`process_batch_slice`), and the DP steps on them equal one
    process reading the whole stream: the port's one-rank steps, and
    bcnn_tpu's make_dp_train_step fed by its own loader."""
    outs = ranks(runs["clusters"]["L"], d, "loader")
    want = mnist_batches(runs, tr.LENET_BATCH)
    per = tr.LENET_BATCH // d
    for r, o in enumerate(outs):
        assert o["slice"] == (r * per, per)
        for step, rows in enumerate(o["rows"]):
            np.testing.assert_array_equal(
                rows, want[step][0][r * per:(r + 1) * per])
    w = runs["w"]
    jloader = JaxMnistLoader(jax_net("lenet"), runs["img"], runs["lbl"])
    jbatches = []
    for _ in range(LOADER_STEPS):
        x, y = jloader.next_batch()
        jbatches.append((np.asarray(x),
                         np.asarray(y).reshape(tr.LENET_BATCH, -1, 1, 1)))
    for (a, _), (b, _) in zip(jbatches, want):
        np.testing.assert_array_equal(a, b)
    exact, _, _ = port_steps("lenet", w, want, torch.float64, imposed(outs))
    one, _, one_l = port_steps("lenet", w, want)
    jp, _, jl = jax_steps("lenet", w, jbatches, d)
    out = outs[0]
    hold("lenet", w, out["params"], one, exact, out["losses"], one_l)
    hold("lenet", w, out["params"], jp, exact, out["losses"], jl)


def uninterrupted(runs, resumed, d):
    """The resumed cluster's last two steps against the uninterrupted
    four: the losses, and the parameters under the rule, the float64 run
    taking A's choices, then the resumed cluster's."""
    w, batches = runs["w"], runs["batches"]
    a = ranks(runs["clusters"]["A"], 2, "resume")
    exact = chained(w, batches, imposed(a), imposed(resumed))
    one, _, one_l = port_steps("lenet", w, batches)
    jp, _, jl = jax_steps("lenet", w, batches, d)
    out = resumed[0]
    assert out["step_count"] == 4 and out["seen"] == 4 * tr.LENET_BATCH
    np.testing.assert_allclose(out["losses"], one_l[2:], rtol=LOSS_RTOL)
    hold("lenet", w, out["params"], one, exact, np.r_[a[0]["losses"],
                                                       out["losses"]], one_l)
    hold("lenet", w, out["params"], jp, exact, np.r_[a[0]["losses"],
                                                      out["losses"]], jl)


def chained(w, batches, first, second):
    """The port's float64 steps of the four batches, the first two under
    `first`'s choices and the last two under `second`'s."""
    from bcnn_tpu_torch.compile import make_train_step
    from tests.test_torch_parallel import port_start, to_np

    net = port_net("lenet")
    params, state, opt = port_start(net, w, torch.float64)
    step = make_train_step(net)
    for choices, part in ((first, batches[:2]), (second, batches[2:])):
        with choices:
            for x, y in part:
                params, state, opt, _ = step(
                    params, state, opt, {"input": torch.from_numpy(x),
                                         "label": torch.from_numpy(y)})
    return to_np(net, params)


def test_checkpoint_resume_same_world(runs):
    """A fresh 2-rank ZeRO-1 cluster resumes A's checkpoint and continues
    the uninterrupted trajectory (`tests/test_multihost_process.py:146`)."""
    uninterrupted(runs, ranks(runs["clusters"]["B"], 2, "resume"), 2)


def test_elastic_resume_two_to_four(runs):
    """A 4-rank FSDP cluster resumes the 2-rank ZeRO-1 checkpoint
    (`tests/test_multihost_process.py:189`): the file is the single-
    device one, so the world size and the sharding may change."""
    uninterrupted(runs, ranks(runs["clusters"]["C"], 4, "resume"), 4)


def test_checkpoint_is_the_single_device_file(runs):
    """Rank 0 wrote bcnn_tpu's `.npz` with whole tensors (the ZeRO-1
    slots gathered): bcnn_tpu's load_checkpoint reads it, and one device
    of the port resumes from it and lands with the clusters (the
    scale-down to 1)."""
    w, batches = runs["w"], runs["batches"]
    a = ranks(runs["clusters"]["A"], 2, "resume")
    p_np, s_np, o_np, extra = jckpt.load_checkpoint(runs["ckpt"])
    assert int(extra["step_count"]) == 2
    assert int(np.asarray(o_np["seen"])) == 2 * tr.LENET_BATCH
    for k, v in a[0]["params"].items():
        np.testing.assert_array_equal(np.asarray(p_np[k]), v)
    assert o_np["velocity"]
    for k, v in o_np["velocity"].items():
        assert np.asarray(v).shape == a[0]["params"][k].shape
    net = port_net("lenet")
    sess = Session(net, 0, device="cpu").compile_net()
    sess.load_checkpoint(runs["ckpt"])
    losses = [float(sess.train_on_batch(x, y)) for x, y in batches[2:]]
    b = ranks(runs["clusters"]["B"], 2, "resume")[0]
    np.testing.assert_allclose(losses, b["losses"], rtol=LOSS_RTOL)
    one, _, _ = port_steps("lenet", w, batches)
    exact = chained(w, batches, imposed(a),
                    imposed(ranks(runs["clusters"]["B"], 2, "resume")))
    hold("lenet", w, bridge.params_to_numpy(net, sess.params), one, exact)


def test_initialize_and_mesh_refusals():
    """Without a process group a Mesh refuses; initialize asks for an
    address with a process count and index, and NCCL for CUDA."""
    with pytest.raises(RuntimeError, match="process group"):
        Mesh(device="cpu")
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize(num_processes=2, process_id=0, backend="gloo")
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize("localhost:1234", backend="gloo")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL"):
            multihost.initialize()
    with pytest.raises(ValueError, match="mesh"):
        Session(port_net("lenet"), 0, device="cpu", zero=1)
