"""The port's prefetch pipelines (`bcnn_tpu_torch.data.pipeline`) on the
CPU device: BatchPipeline and ShardedBatchPipeline hand out exactly the
sequential loader's batches in its order (past EOF, raw uint8 batches
too), the sharded workers' augmentation streams are reseeded as
bcnn_tpu reseeds them, loader errors reach the consumer, and stop()
ends the workers. The card's path (pinned copies on a side stream, the
event and record_stream) is in tests/test_torch_cuda.py."""

import sys
import threading

import numpy as np
import pytest
import torch

from bcnn_tpu import Mode as JMode
from bcnn_tpu import Net as JNet
from bcnn_tpu.data import loaders as jloaders
from bcnn_tpu.data import pipeline as jpipeline

from bcnn_tpu_torch.data import loaders, records
from bcnn_tpu_torch.data.pipeline import BatchPipeline, ShardedBatchPipeline
from bcnn_tpu_torch.graph import Net
from bcnn_tpu_torch.types import Mode

from tests.test_torch_data import (det_list, list_file, pin_port_bip,
                                   write_images)

torch.set_num_threads(1)

TIMEOUT_S = 60


@pytest.fixture(scope="module", autouse=True)
def same_backend():
    """The port's workers augment on bcnn_tpu.bip's host backend."""
    yield from pin_port_bip()


def make_net(cls=Net, mode=Mode.TRAIN, batch=2, aug=None, raw=False):
    net = cls(mode)
    net.set_input_shape(16, 16, 3, batch)
    t1 = net.tensors[1]
    t1.n, t1.c, t1.h, t1.w = batch, 4, 1, 1
    net.data_aug = dict(aug or {})
    if raw:
        net.device_augment = {}
    return net


@pytest.fixture
def clf_list(tmp_path):
    # the net's size: no random crop, whose draws would come from each
    # worker's own stream
    ims = write_images(tmp_path, [(16, 16)] * 9)
    return list_file(tmp_path, "clf.txt",
                     [f"{p} {i % 4}" for i, p in enumerate(ims)])


def sequential(lst, n, **kw):
    ld = loaders.ClassificationListLoader(make_net(**kw), lst)
    return [ld.next_batch() for _ in range(n)]


def take(pipe, n):
    out = []
    for x, y in pipe:
        out.append((x, y))
        if len(out) == n:
            break
    return out


def assert_batches(got, ref, dtype=torch.float32):
    assert len(got) == len(ref)
    for (x, y), (rx, ry) in zip(got, ref):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert x.dtype == dtype and y.dtype == torch.float32
        np.testing.assert_array_equal(x.numpy(), rx.astype(
            x.numpy().dtype))
        np.testing.assert_array_equal(y.numpy(), ry)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_batch_pipeline_matches_sequential(clf_list, depth):
    pipe = BatchPipeline(loaders.ClassificationListLoader(
        make_net(), clf_list), depth=depth, device="cpu")
    try:
        got = take(pipe, 7)  # 14 samples of 9: past EOF
    finally:
        assert pipe.stop()
    assert_batches(got, sequential(clf_list, 7))


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_sharded_pipeline_preserves_sequential_order(clf_list, workers):
    pipe = ShardedBatchPipeline(
        lambda: loaders.ClassificationListLoader(make_net(), clf_list),
        workers=workers, device="cpu")
    try:
        got = take(pipe, 8)
    finally:
        pipe.stop()
    assert_batches(got, sequential(clf_list, 8))
    assert all(p.threads >= 1 for p in pipe.pipes)


def test_raw_batches_move_as_uint8(clf_list):
    """Raw mode (net.device_augment): the loader's whole pixel levels go
    as uint8; the labels stay float32."""
    pipe = ShardedBatchPipeline(
        lambda: loaders.ClassificationListLoader(make_net(raw=True),
                                                 clf_list),
        workers=2, device="cpu")
    try:
        got = take(pipe, 5)
    finally:
        pipe.stop()
    ref = sequential(clf_list, 5, raw=True)
    assert ref[0][0].dtype == np.float32
    assert_batches(got, ref, dtype=torch.uint8)


def test_record_pipeline_matches_the_loader(tmp_path):
    rng = np.random.RandomState(0)
    xs = rng.randint(0, 256, (7, 3, 4, 5)).astype(np.uint8)
    ys = rng.rand(7, 2).astype(np.float32)
    p = str(tmp_path / "r.bcrd")
    records.write_records(p, zip(xs, ys), 3, 4, 5, 2)
    net = make_net(batch=2)
    ref = records.RawRecordLoader(net, p)
    ref_b = [ref.next_batch() for _ in range(6)]
    pipe = ShardedBatchPipeline(lambda: records.RawRecordLoader(net, p),
                                workers=3, device="cpu")
    try:
        got = take(pipe, 6)
    finally:
        pipe.stop()
    assert_batches(got, ref_b, dtype=torch.uint8)


def test_sharded_augment_streams_match_bcnn_tpu(tmp_path):
    """Worker 0 keeps its loader's RandomState stream; the others are
    reseeded from it as bcnn_tpu reseeds them, so the augmented batches
    equal bcnn_tpu's ShardedBatchPipeline's."""
    lst = det_list(tmp_path, bad=False)
    aug = dict(random_fliph=1, min_contrast=0.7, max_contrast=1.3,
               min_brightness=-30, max_brightness=30)

    def det_net(cls, mode):
        net = cls(mode)
        net.set_input_shape(32, 32, 3, 2)
        t1 = net.tensors[1]
        t1.n, t1.c, t1.h, t1.w = 2, 250, 1, 1
        net.data_aug = dict(aug)
        return net

    tp = ShardedBatchPipeline(lambda: loaders.DetectionListLoader(
        det_net(Net, Mode.TRAIN), lst), workers=3, device="cpu")
    jp = jpipeline.ShardedBatchPipeline(lambda: jloaders.DetectionListLoader(
        det_net(JNet, JMode.TRAIN), lst), workers=3)
    try:
        got, ref = take(tp, 6), take(jp, 6)
    finally:
        tp.stop()
        jp.stop()
    for (x, y), (rx, ry) in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    # the workers' streams differ: not every window repeats worker 0's
    assert not all(np.array_equal(got[0][0].numpy(), got[i][0].numpy())
                   for i in (1, 2))


class FailingLoader:
    raw_mode = False

    def __init__(self, good=2):
        self.good = good

    def next_batch(self):
        if self.good == 0:
            raise OSError("disk gone")
        self.good -= 1
        return np.zeros((2, 3), np.float32), np.zeros((2, 1), np.float32)

    def set_shard(self, i, n):
        pass

    def close(self):
        pass


def test_loader_errors_reach_the_consumer():
    pipe = BatchPipeline(FailingLoader(2), depth=4, device="cpu")
    seen = 0
    with pytest.raises(OSError, match="disk gone"):
        for _ in pipe:
            seen += 1
    assert seen == 2
    assert pipe.stop()


def test_sharded_pipeline_surfaces_a_worker_error():
    made = iter([FailingLoader(5), FailingLoader(1)])
    pipe = ShardedBatchPipeline(lambda: next(made), workers=2,
                                device="cpu")
    seen = 0
    with pytest.raises(OSError, match="disk gone"):
        for _ in pipe:
            seen += 1
    assert seen == 3  # w0, w1, w0, then w1 fails
    pipe.stop()


def test_stop_ends_the_worker_and_closes_loaders(clf_list):
    closed = []

    class Tracked(loaders.ClassificationListLoader):
        def close(self):
            closed.append(1)
            super().close()

    pipe = ShardedBatchPipeline(lambda: Tracked(make_net(), clf_list),
                                workers=2, depth=1, device="cpu").start()
    take(pipe, 1)  # the workers now wait on full queues
    threads = [p._thread for p in pipe.pipes]
    pipe.stop()
    for t in threads:
        t.join(timeout=TIMEOUT_S)
        assert not t.is_alive()
    assert closed == [1, 1]


class _Batches:
    def __init__(self, n=2):
        self.x = np.arange(n * 8 * 3, dtype=np.float32).reshape(n, 8, 3)
        self.y = np.arange(n * 8, dtype=np.float32).reshape(n, 8)
        self.i = 0

    def next_batch(self):
        self.i += 1
        return self.x[self.i % 2], self.y[self.i % 2]


def test_refusals():
    """BatchPipeline(sharding=) hands out a mesh rank's stripe of every
    batch on the mesh's device (rank 1 of 2 on the CPU, `parallel.Mesh`
    built without a process group), and refuses another device; the
    card is the default device, refused where CUDA is missing."""
    from bcnn_tpu_torch.parallel import Mesh

    mesh = Mesh.__new__(Mesh)
    mesh.size, mesh.rank, mesh.device = 2, 1, torch.device("cpu")
    src = _Batches()
    pipe = BatchPipeline(_Batches(), depth=1, sharding=mesh).start()
    try:
        it = iter(pipe)
        for _ in range(3):
            x, y = next(it)
            want_x, want_y = src.next_batch()
            assert x.device == mesh.device
            np.testing.assert_array_equal(x.numpy(), want_x[4:])
            np.testing.assert_array_equal(y.numpy(), want_y[4:])
    finally:
        assert pipe.stop()
    with pytest.raises(ValueError, match="rank device"):
        BatchPipeline(FailingLoader(), sharding=mesh, device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BatchPipeline(FailingLoader())  # the card, unless asked
    with pytest.raises(ValueError, match="workers"):
        ShardedBatchPipeline(FailingLoader, workers=0, device="cpu")


def test_many_workers_keep_order_under_fast_switching(clf_list):
    """More workers than cores, a short switch interval: the round-robin
    order holds (a lost or reordered batch breaks it)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    done = threading.Event()
    result = {}

    def run():
        pipe = ShardedBatchPipeline(
            lambda: loaders.ClassificationListLoader(make_net(), clf_list),
            workers=12, depth=1, device="cpu")
        try:
            result["got"] = take(pipe, 24)
        finally:
            pipe.stop()
            done.set()

    try:
        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(timeout=TIMEOUT_S)
        assert done.is_set() and not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert_batches(result["got"], sequential(clf_list, 24))


def test_session_trains_from_a_pipeline(clf_list):
    """Session.train_on_batch on the pipeline's tensors equals it on the
    loader's host arrays (the same steps, bit for bit on the CPU)."""
    from bcnn_tpu_torch import Session
    from bcnn_tpu_torch.types import (Activation, FillerType, Loss,
                                      Metric)

    def session():
        net = make_net(batch=2)
        net.set_sgd_optimizer(0.05, 0.9)
        net.add_convolutional_layer(4, 3, 1, 1, 1, 0, FillerType.XAVIER,
                                    Activation.RELU, 0, "input", "c1")
        net.add_fullc_layer(4, FillerType.XAVIER, Activation.NONE, 0,
                            "c1", "fc")
        net.add_softmax_layer("fc", "sm")
        net.add_cost_layer(Loss.EUCLIDEAN, Metric.SSE, 1.0, "sm")
        return Session(net, 0, device="cpu").compile_net()

    a, b = session(), session()
    pipe = BatchPipeline(loaders.ClassificationListLoader(a.net, clf_list),
                         device="cpu")
    try:
        la = [float(a.train_on_batch(x, y)) for x, y in take(pipe, 4)]
    finally:
        pipe.stop()
    b.loader = loaders.ClassificationListLoader(b.net, clf_list)
    lb = [float(b.train_on_batch()) for _ in range(4)]
    assert la == lb
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
