"""The upload of a host batch (`bcnn_tpu_torch/upload.py`), on the CPU:
the chunk plan, which inputs the staged path takes, the staging loop
run over a ring of plain CPU buffers (its copies, its waits and
records, its chunk count), a CPU session's `_input` against
`torch.as_tensor`, and the counters. The staged path on the card is
in `tests/test_torch_cuda.py`. Imports no JAX."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bcnn_tpu_torch import Session, upload
from bcnn_tpu_torch.models import yolov3_tiny

torch.set_num_threads(1)

CHUNK = upload.CHUNK_BYTES // 4  # fp32 values a slot
BIG = 2 * CHUNK + 12_345  # three chunks, the last a partial one


@pytest.fixture(autouse=True)
def fresh_counts():
    upload.reset_counts()
    yield
    upload.reset_counts()


@pytest.mark.parametrize("numel,chunk", [
    (10, 3), (9, 3), (1, 4), (4, 4), (BIG, CHUNK),
    (64 * 3 * 416 * 416, CHUNK), (64 * 3 * 608 * 608, CHUNK)])
def test_chunks_cover_every_value_once_in_order(numel, chunk):
    plan = upload.chunks(numel, chunk)
    assert len(plan) == -(-numel // chunk)
    assert plan[0][0] == 0 and plan[-1][1] == numel
    for (a, b), (c, _) in zip(plan, plan[1:]):
        assert b == c  # no gap, no overlap
    assert all(0 < b - a <= chunk for a, b in plan)
    assert all(b - a == chunk for a, b in plan[:-1])


def _big(dtype=np.float32, shape=(BIG,)):
    return (np.random.RandomState(0).rand(*shape) * 255).astype(dtype)


@pytest.mark.parametrize("make", [
    lambda: _big(),
    lambda: _big(np.uint8),
    lambda: _big(np.float64),
    lambda: torch.from_numpy(_big()),
    lambda: _big(shape=(4, 3, 1024, 1024)),
    lambda: np.zeros(2 * CHUNK, np.uint8),  # two chunks once in fp32
], ids=["fp32", "uint8", "float64", "cpu-tensor", "nchw",
        "uint8-two-chunks"])
def test_host_flat_takes_large_contiguous_host_batches(make):
    x = make()
    flat = upload.host_flat(x)
    assert flat is not None and flat.dim() == 1
    assert flat.numel() == (x.size if isinstance(x, np.ndarray)
                            else x.numel())
    # the caller's own memory, not a copy
    ptr = x.ctypes.data if isinstance(x, np.ndarray) else x.data_ptr()
    assert flat.data_ptr() == ptr


@pytest.mark.parametrize("make", [
    lambda: np.zeros(2 * CHUNK - 1, np.float32),   # under two chunks
    lambda: np.zeros(2 * CHUNK - 1, np.uint8),     # counted in fp32
    lambda: _big(shape=(3, BIG // 3)).T,           # not C-contiguous
    lambda: _big(shape=(2, BIG))[:, ::2],          # strided
    lambda: _big()[::-1],                          # negative stride
    lambda: _big().astype(">f4"),                  # byte order
    lambda: torch.zeros(BIG, requires_grad=True),  # autograd
    lambda: torch.zeros(BIG, device="meta"),       # not a host tensor
    lambda: [1.0, 2.0],
], ids=["small", "small-uint8", "transposed", "strided", "reversed",
        "big-endian", "grad", "device", "list"])
def test_host_flat_leaves_the_rest_to_the_direct_path(make):
    assert upload.host_flat(make()) is None


class _Event:
    """A slot's event on the CPU: logs its waits and records."""

    def __init__(self, log, k):
        self.log, self.k = log, k

    def synchronize(self):
        self.log.append(("wait", self.k))

    def record(self, stream):
        self.log.append(("record", self.k))


def _cpu_ring(log, slots=3, chunk=1000):
    return SimpleNamespace(
        chunk=chunk,
        slots=[torch.full((chunk,), float("nan")) for _ in range(slots)],
        events=[_Event(log, k) for k in range(slots)])


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.float64,
                                   np.int64, np.float16])
@pytest.mark.parametrize("numel", [1000, 7001, 12000])
def test_stage_writes_as_tensors_bits_through_the_ring(dtype, numel):
    x = np.random.RandomState(numel).randn(numel) * 1e3
    x = x.astype(dtype)
    log = []
    ring = _cpu_ring(log)
    dst = torch.full((numel,), float("nan"))
    upload.stage(torch.from_numpy(x), dst, ring, stream=None)
    want = torch.as_tensor(x, dtype=torch.float32)
    assert torch.equal(dst.view(torch.int32), want.view(torch.int32))
    n = -(-numel // ring.chunk)
    assert upload.counts()["chunks"] == n
    # each chunk: wait on its slot's event, then record it, in turn
    assert log == [e for i in range(n)
                   for e in (("wait", i % 3), ("record", i % 3))]


def test_stage_under_inference_mode_then_outside_it():
    """A ring made in inference mode is written outside it too."""
    log = []
    with torch.inference_mode(), torch.inference_mode(False):
        ring = _cpu_ring(log)
    x = torch.arange(2500, dtype=torch.float32)
    for mode in (True, False):
        with torch.inference_mode(mode):
            dst = torch.empty(2500)
            upload.stage(x, dst, ring, stream=None)
        assert torch.equal(dst, x)


def test_cpu_session_input_is_as_tensor_bit_for_bit():
    sess = Session(yolov3_tiny(2, 64, 64, 4), 0, device="cpu")
    rs = np.random.RandomState(1)
    base = rs.randn(4, 3, 1024, 1024) * 300
    cases = [base.astype(np.float32), (base % 256).astype(np.uint8),
             base, base.astype(np.float32).transpose(0, 1, 3, 2),
             torch.from_numpy(base.astype(np.float32))]
    assert upload.host_flat(cases[0]) is not None  # large enough to stage
    for x in cases:
        got = sess._input(x)
        want = torch.as_tensor(x, dtype=torch.float32)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert upload.counts() == {"staged": 0, "direct": len(cases),
                               "chunks": 0, "pin_failed": 0}


def test_a_refused_ring_falls_back_to_the_direct_path(monkeypatch):
    def refuse():
        raise RuntimeError("pinned memory refused")

    took = []
    as_tensor = torch.as_tensor
    monkeypatch.setattr(upload, "Ring", refuse)
    monkeypatch.setattr(torch, "as_tensor",
                        lambda x, dtype, device: took.append(device)
                        or as_tensor(x, dtype=dtype))
    up = upload.Uploader(torch.device("cuda"))
    x = _big()
    for _ in range(2):  # the allocation is not tried again
        assert torch.equal(up(x), as_tensor(x))
    assert took == [torch.device("cuda")] * 2
    assert upload.counts() == {"staged": 0, "direct": 2, "chunks": 0,
                               "pin_failed": 1}


def test_counts_count_and_reset():
    up = upload.Uploader(torch.device("cpu"))
    up(np.zeros(4, np.float32))
    up(_big())
    assert upload.counts()["direct"] == 2
    got = upload.counts()
    got["direct"] = 99  # a copy, not the counters
    assert upload.counts()["direct"] == 2
    upload.stage(torch.zeros(2500), torch.empty(2500), _cpu_ring([]),
                 stream=None)
    assert upload.counts()["chunks"] == 3
    upload.reset_counts()
    assert upload.counts() == {"staged": 0, "direct": 0, "chunks": 0,
                               "pin_failed": 0}


def test_each_chunk_is_a_stage_span_inside_the_upload():
    """Under a profiler each chunk's host copy is a `bcnn.upload.stage`
    span, nested in the caller's `bcnn.upload` (`spans.py` puts a gap
    there down to the upload); no profiler, no span."""
    from torch.profiler import ProfilerActivity, profile

    from bcnn_tpu_torch.profiling import span

    def run():
        with span("bcnn.upload"):
            upload.stage(torch.zeros(2500), torch.empty(2500),
                          _cpu_ring([]), stream=None)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    got = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith("bcnn.")]
    (outer,) = [s for s in got if s[0] == "bcnn.upload"]
    stages = [s for s in got if s[0] == "bcnn.upload.stage"]
    assert len(stages) == 3
    assert all(outer[1] <= a and b <= outer[2] for _, a, b in stages)
