"""Background prefetch of loader batches onto the device, the port of
`bcnn_tpu.data.pipeline`.

The reference uploads each batch synchronously after assembling it
(bcnn_loader_next's cudaMemcpy, bcnn_data.c:413-425). Here a worker
thread assembles the next batch on the host (decode, augmentation: numpy
and the native bip, which release the GIL) while the device computes on
the current one.

On a CUDA device the worker copies each batch into pinned host memory
and from there to the device with `non_blocking=True` copies on a CUDA
stream of its own, records an event after them and queues (x, y,
event). The consumer's stream waits on that event before the batch is
handed out, and each tensor is marked with `record_stream` for the
consumer's stream, so that the caching allocator does not give its
memory to another batch while the consumer's kernels may still read it.
The queue's depth bounds the batches held on the card (depth queued,
one being copied, one in use). On the CPU device the host arrays are
handed out as tensors, without a copy.

A batch moves as uint8 when the loader is in raw mode (`net.
device_augment` set: DataLoader.raw_mode, or a RawRecordLoader), its
values being whole pixel levels; the training step normalizes on the
device.

Data parallel (`sharding=`, a `parallel.Mesh`, where `bcnn_tpu/data/
pipeline.py:21-40` takes a jax sharding): each rank's loader yields the
global batch, and only the rank's stripe of it (`Mesh.stripe`) is copied
to the rank's device, the mesh's: the batch the DP step takes.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .. import bip


class BatchPipeline:
    def __init__(self, loader, depth: int = 2, device=None, sharding=None):
        """loader: anything with next_batch() -> (x, y) host arrays;
        depth: batches prefetched; device: where the batches go (the
        card unless the caller asks for the CPU); sharding: a
        `parallel.Mesh`, whose rank's stripe of each batch goes to its
        device."""
        if sharding is not None:
            if device is not None and torch.device(device) not in (
                    sharding.device, torch.device(sharding.device.type)):
                raise ValueError(f"BatchPipeline(device={device!r}) is not "
                                 f"the mesh's rank device {sharding.device}")
            device = sharding.device
        self.sharding = sharding
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"BatchPipeline(device={device!r}): CUDA is not available")
        self.loader = loader
        self._raw = bool(getattr(loader, "raw_mode", False))
        # the native bip's OpenMP pool of the worker thread
        # (ShardedBatchPipeline caps it so that W pools share the cores)
        self.threads: Optional[int] = None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stream = None

    def _to_device(self, x: np.ndarray, y: np.ndarray):
        if self._raw and x.dtype != np.uint8:
            x = x.astype(np.uint8)  # whole levels in [0, 255]: exact
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        if self.sharding is not None:
            xt, yt = self.sharding.stripe(xt), self.sharding.stripe(yt)
        if self.device.type != "cuda":
            return xt.to(self.device), yt.to(self.device), None
        with torch.cuda.stream(self._stream):
            xd = xt.pin_memory().to(self.device, non_blocking=True)
            yd = yt.pin_memory().to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return xd, yd, ev

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.25)
                return
            except queue.Full:
                continue

    def _worker(self):
        if self.threads is not None:
            bip.set_num_threads(self.threads)
        while not self._stop.is_set():
            try:
                x, y = self.loader.next_batch()
                item = self._to_device(x, y)
            except Exception as e:  # surfaced to the consumer, in order
                self._put(e)
                return
            self._put(item)

    def start(self) -> "BatchPipeline":
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        if self._thread is None:
            self.start()
        while True:
            item = self._q.get()
            if isinstance(item, Exception):
                raise item
            x, y, ev = item
            if ev is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(ev)
                x.record_stream(cur)
                y.record_stream(cur)
            yield x, y

    def stop(self) -> bool:
        """Returns True when the worker thread actually exited (callers
        may only tear down the loader underneath it in that case)."""
        self._stop.set()
        joined = True
        if self._thread:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2.0)
            joined = not self._thread.is_alive()
            self._thread = None
        return joined


class ShardedBatchPipeline:
    """Parallel host-side loading that PRESERVES the sequential stream's
    batch order (`bcnn_tpu/data/pipeline.py:76-142`).

    Each of W workers owns a private loader striped (w, W) over the same
    files (DataLoader.set_shard), so worker w assembles the w-th b-sample
    slice of every W*b-sample window; consuming the per-worker queues
    round-robin reproduces exactly the single-stream batch order while
    decode and augmentation run W-wide. Sample order, labels, EOF rewind
    and skip-bad-sample follow set_shard's per-shard semantics. Worker 0
    keeps its loader's augmentation stream (the 1-worker path is the
    parity one); the others are reseeded from it, so AUGMENTED pixels
    draw from per-worker streams. The native bip's OpenMP pool of each
    worker is capped at cpu_count / W threads."""

    def __init__(self, loader_factory, workers: int = 2, depth: int = 2,
                 device=None, sharding=None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.loaders = []
        for w in range(workers):
            ld = loader_factory()
            ld.set_shard(w, workers)
            aug = getattr(ld, "augmenter", None)
            if aug is not None and w > 0:
                aug.rng = np.random.RandomState(
                    (aug.rng.randint(1 << 31) + w) & 0x7FFFFFFF
                )
            self.loaders.append(ld)
        self.pipes = [
            BatchPipeline(ld, depth=depth, device=device, sharding=sharding)
            for ld in self.loaders
        ]
        for p in self.pipes:
            p.threads = max(1, (os.cpu_count() or 1) // workers)

    def start(self) -> "ShardedBatchPipeline":
        for p in self.pipes:
            p.start()
        return self

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        its = [iter(p) for p in self.pipes]
        while True:
            for it in its:
                yield next(it)

    def stop(self):
        for p, ld in zip(self.pipes, self.loaders):
            # close the loader only once its worker has really exited: a
            # thread still in a slow decode would read a closed file
            if p.stop():
                ld.close()
