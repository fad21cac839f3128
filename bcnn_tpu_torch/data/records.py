"""Raw training records: decode once, train many times. The port's copy
of `bcnn_tpu.data.records` (numpy, no JAX).

The reference re-decodes every PNG/JPG on every epoch
(bcnn_detection_loader.c:85, via stb_image). The record file runs the
decode and letterbox ONCE offline, stores raw uint8 pixels and final
labels in a fixed-record binary, and trains from it with nothing on the
host but a memcpy. Augmentation then runs on the device inside the
training step (`net.device_augment`, `data.device_augment`).

File layout (little-endian):
  header: magic 'BCRD' | u32 version=1 | u32 n | u32 c,h,w | u32 label_sz
  then n records of (c*h*w uint8 pixels, label_sz float32 labels).

RawRecordLoader is a DataLoader: same stream semantics (sequential
reads, EOF rewind, set_shard striping for multi-host AND for
ShardedBatchPipeline workers), but next_batch returns UINT8 pixels so
the host->device transfer is 4x smaller than fp32 — normalization is
the device augment's job. Records are mmapped; a batch is one gather.
"""

from __future__ import annotations

import struct

import numpy as np

from ..types import Mode
from .native_loader import native_lib

_MAGIC = b"BCRD"


def write_records(path: str, sample_iter, c: int, h: int, w: int,
                  label_size: int) -> int:
    """Write records from an iterator of (uint8 CHW pixels, float32
    labels). Returns the number of records written."""
    n = 0
    with open(path, "wb") as f:
        f.write(_MAGIC + struct.pack("<5I", 1, 0, c, h, w))
        f.write(struct.pack("<I", label_size))
        for img, lab in sample_iter:
            img = np.ascontiguousarray(img, np.uint8)
            if img.size != c * h * w:
                raise ValueError(f"record {n}: pixels {img.shape} != "
                                 f"({c},{h},{w})")
            labv = np.zeros(label_size, np.float32)
            if lab is not None:
                lab = np.asarray(lab, np.float32).ravel()
                labv[: lab.size] = lab
            f.write(img.tobytes())
            f.write(labv.tobytes())
            n += 1
        f.seek(8)
        f.write(struct.pack("<I", n))
    return n


def records_from_loader(loader, path: str, n: int) -> int:
    """Offline conversion pass: pull n samples of the TRAIN source
    through an existing loader's VALID-mode processing (centered
    letterbox, host augmentation off — randomness belongs to the
    on-device augment at train time) and write them as raw records. The
    loader's float output is inverted exactly back to uint8
    ((v*127.5)+127.5 is exact for uint8 pixels), which requires the
    DEFAULT normalization: custom means, no_input_norm, BGR swap, and
    raw_mode would all silently corrupt the inversion, so they are
    rejected loudly here."""
    a = getattr(loader, "augmenter", None)
    if getattr(loader, "raw_mode", False) or (a is not None and (
        a.no_input_norm or a.swap_to_bgr or a.mean_r or a.mean_g
        or a.mean_b
    )):
        raise ValueError(
            "records_from_loader assumes the default (v-127.5)/127.5 "
            "normalization; this loader uses no_input_norm/mean/BGR/"
            "raw_mode — write records with write_records() from raw "
            "pixels instead"
        )
    net = loader.net
    t0, t1 = net.tensors[0], net.tensors[1]
    # VALID-mode PROCESSING over the TRAIN source: f_current prefers the
    # test stream outside TRAIN mode, so park it during the pass
    saved = (loader.f_test, loader.f_test_extra)
    loader.f_test = loader.f_test_extra = None
    loader.set_mode(Mode.VALID)

    def gen():
        produced = 0
        while produced < n:
            x, y = loader.next_batch()
            for i in range(x.shape[0]):
                if produced >= n:
                    return
                img = np.clip(np.rint(x[i] * 127.5 + 127.5), 0, 255)
                yield img.astype(np.uint8), y[i]
                produced += 1

    try:
        return write_records(path, gen(), t0.c, t0.h, t0.w,
                             max(1, t1.size3d()))
    finally:
        loader.f_test, loader.f_test_extra = saved
        loader.set_mode(Mode.TRAIN)


class RawRecordLoader:
    """DataLoader-shaped reader for record files (see module docstring).

    next_batch returns (uint8 (b,c,h,w), float32 (b,label_size)): feed
    it to a training step with device_augment (net.device_augment), which
    takes raw uint8 NCHW and normalizes on the device. Supports set_shard (the same stripe
    partition DataLoader uses, so it works under ShardedBatchPipeline
    and multihost.shard_loader) and EOF rewind."""

    def __init__(self, net, path: str):
        self.net = net
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8 + 16 + 4)
        if head[:4] != _MAGIC:
            raise ValueError(f"{path}: not a BCRD record file")
        ver, n, c, h, w, lab = struct.unpack("<6I", head[4:28])
        if ver != 1:
            raise ValueError(f"{path}: unsupported record version {ver}")
        self.n, self.c, self.h, self.w, self.label_size = n, c, h, w, lab
        self._hdr = 28
        self._rec = c * h * w + lab * 4
        self._buf = np.memmap(path, np.uint8, mode="r")
        if n < 1:
            raise ValueError(
                f"{path}: header says {n} records (writer crashed before "
                "patching the count?)"
            )
        need = self._hdr + n * self._rec
        if self._buf.size < need:
            raise ValueError(
                f"{path}: truncated — header promises {n} records "
                f"({need} bytes), file has {self._buf.size}"
            )
        self._pos = 0        # TRAIN stream position
        self._pos_eval = 0   # VALID/PREDICT stream position
        self._mode = Mode.TRAIN
        self._shard = None

    # -- DataLoader surface ------------------------------------------- #

    def set_shard(self, process_index: int, process_count: int):
        if not (0 <= process_index < process_count):
            raise ValueError((process_index, process_count))
        self._shard = (
            None if process_count == 1 else (process_index, process_count)
        )

    def set_mode(self, mode):
        """DataLoader stream semantics: the eval stream rewinds on every
        switch; the TRAIN position survives eval cycles."""
        self._mode = mode
        if mode != Mode.TRAIN:
            self._pos_eval = 0

    def close(self):
        self._buf = None

    def _get_pos(self) -> int:
        return self._pos if self._mode == Mode.TRAIN else self._pos_eval

    def _set_pos(self, v: int):
        if self._mode == Mode.TRAIN:
            self._pos = v
        else:
            self._pos_eval = v

    def _take(self, b: int):
        px = self.c * self.h * self.w
        x = np.empty((b, self.c, self.h, self.w), np.uint8)
        y = np.empty((b, self.label_size), np.float32)
        cur = self._get_pos()
        lib = native_lib()  # the numpy gather when None
        if lib is not None:
            import ctypes

            pos = ctypes.c_long(cur)
            rc = lib.bcnn_loader_records_batch(
                self._buf, self._hdr, self.n, px, self.label_size,
                ctypes.byref(pos), b,
                x.reshape(-1), y,
            )
            if rc != 0:
                raise ValueError(f"{self.path}: native record gather "
                                 f"failed ({rc})")
            self._set_pos(pos.value)
            return x, y
        idx = [(cur + j) % self.n for j in range(b)]
        self._set_pos((cur + b) % self.n)
        for j, r in enumerate(idx):
            off = self._hdr + r * self._rec
            x[j] = self._buf[off: off + px].reshape(
                self.c, self.h, self.w
            )
            y[j] = np.frombuffer(
                self._buf[off + px: off + self._rec].tobytes(), np.float32
            )
        return x, y

    def next_batch(self):
        b = self.net.batch_size
        if self._shard is None:
            return self._take(b)
        pi, pc = self._shard
        self._set_pos((self._get_pos() + pi * b) % self.n)
        out = self._take(b)
        self._set_pos((self._get_pos() + (pc - 1 - pi) * b) % self.n)
        return out

    def read_all(self):
        """Decode the whole file: (x (n,c,h,w) uint8, y (n,label) f32).

        The device-resident feed uploads this ONCE and trains from device
        memory with per-call index gathers
        (compile.make_train_scan_resident, Session.
        train_scan_resident_on_batches): a dataset that fits on the card
        removes the per-step host-to-device copy."""
        px = self.c * self.h * self.w
        rec = np.asarray(
            self._buf[self._hdr: self._hdr + self.n * self._rec]
        ).reshape(self.n, self._rec)
        x = rec[:, :px].reshape(self.n, self.c, self.h, self.w).copy()
        y = rec[:, px:].copy().view(np.float32)
        return x, y


class EpochIndexStream:
    """Deterministic per-epoch-shuffled sample indices for the
    device-resident feed.

    `pos` is ONE absolute sample counter: epoch = pos // n picks the
    epoch's permutation (reseeded from (seed, epoch)), offset = pos % n
    walks it. Checkpoints store just `pos`; restoring it resumes the
    exact index sequence — same recovery contract as RawRecordLoader's
    stream position. shuffle=False degrades to the sequential mod-n
    order RawRecordLoader itself produces."""

    def __init__(self, n: int, batch: int, seed: int = 0,
                 shuffle: bool = True):
        if n < 1 or batch < 1:
            raise ValueError((n, batch))
        self.n, self.batch = n, batch
        self.seed = seed
        self.shuffle = shuffle
        self.pos = 0
        self._perm_epoch = -1
        self._perm = None

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return None
        if epoch != self._perm_epoch:
            self._perm = np.random.default_rng(
                (self.seed, epoch)
            ).permutation(self.n).astype(np.int32)
            self._perm_epoch = epoch
        return self._perm

    def next(self, k: int) -> np.ndarray:
        """(k, batch) int32 — indices for k consecutive scan steps."""
        out = np.empty(k * self.batch, np.int32)
        got, pos = 0, self.pos
        while got < out.size:
            epoch, off = divmod(pos, self.n)
            take = min(self.n - off, out.size - got)
            if self.shuffle:
                out[got: got + take] = self._epoch_perm(epoch)[
                    off: off + take]
            else:
                out[got: got + take] = np.arange(off, off + take,
                                                 dtype=np.int32)
            got += take
            pos += take
        self.pos = pos
        return out.reshape(k, self.batch)


class ShardedEpochIndexStream:
    """Index stream for a SHARDED device-resident feed (bcnn_tpu's
    parallel.make_dp_train_scan_resident_sharded): the dataset lives as
    D shards of n/D samples, and every batch is STRATIFIED — exactly
    batch/D samples from each shard, drawn from D independent per-shard
    epoch shuffles (each shard's samples appear once per local epoch).
    next(k) returns (k, D, batch/D) int32 LOCAL indices.

    One absolute `pos` counter (in global samples) checkpoints/resumes
    the whole stream: all shard streams advance in lockstep, so pos/D
    positions each of them — the same recovery contract as
    EpochIndexStream."""

    def __init__(self, n: int, batch: int, d_shards: int, seed: int = 0,
                 shuffle: bool = True):
        if n % d_shards or batch % d_shards:
            raise ValueError(
                f"n={n} and batch={batch} must divide by D={d_shards}"
            )
        self.n, self.batch, self.d = n, batch, d_shards
        self._streams = [
            EpochIndexStream(
                n // d_shards, batch // d_shards,
                seed=int(np.random.SeedSequence(
                    [seed, s]).generate_state(1)[0]),
                shuffle=shuffle,
            )
            for s in range(d_shards)
        ]

    @property
    def pos(self) -> int:
        return self._streams[0].pos * self.d

    @pos.setter
    def pos(self, p: int):
        if p % self.d:
            raise ValueError(f"pos {p} not divisible by D={self.d}")
        for s in self._streams:
            s.pos = p // self.d

    def next(self, k: int) -> np.ndarray:
        """(k, D, batch/D) int32 local per-shard indices."""
        return np.stack([s.next(k) for s in self._streams], axis=1)
