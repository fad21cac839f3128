"""Streaming data loaders, the port's copy of `bcnn_tpu.data.loaders`
(numpy, no JAX): batches come out as host numpy arrays, NCHW, and the
Session or a pipeline (`data.pipeline`) moves them to the device.

Mirrors src/bcnn_data.{h,c} + src/data_loader/: each loader owns open file
handles for the train and test streams; `next_sample` reads one example at
the current position with auto-rewind at EOF (infinite epochs,
bcnn_mnist_loader.c:107-116), unreadable samples are skipped with a retry
(bcnn_data.c:402-427); switching into VALID/PREDICT rewinds the test stream
(bcnn_switch_data_handles, bcnn_data.c:512-544).

Sample output: (input CHW float32, label float32 vector), normalization
[0,255] -> [-1,1] unless a loader documents otherwise.
"""

from __future__ import annotations

import io
import struct
from typing import IO, Optional, Tuple

import numpy as np

from .. import bip
from ..types import DETECTION_MAX_BOXES, LoaderType, Mode
from .augment import Augmenter, convert_img_to_float


class DataLoader:
    def __init__(
        self,
        net,
        train_path: str,
        train_path_extra: Optional[str] = None,
        test_path: Optional[str] = None,
        test_path_extra: Optional[str] = None,
    ):
        self.net = net
        self.f_train = open(train_path, "rb") if train_path else None
        self.f_train_extra = (
            open(train_path_extra, "rb") if train_path_extra else None
        )
        self.f_test = open(test_path, "rb") if test_path else None
        self.f_test_extra = (
            open(test_path_extra, "rb") if test_path_extra else None
        )
        self._mode = Mode.TRAIN if self.f_train else Mode.PREDICT
        # per-process stream striping (multi-host data loading): process p
        # of P owns records [k*P*b + p*b, k*P*b + (p+1)*b) of each global
        # batch k (b = net.batch_size = the LOCAL batch). None = whole
        # stream (single process).
        self._shard: Optional[Tuple[int, int]] = None
        aug_dict = getattr(net, "data_aug", {}) or {}
        self.augmenter = Augmenter.from_dict(aug_dict)
        # raw mode: skip host augmentation AND normalization, emitting raw
        # pixel values [0,255] as float CHW — the feed for train steps with
        # fused on-device augmentation (compile.make_train_step's
        # device_augment / net.device_augment)
        self.raw_mode = getattr(net, "device_augment", None) is not None

    # ---- stream selection (bcnn_switch_data_handles) ------------------- #

    @property
    def f_current(self) -> IO:
        if self._mode == Mode.TRAIN:
            return self.f_train
        return self.f_test if self.f_test else self.f_train

    @property
    def f_current_extra(self) -> IO:
        if self._mode == Mode.TRAIN:
            return self.f_train_extra
        return self.f_test_extra if self.f_test_extra else self.f_train_extra

    def set_mode(self, mode: Mode):
        """Rewind the eval stream on switch (bcnn_data.c:526-535). With a
        shard active, every process rewinds its own stream, so the stripe
        alignment restarts at global batch 0 on all processes together."""
        self._mode = mode
        if mode != Mode.TRAIN:
            for f in (self.f_test, self.f_test_extra):
                if f:
                    f.seek(0)

    def set_shard(self, process_index: int, process_count: int):
        """Per-process striping of the sequential stream (multi-host data
        loading; the reference is single-process — bcnn_data.c:402-427 —
        so this is the rebuild's DP extension of its FILE* semantics).

        The global batch of a P-process run is P*b samples in file order;
        process p reads its b-sample slice and SKIPS the other (P-1)*b
        records (a seek for fixed-record formats, a readline for list
        formats — no image decode), so the processes partition the
        stream exactly like one process reading P*b per batch.

        Per-shard stream semantics are preserved: EOF auto-rewind,
        eval-stream rewind on mode switch, and skip-bad-sample (the retry
        consumes the record following the slice, exactly like the
        reference's same-stream retry; for a readable stream the
        partition is exact, with corrupt records the affected process's
        stripe shifts by one record per bad sample)."""
        if not (0 <= process_index < process_count):
            raise ValueError((process_index, process_count))
        self._shard = (
            None if process_count == 1 else (process_index, process_count)
        )

    def close(self):
        for f in (
            self.f_train,
            self.f_train_extra,
            self.f_test,
            self.f_test_extra,
        ):
            if f:
                f.close()

    # ---- batch assembly (bcnn_loader_next, bcnn_data.c:392-427) -------- #

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._shard is None:
            return self._next_batch_impl()
        pi, pc = self._shard
        b = self.net.batch_size
        self._skip_samples(pi * b)
        out = self._next_batch_impl()
        self._skip_samples((pc - 1 - pi) * b)
        return out

    def _next_batch_impl(self) -> Tuple[np.ndarray, np.ndarray]:
        net = self.net
        b = net.batch_size
        t0, t1 = net.tensors[0], net.tensors[1]
        x = np.zeros((b, t0.c, t0.h, t0.w), np.float32)
        y = np.zeros((b, max(1, t1.size3d())), np.float32)
        i = 0
        attempts = 0
        while i < b:
            try:
                xi, yi = self.next_sample()
            except _SkipSample:
                attempts += 1
                if attempts > 16 * b:
                    raise RuntimeError("too many unreadable samples")
                continue
            x[i] = xi.reshape(t0.c, t0.h, t0.w)
            if yi is not None:
                y[i, : yi.size] = yi
            i += 1
        return x, y

    def next_sample(self):
        raise NotImplementedError

    def skip_sample(self):
        """Advance the stream past one record WITHOUT producing it.
        Default: parse-and-discard (bad records count as one record, as
        in next_sample). Fixed-record loaders override with a seek; list
        loaders with a readline — neither decodes the image."""
        try:
            self.next_sample()
        except _SkipSample:
            pass

    def _skip_samples(self, n: int):
        for _ in range(n):
            self.skip_sample()

    # helpers shared by list loaders
    def _read_line_tokens(self, f: IO):
        line = f.readline()
        if not line:
            f.seek(0)
            line = f.readline()
        return line.decode().split()

    def _load_image_crop(self, path: str):
        """bcnn_load_image_from_path (bcnn_data.c:104-143): center crop in
        VALID/PREDICT, random crop in TRAIN, to the net input size."""
        net = self.net
        t0 = net.tensors[0]
        img = bip.load_image(path)
        h, w, c = img.shape
        if c != t0.c:
            raise _SkipSample(path)
        if (w, h) != (t0.w, t0.h):
            if self._mode == Mode.TRAIN:
                x_ul = int(
                    self.augmenter.rng.rand() * (w - t0.w) + 0.5
                )
                y_ul = int(
                    self.augmenter.rng.rand() * (h - t0.h) + 0.5
                )
            else:
                x_ul = (w - t0.w) // 2
                y_ul = (h - t0.h) // 2
            img = bip.crop_image(img, x_ul, y_ul, t0.w, t0.h)
        return img

    def _augment(self, img: np.ndarray) -> np.ndarray:
        if self._mode == Mode.TRAIN and not self.raw_mode:
            return self.augmenter.apply(img)
        return img

    def _normalize(self, img: np.ndarray) -> np.ndarray:
        a = self.augmenter
        if self.raw_mode:
            return convert_img_to_float(img, 1.0, a.swap_to_bgr, 0, 0, 0)
        if a.no_input_norm:
            return convert_img_to_float(img, 1.0, a.swap_to_bgr, 0, 0, 0)
        mr = a.mean_r * 255.0 if a.mean_r else 127.5
        mg = a.mean_g * 255.0 if a.mean_g else 127.5
        mb = a.mean_b * 255.0 if a.mean_b else 127.5
        return convert_img_to_float(
            img, 1 / 127.5, a.swap_to_bgr, mr, mg, mb
        )


class _SkipSample(Exception):
    pass


class MnistLoader(DataLoader):
    """idx-format (bcnn_mnist_loader.c:41-192): 16-byte image header /
    8-byte label header; streaming with auto-rewind; one-hot labels."""

    HDR_IMG = 16
    HDR_LBL = 8

    def __init__(self, net, train_img, train_label, test_img=None,
                 test_label=None):
        super().__init__(net, train_img, train_label, test_img, test_label)
        self._read_header(self.f_train, self.f_train_extra)
        if self.f_test:
            self._read_header(self.f_test, self.f_test_extra)
        for f in (self.f_train, self.f_train_extra, self.f_test,
                  self.f_test_extra):
            if f:
                f.seek(0)

    def _read_header(self, fimg, flbl):
        h = fimg.read(16)
        if len(h) != 16:
            raise ValueError("Corrupted Mnist data")
        _, n_img, self.img_h, self.img_w = struct.unpack(">4i", h)
        h2 = flbl.read(8)
        _, n_lbl = struct.unpack(">2i", h2)
        if n_img != n_lbl:
            raise ValueError(
                "Inconsistent MNIST data: images != labels"
            )
        fimg.seek(16)
        flbl.seek(8)

    def _next_batch_impl(self):
        """Native C++ batch assembly (native/loader.cpp) when no host
        augmentation runs; bit-identical to the per-sample path."""
        if self.raw_mode or self._mode != Mode.TRAIN \
                or self.augmenter.is_identity():
            from . import native_loader

            t0, t1 = self.net.tensors[0], self.net.tensors[1]
            out = None
            if t0.h <= self.img_h and t0.w <= self.img_w:
                try:
                    out = native_loader.mnist_batch(
                        self.f_current, self.f_current_extra,
                        self.net.batch_size, self.img_h, self.img_w,
                        t0.h, t0.w,
                        normalize=not self.raw_mode,
                        label_sz=max(1, t1.size3d()),
                    )
                except (OSError, io.UnsupportedOperation):
                    out = None  # not a real file (BytesIO): python path
            if out is not None:
                return out
        return super()._next_batch_impl()

    def skip_sample(self):
        """Record skip by seek: no decode, same rewind rules as
        next_sample."""
        fimg, flbl = self.f_current, self.f_current_extra
        if not fimg.peek(1)[:1]:
            fimg.seek(0)
        if not flbl.peek(1)[:1]:
            flbl.seek(0)
        if fimg.tell() == 0 and flbl.tell() == 0:
            self._read_header(fimg, flbl)
        fimg.seek(self.img_w * self.img_h, 1)
        flbl.seek(1, 1)

    def next_sample(self):
        fimg, flbl = self.f_current, self.f_current_extra
        sz = self.img_w * self.img_h
        # auto-rewind at EOF (past-the-header restart)
        if not fimg.peek(1)[:1]:
            fimg.seek(0)
        if not flbl.peek(1)[:1]:
            flbl.seek(0)
        if fimg.tell() == 0 and flbl.tell() == 0:
            self._read_header(fimg, flbl)
        lbl = flbl.read(1)
        raw = fimg.read(sz)
        if len(raw) != sz or len(lbl) != 1:
            raise ValueError("Corrupted Mnist data")
        img = np.frombuffer(raw, np.uint8).reshape(self.img_h, self.img_w, 1)
        img = self._augment(np.ascontiguousarray(img))
        t0 = self.net.tensors[0]
        if t0.w < self.img_w or t0.h < self.img_h:
            img = bip.crop_image(
                img,
                (self.img_w - t0.w) // 2,
                (self.img_h - t0.h) // 2,
                t0.w,
                t0.h,
            )
        if self.raw_mode:
            x = convert_img_to_float(img, 1.0, 0, 0, 0, 0)  # raw pixels
        else:
            x = convert_img_to_float(img)  # [-1, 1]
        y = np.zeros(max(1, self.net.tensors[1].size3d()), np.float32)
        y[int(lbl[0])] = 1.0
        return x, y


class Cifar10Loader(DataLoader):
    """CIFAR-10 binary (bcnn_cifar10_loader.c:69-171): 1 label byte +
    3072 CHW bytes per record; CHW->HWC staging swap; one-hot."""

    def __init__(self, net, train_path, test_path=None):
        super().__init__(net, train_path, None, test_path, None)
        self.img_w = self.img_h = 32
        self.depth = 3

    def _next_batch_impl(self):
        """Native C++ batch assembly (native/loader.cpp) when no host
        augmentation runs; bit-identical to the per-sample path."""
        t0 = self.net.tensors[0]
        if (t0.h, t0.w, t0.c) == (32, 32, 3) and (
            self.raw_mode or self._mode != Mode.TRAIN
            or self.augmenter.is_identity()
        ):
            from . import native_loader

            a = self.augmenter
            if self.raw_mode or a.no_input_norm:
                coeff, means = 1.0, (0.0, 0.0, 0.0)
            else:
                coeff = 1 / 127.5
                means = (
                    a.mean_r * 255.0 if a.mean_r else 127.5,
                    a.mean_g * 255.0 if a.mean_g else 127.5,
                    a.mean_b * 255.0 if a.mean_b else 127.5,
                )
            try:
                out = native_loader.cifar_batch(
                    self.f_current, self.net.batch_size, a.swap_to_bgr,
                    means, coeff,
                    max(1, self.net.tensors[1].size3d()),
                )
            except (OSError, io.UnsupportedOperation):
                out = None
            if out is not None:
                return out
        return super()._next_batch_impl()

    def skip_sample(self):
        f = self.f_current
        if not f.peek(1)[:1]:
            f.seek(0)
        f.seek(self.img_w * self.img_h * self.depth + 1, 1)

    def next_sample(self):
        f = self.f_current
        rec = self.img_w * self.img_h * self.depth + 1
        if not f.peek(1)[:1]:
            f.seek(0)
        raw = f.read(rec)
        if len(raw) != rec:
            raise ValueError("Corrupted Cifar data")
        lbl = raw[0]
        chw = np.frombuffer(raw[1:], np.uint8).reshape(
            self.depth, self.img_h, self.img_w
        )
        img = np.ascontiguousarray(np.transpose(chw, (1, 2, 0)))
        img = self._augment(img)
        x = self._normalize(img)
        y = np.zeros(max(1, self.net.tensors[1].size3d()), np.float32)
        y[int(lbl)] = 1.0
        return x, y


class ClassificationListLoader(DataLoader):
    """Text lines `path label` (bcnn_classif_loader.c:63-106)."""

    def __init__(self, net, train_path, test_path=None):
        super().__init__(net, train_path, None, test_path, None)

    def skip_sample(self):
        self._read_line_tokens(self.f_current)  # no image decode

    def next_sample(self):
        toks = self._read_line_tokens(self.f_current)
        if not toks:
            raise _SkipSample("empty line")
        if self._mode != Mode.PREDICT and len(toks) != 2:
            raise _SkipSample("bad classif line")
        img = self._augment(self._load_image_crop(toks[0]))
        x = self._normalize(img)
        y = np.zeros(max(1, self.net.tensors[1].size3d()), np.float32)
        if len(toks) > 1:
            y[int(toks[1])] = 1.0
        return x, y


class RegressionListLoader(DataLoader):
    """Text lines `path v1 v2 ...` (bcnn_regression_loader.c:61-89)."""

    def __init__(self, net, train_path, test_path=None):
        super().__init__(net, train_path, None, test_path, None)

    def skip_sample(self):
        self._read_line_tokens(self.f_current)  # no image decode

    def next_sample(self):
        toks = self._read_line_tokens(self.f_current)
        if not toks:
            raise _SkipSample("empty line")
        img = self._augment(self._load_image_crop(toks[0]))
        x = self._normalize(img)
        label_sz = max(1, self.net.tensors[1].size3d())
        y = np.zeros(label_sz, np.float32)
        vals = [float(v) for v in toks[1:]]
        y[: min(len(vals), label_sz)] = vals[: label_sz]
        return x, y


class DetectionListLoader(DataLoader):
    """Text lines `path [class x y w h]xN` (bcnn_detection_loader.c:67-183):
    aspect-preserving resize onto a gray(128) letterbox canvas — random
    placement in TRAIN, centered otherwise — labels rescaled to canvas
    coordinates, h-flip mirrored onto box x; 50x5 label layout.

    Deviation: the reference computes the aspect ratio with integer division
    (`float wh_ratio = w_img / h_img`, :103), which degenerates (nw == 0 for
    portrait images); the correct float ratio is used here."""

    def __init__(self, net, train_path, test_path=None):
        super().__init__(net, train_path, None, test_path, None)

    def skip_sample(self):
        self._read_line_tokens(self.f_current)  # no image decode

    def next_sample(self):
        net = self.net
        t0 = net.tensors[0]
        toks = self._read_line_tokens(self.f_current)
        if not toks or (len(toks) - 1) % 5 != 0:
            raise _SkipSample("bad detection line")
        try:
            img = bip.load_image(toks[0])
        except Exception:
            raise _SkipSample(toks[0])
        h, w, c = img.shape
        if c != t0.c:
            raise _SkipSample("channels")
        ratio = w / h
        if ratio < 1:
            nh = t0.h
            nw = max(1, int(nh * ratio))
        else:
            nw = t0.w
            nh = max(1, int(nw / ratio))
        resized = bip.resize_bilinear(img, nw, nh)
        if self._mode == Mode.TRAIN:
            dx = int(self.augmenter.rng.rand() * (t0.w - nw) + 0.5)
            dy = int(self.augmenter.rng.rand() * (t0.h - nh) + 0.5)
        else:
            dx = (t0.w - nw) // 2
            dy = (t0.h - nh) // 2
        canvas = np.full((t0.h, t0.w, c), 128, np.uint8)
        bip.crop_image(resized, -dx, -dy, t0.w, t0.h, out=canvas)
        if self._mode == Mode.TRAIN:
            # only flip/contrast/brightness supported for detection
            self.augmenter.apply_fliph = 0
            if self.augmenter.random_fliph:
                self.augmenter.apply_fliph = int(
                    self.augmenter.rng.rand() > 0.5
                )
            if self.augmenter.apply_fliph:
                canvas = bip.fliph_image(canvas)
            if self.augmenter.min_contrast or self.augmenter.max_contrast:
                cst = (
                    self.augmenter.rng.rand()
                    * (self.augmenter.max_contrast
                       - self.augmenter.min_contrast)
                    + self.augmenter.min_contrast
                )
                canvas = bip.contrast_stretch(canvas, cst)
            if self.augmenter.min_brightness or self.augmenter.max_brightness:
                br = int(
                    self.augmenter.rng.rand()
                    * (self.augmenter.max_brightness
                       - self.augmenter.min_brightness)
                    + self.augmenter.min_brightness
                )
                canvas = bip.image_brightness(canvas, br)
        x = self._normalize(canvas)
        y = np.zeros(DETECTION_MAX_BOXES * 5, np.float32)
        num_boxes = min((len(toks) - 1) // 5, DETECTION_MAX_BOXES)
        sx, sy = nw / t0.w, nh / t0.h
        sdx, sdy = dx / t0.w, dy / t0.h
        for i in range(num_boxes):
            cls = float(toks[1 + 5 * i])
            bx = float(toks[2 + 5 * i]) * sx + sdx
            by = float(toks[3 + 5 * i]) * sy + sdy
            bw = float(toks[4 + 5 * i]) * sx
            bh = float(toks[5 + 5 * i]) * sy
            if self.augmenter.apply_fliph:
                bx = 1.0 - bx
            y[5 * i : 5 * i + 5] = [bx, by, bw, bh, cls]
        return x, y


def make_loader(net, loader_type: LoaderType, train_path, train_path_extra,
                test_path=None, test_path_extra=None) -> DataLoader:
    """bcnn_set_data_loader dispatch (bcnn_data.c:377-390)."""
    lt = LoaderType(loader_type)
    if lt == LoaderType.MNIST:
        return MnistLoader(
            net, train_path, train_path_extra, test_path, test_path_extra
        )
    if lt == LoaderType.CIFAR10:
        return Cifar10Loader(net, train_path, test_path)
    if lt == LoaderType.CLASSIFICATION_LIST:
        return ClassificationListLoader(net, train_path, test_path)
    if lt == LoaderType.REGRESSION_LIST:
        return RegressionListLoader(net, train_path, test_path)
    if lt == LoaderType.DETECTION_LIST:
        return DetectionListLoader(net, train_path, test_path)
    raise ValueError(f"unknown loader type {loader_type}")
