"""Native (C++/OpenMP) batch assembly for the streaming loaders, the
port's copy of `bcnn_tpu.data.native_loader`.

The reference's data pipeline layer is C (src/data_loader/ +
bcnn_loader_next, bcnn_data.c:392-427); this is its native rebuild for the
formats whose decode is pure byte math: MNIST idx and CIFAR-10 binary.
The dataset files are mmapped once per file object; stream positions stay
in the Python file objects (so rewind-on-mode-switch, finite `tell()`
semantics and interop with the per-sample path are preserved), and
native/loader.cpp assembles the whole batch in one call.

Used by MnistLoader/Cifar10Loader when no host augmentation is active
(augmented samples go through the per-sample bip path, which owns the RNG
stream) and the bip backend is native; with the numpy backend the
loaders take the per-sample path. Outputs are bit-identical to it
(tests/test_torch_data.py).
"""

from __future__ import annotations

import ctypes
import mmap
from typing import Optional, Tuple

import numpy as np

from .. import bip


def native_lib():
    """The native library under the native bip backend (built if need
    be; a failed build raises), else None."""
    return bip.native.get_lib() if bip.backend() == "native" else None


def _mmap_of(f) -> np.ndarray:
    """uint8 view of the whole file, cached on the file object."""
    buf = getattr(f, "_bcnn_mmap", None)
    if buf is None:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        buf = np.frombuffer(mm, np.uint8)
        f._bcnn_mmap_obj = mm  # keep the mapping alive
        f._bcnn_mmap = buf
    return buf


def mnist_batch(
    fimg, flbl, batch: int, img_h: int, img_w: int, out_h: int, out_w: int,
    normalize: bool, label_sz: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = native_lib()
    if lib is None:
        return None
    img = _mmap_of(fimg)
    lbl = _mmap_of(flbl)
    ip = ctypes.c_long(fimg.tell())
    lp = ctypes.c_long(flbl.tell())
    x = np.zeros((batch, 1, out_h, out_w), np.float32)
    y = np.zeros((batch, label_sz), np.float32)
    rc = lib.bcnn_loader_mnist_batch(
        img, img.size, lbl, lbl.size, ctypes.byref(ip), ctypes.byref(lp),
        batch, img_h, img_w, out_h, out_w, int(normalize), x, y, label_sz,
    )
    if rc != 0:
        raise ValueError("Corrupted Mnist data")
    fimg.seek(ip.value)
    flbl.seek(lp.value)
    return x, y


def cifar_batch(
    f, batch: int, swap_bgr: int, means: Tuple[float, float, float],
    coeff: float, label_sz: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = native_lib()
    if lib is None:
        return None
    buf = _mmap_of(f)
    pos = ctypes.c_long(f.tell())
    x = np.zeros((batch, 3, 32, 32), np.float32)
    y = np.zeros((batch, label_sz), np.float32)
    rc = lib.bcnn_loader_cifar_batch(
        buf, buf.size, ctypes.byref(pos), batch, int(swap_bgr),
        float(means[0]), float(means[1]), float(means[2]), float(coeff),
        x, y, label_sz,
    )
    if rc != 0:
        raise ValueError("Corrupted Cifar data")
    f.seek(pos.value)
    return x, y
