"""bip, the host image-processing library of the port: `bcnn_tpu.bip`'s
load/save, crop (with negative-offset padding), bilinear resize, rotate,
flip, contrast/brightness, Perlin distortion and spotlights.

Two backends with the same semantics, and the choice is explicit:
  - "native", the default: the repo's C++ kernels (native/bip.cpp,
    OpenMP), built at first use (`native.py`). A failed build or load
    raises; nothing falls back;
  - "numpy" (`ops.py`): runs only when the caller asks for it with
    `set_backend("numpy")`. It is the oracle the tests hold the native
    one to (resize and rotate may differ by one level).

Decode follows `bcnn_tpu.bip`: with the native backend and the codecs
built, JPEG and PNG decode natively and Pillow takes the formats outside
them; otherwise Pillow decodes. `backend()` and `decoder()` say which
ran. Perlin distortion, spotlights and the image writers have no native
kernel: both backends run ops.py's.
"""

from __future__ import annotations

import numpy as np

from . import native, ops
from .ops import (  # noqa: F401  (no native kernel: one implementation)
    add_random_spotlights,
    perlin_distortion,
    status_string,
    write_double_image,
    write_float_image,
    write_float_image_norm,
    write_image,
)

BACKENDS = ("native", "numpy")
_backend = "native"


def set_backend(name: str) -> str:
    """Select the backend of every op below for this process; returns the
    previous one."""
    global _backend
    if name not in BACKENDS:
        raise ValueError(f"bip backend must be one of {BACKENDS}, got "
                         f"{name!r}")
    prev, _backend = _backend, name
    return prev


def backend() -> str:
    return _backend


def decoder() -> str:
    """"native" (libjpeg/libpng, Pillow for other formats) or
    "pillow"."""
    if _backend == "native" and native.decode_available():
        return "native"
    return "pillow"


def _impl():
    return native if _backend == "native" else ops


def load_image(path: str) -> np.ndarray:
    """bip_load_image: HWC uint8, grayscale stays one channel."""
    if decoder() == "native":
        try:
            return native.load_image(path)
        except ValueError:  # a format outside the native codecs
            return ops.load_image(path)
    return ops.load_image(path)


def crop_image(src, x_ul, y_ul, dst_w, dst_h, fill=0, out=None):
    return _impl().crop_image(src, x_ul, y_ul, dst_w, dst_h, fill, out)


def fliph_image(src):
    return _impl().fliph_image(src)


def resize_bilinear(src, dst_w, dst_h):
    return _impl().resize_bilinear(src, dst_w, dst_h)


def rotate_image(src, angle, center_x, center_y):
    return _impl().rotate_image(src, angle, center_x, center_y)


def contrast_stretch(src, contrast):
    return _impl().contrast_stretch(src, contrast)


def image_brightness(src, brightness):
    return _impl().image_brightness(src, brightness)


def set_num_threads(n: int) -> None:
    """Cap the native kernels' OpenMP pool for the calling thread (the
    numpy backend has none)."""
    if _backend == "native":
        native.set_num_threads(n)
