"""ctypes bindings for the repo's native C++ host kernels: the bip image
ops (`native/bip.cpp`), the batched MNIST / CIFAR / record loaders
(`native/loader.cpp`) and the JPEG/PNG decode (`native/decode.cpp`).

The sources are compiled as they stand with `native/Makefile`'s flags
(`-O3 -march=native -fPIC -shared -fopenmp -std=c++17`) and its default
compiler, the `g++` on PATH, so that on one machine the library
computes what `bcnn_tpu.bip.native`'s does, bit for bit. `$CXX` is not
read: a CXX set for another toolchain (a gcc installed without
OpenMP's spec file, as on some GPU hosts) would fail the build. The codecs are probed
the way the Makefile probes them: decode.cpp is built only when a
program links against -ljpeg -lpng.

The library is built at first use, once, into `bcnn_tpu_torch/_build/`,
named by a hash of the sources, the flags and the codec probe; a
change to any of them builds anew. The build runs under an
`fcntl` lock on a file beside it, so that concurrent processes (test
workers) build it once, and the finished file is renamed into place
atomically. Nothing is written into `native/`. A build or load failure
raises NativeBuildFailed with the compiler's output: nothing falls back
to another backend here.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import signal
import subprocess
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
            "-std=c++17")
SOURCES = ("bip.cpp", "loader.cpp")
CODEC_SOURCE = "decode.cpp"
CODEC_LIBS = ("-ljpeg", "-lpng")
CXX = "g++"  # native/Makefile: CXX ?= g++
BUILD_TIMEOUT_S = 300

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_lp = ctypes.POINTER(ctypes.c_long)
_ip = ctypes.POINTER(ctypes.c_int)
_i = ctypes.c_int
_f = ctypes.c_float
_l = ctypes.c_long


class NativeBuildFailed(RuntimeError):
    """The native host library could not be built or loaded."""


def _run(cmd, stdin=""):
    """(returncode, output) of cmd in a session of its own, so that a
    timeout kills the compiler's children too (a killed g++ leaves
    cc1plus holding the pipes)."""
    try:
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
    except OSError as e:
        raise NativeBuildFailed(f"cannot run the compiler {cmd[0]!r}: {e}")
    try:
        out, _ = proc.communicate(stdin, timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise NativeBuildFailed(f"{' '.join(cmd)}: no result in "
                               f"{BUILD_TIMEOUT_S} s")
    return proc.returncode, out


def _have_codecs(cxx: str) -> bool:
    """native/Makefile's HAVE_CODECS: does a program link with -ljpeg
    -lpng?"""
    rc, _ = _run([cxx, "-x", "c++", "-", *CODEC_LIBS, "-o", os.devnull],
                 "int main(){return 0;}")
    return rc == 0


def _command(cxx: str, codecs: bool, out: Path):
    srcs = list(SOURCES) + ([CODEC_SOURCE] if codecs else [])
    return [
        cxx, *CXXFLAGS, *(["-DBCNN_HAVE_CODECS"] if codecs else []),
        "-o", str(out), *(str(NATIVE_DIR / s) for s in srcs),
        *(CODEC_LIBS if codecs else ()),
    ]


def library_path() -> Path:
    """Build the library unless one of the same sources, flags and
    codecs is in `_build/` already; return its path. Every failure,
    a missing source or an unwritable build directory too, raises
    NativeBuildFailed (the loaders treat an OSError as a file that cannot
    be mmapped)."""
    try:
        return _build()
    except OSError as e:
        raise NativeBuildFailed(f"native build failed: {e}") from e


def _build() -> Path:
    cxx = CXX
    codecs = _have_codecs(cxx)
    digest = hashlib.sha256(
        " ".join(_command(cxx, codecs, Path("out"))).encode())
    for s in SOURCES + (CODEC_SOURCE,):
        digest.update((NATIVE_DIR / s).read_bytes())
    lib = BUILD_DIR / f"libbcnn_bip_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libbcnn_bip.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():  # another process built it while we waited
            return lib
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = _command(cxx, codecs, tmp)
        try:
            rc, out = _run(cmd)
            if rc != 0:
                raise NativeBuildFailed(
                    f"native build failed ({rc}): {' '.join(cmd)}\n{out}")
        except NativeBuildFailed:
            tmp.unlink(missing_ok=True)
            raise
        os.replace(tmp, lib)
    return lib


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The native library, built if need be, loaded and bound (once per
    process)."""
    path = library_path()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeBuildFailed(f"cannot load {path}: {e}")
    lib.bcnn_bip_crop.argtypes = [_u8p, _i, _i, _i, _i, _i, _u8p, _i, _i]
    lib.bcnn_bip_crop.restype = None
    lib.bcnn_bip_fliph.argtypes = [_u8p, _i, _i, _i, _u8p]
    lib.bcnn_bip_fliph.restype = None
    lib.bcnn_bip_resize_bilinear.argtypes = [_u8p, _i, _i, _i, _u8p, _i, _i]
    lib.bcnn_bip_resize_bilinear.restype = None
    lib.bcnn_bip_rotate.argtypes = [_u8p, _i, _i, _i, _u8p, _f, _i, _i]
    lib.bcnn_bip_rotate.restype = None
    lib.bcnn_bip_contrast.argtypes = [_u8p, _i, _i, _i, _u8p, _f]
    lib.bcnn_bip_contrast.restype = None
    lib.bcnn_bip_brightness.argtypes = [_u8p, _i, _u8p, _i]
    lib.bcnn_bip_brightness.restype = None
    lib.bcnn_bip_to_float_chw.argtypes = [
        _u8p, _i, _i, _i, _f, _i, _f32p, _f32p,
    ]
    lib.bcnn_bip_to_float_chw.restype = None
    lib.bcnn_bip_batch_to_float_chw.argtypes = [
        _u8p, _i, _i, _i, _i, _f, _i, _f32p, _f32p,
    ]
    lib.bcnn_bip_batch_to_float_chw.restype = None
    lib.bcnn_bip_set_num_threads.argtypes = [_i]
    lib.bcnn_bip_set_num_threads.restype = None
    lib.bcnn_bip_num_threads.argtypes = []
    lib.bcnn_bip_num_threads.restype = _i
    lib.bcnn_loader_mnist_batch.argtypes = [
        _u8p, _l, _u8p, _l, _lp, _lp, _i, _i, _i, _i, _i, _i, _f32p,
        _f32p, _i,
    ]
    lib.bcnn_loader_mnist_batch.restype = _i
    lib.bcnn_loader_cifar_batch.argtypes = [
        _u8p, _l, _lp, _i, _i, _f, _f, _f, _f, _f32p, _f32p, _i,
    ]
    lib.bcnn_loader_cifar_batch.restype = _i
    lib.bcnn_loader_records_batch.argtypes = [
        _u8p, _l, _l, _l, _l, _lp, _i, _u8p, _f32p,
    ]
    lib.bcnn_loader_records_batch.restype = _i
    if hasattr(lib, "bcnn_decode_image"):  # built with the codecs
        lib.bcnn_decode_image.argtypes = [_u8p, _l, _u8p, _l, _ip, _ip, _ip]
        lib.bcnn_decode_image.restype = _i
        lib.bcnn_decode_batch.argtypes = [
            _u8p, _i64p, _i64p, _i, _u8p, _i64p, _i64p,
            _i32p, _i32p, _i32p, _i32p,
        ]
        lib.bcnn_decode_batch.restype = _i
    return lib


def set_num_threads(n: int) -> None:
    """Cap the OpenMP pool of the native kernels called from this
    thread (bcnn_set_num_threads)."""
    get_lib().bcnn_bip_set_num_threads(max(1, int(n)))


def num_threads() -> int:
    return get_lib().bcnn_bip_num_threads()


# --------------------------------------------------------------------- #
# the bip ops, with ops.py's signatures
# --------------------------------------------------------------------- #


def _hwc(src: np.ndarray) -> np.ndarray:
    if src.ndim != 3 or src.dtype != np.uint8:
        raise ValueError(f"expected an HWC uint8 image, got {src.dtype} "
                         f"{src.shape}")
    return np.ascontiguousarray(src)


def crop_image(src, x_ul, y_ul, dst_w, dst_h, fill=0, out=None):
    src = _hwc(src)
    h, w, c = src.shape
    if out is None:
        out = np.full((dst_h, dst_w, c), fill, np.uint8)
    elif out.shape != (dst_h, dst_w, c) or out.dtype != np.uint8 \
            or not out.flags.c_contiguous:
        raise ValueError(f"out must be a contiguous uint8 "
                         f"{(dst_h, dst_w, c)} array, got {out.shape}")
    get_lib().bcnn_bip_crop(src, h, w, c, x_ul, y_ul, out, dst_h, dst_w)
    return out


def fliph_image(src):
    src = _hwc(src)
    h, w, c = src.shape
    out = np.empty_like(src)
    get_lib().bcnn_bip_fliph(src, h, w, c, out)
    return out


def resize_bilinear(src, dst_w, dst_h):
    src = _hwc(src)
    h, w, c = src.shape
    out = np.empty((dst_h, dst_w, c), np.uint8)
    get_lib().bcnn_bip_resize_bilinear(src, h, w, c, out, dst_h, dst_w)
    return out


def rotate_image(src, angle, center_x, center_y):
    src = _hwc(src)
    h, w, c = src.shape
    out = np.empty_like(src)
    get_lib().bcnn_bip_rotate(src, h, w, c, out, float(angle),
                              int(center_x), int(center_y))
    return out


def contrast_stretch(src, contrast):
    src = _hwc(src)
    h, w, c = src.shape
    out = np.empty_like(src)
    get_lib().bcnn_bip_contrast(src, h, w, c, out, float(contrast))
    return out


def image_brightness(src, brightness):
    src = np.ascontiguousarray(src, np.uint8)
    out = np.empty_like(src)
    get_lib().bcnn_bip_brightness(src, src.size, out, int(brightness))
    return out


def convert_img_to_float(
    img, norm_coeff=1 / 127.5, swap_to_bgr=0,
    mean_r=127.5, mean_g=127.5, mean_b=127.5,
):
    img = _hwc(img)
    h, w, c = img.shape
    mean = np.asarray([mean_r, mean_g, mean_b][:c], np.float32)
    out = np.empty((c, h, w), np.float32)
    get_lib().bcnn_bip_to_float_chw(img, h, w, c, float(norm_coeff),
                                    int(swap_to_bgr), mean, out)
    return out


def batch_convert_to_float(
    imgs, norm_coeff=1 / 127.5, swap_to_bgr=0, mean=(127.5, 127.5, 127.5),
):
    """imgs: (N,H,W,C) uint8 -> (N,C,H,W) float32, OpenMP over the batch."""
    imgs = np.ascontiguousarray(imgs, np.uint8)
    n, h, w, c = imgs.shape
    m = np.asarray(mean[:c], np.float32)
    out = np.empty((n, c, h, w), np.float32)
    get_lib().bcnn_bip_batch_to_float_chw(imgs, n, h, w, c,
                                          float(norm_coeff),
                                          int(swap_to_bgr), m, out)
    return out


# --------------------------------------------------------------------- #
# JPEG/PNG decode (native/decode.cpp, the system libjpeg/libpng)
# --------------------------------------------------------------------- #

_DECODE_DUMMY = np.zeros(1, np.uint8)


def decode_available() -> bool:
    """Whether the library was built with the codecs."""
    return hasattr(get_lib(), "bcnn_decode_image")


def decode_image_bytes(data) -> np.ndarray:
    """Decode an in-memory JPEG/PNG blob -> HWC uint8 (grayscale stays
    one channel, like ops.load_image). Raises ValueError on anything the
    native codecs do not cover."""
    lib = get_lib()
    buf = np.frombuffer(data, np.uint8) if not isinstance(
        data, np.ndarray) else data
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    r = lib.bcnn_decode_image(buf, len(buf), _DECODE_DUMMY, 0,
                              ctypes.byref(w), ctypes.byref(h),
                              ctypes.byref(c))
    if r == -1:
        raise ValueError("unsupported or corrupt image")
    out = np.empty((h.value, w.value, c.value), np.uint8)
    r = lib.bcnn_decode_image(buf, len(buf), out, out.size,
                              ctypes.byref(w), ctypes.byref(h),
                              ctypes.byref(c))
    if r != 0:
        raise ValueError("image decode failed")
    return out


def load_image(path: str) -> np.ndarray:
    """bip_load_image through the native codecs."""
    with open(path, "rb") as f:
        return decode_image_bytes(f.read())


def decode_batch(blobs) -> list:
    """Decode a list of in-memory JPEG/PNG blobs OpenMP-parallel into HWC
    uint8 arrays; raises ValueError if any blob fails."""
    lib = get_lib()
    n = len(blobs)
    data = np.frombuffer(b"".join(blobs), np.uint8)
    sizes = np.asarray([len(b) for b in blobs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    ws, hs, cs, status = (np.zeros(n, np.int32) for _ in range(4))
    # probe pass (capacity 0) for the dims, then one parallel decode
    caps0 = np.zeros(n, np.int64)
    lib.bcnn_decode_batch(data, offsets, sizes, n, _DECODE_DUMMY, caps0,
                          caps0, ws, hs, cs, status)
    if (status == -1).any():
        raise ValueError(f"undecodable blobs at {np.nonzero(status == -1)[0]}")
    caps = ws.astype(np.int64) * hs * cs
    out_offsets = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int64)
    outs = np.empty(int(caps.sum()), np.uint8)
    r = lib.bcnn_decode_batch(data, offsets, sizes, n, outs, out_offsets,
                              caps, ws, hs, cs, status)
    if r != 0:
        raise ValueError(f"decode failed at {np.nonzero(status != 0)[0]}")
    return [outs[o:o + k].reshape(hs[i], ws[i], cs[i])
            for i, (o, k) in enumerate(zip(out_offsets, caps))]
