"""The port's bip (`bcnn_tpu_torch.bip`) against bcnn_tpu's, on the CPU.

  - numpy backend: every op of `bip/ops.py` against `bcnn_tpu.bip.ops`
    on the same inputs, bit for bit (the same numpy code);
  - native backend: the port's library, built from native/*.cpp with the
    Makefile's flags, against `bcnn_tpu.bip.native` (the Makefile's
    build), bit for bit;
  - the port's native against its numpy within the one level
    tests/test_native.py allows for resize and rotate (float summation
    order), exact elsewhere;
  - the build: the library lives in `_build/` under a hash of its
    sources, is built once under its lock by concurrent processes, and a
    failed build raises.

The native library is built once, in the `lib` fixture, under the lock;
a build failure there is an error."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from bcnn_tpu.bip import native as jnative
from bcnn_tpu.bip import ops as jops

from bcnn_tpu_torch import bip
from bcnn_tpu_torch.bip import native as tnative
from bcnn_tpu_torch.bip import ops as tops

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    return tnative.get_lib()


@pytest.fixture(scope="module")
def jax_native():
    """bcnn_tpu's native library, built by its own `make`."""
    if not jnative.available():
        pytest.skip("bcnn_tpu's native library did not build (its make)")
    return jnative


def _img(seed=0, h=37, w=29, c=3):
    return (np.random.RandomState(seed).rand(h, w, c) * 255).astype(np.uint8)


IMG = _img()
GRAY = _img(1, 23, 31, 1)
ODD = _img(2, 15, 13, 1)

# op name -> call on an ops module (numpy backend)
OPS = {
    "crop_negative": lambda m: m.crop_image(IMG, -4, -2, 40, 40, fill=7),
    "crop_inside": lambda m: m.crop_image(IMG, 3, 5, 20, 22),
    "crop_past_edge": lambda m: m.crop_image(IMG, 10, 30, 29, 37),
    "fliph": lambda m: m.fliph_image(IMG),
    "resize_up": lambda m: m.resize_bilinear(IMG, 64, 48),
    "resize_down": lambda m: m.resize_bilinear(IMG, 13, 11),
    "rotate": lambda m: m.rotate_image(IMG, 0.3, 14, 18),
    "rotate_negative": lambda m: m.rotate_image(IMG, -1.1, 3, 30),
    "contrast": lambda m: m.contrast_stretch(IMG, 1.3),
    "brightness": lambda m: m.image_brightness(IMG, -30),
    "perlin": lambda m: m.perlin_distortion(IMG, 0.05, 0.2, -0.3, 42),
    "spotlights": lambda m: m.add_random_spotlights(
        IMG, 3, 0.3, 3.0, 0.3, 3.0, np.random.RandomState(5)),
    "integral": lambda m: m.image_integral(GRAY),
    "sobel": lambda m: m.image_sobel(GRAY),
    "otsu": lambda m: m.otsu_threshold(GRAY),
    "pyramid_down": lambda m: m.pyramid_down(ODD),
    "pyramid_up": lambda m: m.pyramid_up(ODD),
    "rgb2gray": lambda m: m.rgb2gray(IMG),
    "invert": lambda m: m.invert_image(IMG),
    "mirror_borders": lambda m: m.mirror_borders(IMG, 2, 3, 4, 1),
    "histogram": lambda m: m.image_histogram(GRAY),
    "entropy": lambda m: m.image_entropy(GRAY),
    "square_integral": lambda m: m.image_square_integral(GRAY),
    "sliding_mean": lambda m: m.image_sliding_mean(GRAY, 5, 3),
    "sliding_mean_variance": lambda m: m.image_sliding_mean_variance(
        GRAY, 3, 5),
    "lbp_estimate": lambda m: m.lbp_estimate(GRAY),
    "lbp_histogram": lambda m: m.lbp_histogram_features(
        m.lbp_estimate(GRAY)),
    "lbp_histogram_uniform_norm": lambda m: m.lbp_histogram_features(
        m.lbp_estimate(GRAY), norm=True, uniform=True),
    "median_3x3": lambda m: m.median_3x3(GRAY),
    "gaussian_blur_3x3": lambda m: m.gaussian_blur_3x3(IMG),
    "status_string": lambda m: [m.status_string(s) for s in range(5)],
}


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("op", sorted(OPS))
def test_numpy_ops_match_bcnn_tpu(op):
    _same(OPS[op](tops), OPS[op](jops))


@pytest.mark.parametrize("writer", ["write_image", "write_float_image",
                                    "write_float_image_norm",
                                    "write_double_image"])
def test_image_writers_match_bcnn_tpu(tmp_path, writer):
    img = IMG if writer == "write_image" else (
        IMG.astype(np.float64) / 200.0 - 0.2)
    getattr(tops, writer)(str(tmp_path / "t.png"), img)
    getattr(jops, writer)(str(tmp_path / "j.png"), img)
    assert (tmp_path / "t.png").read_bytes() == (
        tmp_path / "j.png").read_bytes()
    _same(tops.load_image(str(tmp_path / "t.png")),
          jops.load_image(str(tmp_path / "j.png")))


def test_memory_codec_matches_bcnn_tpu():
    blob = tops.write_image_to_memory(IMG)
    assert blob == jops.write_image_to_memory(IMG)
    _same(tops.load_image_from_memory(blob), jops.load_image_from_memory(
        blob))
    _same(tops.load_image_from_memory(blob), IMG)


# ------------------------------------------------------------- native #

NATIVE = {
    "crop_negative": lambda m: m.crop_image(IMG, -4, -2, 40, 40, fill=7),
    "crop_inside": lambda m: m.crop_image(IMG, 3, 5, 20, 22),
    "crop_past_edge": lambda m: m.crop_image(IMG, 10, 30, 29, 37),
    "fliph": lambda m: m.fliph_image(IMG),
    "resize_up": lambda m: m.resize_bilinear(IMG, 64, 48),
    "resize_down": lambda m: m.resize_bilinear(IMG, 13, 11),
    "resize_same": lambda m: m.resize_bilinear(IMG, 29, 37),
    "rotate": lambda m: m.rotate_image(IMG, 0.3, 14, 18),
    "rotate_negative": lambda m: m.rotate_image(IMG, -1.1, 3, 30),
    "contrast": lambda m: m.contrast_stretch(IMG, 1.3),
    "brightness": lambda m: m.image_brightness(IMG, -30),
    "to_float": lambda m: m.convert_img_to_float(
        IMG, 1 / 127.5, 1, 100.0, 110.0, 120.0),
    "batch_to_float": lambda m: m.batch_convert_to_float(
        np.stack([IMG, IMG[::-1].copy()])),
}
# the port's numpy against its native: one level (tests/test_native.py)
LEVEL = {"resize_up", "resize_down", "resize_same", "rotate",
         "rotate_negative"}


@pytest.mark.parametrize("op", sorted(NATIVE))
def test_native_matches_bcnn_tpu_native(lib, jax_native, op):
    _same(NATIVE[op](tnative), NATIVE[op](jax_native))


@pytest.mark.parametrize("op", sorted(NATIVE))
def test_native_matches_numpy(lib, op):
    got = NATIVE[op](tnative)
    if op == "to_float":
        from bcnn_tpu_torch.data.augment import convert_img_to_float

        ref = convert_img_to_float(IMG, 1 / 127.5, 1, 100.0, 110.0, 120.0)
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        return
    if op == "batch_to_float":
        from bcnn_tpu_torch.data.augment import convert_img_to_float

        np.testing.assert_allclose(
            got[1], convert_img_to_float(IMG[::-1].copy()), rtol=1e-6)
        return
    ref = NATIVE[op](tops)
    if op in LEVEL:
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    else:
        _same(got, ref)


def _save(tmp_path, img, name, **kw):
    from PIL import Image

    mode = {1: "L", 3: "RGB"}[img.shape[2]]
    p = str(tmp_path / name)
    Image.fromarray(img.squeeze(), mode).save(p, **kw)
    return p


@pytest.mark.parametrize("name,img,kw", [
    ("rgb.png", _img(3, 41, 57), {}),
    ("gray.png", _img(4, 20, 33, 1), {}),
    ("rgb.jpg", _img(5, 64, 48), {"quality": 90}),
])
def test_native_decode_matches_bcnn_tpu(lib, jax_native, tmp_path, name,
                                        img, kw):
    """The port's decode and bcnn_tpu.bip's load_image, each with its own
    backend rules: native codecs where built, Pillow otherwise."""
    import bcnn_tpu.bip as jbip

    p = _save(tmp_path, img, name, **kw)
    _same(bip.load_image(p), jbip.load_image(p))
    if tnative.decode_available():
        assert bip.decoder() == "native"
        _same(tnative.load_image(p), jax_native.load_image(p))
        with open(p, "rb") as f:
            blob = f.read()
        _same(tnative.decode_batch([blob, blob])[1],
              jax_native.decode_batch([blob])[0])
    else:
        assert bip.decoder() == "pillow"
    if name.endswith(".png"):  # lossless
        _same(bip.load_image(p), img)


def test_backend_is_explicit(lib, tmp_path):
    assert bip.backend() == "native"
    assert bip.BACKENDS == ("native", "numpy")
    with pytest.raises(ValueError, match="backend"):
        bip.set_backend("pil")
    prev = bip.set_backend("numpy")
    try:
        assert prev == "native" and bip.backend() == "numpy"
        assert bip.decoder() == "pillow"
        _same(bip.resize_bilinear(IMG, 64, 48), tops.resize_bilinear(
            IMG, 64, 48))
        p = _save(tmp_path, IMG, "a.bmp")  # outside the native codecs
        _same(bip.load_image(p), IMG)
    finally:
        bip.set_backend(prev)
    _same(bip.resize_bilinear(IMG, 64, 48), tnative.resize_bilinear(
        IMG, 64, 48))
    p = _save(tmp_path, IMG, "b.bmp")  # Pillow takes it under native too
    _same(bip.load_image(p), IMG)


def test_native_rejects_bad_buffers(lib):
    with pytest.raises(ValueError, match="uint8"):
        tnative.fliph_image(IMG.astype(np.float32))
    with pytest.raises(ValueError, match="out must be"):
        tnative.crop_image(IMG, 0, 0, 8, 8, out=np.zeros((8, 7, 3),
                                                         np.uint8))


def test_native_num_threads_caps_the_pool(lib):
    before = tnative.num_threads()
    try:
        bip.set_num_threads(2)
        assert tnative.num_threads() == 2
    finally:
        tnative.set_num_threads(before)


# -------------------------------------------------------------- build #


def test_library_lives_in_build_dir_under_its_hash(lib):
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR
    assert path.name.startswith("libbcnn_bip_") and path.suffix == ".so"
    assert len(path.name) == len("libbcnn_bip_") + 16 + len(".so")
    assert os.path.samefile(tnative.NATIVE_DIR, os.path.join(REPO,
                                                             "native"))
    mtime = path.stat().st_mtime_ns
    assert tnative.library_path() == path  # no rebuild
    assert path.stat().st_mtime_ns == mtime


def _build_in(build_dir, env):
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {REPO!r})
        import bcnn_tpu_torch.bip.native as n
        n.BUILD_DIR = Path({str(build_dir)!r})
        print(n.library_path())
    """)
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _fake_gxx(tmp_path, body):
    """A directory holding a `g++` script, to put first on PATH."""
    d = tmp_path / "bin"
    d.mkdir(exist_ok=True)
    (d / "g++").write_text("#!/bin/sh\n" + body)
    (d / "g++").chmod(0o755)
    return str(d)


def test_concurrent_builds_compile_once(tmp_path):
    """Three processes build into one empty directory at once: one
    compiles under the lock, the others load its library."""
    import shutil

    log = tmp_path / "cxx.log"
    real = shutil.which("g++")
    path = _fake_gxx(tmp_path, f'echo "$@" >> {log}\nexec {real} "$@"\n')
    env = dict(os.environ, PATH=path + os.pathsep + os.environ["PATH"],
               CXX="/no/such/compiler")  # $CXX is not read
    procs = [_build_in(tmp_path / "build", env) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1 and os.path.exists(paths.pop())
    builds = [ln for ln in log.read_text().splitlines() if "-shared" in ln]
    assert len(builds) == 1
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".tmp")]


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    # a g++ that links nothing and compiles nothing
    path = _fake_gxx(tmp_path, "echo no compiler here >&2\nexit 1\n")
    monkeypatch.setenv("PATH", path + os.pathsep + os.environ["PATH"])
    with pytest.raises(tnative.NativeBuildFailed,
                       match="(?s)native build failed.*no compiler here"):
        tnative.library_path()
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(tnative.NativeBuildFailed, match="cannot run"):
        tnative.library_path()
    assert not list((tmp_path / "build").glob("*.so*"))
