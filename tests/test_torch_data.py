"""The port's host data feed (`bcnn_tpu_torch.data`: the five loaders,
the host Augmenter, the native batch assembly, raw records and their
index streams) against bcnn_tpu's, on the CPU, on the same files and
seeds.

Every comparison is exact: both packages run the same numpy and the
same native bip (the port's library is built with bcnn_tpu's flags from
the same sources), with the backend bcnn_tpu.bip chose at its import,
and the same np.random.RandomState streams. Each loader walks TRAIN
batches past EOF, switches to VALID (the eval stream rewinds) and back
to TRAIN (its position survives), alone and striped with set_shard."""

import struct

import numpy as np
import pytest
import torch

from bcnn_tpu import Mode as JMode
from bcnn_tpu import Net as JNet
from bcnn_tpu import bip as jbip
from bcnn_tpu.data import loaders as jloaders
from bcnn_tpu.data import records as jrecords
from bcnn_tpu.data.augment import Augmenter as JAugmenter

from bcnn_tpu_torch import bip
from bcnn_tpu_torch.data import loaders, native_loader, records
from bcnn_tpu_torch.data.augment import Augmenter, convert_img_to_float
from bcnn_tpu_torch.graph import Net
from bcnn_tpu_torch.types import DETECTION_MAX_BOXES, LoaderType, Mode

from tests.test_data import write_mnist

torch.set_num_threads(1)


def bcnn_tpu_bip_backend() -> str:
    """The host image backend bcnn_tpu.bip resolved to at its import:
    "native" where its library built and loaded (its ops, and with its
    codecs its decode, run natively), else "numpy" (BCNN_TPU_NATIVE=0,
    or a `make` that failed or timed out, as under many test workers)."""
    return "native" if jbip._native.available() else "numpy"


def pin_port_bip():
    """Put the port's bip on bcnn_tpu.bip's backend (the native library
    built once here, under its lock), yield its name, then restore the
    port's backend: a module fixture of every test file that holds the
    port's host batches or augmentation against bcnn_tpu's. With the
    native backend both decode natively where their codecs built (the
    same probe of the same sources), else with Pillow; the tests' images
    are PNGs, which decode to the same bytes either way."""
    name = bcnn_tpu_bip_backend()
    if name == "native":
        bip.native.get_lib()
    prev = bip.set_backend(name)
    try:
        yield name
    finally:
        bip.set_backend(prev)


@pytest.fixture(scope="module", autouse=True)
def same_backend():
    yield from pin_port_bip()


def nets(w, h, c, batch, label, aug=None, device_augment=None):
    out = []
    for cls, mode in ((JNet, JMode.TRAIN), (Net, Mode.TRAIN)):
        net = cls(mode)
        net.set_input_shape(w, h, c, batch)
        t1 = net.tensors[1]
        t1.n, t1.c, t1.h, t1.w = batch, label, 1, 1
        net.data_aug = dict(aug or {})
        if device_augment is not None:
            net.device_augment = dict(device_augment)
        out.append(net)
    return out


def walk(loader, train=3, valid=2, back=2):
    """TRAIN batches, then VALID (rewinds the eval stream), then TRAIN."""
    out = [loader.next_batch() for _ in range(train)]
    loader.set_mode(Mode.VALID)
    out += [loader.next_batch() for _ in range(valid)]
    loader.set_mode(Mode.TRAIN)
    out += [loader.next_batch() for _ in range(back)]
    return out


def assert_same_walk(jld, tld, shard=None, **kw):
    if shard is not None:
        jld.set_shard(*shard)
        tld.set_shard(*shard)
    a, b = walk(jld, **kw), walk(tld, **kw)
    for (xj, yj), (xt, yt) in zip(a, b):
        assert xt.dtype == xj.dtype and xt.shape == xj.shape
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)


AUG = dict(range_shift_x=4, range_shift_y=4, min_scale=0.9, max_scale=1.1,
           rotation_range=20.0, min_contrast=0.8, max_contrast=1.2,
           min_brightness=-20, max_brightness=20, random_fliph=1)
DET_AUG = dict(random_fliph=1, min_contrast=0.8, max_contrast=1.2,
               min_brightness=-20, max_brightness=20)

# (name, net aug, device_augment): host augmentation runs per sample with
# the RandomState stream; raw mode (device_augment) skips it and the
# normalization
VARIANTS = [
    ("plain", None, None),
    ("augmented", AUG, None),
    ("raw", AUG, {}),
    ("means_bgr", dict(mean_r=0.4, mean_g=0.5, mean_b=0.6, swap_to_bgr=1),
     None),
]
SHARDS = [None, (1, 2)]


# --------------------------------------------------------------- mnist #


@pytest.mark.parametrize("shard", SHARDS)
@pytest.mark.parametrize("variant", VARIANTS[:3], ids=lambda v: v[0])
@pytest.mark.parametrize("size", [28, 24])  # 24: the center crop
def test_mnist_loader_matches_bcnn_tpu(tmp_path, variant, shard, size):
    _, aug, dev = variant
    ti, tl, _, _ = write_mnist(tmp_path, n=11, seed=0, name="train")
    vi, vl, _, _ = write_mnist(tmp_path, n=7, seed=3, name="t10k")
    jn, tn = nets(size, size, 1, 4, 10, aug, dev)
    assert_same_walk(jloaders.MnistLoader(jn, ti, tl, vi, vl),
                     loaders.MnistLoader(tn, ti, tl, vi, vl), shard)


# --------------------------------------------------------------- cifar #


def write_cifar(tmp_path, n=7, seed=1):
    rng = np.random.RandomState(seed)
    p = tmp_path / f"cifar{seed}.bin"
    with open(p, "wb") as f:
        for _ in range(n):
            f.write(bytes([rng.randint(10)]))
            rng.randint(0, 256, 3 * 32 * 32).astype(np.uint8).tofile(f)
    return str(p)


@pytest.mark.parametrize("shard", SHARDS)
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v[0])
def test_cifar10_loader_matches_bcnn_tpu(tmp_path, variant, shard):
    _, aug, dev = variant
    tr, te = write_cifar(tmp_path, 7, 1), write_cifar(tmp_path, 5, 2)
    jn, tn = nets(32, 32, 3, 3, 10, aug, dev)
    assert_same_walk(jloaders.Cifar10Loader(jn, tr, te),
                     loaders.Cifar10Loader(tn, tr, te), shard)


# ---------------------------------------------------------- list files #


def write_images(tmp_path, sizes, channels=3, seed=0, ext="png"):
    rng = np.random.RandomState(seed)
    paths = []
    for i, (h, w) in enumerate(sizes):
        img = (rng.rand(h, w, channels) * 255).astype(np.uint8)
        p = str(tmp_path / f"im{seed}_{i}.{ext}")
        jbip.write_image(p, img)
        paths.append(p)
    return paths


def list_file(tmp_path, name, lines):
    p = tmp_path / name
    p.write_text("\n".join(lines) + "\n")
    return str(p)


@pytest.mark.parametrize("shard", SHARDS)
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: v[0])
def test_classification_list_loader_matches_bcnn_tpu(tmp_path, variant,
                                                     shard):
    """Images larger than the net (random crop in TRAIN, centered
    otherwise); an empty line, a line with three tokens and a grayscale
    image (wrong channels) are skipped."""
    _, aug, dev = variant
    ims = write_images(tmp_path, [(20, 22), (16, 16), (25, 19), (18, 30)])
    gray = write_images(tmp_path, [(16, 16)], channels=1, seed=9)[0]
    tr = list_file(tmp_path, "train.txt", [
        f"{ims[0]} 1", "", f"{ims[1]} 0", f"{ims[2]} 2 7", f"{ims[2]} 2",
        f"{gray} 1", f"{ims[3]} 0"])
    te = list_file(tmp_path, "test.txt", [f"{ims[3]} 2", f"{ims[1]} 1",
                                          f"{ims[0]} 0"])
    jn, tn = nets(16, 16, 3, 2, 3, aug, dev)
    assert_same_walk(jloaders.ClassificationListLoader(jn, tr, te),
                     loaders.ClassificationListLoader(tn, tr, te), shard)


@pytest.mark.parametrize("shard", SHARDS)
@pytest.mark.parametrize("variant", VARIANTS[:3], ids=lambda v: v[0])
def test_regression_list_loader_matches_bcnn_tpu(tmp_path, variant,
                                                 shard):
    _, aug, dev = variant
    ims = write_images(tmp_path, [(18, 20), (16, 16), (21, 17)],
                       channels=1)
    tr = list_file(tmp_path, "train.txt", [
        f"{ims[0]} 0.5 -1.25 3.0", f"{ims[1]} 1 2", "",
        f"{ims[2]} 0.1 0.2 0.3 0.4 0.5"])
    jn, tn = nets(16, 16, 1, 2, 3, aug, dev)
    assert_same_walk(jloaders.RegressionListLoader(jn, tr),
                     loaders.RegressionListLoader(tn, tr), shard)


def det_list(tmp_path, bad=True):
    """Landscape and portrait images (the letterbox both ways) with 1-3
    boxes each; with `bad`, a line whose box count is not whole and a
    line whose image does not exist, both skipped."""
    rng = np.random.RandomState(4)
    ims = write_images(tmp_path, [(30, 50), (48, 26), (40, 40), (20, 64)],
                       seed=4)
    lines = []
    for p in ims:
        boxes = " ".join(
            f"{rng.randint(3)} {rng.uniform(0.2, 0.8):.4f} "
            f"{rng.uniform(0.2, 0.8):.4f} {rng.uniform(0.1, 0.4):.4f} "
            f"{rng.uniform(0.1, 0.4):.4f}"
            for _ in range(rng.randint(1, 4)))
        lines.append(f"{p} {boxes}")
    if bad:
        lines.insert(1, f"{ims[0]} 1 0.5 0.5")
        lines.insert(3, f"{tmp_path / 'missing.png'} 0 0.5 0.5 0.2 0.2")
    return list_file(tmp_path, "det.txt", lines)


@pytest.mark.parametrize("shard", SHARDS)
@pytest.mark.parametrize("variant", [
    ("plain", None, None), ("augmented", DET_AUG, None),
    ("raw", DET_AUG, {})], ids=lambda v: v[0])
def test_detection_list_loader_matches_bcnn_tpu(tmp_path, variant, shard):
    """The letterbox (random placement in TRAIN, centered otherwise), the
    rescaled labels and the flip mirrored onto x, 250 label floats."""
    _, aug, dev = variant
    lst = det_list(tmp_path)
    jn, tn = nets(32, 32, 3, 2, DETECTION_MAX_BOXES * 5, aug, dev)
    assert_same_walk(jloaders.DetectionListLoader(jn, lst, lst),
                     loaders.DetectionListLoader(tn, lst, lst), shard)


@pytest.mark.parametrize("lt", list(LoaderType), ids=lambda t: t.name)
def test_make_loader_dispatch(tmp_path, lt):
    ti, tl, _, _ = write_mnist(tmp_path, n=3)
    paths = {LoaderType.MNIST: (ti, tl), LoaderType.CIFAR10: (
        write_cifar(tmp_path), None)}
    lst = det_list(tmp_path, bad=False)
    jn, tn = nets(28, 28, 1, 2, 10)
    args = paths.get(lt, (lst, None))
    ld = loaders.make_loader(tn, lt, *args)
    jld = jloaders.make_loader(jn, int(lt), *args)
    assert type(ld).__name__ == type(jld).__name__
    assert ld.raw_mode is False
    ld.close()
    jld.close()


# ------------------------------------------------- native batch assembly #


@pytest.mark.parametrize("mode", [Mode.TRAIN, Mode.VALID])
@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("fmt", ["mnist", "cifar"])
def test_native_batches_equal_the_per_sample_path(tmp_path, fmt, raw, mode):
    """native/loader.cpp's whole-batch assembly against the port's
    per-sample path (DataLoader._next_batch_impl) on the same stream,
    past EOF."""
    if bip.backend() != "native":
        pytest.skip("bcnn_tpu chose the numpy bip backend")
    dev = {} if raw else None
    if fmt == "mnist":
        ti, tl, _, _ = write_mnist(tmp_path, n=9, seed=2)
        _, na = nets(24, 24, 1, 4, 10, None, dev)
        _, nb = nets(24, 24, 1, 4, 10, None, dev)
        a = loaders.MnistLoader(na, ti, tl, ti, tl)
        b = loaders.MnistLoader(nb, ti, tl, ti, tl)
    else:
        p = write_cifar(tmp_path, 5)
        _, na = nets(32, 32, 3, 3, 10, None, dev)
        _, nb = nets(32, 32, 3, 3, 10, None, dev)
        a, b = loaders.Cifar10Loader(na, p), loaders.Cifar10Loader(nb, p)
    a.set_mode(mode)
    b.set_mode(mode)
    for _ in range(4):
        xa, ya = a.next_batch()
        xb, yb = loaders.DataLoader._next_batch_impl(b)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_native_loader_is_used_and_numpy_backend_is_not(tmp_path,
                                                        monkeypatch):
    if bip.backend() != "native":
        pytest.skip("bcnn_tpu chose the numpy bip backend")
    ti, tl, _, _ = write_mnist(tmp_path, n=9)
    _, tn = nets(28, 28, 1, 4, 10)
    seen = []
    real = native_loader.mnist_batch
    monkeypatch.setattr(native_loader, "mnist_batch",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    x, _ = loaders.MnistLoader(tn, ti, tl).next_batch()
    assert seen == [1]
    prev = bip.set_backend("numpy")
    try:
        y, _ = loaders.MnistLoader(tn, ti, tl).next_batch()
    finally:
        bip.set_backend(prev)
    assert seen == [1, 1]  # asked, and declined: the per-sample path ran
    np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------- records #


def test_records_from_loader_matches_bcnn_tpu(tmp_path):
    lst = det_list(tmp_path, bad=False)
    jn, tn = nets(32, 32, 3, 3, DETECTION_MAX_BOXES * 5, DET_AUG)
    nj = jrecords.records_from_loader(
        jloaders.DetectionListLoader(jn, lst), str(tmp_path / "j.bcrd"), 7)
    nt = records.records_from_loader(
        loaders.DetectionListLoader(tn, lst), str(tmp_path / "t.bcrd"), 7)
    assert nj == nt == 7
    assert (tmp_path / "j.bcrd").read_bytes() == (
        tmp_path / "t.bcrd").read_bytes()
    # the records hold the loader's VALID letterbox, inverted exactly
    _, vn = nets(32, 32, 3, 7, DETECTION_MAX_BOXES * 5)
    ld = loaders.DetectionListLoader(vn, lst)
    ld.set_mode(Mode.VALID)
    xv, yv = ld.next_batch()
    ld.f_test = None
    rx, ry = records.RawRecordLoader(vn, str(tmp_path / "t.bcrd")
                                     ).read_all()
    np.testing.assert_array_equal(np.stack(
        [convert_img_to_float(r.transpose(1, 2, 0)) for r in rx]), xv)
    np.testing.assert_array_equal(ry, yv)


def test_records_from_loader_refuses_custom_normalization(tmp_path):
    lst = det_list(tmp_path, bad=False)
    _, tn = nets(32, 32, 3, 2, 250, dict(mean_r=0.5))
    with pytest.raises(ValueError, match="normalization"):
        records.records_from_loader(loaders.DetectionListLoader(tn, lst),
                                    str(tmp_path / "x.bcrd"), 2)


def write_raw(tmp_path, n=7, c=3, h=6, w=5, lab=4, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.randint(0, 256, (n, c, h, w)).astype(np.uint8)
    ys = rng.randn(n, lab).astype(np.float32)
    p = str(tmp_path / f"r{seed}.bcrd")
    assert records.write_records(p, zip(xs, ys), c, h, w, lab) == n
    return p, xs, ys


def test_write_records_matches_bcnn_tpu(tmp_path):
    p, xs, ys = write_raw(tmp_path)
    q = str(tmp_path / "j.bcrd")
    jrecords.write_records(q, zip(xs, ys), 3, 6, 5, 4)
    assert open(p, "rb").read() == open(q, "rb").read()
    with pytest.raises(ValueError, match="pixels"):
        records.write_records(str(tmp_path / "bad.bcrd"),
                              [(xs[0, :2], ys[0])], 3, 6, 5, 4)


@pytest.mark.parametrize("shard", SHARDS)
@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_raw_record_loader_matches_bcnn_tpu(tmp_path, backend, shard):
    """The native gather and the numpy one, each against bcnn_tpu's
    RawRecordLoader: sequential reads, EOF wrap, the eval stream
    rewinding on a switch, striping; read_all."""
    p, xs, ys = write_raw(tmp_path)
    jn, tn = nets(5, 6, 3, 3, 4)
    prev = bip.set_backend(backend)
    try:
        j, t = jrecords.RawRecordLoader(jn, p), records.RawRecordLoader(
            tn, p)
        assert_same_walk(j, t, shard, train=4, valid=3, back=3)
        ax, ay = t.read_all()
    finally:
        bip.set_backend(prev)
    jx, jy = jrecords.RawRecordLoader(jn, p).read_all()
    assert ax.dtype == np.uint8 and ay.dtype == np.float32
    np.testing.assert_array_equal(ax, xs)
    np.testing.assert_array_equal(ax, jx)
    np.testing.assert_array_equal(ay, jy)


def test_raw_record_loader_rejects_bad_files(tmp_path):
    p, _, _ = write_raw(tmp_path)
    _, tn = nets(5, 6, 3, 3, 4)
    data = open(p, "rb").read()
    (tmp_path / "trunc.bcrd").write_bytes(data[:-10])
    with pytest.raises(ValueError, match="truncated"):
        records.RawRecordLoader(tn, str(tmp_path / "trunc.bcrd"))
    (tmp_path / "magic.bcrd").write_bytes(b"XXXX" + data[4:])
    with pytest.raises(ValueError, match="not a BCRD"):
        records.RawRecordLoader(tn, str(tmp_path / "magic.bcrd"))
    (tmp_path / "empty.bcrd").write_bytes(
        data[:8] + struct.pack("<I", 0) + data[12:])
    with pytest.raises(ValueError, match="0 records"):
        records.RawRecordLoader(tn, str(tmp_path / "empty.bcrd"))


@pytest.mark.parametrize("shuffle", [False, True])
def test_epoch_index_stream_matches_bcnn_tpu(shuffle):
    j = jrecords.EpochIndexStream(11, 4, seed=3, shuffle=shuffle)
    t = records.EpochIndexStream(11, 4, seed=3, shuffle=shuffle)
    for k in (1, 3, 2, 5):
        np.testing.assert_array_equal(t.next(k), j.next(k))
    assert t.pos == j.pos
    r = records.EpochIndexStream(11, 4, seed=3, shuffle=shuffle)
    r.pos = 8  # restoring pos resumes the exact index sequence
    t2 = records.EpochIndexStream(11, 4, seed=3, shuffle=shuffle)
    t2.next(2)
    np.testing.assert_array_equal(r.next(3), t2.next(3))


@pytest.mark.parametrize("shuffle", [False, True])
def test_sharded_epoch_index_stream_matches_bcnn_tpu(shuffle):
    j = jrecords.ShardedEpochIndexStream(12, 6, 3, seed=1, shuffle=shuffle)
    t = records.ShardedEpochIndexStream(12, 6, 3, seed=1, shuffle=shuffle)
    for k in (2, 1, 4):
        a, b = t.next(k), j.next(k)
        assert a.shape == (k, 3, 2)
        np.testing.assert_array_equal(a, b)
    assert t.pos == j.pos
    t.pos = 6
    j.pos = 6
    np.testing.assert_array_equal(t.next(2), j.next(2))
    with pytest.raises(ValueError):
        records.ShardedEpochIndexStream(10, 6, 3)


# -------------------------------------------------------------- augment #


@pytest.mark.parametrize("cfg", [
    AUG, DET_AUG, dict(max_distortion=0.3), dict(max_random_spots=3),
    dict(AUG, max_distortion=0.2, max_random_spots=2)],
    ids=["geometry", "photometric", "perlin", "spotlights", "all"])
def test_host_augmenter_matches_bcnn_tpu(cfg):
    """The Augmenter's op order and RandomState stream, and
    use_precomputed replaying the last draw."""
    rng = np.random.RandomState(7)
    imgs = [(rng.rand(20, 24, 3) * 255).astype(np.uint8) for _ in range(3)]
    a, b = Augmenter.from_dict(cfg, seed=5), JAugmenter.from_dict(cfg, 5)
    for img in imgs:
        np.testing.assert_array_equal(a.apply(img), b.apply(img))
    a.use_precomputed = b.use_precomputed = True
    np.testing.assert_array_equal(a.apply(imgs[0]), b.apply(imgs[0]))
    assert a.is_identity() == b.is_identity() is False
    assert Augmenter().is_identity()


@pytest.mark.parametrize("args", [(), (1 / 255.0, 1, 10.0, 20.0, 30.0)])
def test_convert_img_to_float_matches_bcnn_tpu(args):
    from bcnn_tpu.data.augment import convert_img_to_float as jconvert

    img = (np.random.RandomState(0).rand(5, 7, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(convert_img_to_float(img, *args),
                                  jconvert(img, *args))


def test_fill_tensor_with_image_matches_bcnn_tpu():
    from bcnn_tpu import Session as JSession
    from bcnn_tpu_torch import Session

    img = (np.random.RandomState(1).rand(8, 8, 3) * 255).astype(np.uint8)
    jn, tn = nets(8, 8, 3, 2, 4)
    a = Session(tn, 0, device="cpu").fill_tensor_with_image(
        img, 1, np.zeros((2, 3, 8, 8), np.float32))
    b = JSession(jn, 0).fill_tensor_with_image(
        img, 1, np.zeros((2, 3, 8, 8), np.float32))
    np.testing.assert_array_equal(a, b)
    assert Session(tn, 0, device="cpu").get_batch_size() == 2
