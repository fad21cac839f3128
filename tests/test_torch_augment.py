"""The port's on-device augmentation (`bcnn_tpu_torch.data.device_augment`)
and the plain version of its row-shift kernel K2 against bcnn_tpu's, on
the same numpy inputs and the same sampled params, on the CPU.

Tolerances, on [0, 255] pixel values:
  - row shift: atol 1e-4, the tolerance tests/test_shear_pallas.py sets
    for the Pallas kernel (one fma contraction may round differently);
  - whole warps: atol 5e-4. The port and XLA compute tan, sin and cos of
    the angles and the matmul sums to within an ulp of each other, which
    moves the three shears' weights by a few 1e-7.
  - boxes: rtol 1e-5, atol 1e-6 (normalized coordinates, the same
    float32 formulas)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnn_tpu.data import device_augment as jda
from bcnn_tpu.ops.shear_pallas import row_shift_pallas

from bcnn_tpu_torch.data import device_augment as tda
from bcnn_tpu_torch.ops import library
from bcnn_tpu_torch.ops.row_shift import (col_shift, col_shift_ref,
                                          row_shift, row_shift_ref)

torch.set_num_threads(1)

SHIFT_ATOL = 1e-4
WARP_ATOL = 5e-4


def _shifts(rng, n, r, kmax):
    return np.clip(
        rng.uniform(-(kmax - 1), kmax - 1, (n, r)), -(kmax - 1), kmax - 1
    ).astype(np.float32)


@pytest.mark.parametrize(
    "n,r,win,c,kmax,out_x0,out_w,in_x0",
    [
        (2, 7, 20, 3, 4, 0, 20, 0),       # same frame in and out
        (1, 9, 30, 3, 6, -6, 42, -1),     # pass 1 of the shear chain
        (2, 5, 16, 1, 3, 2, 10, 0),       # window inside the image
        (1, 3, 12, 2, 5, -20, 8, 0),      # output entirely in the fill
    ],
)
def test_row_shift_ref_matches_jax_sweep(n, r, win, c, kmax, out_x0,
                                         out_w, in_x0):
    rng = np.random.RandomState(r * win + kmax)
    img = (rng.rand(n, r, win, c) * 255).astype(np.float32)
    d = _shifts(rng, n, r, kmax)
    d[0, 0] = 1.0  # an integer shift: one unit-weight tap
    ref = np.stack([
        np.asarray(jda._row_shift(jnp.asarray(img[i]), jnp.asarray(d[i]),
                                  kmax, out_x0, out_w, in_x0, 127.0))
        for i in range(n)
    ])
    got = row_shift_ref(torch.from_numpy(img), torch.from_numpy(d), kmax,
                        out_x0, out_w, in_x0, 127.0).numpy()
    assert got.shape == (n, r, out_w, c)
    np.testing.assert_allclose(got, ref, rtol=0, atol=SHIFT_ATOL)


@pytest.mark.parametrize("r,w,out_w,kmax,k_local", [
    (37, 53, 48, 9, 5), (40, 64, 64, 6, 4), (8, 30, 20, 12, 10),
])
def test_row_shift_ref_matches_pallas_kernel(r, w, out_w, kmax, k_local):
    """The TPU kernel in interpret mode, padded as
    tests/test_shear_pallas.py pads it, with shifts inside its per-group
    spread bound."""
    rng = np.random.RandomState(r + w)
    img = (rng.rand(r, w, 3) * 255).astype(np.float32)
    slope = (k_local - 3) / 7.0 * 0.9
    d = np.clip((np.arange(r) - r / 2) * slope + 1.3, -(kmax - 1),
                kmax - 1).astype(np.float32)
    pad_l, pad_r = kmax, (out_w - 1 + kmax) - (w - 1)
    imgp = jnp.pad(jnp.asarray(img), ((0, 0), (pad_l, pad_r + k_local),
                                      (0, 0)), constant_values=127.0)
    ref = np.asarray(row_shift_pallas(imgp, jnp.asarray(d), kmax, out_w,
                                      k_local, interpret=True))
    got = row_shift_ref(torch.from_numpy(img[None]),
                        torch.from_numpy(d[None]), kmax, 0, out_w, 0,
                        127.0)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=SHIFT_ATOL)


def test_row_shift_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.RandomState(3)
    img = torch.from_numpy((rng.rand(2, 5, 12, 3) * 255).astype(np.float32))
    d = torch.from_numpy(_shifts(rng, 2, 5, 4))
    before = library.launches("row_shift")
    assert torch.equal(row_shift(img, d, 4, -2, 14, 0, 128.0),
                       row_shift_ref(img, d, 4, -2, 14, 0, 128.0))
    assert library.launches("row_shift") == before  # no kernel on the CPU
    with pytest.raises(ValueError):
        row_shift(img.to("meta"), d.to("meta"), 4, 0, 12, 0, 128.0)


@pytest.mark.parametrize(
    "n,win,r,c,kmax,out_x0,out_w,in_x0",
    [
        (2, 20, 7, 3, 4, 0, 20, 0),       # same frame in and out
        (1, 30, 9, 3, 6, 0, 28, -1),      # pass 2 of the shear chain
        (2, 16, 5, 1, 3, 2, 10, 0),       # window inside the columns
        (1, 12, 3, 2, 5, -20, 8, 0),      # output entirely in the fill
        (2, 11, 6, 7, 4, -3, 17, 2),      # fill at both ends, 7 channels
    ],
)
def test_col_shift_ref_matches_jax_sweep_on_transposed_columns(
        n, win, r, c, kmax, out_x0, out_w, in_x0):
    """Column mode's plain version against bcnn_tpu's `_row_shift` of
    each transposed image (the JAX package's pass 2)."""
    rng = np.random.RandomState(win * r + kmax)
    img = (rng.rand(n, win, r, c) * 255).astype(np.float32)
    d = _shifts(rng, n, r, kmax)
    d[0, 0], d[-1, -1] = 2.0, -3.0  # integer shifts, one negative
    ref = np.stack([
        np.asarray(jda._row_shift(jnp.asarray(img[i].transpose(1, 0, 2)),
                                  jnp.asarray(d[i]), kmax, out_x0, out_w,
                                  in_x0, 127.0)).transpose(1, 0, 2)
        for i in range(n)
    ])
    got = col_shift_ref(torch.from_numpy(img), torch.from_numpy(d), kmax,
                        out_x0, out_w, in_x0, 127.0)
    assert got.shape == (n, out_w, r, c) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=SHIFT_ATOL)


def test_col_shift_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.RandomState(5)
    img = torch.from_numpy((rng.rand(2, 12, 5, 3) * 255).astype(np.float32))
    d = torch.from_numpy(_shifts(rng, 2, 5, 4))
    before = library.launches("row_shift")
    got = col_shift(img, d, 4, -2, 14, 0, 128.0)
    assert torch.equal(got, col_shift_ref(img, d, 4, -2, 14, 0, 128.0))
    assert torch.equal(got, row_shift_ref(
        img.transpose(1, 2).contiguous(), d, 4, -2, 14, 0,
        128.0).transpose(1, 2))
    assert library.launches("row_shift") == before  # no kernel on the CPU
    with pytest.raises(ValueError):
        col_shift(img.to("meta"), d.to("meta"), 4, 0, 12, 0, 128.0)


def _chain_inputs(rng, n, h, w, rot):
    kx, ky, kx2, myc, mxc = tda._shear_bounds(rot, h, w)
    mid = (rng.rand(n, h + 2 * myc, w + 2 * mxc, 3) * 255).astype(np.float32)
    theta = np.deg2rad(rng.uniform(-0.5, 0.5, n) * rot).astype(np.float32)
    return mid, theta, (h, w, kx, ky, kx2, myc, mxc, 127.0)


@pytest.mark.parametrize("h,w,rot", [(40, 48, 20.0), (33, 17, 10.0)])
def test_rotate_3shear_matches_bcnn_tpu(h, w, rot):
    """The port's shear chain, pass 2 in column mode, against the JAX
    package's, which runs pass 2 as a row shift of the transposed
    image."""
    mid, theta, args = _chain_inputs(np.random.RandomState(h + w), 2, h, w,
                                     rot)
    ref = np.asarray(jax.vmap(
        lambda m, t: jda._rotate_3shear(m, t, *args))(
            jnp.asarray(mid), jnp.asarray(theta)))
    got = tda._rotate_3shear(torch.from_numpy(mid), torch.from_numpy(theta),
                             *args)
    assert got.shape == (2, h, w, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=WARP_ATOL)


def test_shear_chain_hands_each_pass_a_contiguous_tensor(monkeypatch):
    """Pass 2 runs in column mode on r3 as pass 1 wrote it, and pass 3
    reads pass 2's output as it comes: no transpose, no copy between."""
    calls = []

    def spy(fn):
        def run(img, *a):
            out = fn(img, *a)
            calls.append((fn.__name__, img, out))
            return out
        return run

    monkeypatch.setattr(tda, "row_shift", spy(tda.row_shift))
    monkeypatch.setattr(tda, "col_shift", spy(tda.col_shift))
    mid, theta, args = _chain_inputs(np.random.RandomState(1), 2, 24, 20,
                                     10.0)
    out = tda._rotate_3shear(torch.from_numpy(mid), torch.from_numpy(theta),
                             *args)
    assert [c[0] for c in calls] == ["row_shift", "col_shift", "row_shift"]
    (_, _, r3), (_, img2, r2), (_, img3, r1) = calls
    assert img2 is r3 and img3 is r2 and r1 is out
    for t in (r3, r2, r1):
        assert t.is_contiguous()
    assert img3.data_ptr() == r2.data_ptr()


def test_shear_bounds_match_bcnn_tpu():
    for args in [(10, 416, 416), (20, 64, 80, 1.1, 4.0, 3.0),
                 (90, 96, 96), (1, 33, 17, 1.5, 0.0, 8.0)]:
        assert tda._shear_bounds(*args) == jda._shear_bounds(*args)
    # the training path's shapes at 416 px, rotation_range 10
    assert tda._shear_bounds(10, 416, 416) == (11, 21, 11, 1, 1)


def _np_params(rng, n, cfg):
    rot = float(cfg.get("rotation_range", 0.0))
    lo_s, hi_s = cfg.get("min_scale", 1.0), cfg.get("max_scale", 1.0)
    return dict(
        theta=np.deg2rad(rng.uniform(-0.5, 0.5, n) * rot),
        scale=rng.uniform(lo_s, hi_s, n),
        tx=rng.uniform(-0.5, 0.5, n) * cfg.get("range_shift_x", 0),
        ty=rng.uniform(-0.5, 0.5, n) * cfg.get("range_shift_y", 0),
        contrast=rng.uniform(0.8, 1.2, n),
        brightness=rng.uniform(-30, 30, n),
        flip=(np.arange(n) % 2 if cfg.get("random_fliph") else np.zeros(n)),
    )


def _f32(p):
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


CFGS = {
    "none": dict(random_fliph=1),
    "separable": dict(range_shift_x=8, range_shift_y=6, min_scale=0.8,
                      max_scale=1.2, random_fliph=1),
    "shear": dict(rotation_range=20.0, random_fliph=1),
    "shear_sep": dict(rotation_range=20.0, range_shift_x=8,
                      range_shift_y=6, min_scale=0.9, max_scale=1.1,
                      random_fliph=1),
}


@pytest.mark.parametrize("name", list(CFGS))
def test_augment_matches_bcnn_tpu_augment_one(name):
    cfg = CFGS[name]
    rng = np.random.RandomState(len(name))
    n, h, w = 2, 64, 80
    x = (rng.rand(n, h, w, 3) * 255).astype(np.uint8).astype(np.float32)
    p = _f32(_np_params(rng, n, cfg))
    kw = jda._geo_kwargs(cfg)
    assert tda._geo_kwargs(cfg) == kw
    assert kw["geo"] == name.split("_")[0]
    assert kw.get("sep", name == "shear_sep") == (name == "shear_sep")
    ref = np.asarray(jax.vmap(functools.partial(jda._augment_one, **kw))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}
    ))
    got = tda._augment(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        **kw,
    ).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=WARP_ATOL)


def _labels(rng, n, boxes, classes=4):
    lab = np.zeros((n, 50, 5), np.float32)
    for i in range(n):
        for t in range(boxes):
            lab[i, t] = [rng.uniform(0.05, 0.95), rng.uniform(0.05, 0.95),
                         rng.uniform(0.05, 0.4), rng.uniform(0.05, 0.4),
                         rng.randint(classes)]
    lab[0, 1] = [0.999, 0.5, 0.001, 0.2, 1]  # collapses at the frame edge
    lab[1, boxes - 2, 0] = 0.0  # a zero mid-list ends the truths there
    return lab.reshape(n, 250)


@pytest.mark.parametrize("name", ["none", "separable", "shear_sep"])
def test_transform_boxes_matches_bcnn_tpu(name):
    rng = np.random.RandomState(7)
    n, h, w = 2, 64, 80
    p = _f32(_np_params(rng, n, dict(CFGS[name], rotation_range=30.0)))
    p["scale"] = np.asarray([1.3, 0.7], np.float32)  # zoom pushes boxes out
    lab = _labels(rng, n, 8)
    ref = np.asarray(jda.transform_boxes(
        jnp.asarray(lab), {k: jnp.asarray(v) for k, v in p.items()}, h, w
    ))
    got = tda.transform_boxes(
        torch.from_numpy(lab), {k: torch.from_numpy(v) for k, v in p.items()},
        h, w,
    ).numpy()
    np.testing.assert_array_equal(got[:, 0::5] != 0, ref[:, 0::5] != 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_augment_batch_with_boxes_nchw_matches_bcnn_tpu(monkeypatch):
    """The whole detection augmentation from uint8 NCHW, both samplers
    replaced by the same numpy draws."""
    cfg = dict(random_fliph=1, min_contrast=0.8, max_contrast=1.2,
               min_brightness=-30, max_brightness=30, rotation_range=10.0)
    rng = np.random.RandomState(11)
    n, h, w = 2, 72, 64
    x = (rng.rand(n, 3, h, w) * 255).astype(np.uint8)
    lab = _labels(rng, n, 5)
    p = _f32(_np_params(rng, n, cfg))
    monkeypatch.setattr(jda, "sample_params", lambda *a: {
        k: jnp.asarray(v) for k, v in p.items()})
    monkeypatch.setattr(tda, "sample_params", lambda *a: {
        k: torch.from_numpy(v) for k, v in p.items()})
    ref_x, ref_l = jda.augment_batch_with_boxes_nchw(
        jnp.asarray(x), jnp.asarray(lab), jax.random.PRNGKey(0), cfg)
    got_x, got_l = tda.augment_batch_with_boxes_nchw(
        torch.from_numpy(x), torch.from_numpy(lab), torch.Generator(), cfg)
    assert got_x.shape == (n, 3, h, w) and got_x.dtype == torch.float32
    assert float(got_x.min()) >= -1.0 and float(got_x.max()) <= 1.0
    # WARP_ATOL on [0, 255], normalized by 1/127.5
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), rtol=0,
                               atol=WARP_ATOL / 127.5)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(ref_l), rtol=1e-5,
                               atol=1e-6)


def test_sample_params_keys_ranges_and_generator():
    cfg = dict(rotation_range=10.0, min_scale=0.8, max_scale=1.2,
               range_shift_x=8, range_shift_y=4, min_contrast=0.8,
               max_contrast=1.2, min_brightness=-30, max_brightness=30,
               random_fliph=1)
    n = 4096
    p = tda.sample_params(torch.Generator().manual_seed(0), n, cfg)
    ref = jda.sample_params(jax.random.PRNGKey(0), 8, cfg)
    assert set(p) == set(ref)
    assert all(v.shape == (n,) and v.dtype == torch.float32
               for v in p.values())
    bounds = dict(theta=(-np.deg2rad(5), np.deg2rad(5)), scale=(0.8, 1.2),
                  tx=(-4, 4), ty=(-2, 2), contrast=(0.8, 1.2),
                  brightness=(-30, 30), flip=(0, 1))
    for k, (lo, hi) in bounds.items():
        v = p[k].double()
        assert lo - 1e-6 <= float(v.min()) and float(v.max()) <= hi + 1e-6
        assert abs(float(v.mean()) - (lo + hi) / 2) < 0.05 * (hi - lo), k
    assert set(p["flip"].tolist()) == {0.0, 1.0}
    again = tda.sample_params(torch.Generator().manual_seed(0), n, cfg)
    assert all(torch.equal(p[k], again[k]) for k in p)
    plain = tda.sample_params(torch.Generator(), 3, {})
    assert torch.equal(plain["scale"], torch.ones(3))
    assert torch.equal(plain["flip"], torch.zeros(3))


def test_unported_augmentations_raise():
    """Geo "full" (rotation_range > 90) and Perlin distortion are ported
    since (tests/test_torch_device_augment.py holds them to bcnn_tpu);
    Perlin distortion on boxes stays refused, as in bcnn_tpu."""
    x = torch.zeros(1, 16, 16, 3)
    lab = torch.zeros(1, 250)
    for cfg in (dict(rotation_range=120.0), dict(max_distortion=0.2)):
        out = tda.augment_batch(x, torch.Generator(), cfg)
        assert out.shape == (1, 16, 16, 3) and torch.isfinite(out).all()
    with pytest.raises(ValueError):  # as bcnn_tpu: never on boxes
        tda.augment_batch_with_boxes(x, lab, torch.Generator(),
                                     dict(max_distortion=0.2))
