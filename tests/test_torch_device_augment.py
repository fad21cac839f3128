"""The rest of the port's on-device augmentation against bcnn_tpu's, on
the CPU, with one sampled params dict handed to both packages (their
samplers draw from threefry and philox): geo "full" (the one-pass
bilinear gather for rotation ranges above 90 degrees), Perlin distortion
and spotlights, alone and after the other ops; the sampler's keys, and
the refusal of Perlin distortion for detection.

Tolerance: atol 1e-3 on [0, 255] values (64 float32 ulps at 255). cos,
sin, exp and the gathers' weights round within an ulp of each other in
the two packages, as in tests/test_torch_augment.py's 5e-4 for the
shear warp; here the contrast also scales each pixel's distance from a
per-image mean of 884 pixels that the two packages sum in different
orders, and Perlin's sample cells move with the noise's last bit (up to
5.6e-4 measured over these cases)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnn_tpu.data import device_augment as jda

from bcnn_tpu_torch.data import device_augment as tda
from bcnn_tpu_torch.models import yolov3_tiny
from bcnn_tpu_torch.types import Mode

torch.set_num_threads(1)

WARP_ATOL = 1e-3
N, H, W = 3, 26, 34

CFGS = {
    "full": dict(rotation_range=150.0),
    "full_all": dict(rotation_range=360.0, min_scale=0.8, max_scale=1.2,
                     range_shift_x=6, range_shift_y=4, random_fliph=1,
                     min_contrast=0.7, max_contrast=1.3,
                     min_brightness=-25, max_brightness=25),
    "perlin": dict(max_distortion=0.4),
    "perlin_after_shear": dict(rotation_range=20.0, random_fliph=1,
                               max_distortion=0.25),
    "spotlights": dict(max_random_spots=4),
    "everything": dict(rotation_range=120.0, min_scale=0.9, max_scale=1.1,
                       random_fliph=1, min_contrast=0.8, max_contrast=1.2,
                       max_distortion=0.3, max_random_spots=3),
}


def _params(name, seed):
    """One draw, in the port's sampler, as numpy."""
    p = tda.sample_params(torch.Generator().manual_seed(seed), N,
                          CFGS[name], (H, W))
    return {k: v.numpy() for k, v in p.items()}


def _image(seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(N, H, W, 3).astype(np.float32) * 255
    x[0, :5] = 128.0  # flat rows: the fill's value
    return np.round(x)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_augment_matches_bcnn_tpu(name, seed):
    cfg = CFGS[name]
    p = _params(name, seed)
    x = _image(seed)
    kw = jda._geo_kwargs(cfg)
    assert kw["geo"] == tda._geo_kwargs(cfg)["geo"]
    ref = np.asarray(jax.vmap(functools.partial(jda._augment_one, **kw))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}))
    got = tda._augment(torch.from_numpy(x),
                       {k: torch.from_numpy(v) for k, v in p.items()},
                       **tda._geo_kwargs(cfg)).numpy()
    assert got.shape == ref.shape == (N, H, W, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=WARP_ATOL)
    assert got.min() >= 0 and got.max() <= 255
    if "distortion" in p:  # Perlin moved pixels
        assert np.abs(got - x).max() > 1


def test_full_geo_is_the_gather_and_matches_the_shear_near_zero():
    """geo "full" at rotation_range 150, theta drawn small, against geo
    "shear" on the same params: two resamplings of one affine map."""
    p = _params("full", 3)
    p["theta"] = p["theta"] * 0.02
    x = torch.from_numpy(_image(3))
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    full = tda._augment(x, t, geo="full")
    shear = tda._augment(x, t, **tda._geo_kwargs(dict(rotation_range=10.)))
    inner = (slice(None), slice(3, -3), slice(3, -3))
    assert (full - shear)[inner].abs().mean() < 2.0


def test_perlin_noise_hash_wraps_like_c():
    """The int32 hash of bip.c:154-160 at coordinates and seeds where the
    products overflow, against bcnn_tpu's int32 jnp and the numpy
    reference's."""
    from bcnn_tpu.bip import ops as jops

    rng = np.random.RandomState(0)
    ix = rng.randint(-5000, 5000, 64).astype(np.float32)
    iy = rng.randint(-5000, 5000, 64).astype(np.float32)
    seed = rng.randint(0, 2**31 - 1, 64).astype(np.int32)
    got = tda._noise2d_i32(torch.from_numpy(ix), torch.from_numpy(iy),
                           torch.from_numpy(seed)).numpy()
    ref = np.asarray(jda._noise2d_i32(jnp.asarray(ix), jnp.asarray(iy),
                                      jnp.asarray(seed)))
    np.testing.assert_array_equal(got, ref)
    host = np.array([jops._noise2d(np.array(a), np.array(b), 0, int(s))
                     for a, b, s in zip(ix, iy, seed)])
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-6)


def test_sampler_keys_match_bcnn_tpu():
    cfg = dict(CFGS["everything"], _img_h=H, _img_w=W)
    ref = jda.sample_params(jax.random.PRNGKey(0), 64, cfg)
    got = tda.sample_params(torch.Generator().manual_seed(0), 64,
                            CFGS["everything"], (H, W))
    assert set(got) == set(ref)
    for k, v in got.items():
        r = np.asarray(ref[k])
        assert tuple(v.shape) == r.shape, k
        assert str(v.dtype).split(".")[-1] == str(r.dtype), k
    assert ((got["distortion"] >= 0) & (got["distortion"] < 0.3)).all()
    assert (got["dist_kx"].abs() <= 0.5).all()
    assert (got["dist_seed"] >= 0).all()
    act = got["spot_active"]
    # a prefix of the slots is active, as the host draws a count
    assert (act[:, 1:] <= act[:, :-1]).all()
    for k, hi in (("spot_mu_x", W - 1), ("spot_mu_y", H - 1)):
        v = got[k]
        assert (v == v.round()).all() and v.min() >= 0 and v.max() <= hi
    for k in ("spot_sx", "spot_sy"):
        assert got[k].min() >= 0.8 and got[k].max() < 3.5
    with pytest.raises(ValueError, match="spotlights need"):
        tda.sample_params(None, 2, dict(max_random_spots=2))


def test_detection_refuses_perlin_and_trains_with_spotlights():
    lab = torch.zeros(2, 250)
    lab[:, :5] = torch.tensor([0.5, 0.5, 0.3, 0.4, 1.0])
    x = torch.randint(0, 256, (2, 40, 40, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="distortion"):
        tda.augment_batch_with_boxes(x, lab, None, CFGS["perlin"])
    cfg = dict(max_random_spots=3, rotation_range=120.0)
    out, newlab = tda.augment_batch_with_boxes(
        x, lab, torch.Generator().manual_seed(1), cfg)
    assert out.shape == (2, 40, 40, 3) and torch.isfinite(out).all()
    assert newlab.shape == (2, 250)

    from bcnn_tpu_torch import Session

    net = yolov3_tiny(2, 64, 64, 2, mode=Mode.TRAIN)
    net.device_augment = dict(max_distortion=0.2)
    with pytest.raises(ValueError, match="max_distortion"):
        Session(net, 0, device="cpu").compile_net().train_on_batch(
            np.zeros((2, 3, 64, 64), np.uint8), lab.numpy())
    net = yolov3_tiny(2, 64, 64, 2, mode=Mode.TRAIN)
    net.device_augment = cfg
    sess = Session(net, 0, device="cpu").compile_net()
    loss = sess.train_on_batch(
        np.random.RandomState(0).randint(0, 256, (2, 3, 64, 64)).astype(
            np.uint8), lab.numpy())
    assert torch.isfinite(loss)


def test_classification_batch_with_perlin_and_spots():
    x = torch.randint(0, 256, (2, 3, 20, 24), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1))
    cfg = dict(CFGS["everything"])
    out = tda.augment_batch_nchw(x, torch.Generator().manual_seed(2), cfg)
    assert out.shape == (2, 3, 20, 24)
    assert out.min() >= -1.0 and out.max() <= 1.0
