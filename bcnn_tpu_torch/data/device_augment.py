"""On-device batched augmentation, ported from
`bcnn_tpu.data.device_augment`: flip, shift, scale and rotation, then
contrast and brightness, Perlin distortion and spotlights, and the
[-1, 1] normalisation, on the batch's device, with box labels carried
through the same map.

Parameter distributions are the JAX package's (`sample_params`): shift
~ U(-range/2, range/2), scale ~ U(min, max), rotation ~
U(-range/2, range/2) degrees, contrast ~ U(min, max), brightness ~
U(min, max), flip with p = 0.5; pixels sampled outside the source read
the fill value 128. The numbers come from a `torch.Generator`, so they
differ from JAX's; the sampler is split from the transform
(`apply_augment`, `apply_augment_with_boxes`) so that a test can hand
both packages the same params.

Images are (N, H, W, C) here, the JAX package's per-image (H, W, C) with
the batch written out in place of `vmap`. The warp is chosen from the
config (`_geo_mode`): "none" (flip only), "separable" (scale/shift/flip
as two interpolation matmuls), "shear" (rotation within 90 degrees:
the separable warp, then Paeth's three-shear rotation, each shear a
per-row two-tap shift, the CUDA kernel K2 on the card) or "full" (the
one-pass bilinear gather, for rotation ranges above 90 degrees). Perlin
distortion (bip_image_perlin_distortion, with C's int32 wraparound in
its noise hash) and spotlights (bip_add_random_spotlights, clamped
after each spot) follow in the host Augmenter's order. These are plain
torch: the JAX package writes them in plain jnp, with no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..ops.row_shift import col_shift, row_shift
from ..types import DETECTION_MAX_BOXES

FILL = 128.0
f32 = torch.float32


def _gather4(img, y0, x0):
    """img (N, H, W, C); y0, x0 (N, h, w) int64 cells -> the four taps
    img[y0, x0], img[y0, x0+1], img[y0+1, x0], img[y0+1, x0+1] of each
    image, each (N, h, w, C)."""
    n, hi, wi, c = img.shape
    flat = img.reshape(n, hi * wi, c)

    def tap(yy, xx):
        idx = (yy * wi + xx).reshape(n, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(*yy.shape, c)

    return (tap(y0, x0), tap(y0, x0 + 1), tap(y0 + 1, x0),
            tap(y0 + 1, x0 + 1))


def _bilinear_gather(img, xs, ys, fill):
    """img (N, H, W, C); xs, ys (N, H, W) source coordinates -> (N, H, W,
    C). The interpolation cell is clamped to [0, n-2] and the remainder
    folded into the fraction, so exact boundary coordinates (the
    identity) stay valid; samples outside the source read `fill`."""
    _, h, w, _ = img.shape
    x0 = torch.clamp(torch.floor(xs), 0, w - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(ys), 0, h - 2).to(torch.int64)
    fx = (xs - x0)[..., None]
    fy = (ys - y0)[..., None]
    valid = ((xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1))[
        ..., None]
    p00, p01, p10, p11 = _gather4(img, y0, x0)
    out = (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
           + p10 * (1 - fx) * fy + p11 * fx * fy)
    return torch.where(valid, out, fill)


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value C's wrapping arithmetic leaves."""
    return ((v + 2**31) & 0xFFFFFFFF) - 2**31


def _noise2d_i32(ix, iy, seed):
    """bip's _bip_noise2d integer hash (bip.c:154-160) with int32
    wraparound, computed in int64 and wrapped after each step."""
    ix, iy = ix.to(torch.int64), iy.to(torch.int64)
    i = _wrap32(ix * 1619 + iy * 31337 + seed.to(torch.int64) * 13397)
    n = _wrap32(i << 13) ^ i
    t = _wrap32(_wrap32(n * n) * 15731 + 789221)
    m = (n * t + 1376312589) & 0x7FFFFFFF
    return 1.0 - m.to(f32) / 1073741824.0


def _smooth2d(x, y, seed):
    ix, iy = torch.floor(x), torch.floor(y)
    fx, fy = x - ix, y - iy
    v1 = _noise2d_i32(ix, iy, seed)
    v2 = _noise2d_i32(ix + 1, iy, seed)
    v3 = _noise2d_i32(ix, iy + 1, seed)
    v4 = _noise2d_i32(ix + 1, iy + 1, seed)

    def interp(a, b, t):
        tt = (1.0 - torch.cos(t * math.pi)) * 0.5
        return a * (1.0 - tt) + b * tt

    return interp(interp(v1, v2, fx), interp(v3, v4, fx), fy)


def _perlin(img, distortion, kx, ky, seed):
    """bip_image_perlin_distortion (bip.c:205-266) on a batch: img (N, H,
    W, C) float, the rest (N,): one octave, the same displacement on x
    and y, bilinear with zero outside, the C truncation of the sample
    cell; clamped to [0, 255] where the host rounds through uint8."""
    _, h, w, _ = img.shape
    opts = dict(dtype=f32, device=img.device)
    y_norm = (torch.arange(h, **opts) / h)[None, :, None]
    x_norm = (torch.arange(w, **opts) / w)[None, None, :]
    noise = _smooth2d(x_norm + _col(kx, 3), y_norm + _col(ky, 3),
                      _col(seed, 3))
    dist = _col(distortion, 3)
    px = (x_norm + noise * dist) * w
    py = (y_norm + noise * dist) * h
    x_map = px.to(torch.int32)  # C's cast truncates toward zero
    y_map = py.to(torch.int32)
    fx = (px - torch.floor(px))[..., None]
    fy = (py - torch.floor(py))[..., None]
    valid = ((x_map >= 0) & (x_map < w - 1) & (y_map >= 0)
             & (y_map < h - 1))[..., None]
    xm = torch.clamp(x_map, 0, w - 2).to(torch.int64)
    ym = torch.clamp(y_map, 0, h - 2).to(torch.int64)
    p00, p01, p10, p11 = _gather4(img, ym, xm)
    out = (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
           + p10 * (1 - fx) * fy + p11 * fx * fy)
    out = torch.clamp(out, 0.0, 255.0)
    return torch.where(valid, out, 0.0)


def _spotlights(img, mu_x, mu_y, sx, sy, active):
    """bip_add_random_spotlights (bip.c:282-317) on a batch: img (N, H, W,
    C), the rest (N, S). Additive 255 * gaussian a spot, clamped after
    EACH spot (the host's order); slot i counts where active."""
    _, h, w, _ = img.shape
    opts = dict(dtype=f32, device=img.device)
    ys = torch.arange(h, **opts)[None, :, None]
    xs = torch.arange(w, **opts)[None, None, :]
    out = img
    for i in range(mu_x.shape[1]):
        val = torch.exp(-0.5 * (
            (xs - _col(mu_x[:, i], 3)) ** 2
            / (_col(sx[:, i], 3) * _col(sx[:, i], 3))
            + (ys - _col(mu_y[:, i], 3)) ** 2
            / (_col(sy[:, i], 3) * _col(sy[:, i], 3))))
        out = torch.clamp(
            out + 255.0 * val[..., None] * _col(active[:, i], 4), 0.0,
            255.0)
    return out


def _interp_matrix(coords: torch.Tensor, n: int):
    """(N, m) source coordinates -> ((N, m, n) two-tap bilinear weights
    with the gather path's clamped-cell semantics, (N, m) in-range
    mask)."""
    c0 = torch.clamp(torch.floor(coords), 0, n - 2).to(torch.int64)
    f = (coords - c0)[..., None]
    j = torch.arange(n, device=coords.device)
    c0 = c0[..., None]
    W = ((j == c0) * (1.0 - f) + (j == c0 + 1) * f).to(f32)
    valid = (coords >= 0) & (coords <= n - 1)
    return W, valid


def _rotate_3shear(mid, theta, h, w, kx, ky, kx2, myc, mxc, fill):
    """Rotation about the (h, w) frame's center by Paeth's three-shear
    decomposition R(theta) = Shx(-tan(theta/2)) Shy(sin(theta))
    Shx(-tan(theta/2)). `mid` (N, h+2*myc, w+2*mxc, C) is the
    pre-rotation content on a canvas with absolute origin (-myc, -mxc);
    theta (N,). Each shear is one K2 launch on the card
    (`ops.row_shift`), each handing the next a contiguous tensor: no
    copy in between."""
    opts = dict(dtype=f32, device=mid.device)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    alpha = -torch.tan(theta / 2.0)[:, None]
    beta = torch.sin(theta)[:, None]
    # pass 1: x-shear of every content row; output columns [-kx, w-1+kx]
    # (the separable warp's einsum may hand over a permuted layout)
    d1e = alpha * (torch.arange(h + 2 * myc, **opts) - myc - cy)
    r3 = row_shift(mid.contiguous(), d1e, kx2, -kx, w + 2 * kx, -mxc, fill)
    # pass 2: y-shear down each extended column (the JAX package's shift
    # of the transposed image); rows beyond the content extent read fill
    d2 = beta * (torch.arange(w + 2 * kx, **opts) - kx - cx)
    r2 = col_shift(r3, d2, ky, 0, h, -myc, fill)
    # pass 3: x-shear back to [0, w)
    d1 = alpha * (torch.arange(h, **opts) - cy)
    return row_shift(r2, d1, kx, 0, w, -kx, fill)


def _shear_bounds(rot_deg, h, w, s_max=1.0, txm=0.0, tym=0.0):
    """Static extents of the shear chain for the cfg's rotation_range
    (degrees, full width: |theta| <= rot_deg/2) and the scale/shift
    envelopes: (kx, ky, kx2, myc, mxc). kx/ky/kx2 bound the per-pass
    shift spans; myc/mxc are the content canvas half-extensions."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    theta_max = math.radians(rot_deg) / 2.0
    a = math.tan(theta_max / 2.0)  # |alpha| bound
    b = math.sin(theta_max)  # |beta| bound
    mxc = int(min(math.ceil(cy * b),
                  math.ceil(max(0.0, s_max * (cx + txm) - cx)))) + 1
    myc = int(min(math.ceil(cx * b),
                  math.ceil(max(0.0, s_max * (cy + tym) - cy)))) + 1
    kx = int(math.ceil(a * cy)) + 1
    kx2 = int(math.ceil(a * (cy + myc))) + 1
    ky = int(math.ceil(b * (cx + kx))) + 1
    return kx, ky, kx2, myc, mxc


def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(N,) per-image scalars shaped to broadcast over ndim - 1 axes."""
    return v.reshape(-1, *([1] * (ndim - 1)))


def _warp_separable(img, params, fill, ey=0, ex=0, edge_clamp=False):
    """Scale/shift/flip warp as two batched two-tap interpolation matmuls
    (out = Wx @ (Wy @ img)), in fp32 (PyTorch runs fp32 matmuls without
    TF32 unless told to); validity/fill is the outer product of the
    per-axis in-range masks. ey/ex extend the OUTPUT canvas beyond the
    frame for the shear chain's pre-rotation content. edge_clamp=True
    clamps the source coordinates into the frame instead of filling."""
    _, h, w, _ = img.shape
    opts = dict(dtype=f32, device=img.device)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    inv_s = (1.0 / params["scale"])[:, None]
    ys = torch.arange(h + 2 * ey, **opts) - ey
    xs = torch.arange(w + 2 * ex, **opts) - ex
    sy = (ys - cy) * inv_s + cy + params["ty"][:, None]
    sx = (xs - cx) * inv_s + cx + params["tx"][:, None]
    sx = torch.where(params["flip"][:, None] > 0, (w - 1) - sx, sx)
    if edge_clamp:
        sy = torch.clamp(sy, 0, h - 1)
        sx = torch.clamp(sx, 0, w - 1)
    Wy, vy = _interp_matrix(sy, h)
    Wx, vx = _interp_matrix(sx, w)
    tmp = torch.einsum("nih,nhwc->niwc", Wy, img)
    out = torch.einsum("njw,niwc->nijc", Wx, tmp)
    if edge_clamp:
        return out
    return torch.where((vy[:, :, None] & vx[:, None, :])[..., None], out,
                       fill)


def _flip(img, params):
    return torch.where(_col(params["flip"], 4) > 0, img.flip(2), img)


def _augment(img, params, fill=FILL, geo="none", rot_deg=0.0, sep=False,
             s_max=1.0, txm=0.0, tym=0.0):
    """img (N, H, W, C) float; params dict of (N,) tensors on img's
    device. The batched `_augment_one` of the JAX package: the warp of
    `geo`, contrast about the per-image channel mean and brightness,
    clipped to [0, 255], then Perlin distortion and spotlights where
    params hold their keys."""
    _, h, w, _ = img.shape
    if geo == "none":
        out = _flip(img, params)
    elif geo == "separable":
        out = _warp_separable(img, params, fill)
    elif geo == "shear":
        kx, ky, kx2, myc, mxc = _shear_bounds(rot_deg, h, w, s_max, txm,
                                              tym)
        if sep:
            mid = _warp_separable(img, params, fill, ey=myc, ex=mxc,
                                  edge_clamp=True)
        else:  # flip, then edge-replicate onto the expanded canvas
            dev = img.device
            rows = torch.clamp(torch.arange(-myc, h + myc, device=dev),
                               0, h - 1)
            cols = torch.clamp(torch.arange(-mxc, w + mxc, device=dev),
                               0, w - 1)
            mid = _flip(img, params)[:, rows][:, :, cols]
        out = _rotate_3shear(mid, params["theta"], h, w, kx, ky, kx2, myc,
                             mxc, fill)
        # re-apply the gather path's exact fill region from the composed
        # inverse map (flip maps the frame to itself and drops out)
        opts = dict(dtype=f32, device=img.device)
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        ys = (torch.arange(h, **opts) - cy)[:, None]
        xs = (torch.arange(w, **opts) - cx)[None, :]
        cos_t = _col(torch.cos(params["theta"]), 3)
        sin_t = _col(torch.sin(params["theta"]), 3)
        inv_s = _col(1.0 / params["scale"], 3)
        sx = (cos_t * xs - sin_t * ys) * inv_s + cx + _col(params["tx"], 3)
        sy = (sin_t * xs + cos_t * ys) * inv_s + cy + _col(params["ty"], 3)
        valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
        out = torch.where(valid[..., None], out, fill)
    else:  # "full": the inverse affine map, one bilinear gather
        opts = dict(dtype=f32, device=img.device)
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        ys = (torch.arange(h, **opts) - cy)[:, None]
        xs = (torch.arange(w, **opts) - cx)[None, :]
        cos_t = _col(torch.cos(params["theta"]), 3)
        sin_t = _col(torch.sin(params["theta"]), 3)
        inv_s = _col(1.0 / params["scale"], 3)
        sx = (cos_t * xs - sin_t * ys) * inv_s + cx + _col(params["tx"], 3)
        sy = (sin_t * xs + cos_t * ys) * inv_s + cy + _col(params["ty"], 3)
        sx = torch.where(_col(params["flip"], 3) > 0, (w - 1) - sx, sx)
        out = _bilinear_gather(img, sx, sy, fill)
    mean = torch.mean(out, dim=(1, 2), keepdim=True)
    out = (out - mean) * _col(params["contrast"], 4) + mean + _col(
        params["brightness"], 4
    )
    out = torch.clamp(out, 0.0, 255.0)
    # Perlin distortion, then spotlights, in the host Augmenter's order
    # (bcnn_apply_data_augmentation, bcnn_data.c:214-332)
    if "distortion" in params:
        distorted = _perlin(out, params["distortion"], params["dist_kx"],
                            params["dist_ky"], params["dist_seed"])
        out = torch.where(_col(params["distortion"], 4) > 0, distorted, out)
    if "spot_mu_x" in params:
        out = _spotlights(out, params["spot_mu_x"], params["spot_mu_y"],
                          params["spot_sx"], params["spot_sy"],
                          params["spot_active"])
    return out


def _geo_mode(cfg: Dict) -> str:
    """Warp class for `_augment`'s `geo`: "none" (flip only),
    "separable" (scale/shift but no rotation), "shear" (rotation range
    <= 90 deg), "full" (larger rotation ranges: the bilinear gather)."""
    rot = float(cfg.get("rotation_range", 0.0))
    if rot:
        return "shear" if rot <= 90.0 else "full"
    if (float(cfg.get("min_scale", 0.0)) or float(cfg.get("max_scale", 0.0))
            or float(cfg.get("range_shift_x", 0))
            or float(cfg.get("range_shift_y", 0))):
        return "separable"
    return "none"


def _geo_kwargs(cfg: Dict) -> Dict:
    """Static kwargs for `_augment` derived from the cfg."""
    geo = _geo_mode(cfg)
    kw = dict(geo=geo)
    if geo == "shear":
        kw["rot_deg"] = float(cfg.get("rotation_range", 0.0))
        lo_s = float(cfg.get("min_scale", 0.0))
        hi_s = float(cfg.get("max_scale", 0.0))
        txm = float(cfg.get("range_shift_x", 0)) / 2.0
        tym = float(cfg.get("range_shift_y", 0)) / 2.0
        kw["sep"] = bool(lo_s or hi_s or txm or tym)
        kw["s_max"] = max(lo_s, hi_s, 1.0) if (lo_s or hi_s) else 1.0
        kw["txm"] = txm
        kw["tym"] = tym
    return kw


def sample_params(
    generator: torch.Generator, n: int, cfg: Dict, hw=None
) -> Dict[str, torch.Tensor]:
    """Per-image augmentation params, CPU tensors with the keys and
    distributions of `bcnn_tpu`'s sampler, drawn from `generator` (a CPU
    generator; None draws from torch's default): (n,) float32, and with
    max_distortion the Perlin keys (dist_seed int32), with
    max_random_spots the (n, max_spots) spot keys, whose centres need
    the image's (h, w) as `hw`."""

    def u(lo, hi, shape=(n,)):
        return torch.empty(shape, dtype=f32).uniform_(lo, hi,
                                                      generator=generator)

    theta = torch.deg2rad(u(-0.5, 0.5) * float(cfg.get("rotation_range", 0.0)))
    lo_s, hi_s = cfg.get("min_scale", 0.0), cfg.get("max_scale", 0.0)
    scale = u(lo_s, hi_s) if (lo_s or hi_s) else torch.ones(n)
    tx = u(-0.5, 0.5) * float(cfg.get("range_shift_x", 0))
    ty = u(-0.5, 0.5) * float(cfg.get("range_shift_y", 0))
    lo_c, hi_c = cfg.get("min_contrast", 0.0), cfg.get("max_contrast", 0.0)
    contrast = u(lo_c, hi_c) if (lo_c or hi_c) else torch.ones(n)
    lo_b, hi_b = cfg.get("min_brightness", 0), cfg.get("max_brightness", 0)
    brightness = u(lo_b, hi_b) if (lo_b or hi_b) else torch.zeros(n)
    flip = (
        (u(0.0, 1.0) > 0.5).to(f32) if cfg.get("random_fliph")
        else torch.zeros(n)
    )
    out = dict(theta=theta, scale=scale, tx=tx, ty=ty, contrast=contrast,
               brightness=brightness, flip=flip)
    max_dist = float(cfg.get("max_distortion", 0.0))
    if max_dist > 0.0:
        out["distortion"] = u(0.0, max_dist)
        out["dist_kx"] = u(-0.5, 0.5)
        out["dist_ky"] = u(-0.5, 0.5)
        out["dist_seed"] = torch.randint(0, 2**31 - 1, (n,),
                                         generator=generator,
                                         dtype=torch.int32)
    max_spots = int(cfg.get("max_random_spots", 0))
    if max_spots > 0:
        if hw is None:
            raise ValueError("sample_params: spotlights need the image's "
                             "(h, w)")
        hh, ww = hw
        # host: n_spots = int(rand*max + 0.5), slot i active iff i <
        # n_spots; mu = int(rand*(dim-1) + 0.5); sigma = rand*(3-0.3) +
        # 0.3 + 0.5
        n_spots = torch.floor(u(0.0, 1.0) * max_spots + 0.5)
        out["spot_active"] = (torch.arange(max_spots, dtype=f32)[None, :]
                              < n_spots[:, None]).to(f32)
        shape = (n, max_spots)
        out["spot_mu_x"] = torch.floor(u(0.0, 1.0, shape) * (ww - 1) + 0.5)
        out["spot_mu_y"] = torch.floor(u(0.0, 1.0, shape) * (hh - 1) + 0.5)
        out["spot_sx"] = u(0.0, 1.0, shape) * (3.0 - 0.3) + 0.3 + 0.5
        out["spot_sy"] = u(0.0, 1.0, shape) * (3.0 - 0.3) + 0.3 + 0.5
    return out


def _on(params: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in params.items()}


def apply_augment(x, params, cfg, norm_coeff=1 / 127.5, mean=127.5):
    """x (N, H, W, C) float32 pixels, params from `sample_params` ->
    augmented, normalized (N, H, W, C) float32 in [-1, 1]."""
    out = _augment(x, _on(params, x.device), **_geo_kwargs(cfg))
    return (out - mean) * norm_coeff


def _stripe_params(generator, n, cfg, hw, stripe):
    """sample_params for n images, or, with stripe = (rank, ranks), for
    the ranks' n * ranks images of a data-parallel batch, of which the
    rank keeps its stripe: each rank's generator moves as one device's
    would, and the ranks' stripes together are its draws."""
    if stripe is None:
        return sample_params(generator, n, cfg, hw)
    r, d = stripe
    params = sample_params(generator, n * d, cfg, hw)
    return {k: v[r * n:(r + 1) * n] for k, v in params.items()}


def augment_batch(batch_u8, generator, cfg, norm_coeff=1 / 127.5,
                  mean=127.5, stripe=None):
    """batch (N, H, W, C) uint8/float on the device -> augmented,
    normalized (N, H, W, C) float32 in [-1, 1]. stripe: (rank, ranks)
    under a mesh (`_stripe_params`)."""
    x = batch_u8.to(f32)
    params = _stripe_params(generator, x.shape[0], cfg, x.shape[1:3], stripe)
    return apply_augment(x, params, cfg, norm_coeff, mean)


# --------------------------------------------------------------------- #
# Detection: the same affine map applied to box labels.
# --------------------------------------------------------------------- #


def transform_boxes(labels: torch.Tensor, params: Dict, h: int, w: int):
    """labels (N, 50*5) normalized [x, y, bw, bh, class], valid up to the
    first x == 0. Maps each box's corners forward through the image's
    affine map, takes the axis-aligned envelope, clips it to the frame,
    drops collapsed boxes and compacts the survivors to the front (a
    stable sort), so the first zero still ends the list."""
    B = DETECTION_MAX_BOXES
    n = labels.shape[0]
    lab = labels.reshape(n, B, 5)
    valid = torch.cumprod((lab[..., 0] != 0).to(f32), dim=1)

    cy_i, cx_i = (h - 1) / 2.0, (w - 1) / 2.0
    # normalized -> pixel coords (pixel centers at (i+0.5)/dim)
    cx = lab[..., 0] * w - 0.5
    cy = lab[..., 1] * h - 0.5
    hw = lab[..., 2] * w / 2.0
    hh = lab[..., 3] * h / 2.0
    corner_x = torch.stack([cx - hw, cx + hw, cx - hw, cx + hw], dim=-1)
    corner_y = torch.stack([cy - hh, cy - hh, cy + hh, cy + hh], dim=-1)

    flip, theta, scale, tx, ty = (
        _col(params[k], 3)
        for k in ("flip", "theta", "scale", "tx", "ty")
    )
    # forward of: s = R(theta) @ o / scale + c + t, then flip on s.x
    px = torch.where(flip > 0, (w - 1) - corner_x, corner_x)
    dx = px - cx_i - tx
    dy = corner_y - cy_i - ty
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    ox = (cos_t * dx + sin_t * dy) * scale + cx_i
    oy = (-sin_t * dx + cos_t * dy) * scale + cy_i

    x0 = torch.clamp(torch.amin(ox, -1), -0.5, w - 0.5)
    x1 = torch.clamp(torch.amax(ox, -1), -0.5, w - 0.5)
    y0 = torch.clamp(torch.amin(oy, -1), -0.5, h - 0.5)
    y1 = torch.clamp(torch.amax(oy, -1), -0.5, h - 0.5)

    eps = 1e-3
    keep = (valid > 0) & ((x1 - x0) > eps) & ((y1 - y0) > eps)

    nx = ((x0 + x1) / 2.0 + 0.5) / w
    ny = ((y0 + y1) / 2.0 + 0.5) / h
    nw = (x1 - x0) / w
    nh = (y1 - y0) / h
    newlab = torch.stack([nx, ny, nw, nh, lab[..., 4]], dim=-1)
    newlab = torch.where(keep[..., None], newlab, 0.0)

    # stable compaction: dropped rows sink to the back, survivors keep
    # their relative order
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    newlab = torch.gather(newlab, 1, order[..., None].expand(-1, -1, 5))
    return newlab.reshape(n, B * 5)


def _check_boxes_cfg(cfg: Dict) -> None:
    if float(cfg.get("max_distortion", 0.0)) > 0.0:
        raise ValueError(
            "max_distortion is not representable as a box transform; "
            "disable perlin distortion for detection training"
        )


def apply_augment_with_boxes(x, labels, params, cfg,
                             norm_coeff=1 / 127.5, mean=127.5):
    """x (N, H, W, C) float32 pixels, labels (N, 250), params from
    `sample_params` -> (normalized images, transformed labels)."""
    params = _on(params, x.device)
    out = _augment(x, params, **_geo_kwargs(cfg))
    newlab = transform_boxes(labels, params, x.shape[1], x.shape[2])
    return (out - mean) * norm_coeff, newlab


def augment_batch_with_boxes(batch_u8, labels, generator, cfg,
                             norm_coeff=1 / 127.5, mean=127.5, stripe=None):
    """Detection-safe device augmentation: images through the device
    pipeline, box labels through the SAME per-image affine map. stripe:
    as in `augment_batch`."""
    _check_boxes_cfg(cfg)
    x = batch_u8.to(f32)
    params = _stripe_params(generator, x.shape[0], cfg, x.shape[1:3], stripe)
    return apply_augment_with_boxes(x, labels, params, cfg, norm_coeff,
                                    mean)


def _nhwc(batch_nchw: torch.Tensor) -> torch.Tensor:
    return batch_nchw.permute(0, 2, 3, 1).contiguous()


def _nchw(x_nhwc: torch.Tensor) -> torch.Tensor:
    return x_nhwc.permute(0, 3, 1, 2).contiguous()


def augment_batch_with_boxes_nchw(batch_u8_nchw, labels, generator, cfg,
                                  **kw):
    out, lab = augment_batch_with_boxes(
        _nhwc(batch_u8_nchw), labels, generator, cfg, **kw
    )
    return _nchw(out), lab


def augment_batch_nchw(batch_u8_nchw, generator, cfg, **kw):
    return _nchw(augment_batch(_nhwc(batch_u8_nchw), generator, cfg, **kw))
