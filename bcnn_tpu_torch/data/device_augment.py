"""On-device batched augmentation, ported from
`bcnn_tpu.data.device_augment`: flip, shift, scale and rotation, then
contrast and brightness and the [-1, 1] normalisation, on the batch's
device, with box labels carried through the same map.

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
as two interpolation matmuls) or "shear" (rotation within 90 degrees:
the separable warp, then Paeth's three-shear rotation, each shear a
per-row two-tap shift, the CUDA kernel K2 on the card). Not ported yet:
geo "full" (the bilinear gather for rotation ranges above 90 degrees),
Perlin distortion and spotlights.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..ops.row_shift import col_shift, row_shift
from ..types import DETECTION_MAX_BOXES

FILL = 128.0
f32 = torch.float32


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
    device. The batched `_augment_one` of the JAX package for geo "none",
    "separable" and "shear", then contrast about the per-image channel
    mean and brightness, clipped to [0, 255]."""
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
    else:
        raise NotImplementedError(
            f"device_augment: geo {geo!r} (rotation_range > 90) is not "
            "ported to bcnn_tpu_torch yet"
        )
    mean = torch.mean(out, dim=(1, 2), keepdim=True)
    out = (out - mean) * _col(params["contrast"], 4) + mean + _col(
        params["brightness"], 4
    )
    return torch.clamp(out, 0.0, 255.0)


def _geo_mode(cfg: Dict) -> str:
    """Warp class for `_augment`'s `geo`: "none" (flip only),
    "separable" (scale/shift but no rotation), "shear" (rotation range
    <= 90 deg), "full" (larger rotation ranges; not ported)."""
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
    generator: torch.Generator, n: int, cfg: Dict
) -> Dict[str, torch.Tensor]:
    """Per-image augmentation params, (n,) float32 CPU tensors with the
    keys and distributions of `bcnn_tpu`'s sampler, drawn from
    `generator` (a CPU generator; None draws from torch's default)."""
    if float(cfg.get("max_distortion", 0.0)) > 0.0 or int(
        cfg.get("max_random_spots", 0)
    ) > 0:
        raise NotImplementedError(
            "device_augment: Perlin distortion and spotlights are not "
            "ported to bcnn_tpu_torch yet"
        )

    def u(lo, hi):
        return torch.empty(n, dtype=f32).uniform_(lo, hi,
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
    return dict(theta=theta, scale=scale, tx=tx, ty=ty, contrast=contrast,
                brightness=brightness, flip=flip)


def _on(params: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in params.items()}


def apply_augment(x, params, cfg, norm_coeff=1 / 127.5, mean=127.5):
    """x (N, H, W, C) float32 pixels, params from `sample_params` ->
    augmented, normalized (N, H, W, C) float32 in [-1, 1]."""
    out = _augment(x, _on(params, x.device), **_geo_kwargs(cfg))
    return (out - mean) * norm_coeff


def augment_batch(batch_u8, generator, cfg, norm_coeff=1 / 127.5,
                  mean=127.5):
    """batch (N, H, W, C) uint8/float on the device -> augmented,
    normalized (N, H, W, C) float32 in [-1, 1]."""
    x = batch_u8.to(f32)
    params = sample_params(generator, x.shape[0], cfg)
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
                             norm_coeff=1 / 127.5, mean=127.5):
    """Detection-safe device augmentation: images through the device
    pipeline, box labels through the SAME per-image affine map."""
    _check_boxes_cfg(cfg)
    x = batch_u8.to(f32)
    params = sample_params(generator, x.shape[0], cfg)
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
