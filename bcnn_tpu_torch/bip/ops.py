"""Vectorized numpy implementations of the bip image ops: the port's own
copy of `bcnn_tpu.bip.ops` (numpy and Pillow, no JAX), the plain backend
of `bcnn_tpu_torch.bip` and the oracle for its native one.

Semantics mirror src/bip/src/bip.c (cited per function). Images are HWC
uint8 numpy arrays. Fixed-point rounding is replicated where the reference
uses it (contrast stretch 12-bit, rotate 16.16); bilinear resize matches the
reference's half-pixel index/alpha mapping in float (the reference's 4-bit
fixed-point tables quantize alphas — differences are at most 1 uint8 level).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_image(path: str) -> np.ndarray:
    """bip_load_image (bip.c:1837, via stb_image): returns HWC uint8,
    grayscale stays single-channel."""
    from PIL import Image

    img = Image.open(path)
    if img.mode not in ("L", "RGB"):
        img = img.convert("RGB")
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def write_image(path: str, img: np.ndarray) -> None:
    from PIL import Image

    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    Image.fromarray(img).save(path)


def crop_image(
    src: np.ndarray, x_ul: int, y_ul: int, dst_w: int, dst_h: int,
    fill: int = 0, out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """bip_crop_image (bip.c:319-349): copy the overlapping window; negative
    offsets shift into the destination (the caller pre-fills the buffer —
    bcnn memsets 128 for shift augmentation, bcnn_data.c:233)."""
    h, w, c = src.shape
    if out is None:
        out = np.full((dst_h, dst_w, c), fill, np.uint8)
    off_x = max(0, -x_ul)
    off_y = max(0, -y_ul)
    osx = max(0, x_ul)
    osy = max(0, y_ul)
    cw = min(w - osx, dst_w - off_x)
    ch = min(h - osy, dst_h - off_y)
    if cw > 0 and ch > 0:
        out[off_y : off_y + ch, off_x : off_x + cw] = src[
            osy : osy + ch, osx : osx + cw
        ]
    return out


def fliph_image(src: np.ndarray) -> np.ndarray:
    """bip_fliph_image (bip.c:1309)."""
    return src[:, ::-1].copy()


def _bilinear_axis(dst_n: int, src_n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Half-pixel mapping with edge clamping (bip.c:1121-1156)."""
    alpha = (np.arange(dst_n, dtype=np.float64) + 0.5) * (src_n / dst_n) - 0.5
    idx = np.floor(alpha).astype(np.int64)
    a = alpha - idx
    a[idx < 0] = 0.0
    idx[idx < 0] = 0
    over = idx > src_n - 2
    a[over] = 1.0
    idx[over] = src_n - 2
    return idx, a.astype(np.float32)


def resize_bilinear(src: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """bip_resize_bilinear (bip.c:1077-1200)."""
    h, w, c = src.shape
    iy, ay = _bilinear_axis(dst_h, h)
    ix, ax = _bilinear_axis(dst_w, w)
    s = src.astype(np.float32)
    top = s[iy][:, ix] * (1 - ax)[None, :, None] + s[iy][:, ix + 1] * ax[
        None, :, None
    ]
    bot = s[iy + 1][:, ix] * (1 - ax)[None, :, None] + s[iy + 1][
        :, ix + 1
    ] * ax[None, :, None]
    out = top * (1 - ay)[:, None, None] + bot * ay[:, None, None]
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def rotate_image(
    src: np.ndarray, angle: float, center_x: int, center_y: int
) -> np.ndarray:
    """bip_rotate_image BILINEAR (bip.c:1202-1307): 16.16 fixed-point inverse
    map around (center_x, center_y); out-of-range reads produce 0."""
    h, w, c = src.shape
    cosa = np.int64(np.cos(angle) * 65536)
    sina = np.int64(np.sin(angle) * 65536)
    ys, xs = np.mgrid[0:h, 0:w]
    ty = (ys - center_y).astype(np.int64)
    tx = (xs - center_x).astype(np.int64)
    rx = cosa * tx - sina * ty + (center_x << 16)
    ry = sina * tx + cosa * ty + (center_y << 16)
    x_map = rx >> 16
    y_map = ry >> 16
    x_diff = ((rx - (x_map << 16)) / 65536.0).astype(np.float32)
    y_diff = ((ry - (y_map << 16)) / 65536.0).astype(np.float32)
    valid = (x_map >= 0) & (x_map < w - 1) & (y_map >= 0) & (y_map < h - 1)
    xm = np.clip(x_map, 0, w - 2)
    ym = np.clip(y_map, 0, h - 2)
    s = src.astype(np.float32)
    xd = x_diff[..., None]
    yd = y_diff[..., None]
    out = (
        s[ym, xm] * (1 - xd) * (1 - yd)
        + s[ym, xm + 1] * xd * (1 - yd)
        + s[ym + 1, xm] * (1 - xd) * yd
        + s[ym + 1, xm + 1] * xd * yd
    )
    out = out.astype(np.uint8)  # C truncates the float, no rounding
    out[~valid] = 0
    return out


def contrast_stretch(src: np.ndarray, contrast: float) -> np.ndarray:
    """bip_contrast_stretch (bip.c:85-130): per-channel mean-centered scale
    in 12-bit fixed point."""
    h, w, c = src.shape
    cc = np.int64(contrast * (1 << 12) + 0.5)
    mean = (
        src.astype(np.uint32).sum(axis=(0, 1)) // (w * h)
    ).astype(np.int64)
    pix = (
        ((src.astype(np.int64) - mean) * cc + (1 << 11)) >> 12
    ) + mean
    return np.clip(pix, 0, 255).astype(np.uint8)


def image_brightness(src: np.ndarray, brightness: int) -> np.ndarray:
    """bip_image_brightness (bip.c:131-152)."""
    return np.clip(src.astype(np.int32) + int(brightness), 0, 255).astype(
        np.uint8
    )


def _noise2d(x, y, octave: int, seed: int):
    """_bip_noise2d (bip.c:154-160), with C int32 wraparound."""
    with np.errstate(over="ignore"):
        i = (
            x.astype(np.int32) * np.int32(1619)
            + y.astype(np.int32) * np.int32(31337)
            + np.int32(octave * 3463)
            + np.int32(seed) * np.int32(13397)
        )
        n = (i << np.int32(13)) ^ i
        m = (
            n * (n * n * np.int32(15731) + np.int32(789221))
            + np.int32(1376312589)
        ) & np.int32(0x7FFFFFFF)
    return 1.0 - m.astype(np.float64) / 1073741824.0


def _smooth2d(x, y, octave: int, seed: int):
    ix = np.floor(x).astype(np.int64)
    iy = np.floor(y).astype(np.int64)
    fx = (x - ix)
    fy = (y - iy)
    v1 = _noise2d(ix, iy, octave, seed)
    v2 = _noise2d(ix + 1, iy, octave, seed)
    v3 = _noise2d(ix, iy + 1, octave, seed)
    v4 = _noise2d(ix + 1, iy + 1, octave, seed)

    def interp(a, b, t):
        tt = (1.0 - np.cos(t * np.pi)) * 0.5
        return a * (1.0 - tt) + b * tt

    return interp(interp(v1, v2, fx), interp(v3, v4, fx), fy)


def perlin_distortion(
    src: np.ndarray, distortion: float, kx: float, ky: float, seed: int
) -> np.ndarray:
    """bip_image_perlin_distortion (bip.c:205-266): single-octave
    (persistence 0) perlin displacement applied equally to x and y; bilinear
    sample with zero outside."""
    h, w, c = src.shape
    ys, xs = np.mgrid[0:h, 0:w]
    x_norm = xs / w
    y_norm = ys / h
    noise = _smooth2d(x_norm + kx, y_norm + ky, 0, seed)
    px = (x_norm + noise * distortion) * w
    py = (y_norm + noise * distortion) * h
    x_map = px.astype(np.int64)  # C (int) cast truncates toward zero
    y_map = py.astype(np.int64)
    x_diff = (px - np.floor(px)).astype(np.float32)
    y_diff = (py - np.floor(py)).astype(np.float32)
    valid = (x_map >= 0) & (x_map < w - 1) & (y_map >= 0) & (y_map < h - 1)
    xm = np.clip(x_map, 0, w - 2)
    ym = np.clip(y_map, 0, h - 2)
    s = src.astype(np.float32)
    xd = x_diff[..., None]
    yd = y_diff[..., None]
    out = (
        s[ym, xm] * (1 - xd) * (1 - yd)
        + s[ym, xm + 1] * xd * (1 - yd)
        + s[ym + 1, xm] * (1 - xd) * yd
        + s[ym + 1, xm + 1] * xd * yd
    ).astype(np.uint8)
    out[~valid] = 0
    return out


def image_integral(src: np.ndarray) -> np.ndarray:
    """bip_image_integral (bip.c:528-556): (h+1, w+1) uint32 summed-area
    table with a zero first row/column. src: HW or HWC with c==1."""
    if src.ndim == 3:
        src = src[:, :, 0]
    h, w = src.shape
    out = np.zeros((h + 1, w + 1), np.uint32)
    np.cumsum(
        np.cumsum(src.astype(np.uint32), axis=0), axis=1, out=out[1:, 1:]
    )
    return out


def image_sobel(src: np.ndarray) -> np.ndarray:
    """Sobel gradient magnitude (bip's CV extras; 3x3 kernels, |gx|+|gy|
    clamped to uint8). src: HW or HW1 uint8 -> same-shape uint8, zero
    border."""
    squeeze = src.ndim == 3
    if squeeze:
        src = src[:, :, 0]
    s = src.astype(np.int32)
    gx = np.zeros_like(s)
    gy = np.zeros_like(s)
    gx[1:-1, 1:-1] = (
        (s[:-2, 2:] + 2 * s[1:-1, 2:] + s[2:, 2:])
        - (s[:-2, :-2] + 2 * s[1:-1, :-2] + s[2:, :-2])
    )
    gy[1:-1, 1:-1] = (
        (s[2:, :-2] + 2 * s[2:, 1:-1] + s[2:, 2:])
        - (s[:-2, :-2] + 2 * s[:-2, 1:-1] + s[:-2, 2:])
    )
    mag = np.clip(np.abs(gx) + np.abs(gy), 0, 255).astype(np.uint8)
    return mag[:, :, None] if squeeze else mag


def otsu_threshold(src: np.ndarray) -> int:
    """Otsu's threshold (bip_otsu, bip.c:1034): maximizes between-class
    variance of the grayscale histogram; returns the threshold value."""
    if src.ndim == 3:
        src = src[:, :, 0]
    hist = np.bincount(src.ravel(), minlength=256).astype(np.float64)
    total = hist.sum()
    w0 = np.cumsum(hist)
    m = np.cumsum(hist * np.arange(256))
    mu_t = m[-1]
    w1 = total - w0
    with np.errstate(divide="ignore", invalid="ignore"):
        between = (mu_t * w0 - m) ** 2 / (w0 * w1)
    between[~np.isfinite(between)] = 0.0
    return int(np.argmax(between))


def pyramid_down(src: np.ndarray) -> np.ndarray:
    """bip_pyramid_down (bip.c:352-383): 2x2 box downsample with +2 >> 2
    rounding (odd tails averaged in pairs)."""
    if src.ndim == 3:
        c1 = src.shape[2] == 1
        src2 = src[:, :, 0]
    else:
        c1, src2 = False, src
    h, w = src2.shape
    eh, ew = h - (h % 2), w - (w % 2)
    s = src2.astype(np.uint32)
    core = (
        s[0:eh:2, 0:ew:2] + s[0:eh:2, 1:ew:2]
        + s[1:eh:2, 0:ew:2] + s[1:eh:2, 1:ew:2] + 2
    ) >> 2
    oh, ow = (h + 1) // 2, (w + 1) // 2
    out = np.zeros((oh, ow), np.uint32)
    out[: eh // 2, : ew // 2] = core
    if w % 2:
        col = (s[0:eh:2, w - 1] + s[1:eh:2, w - 1] + 1) >> 1
        out[: eh // 2, ow - 1] = col
    if h % 2:
        row = (s[h - 1, 0:ew:2] + s[h - 1, 1:ew:2] + 1) >> 1
        out[oh - 1, : ew // 2] = row
    if h % 2 and w % 2:
        out[oh - 1, ow - 1] = s[h - 1, w - 1]
    out = out.astype(np.uint8)
    return out[:, :, None] if c1 else out


def add_random_spotlights(
    src: np.ndarray,
    num_spots: int,
    min_w: float,
    max_w: float,
    min_h: float,
    max_h: float,
    rng: np.random.RandomState,
) -> np.ndarray:
    """bip_add_random_spotlights (bip.c:282-317): additive gaussian
    spotlights, clamped."""
    h, w, c = src.shape
    out = src.astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for _ in range(num_spots):
        mu_x = int(rng.rand() * (w - 1) + 0.5)
        mu_y = int(rng.rand() * (h - 1) + 0.5)
        sx = rng.rand() * (max_w - min_w) + min_w + 0.5
        sy = rng.rand() * (max_h - min_h) + min_h + 0.5
        val = np.exp(
            -0.5
            * (
                (xs - mu_x) ** 2 / (sx * sx)
                + (ys - mu_y) ** 2 / (sy * sy)
            )
        )
        out = np.clip(out + 255.0 * val[..., None], 0, 255)
    return out.astype(np.uint8)


# ------------------------------------------------------------------ #
# CV extras round 2: the bip.h long tail (SURVEY "port only as needed"
# -> judged as a gap; everything below is cross-checked against the
# reference semantics in tests/test_bip_extra.py)
# ------------------------------------------------------------------ #


def rgb2gray(src: np.ndarray) -> np.ndarray:
    """bip_rgb2gray (bip.c:63-82): fixed-point equal-weight gray,
    w = round(0.333*4096), (w*(r+g+b) + 2048) >> 12. HWC(3) -> HW1."""
    w = int(0.333 * (1 << 12) + 0.5)
    s = src.astype(np.int32)
    g = (w * s[:, :, 0] + w * s[:, :, 1] + w * s[:, :, 2] + (1 << 11)) >> 12
    return g.astype(np.uint8)[:, :, None]


def invert_image(src: np.ndarray) -> np.ndarray:
    """bip_invert_image (bip.c:1293): bitwise NOT."""
    return np.bitwise_not(src)


def pyramid_up(src: np.ndarray) -> np.ndarray:
    """bip_pyramid_up (bip.c:386-416): 2x nearest-neighbor upsample,
    single channel."""
    if src.ndim == 3:
        src = src[:, :, 0]
    return np.repeat(np.repeat(src, 2, 0), 2, 1)[:, :, None]


def mirror_borders(src: np.ndarray, top: int, bottom: int, left: int,
                   right: int) -> np.ndarray:
    """bip_mirror_borders_8u (bip.c:418-470): symmetric padding (border
    pixel included in the reflection)."""
    return np.pad(
        src, ((top, bottom), (left, right), (0, 0)), mode="symmetric"
    )


def image_histogram(src: np.ndarray) -> np.ndarray:
    """bip_image_histogram (bip.c:982): 256-bin uint32 histogram
    (single-channel)."""
    if src.ndim == 3:
        src = src[:, :, 0]
    return np.bincount(src.ravel(), minlength=256).astype(np.uint32)


def image_entropy(src: np.ndarray) -> float:
    """bip_image_entropy (bip.c:1013-1031): Shannon entropy in bits,
    computed exactly as the reference (natural log * BIP_LOG2)."""
    if src.ndim == 3:
        src = src[:, :, 0]
    h = image_histogram(src).astype(np.float32)
    norm = np.float32(1.0 / (src.shape[0] * src.shape[1]))
    nz = h[h > 0]
    s = -np.sum(norm * nz * np.log(nz * norm), dtype=np.float32)
    return float(s * np.float32(1.4426950408889))


def image_square_integral(src: np.ndarray):
    """bip_image_square_integral (bip.c:558-599): (h+1,w+1) uint32 sum
    table + float64 sum-of-squares table, zero first row/column."""
    if src.ndim == 3:
        src = src[:, :, 0]
    h, w = src.shape
    s = np.zeros((h + 1, w + 1), np.uint32)
    sq = np.zeros((h + 1, w + 1), np.float64)
    np.cumsum(
        np.cumsum(src.astype(np.uint32), 0), 1, out=s[1:, 1:]
    )
    np.cumsum(
        np.cumsum(src.astype(np.float64) ** 2, 0), 1, out=sq[1:, 1:]
    )
    return s, sq


def _window_sums(table, w2, h2, height, width):
    ys, xs = np.mgrid[0:height, 0:width]
    min_x = np.maximum(xs - w2, 0)
    min_y = np.maximum(ys - h2, 0)
    max_x = np.minimum(xs + w2, width - 1)
    max_y = np.minimum(ys + h2, height - 1)
    area = (max_x - min_x + 1) * (max_y - min_y + 1)
    tot = (
        table[max_y + 1, max_x + 1].astype(np.float64)
        - table[min_y, max_x + 1]
        - table[max_y + 1, min_x]
        + table[min_y, min_x]
    )
    return tot, area


def image_sliding_mean(src: np.ndarray, kernel_w: int,
                       kernel_h: int) -> np.ndarray:
    """bip_image_sliding_mean (bip.c:600-745): box mean over the window
    CLIPPED to the image, integer (truncating) division like the C."""
    squeeze = src.ndim == 3
    if squeeze:
        src = src[:, :, 0]
    h, w = src.shape
    table = image_integral(src)
    tot, area = _window_sums(table, kernel_w // 2, kernel_h // 2, h, w)
    mean = (tot // area).astype(np.int64)
    out = np.clip(mean, 0, 255).astype(np.uint8)
    return out[:, :, None] if squeeze else out


def image_sliding_mean_variance(src: np.ndarray, kernel_w: int,
                                kernel_h: int):
    """bip_image_sliding_mean_variance (bip.c:746-981): clipped-window
    mean (uint8, truncated like the C int division) and variance
    E[x^2] - mean^2 where mean is the TRUNCATED integer (reference
    quirk preserved)."""
    squeeze = src.ndim == 3
    if squeeze:
        src = src[:, :, 0]
    h, w = src.shape
    s, sq = image_square_integral(src)
    tot, area = _window_sums(s, kernel_w // 2, kernel_h // 2, h, w)
    mean_i = (tot // area).astype(np.int64)
    tot_sq, _ = _window_sums(sq, kernel_w // 2, kernel_h // 2, h, w)
    var = tot_sq / area - mean_i.astype(np.float64) ** 2
    mean = np.clip(mean_i, 0, 255).astype(np.uint8)
    if squeeze:
        mean = mean[:, :, None]
    return mean, var


def lbp_estimate(src: np.ndarray) -> np.ndarray:
    """bip_lbp_estimate (bip.c:1392-1425): 8-bit local binary pattern,
    neighbor >= center, bit order NW,N,NE,E,SE,S,SW,W; borders zero."""
    squeeze = src.ndim == 3
    if squeeze:
        src = src[:, :, 0]
    h, w = src.shape
    out = np.zeros((h, w), np.uint8)
    c = src[1:-1, 1:-1]
    bits = (
        ((src[0:-2, 0:-2] >= c).astype(np.uint8) << 0)
        | ((src[0:-2, 1:-1] >= c).astype(np.uint8) << 1)
        | ((src[0:-2, 2:] >= c).astype(np.uint8) << 2)
        | ((src[1:-1, 2:] >= c).astype(np.uint8) << 3)
        | ((src[2:, 2:] >= c).astype(np.uint8) << 4)
        | ((src[2:, 1:-1] >= c).astype(np.uint8) << 5)
        | ((src[2:, 0:-2] >= c).astype(np.uint8) << 6)
        | ((src[1:-1, 0:-2] >= c).astype(np.uint8) << 7)
    )
    out[1:-1, 1:-1] = bits
    return out[:, :, None] if squeeze else out


# uniform-pattern LUT, verbatim from bip_lbp_histogram_features
# (bip.c:1434-1450)
_LBP_UNIFORM_LUT = np.asarray([
    0, 1, 2, 3, 4, 58, 5, 6, 7, 58, 58, 58, 8, 58, 9, 10, 11, 58,
    58, 58, 58, 58, 58, 58, 12, 58, 58, 58, 13, 58, 14, 15, 16, 58, 58, 58,
    58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 17, 58, 58, 58, 58, 58,
    58, 58, 18, 58, 58, 58, 19, 58, 20, 21, 22, 58, 58, 58, 58, 58, 58, 58,
    58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58,
    58, 58, 58, 58, 58, 58, 23, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58,
    58, 58, 58, 58, 24, 58, 58, 58, 58, 58, 58, 58, 25, 58, 58, 58, 26, 58,
    27, 28, 29, 30, 58, 31, 58, 58, 58, 32, 58, 58, 58, 58, 58, 58, 58, 33,
    58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 34, 58, 58,
    58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58,
    58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 58, 35, 36, 37, 58, 38, 58, 58,
    58, 39, 58, 58, 58, 58, 58, 58, 58, 40, 58, 58, 58, 58, 58, 58, 58, 58,
    58, 58, 58, 58, 58, 58, 58, 41, 42, 43, 58, 44, 58, 58, 58, 45, 58, 58,
    58, 58, 58, 58, 58, 46, 47, 48, 58, 49, 58, 58, 58, 50, 51, 52, 58, 53,
    54, 55, 56, 57,
], np.uint8)


def lbp_histogram_features(src: np.ndarray, norm: bool = False,
                           uniform: bool = False) -> np.ndarray:
    """bip_lbp_histogram_features (bip.c:1427-1490): histogram of an
    LBP image; 256 bins, or 59 uniform-pattern bins via the LUT;
    optionally normalized by the pixel count."""
    if src.ndim == 3:
        src = src[:, :, 0]
    vals = _LBP_UNIFORM_LUT[src.ravel()] if uniform else src.ravel()
    bins = 59 if uniform else 256
    h = np.bincount(vals, minlength=bins)[:bins].astype(np.float32)
    if norm:
        h /= src.size
    return h


def median_3x3(src: np.ndarray) -> np.ndarray:
    """bip_median_3x3 (bip.c:1587-1731): 3x3 median with the reference's
    exact border scheme — first/last ROW use vertical edge replication,
    first/last COLUMN of every row are copied from src."""
    squeeze = src.ndim == 3
    if squeeze:
        src = src[:, :, 0]
    padded = np.pad(src, ((1, 1), (0, 0)), mode="edge")
    stack = np.stack([
        padded[dy : dy + src.shape[0], :][:, dx_slice]
        for dy in (0, 1, 2)
        for dx_slice in (slice(0, -2), slice(1, -1), slice(2, None))
    ])
    med = np.median(stack, axis=0).astype(np.uint8)
    out = src.copy()
    out[:, 1:-1] = med
    out[:, 0] = src[:, 0]
    out[:, -1] = src[:, -1]
    return out[:, :, None] if squeeze else out


def gaussian_blur_3x3(src: np.ndarray) -> np.ndarray:
    """bip_gaussian_blur_3x3 (bip.c:1733-1820): separable [1,2,1]^2/16
    with edge replication, integer rounding (+8 >> 4)."""
    squeeze = src.ndim == 2
    if squeeze:
        src = src[:, :, None]
    p = np.pad(src, ((1, 1), (1, 1), (0, 0)), mode="edge").astype(np.int32)
    h, w, _ = src.shape
    k = [(1, 0, 0), (2, 0, 1), (1, 0, 2),
         (2, 1, 0), (4, 1, 1), (2, 1, 2),
         (1, 2, 0), (2, 2, 1), (1, 2, 2)]
    acc = np.zeros_like(p[1 : 1 + h, 1 : 1 + w])
    for wgt, dy, dx in k:
        acc += wgt * p[dy : dy + h, dx : dx + w]
    out = ((acc + 8) >> 4).astype(np.uint8)
    return out[:, :, 0] if squeeze else out


def load_image_from_memory(data: bytes) -> np.ndarray:
    """bip_load_image_from_memory: decode from an in-memory buffer."""
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if img.mode not in ("L", "RGB"):
        img = img.convert("RGB")
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def write_image_to_memory(img: np.ndarray, fmt: str = "PNG") -> bytes:
    import io

    from PIL import Image

    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt)
    return buf.getvalue()


def write_float_image(path: str, img: np.ndarray,
                      normalize: bool = False) -> None:
    """bip_write_float_image[_norm]: float image -> u8 PNG; norm maps
    [min,max] to [0,255], otherwise values are clamped."""
    f = np.asarray(img, np.float32)
    if normalize:
        lo, hi = float(f.min()), float(f.max())
        f = (f - lo) / (hi - lo) * 255.0 if hi > lo else f * 0
    u8 = np.clip(f, 0, 255).astype(np.uint8)
    write_image(path, u8)


def write_float_image_norm(path: str, img: np.ndarray) -> None:
    """bip_write_float_image_norm (bip.c:1923-1962), quirks kept: the
    min/max scan covers only the FIRST src_width interleaved elements of
    each row (x < src_width, not src_width*depth — channels >0 of wide
    rows never enter the range), then every element is mapped with
    clamp(norm * (src - min), 0, 255); a flat range writes all black."""
    f = np.atleast_3d(np.asarray(img, np.float32))
    h, w, _d = f.shape
    flat = f.reshape(h, -1)
    head = flat[:, :w]  # the reference's per-row x < src_width scan
    lo, hi = float(head.min()), float(head.max())
    norm = 255.0 / (hi - lo) if hi - lo > 0 else 0.0
    u8 = np.clip(norm * (flat - lo), 0, 255).astype(np.uint8)
    write_image(path, u8.reshape(f.shape).squeeze())


def write_double_image(path: str, img: np.ndarray) -> None:
    """bip_write_double_image (bip.c:1964-1989), quirk kept: the write
    loop covers only the FIRST src_width elements of each interleaved
    row (x < src_width, unlike the float variant's src_width*depth), so
    for depth>1 the right (depth-1)/depth of every row stays at the
    calloc zeros. Values map as clamp(255*src, 0, 255) — float math on
    the double input, like the C expression 255.0f * src[x]."""
    f = np.atleast_3d(np.asarray(img, np.float64))
    h, w, _d = f.shape
    flat = f.reshape(h, -1)
    u8 = np.zeros_like(flat, np.uint8)
    u8[:, :w] = np.clip(
        255.0 * flat[:, :w].astype(np.float32), 0, 255
    ).astype(np.uint8)
    write_image(path, u8.reshape(f.shape).squeeze())


def status_string(status) -> str:
    """bip_status_string (bip.c:1818-1833)."""
    return {
        0: "Success",
        1: "Invalid pointer",
        2: "Invalid parameter size",
        3: "Invalid parameter",
    }.get(int(status), "Unknown error")
