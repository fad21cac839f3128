"""Online host data augmentation, the port's copy of
`bcnn_tpu.data.augment` (numpy, no JAX), on the port's `bip`.

Mirrors bcnn_apply_data_augmentation (src/bcnn_data.c:214-332): ops applied
in the fixed order fliph -> shift(crop) -> scale(resize+crop) -> rotation ->
contrast -> brightness -> perlin distortion -> random spotlights, all on
uint8 HWC via bip. Parameter sampling matches the reference's ranges:
  shift   ~ U(-range/2, range/2) per axis (rand()-RAND_MAX/2 scaling)
  scale   ~ U(min_scale, max_scale)
  rotation~ U(-range/2, range/2) degrees
  contrast~ U(min_contrast, max_contrast)
  brightness ~ U(min_brightness, max_brightness)
  distortion ~ U(0, max_distortion), kx,ky ~ U(-0.5, 0.5)
`use_precomputed` re-applies the previous sample's parameters (paired data).

Deviation: the reference's generic path never actually flips (apply_fliph is
only ever set by the detection loader, bcnn_detection_loader.c:135-138);
here random_fliph flips with p=0.5 for every loader, which is the documented
intent (bcnn_augment_data_with_flip).

Normalization mirrors bcnn_convert_img_to_float (bcnn_data.c:70-100):
HWC uint8 -> CHW float (x - mean)*coeff with optional BGR channel swap.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import bip


@dataclass
class Augmenter:
    """Mirror of bcnn_data_augmenter (src/bcnn_data.h:53-94)."""

    range_shift_x: int = 0
    range_shift_y: int = 0
    min_scale: float = 0.0
    max_scale: float = 0.0
    rotation_range: float = 0.0
    min_contrast: float = 0.0
    max_contrast: float = 0.0
    min_brightness: int = 0
    max_brightness: int = 0
    max_distortion: float = 0.0
    max_random_spots: int = 0
    random_fliph: int = 0
    mean_r: float = 0.0
    mean_g: float = 0.0
    mean_b: float = 0.0
    swap_to_bgr: int = 0
    no_input_norm: int = 0
    use_precomputed: bool = False
    # last sampled params (for use_precomputed and detection label flip)
    shift_x: int = 0
    shift_y: int = 0
    scale: float = 1.0
    rotation: float = 0.0
    contrast: float = 1.0
    brightness: int = 0
    distortion: float = 0.0
    distortion_kx: float = 0.0
    distortion_ky: float = 0.0
    apply_fliph: int = 0
    rng: np.random.RandomState = field(
        default_factory=lambda: np.random.RandomState(0)
    )

    @classmethod
    def from_dict(cls, d: dict, seed: int = 0) -> "Augmenter":
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        a = cls(**known)
        a.rng = np.random.RandomState(seed)
        return a

    def is_identity(self) -> bool:
        """True when apply() is a no-op (and draws no RNG) — the condition
        for the native batched loader fast path (data/native_loader.py)."""
        return not (
            self.range_shift_x or self.range_shift_y or self.min_scale
            or self.max_scale or self.rotation_range or self.min_contrast
            or self.max_contrast or self.min_brightness
            or self.max_brightness or self.max_distortion
            or self.max_random_spots or self.random_fliph
        )

    def apply(self, img: np.ndarray) -> np.ndarray:
        """img: HWC uint8; returns augmented HWC uint8."""
        rng = self.rng
        h, w, c = img.shape
        if self.random_fliph:
            if not self.use_precomputed:
                self.apply_fliph = int(rng.rand() > 0.5)
            if self.apply_fliph:
                img = bip.fliph_image(img)
        if self.range_shift_x or self.range_shift_y:
            if not self.use_precomputed:
                self.shift_x = int(
                    (rng.rand() - 0.5) * self.range_shift_x
                )
                self.shift_y = int(
                    (rng.rand() - 0.5) * self.range_shift_y
                )
            img = bip.crop_image(
                img, self.shift_x, self.shift_y, w, h, fill=128
            )
        if self.max_scale > 0.0 or self.min_scale > 0.0:
            if not self.use_precomputed:
                self.scale = (
                    rng.rand() * (self.max_scale - self.min_scale)
                    + self.min_scale
                )
            ws, hs = int(w * self.scale), int(h * self.scale)
            scaled = bip.resize_bilinear(img, ws, hs)
            img = bip.crop_image(
                scaled, self.shift_x, self.shift_y, w, h, fill=0
            )
        if self.rotation_range > 0.0:
            if not self.use_precomputed:
                self.rotation = np.deg2rad(
                    (rng.rand() - 0.5) * self.rotation_range
                )
            img = bip.rotate_image(img, self.rotation, w // 2, h // 2)
        if self.min_contrast > 0.0 or self.max_contrast > 0.0:
            if not self.use_precomputed:
                self.contrast = (
                    rng.rand() * (self.max_contrast - self.min_contrast)
                    + self.min_contrast
                )
            img = bip.contrast_stretch(img, self.contrast)
        if self.min_brightness != 0 or self.max_brightness != 0:
            if not self.use_precomputed:
                self.brightness = int(
                    rng.rand() * (self.max_brightness - self.min_brightness)
                    + self.min_brightness
                )
            img = bip.image_brightness(img, self.brightness)
        if self.max_distortion > 0.0:
            if not self.use_precomputed:
                self.distortion_kx = rng.rand() - 0.5
                self.distortion_ky = rng.rand() - 0.5
                self.distortion = rng.rand() * self.max_distortion
            img = bip.perlin_distortion(
                img,
                self.distortion,
                self.distortion_kx,
                self.distortion_ky,
                seed=int(rng.randint(0, 2**31 - 1)),
            )
        if self.max_random_spots > 0:
            n = int(rng.rand() * self.max_random_spots + 0.5)
            img = bip.add_random_spotlights(
                img, n, 0.3, 3.0, 0.3, 3.0, rng
            )
        return img


def convert_img_to_float(
    img: np.ndarray,
    norm_coeff: float = 1 / 127.5,
    swap_to_bgr: int = 0,
    mean_r: float = 127.5,
    mean_g: float = 127.5,
    mean_b: float = 127.5,
) -> np.ndarray:
    """HWC uint8 -> CHW float32 (bcnn_convert_img_to_float,
    bcnn_data.c:70-100). Default maps [0,255] to [-1,1]."""
    h, w, c = img.shape
    means = np.asarray([mean_r, mean_g, mean_b][:c], np.float32)
    out = (img.astype(np.float32) - means) * norm_coeff
    out = np.transpose(out, (2, 0, 1))  # CHW
    if swap_to_bgr:
        out = out[::-1]
    return np.ascontiguousarray(out)
