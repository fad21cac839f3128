"""Two-tap fractional shift, one shear of the three-shear rotation: the
CUDA kernel K2 (`csrc/row_shift.cu`) in its row and column modes, and
their plain PyTorch versions.

`row_shift` replaces the Pallas TPU kernel
`bcnn_tpu.ops.shear_pallas.row_shift_pallas` with the fill padding of
`bcnn_tpu.data.device_augment._row_shift` around it, on a batch of
images, shifting along axis 2. `col_shift` is the same shift along axis
1, for the shear that the JAX package runs on transposed images: it
computes `row_shift(img.transpose(1, 2), ...).transpose(1, 2)` without
either transposing copy. `row_shift_ref` and `col_shift_ref` are their
plain versions: `_row_shift`'s sweep over the 2*kmax + 1 integer shifts,
on the padded rows or columns.

Both wrappers call the op `bcnn_tpu_torch::row_shift` (`ops.library`;
`columns` picks the mode): its CPU implementation is the plain version;
its CUDA implementation, `shift_cuda`, launches the kernel or raises;
nothing falls back. Both
modes count on K2's one counter, `library.launches("row_shift")`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from . import library


def _shift_ref(img, d, kmax, out_x0, out_w, in_x0, fill, axis):
    """The sweep along `axis` (1 or 2) of img (N, ., ., C), d the shift
    of each line across it, (N, R)."""
    def cut(t, start, stop):
        sl = [slice(None)] * t.dim()
        sl[axis] = slice(start, stop)
        return t[tuple(sl)]

    win = img.shape[axis]
    lo = out_x0 - kmax  # first absolute column any term reads
    hi = out_x0 + out_w - 1 + kmax
    pad_l, pad_r = in_x0 - lo, hi - (in_x0 + win - 1)
    if pad_l < 0:
        img = cut(img, -pad_l, None)
        pad_l = 0
    if pad_r < 0:
        img = cut(img, None, img.shape[axis] + pad_r)
        pad_r = 0
    pad = (0, 0, pad_l, pad_r) if axis == 2 else (0, 0, 0, 0, pad_l, pad_r)
    imgp = F.pad(img, pad, value=fill)
    shape = list(img.shape)
    shape[axis] = out_w
    acc = torch.zeros(shape, dtype=img.dtype, device=img.device)
    # the shift of line r, broadcast along the shifted axis and C
    w_of = ((lambda w: w[:, :, None, None]) if axis == 2
            else (lambda w: w[:, None, :, None]))
    for i in range(2 * kmax + 1):
        w_k = torch.clamp(1.0 - torch.abs(d - (i - kmax)), min=0.0)
        acc = acc + w_of(w_k) * imgp.narrow(axis, i, out_w)
    return acc


def row_shift_ref(
    img: torch.Tensor, d: torch.Tensor, kmax: int, out_x0: int, out_w: int,
    in_x0: int, fill: float,
) -> torch.Tensor:
    """img (N, R, win, C): rows of pixels whose columns cover absolute x in
    [in_x0, in_x0 + win), `fill` outside; d (N, R) per-row shifts.
    Returns (N, R, out_w, C): out[n, r, j] is the two-tap linear sample
    of row r at absolute x = out_x0 + j + d[n, r], for |d| <= kmax - 1,
    as the sum over the integer shifts k in [-kmax, kmax] of
    hat(d - k) * IMG[out_x0 + j + k], in ascending k."""
    return _shift_ref(img, d, kmax, out_x0, out_w, in_x0, fill, axis=2)


def col_shift_ref(
    img: torch.Tensor, d: torch.Tensor, kmax: int, out_x0: int, out_w: int,
    in_x0: int, fill: float,
) -> torch.Tensor:
    """img (N, win, R, C): columns of pixels whose rows cover absolute y
    in [in_x0, in_x0 + win), `fill` outside; d (N, R) per-column shifts.
    Returns (N, out_w, R, C), contiguous, equal to
    `row_shift_ref(img.transpose(1, 2), d, ...).transpose(1, 2)`: the same
    products summed in the same order."""
    return _shift_ref(img, d, kmax, out_x0, out_w, in_x0, fill, axis=1)


def _check(what, img, d):
    if img.device.type != "cuda" or d.device != img.device:
        raise ValueError(f"{what}: unsupported devices {img.device}, "
                         f"{d.device}")
    if img.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(
            f"{what}: needs float32, got {img.dtype} and {d.dtype}"
        )
    if img.dim() != 4 or d.dim() != 2 or not (img.is_contiguous()
                                              and d.is_contiguous()):
        raise ValueError(f"{what}: img {tuple(img.shape)} and d "
                         f"{tuple(d.shape)} must be contiguous, 4-D and 2-D")


def row_shift(
    img: torch.Tensor, d: torch.Tensor, kmax: int, out_x0: int, out_w: int,
    in_x0: int, fill: float,
) -> torch.Tensor:
    """K2, row mode: `row_shift_ref` as one CUDA kernel for CUDA tensors
    (img fp32 contiguous (N, R, win, C), d fp32 contiguous (N, R)),
    through the op `bcnn_tpu_torch::row_shift` on either device."""
    library.check_devices("row_shift", img, d)
    return _K2(img, d, kmax, out_x0, out_w, in_x0, float(fill), False)


def col_shift(
    img: torch.Tensor, d: torch.Tensor, kmax: int, out_x0: int, out_w: int,
    in_x0: int, fill: float,
) -> torch.Tensor:
    """K2, column mode: `col_shift_ref` as one CUDA kernel for CUDA
    tensors (img fp32 contiguous (N, win, R, C), d fp32 contiguous
    (N, R)), through the op `bcnn_tpu_torch::row_shift` (columns set) on
    either device; returns (N, out_w, R, C), contiguous."""
    library.check_devices("col_shift", img, d)
    return _K2(img, d, kmax, out_x0, out_w, in_x0, float(fill), True)


def _shift_cpu(img, d, kmax, out_x0, out_w, in_x0, fill, columns):
    ref = col_shift_ref if columns else row_shift_ref
    return ref(img, d, kmax, out_x0, out_w, in_x0, fill).contiguous()


def shift_cuda(img, d, kmax, out_x0, out_w, in_x0, fill, columns):
    """The op's CUDA implementation, K2's launcher in row or column mode:
    checks what the kernel takes (raises otherwise), allocates the
    output, launches and checks the launch."""
    what = "col_shift" if columns else "row_shift"
    _check(what, img, d)
    lines = (img.shape[0], img.shape[2] if columns else img.shape[1])
    if tuple(d.shape) != lines:
        raise ValueError(f"{what}: d {tuple(d.shape)} is not (N, R) of "
                         f"img {tuple(img.shape)}")
    if kmax < 0 or out_w < 0:
        raise ValueError(f"{what}: kmax {kmax}, out_w {out_w}")
    out = _shift_fake(img, d, kmax, out_x0, out_w, in_x0, fill, columns)
    if out.numel() == 0:
        return out
    lib = kernels.library()
    entry = lib.bcnn_col_shift if columns else lib.bcnn_row_shift
    with torch.cuda.device(img.device):
        rc = entry(
            img.data_ptr(), d.data_ptr(), out.data_ptr(), *img.shape, kmax,
            out_x0, out_w, in_x0, float(fill),
            torch.cuda.current_stream(img.device).cuda_stream,
        )
    kernels.check(rc, what)
    return out


def _shift_fake(img, d, kmax, out_x0, out_w, in_x0, fill, columns):
    n, a, b, c = img.shape
    return img.new_empty((n, out_w, b, c) if columns else (n, a, out_w, c))


_K2 = library.register(
    "row_shift",
    "(Tensor img, Tensor d, int kmax, int out_x0, int out_w, int in_x0, "
    "float fill, bool columns) -> Tensor",
    cpu=_shift_cpu,
    cuda=shift_cuda,
    fake=_shift_fake,
)
