#!/usr/bin/env python3
"""Time the shear kernel K2 (bcnn_tpu_torch/csrc/row_shift.cu) and the
YOLO decode K1 (csrc/yolo_decode.cu) on one GPU against other builds of
them, at the shapes of the port's paths: K2's three shears of one
training step (batch 32, 416 px, rotation 10) and the whole shear chain,
K1 on YOLOv3-tiny's two heads at batch 8. Every build runs in this one
process, in turns (A, B, ..., B, A), warm and cold (tools/card_timing.py's
cuda_ms and cold_ms); then the profiler's device time by kernel name for
each chain and each K1 build.

    mkdir -p _checkout
    git show <commit>:bcnn_tpu_torch/csrc/row_shift.cu > _checkout/k2_old.cu
    git show <commit>:bcnn_tpu_torch/csrc/yolo_decode.cu > _checkout/k1_old.cu
    python3 tools/k1k2_compare.py --old-k2 _checkout/k2_old.cu \\
        --old-k1 _checkout/k1_old.cu [--variant-k2 other.cu ...]

--old-k2 takes a source with row mode only (its shear chain transposes
pass 2's input and output with two copies, as the port did before the
column mode); --variant-k2 takes sources with the repo's two entry
points. --old-k1 takes any source with the repo's K1 entry point. Every
output must equal the plain version's (K2 bit for bit; K1 within rtol
1e-5, atol 1e-6). Builds go to _checkout/ (gitignored). Needs CUDA and
nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bcnn_tpu_torch import kernels  # noqa: E402
from bcnn_tpu_torch.data.device_augment import _shear_bounds  # noqa: E402
from bcnn_tpu_torch.ops import row_shift as k2  # noqa: E402
from bcnn_tpu_torch.ops.yolo_decode import (  # noqa: E402
    decode_fused, decode_grid_ref)
from benchmark.roofline import PEAK_BYTES  # noqa: E402
from tools.card_timing import (  # noqa: E402
    FLUSH_FLOATS, cold_ms, cuda_ms, device_us, gpu_line)

OUT = ROOT / "_checkout" / "k1k2_compare"
FILL = 128.0
BATCH, SIZE, ROT = 32, 416, 10.0
DET_BATCH, CLASSES = 8, 80
ANCHORS = [10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319]
HEADS = [(13, [3, 4, 5]), (26, [0, 1, 2])]


def build(src: Path, entries) -> ctypes.CDLL:
    """src built alone into a shared library, its entry points bound."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{src.stem}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    repo = kernels.library()
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes = getattr(repo, name).argtypes
        fn.restype = ctypes.c_int
    return lib


def ctypes_shift(lib, entry):
    """A K2 entry point of `lib` as shift(img, d, kmax, out_x0, out_w,
    in_x0) -> out, in the repo wrapper's layouts."""
    def run(img, d, kmax, out_x0, out_w, in_x0):
        n, a, b, c = img.shape
        shape = ((n, a, out_w, c) if entry == "bcnn_row_shift"
                 else (n, out_w, b, c))
        out = torch.empty(shape, device=img.device)
        rc = getattr(lib, entry)(
            img.data_ptr(), d.data_ptr(), out.data_ptr(), n, a, b, c, kmax,
            out_x0, out_w, in_x0, FILL, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry}: CUDA error {rc}")
        return out
    return run


def chain_inputs():
    """mid (32, 418, 418, 3) in [0, 255) and the three passes' shifts from
    a random angle within +-5 degrees an image, as _rotate_3shear makes
    them; and the static extents."""
    kx, ky, kx2, myc, mxc = _shear_bounds(ROT, SIZE, SIZE)
    gen = torch.Generator().manual_seed(0)
    mid = 255 * torch.rand(BATCH, SIZE + 2 * myc, SIZE + 2 * mxc, 3,
                           generator=gen)
    theta = torch.deg2rad((torch.rand(BATCH, generator=gen) - 0.5) * ROT)
    alpha = -torch.tan(theta / 2)[:, None]
    beta = torch.sin(theta)[:, None]
    c = (SIZE - 1) / 2.0
    ar = torch.arange
    d1e = alpha * (ar(SIZE + 2 * myc) - myc - c)
    d2 = beta * (ar(SIZE + 2 * kx) - kx - c)
    d1 = alpha * (ar(SIZE) - c)
    ds = [t.float().cuda() for t in (d1e, d2, d1)]
    return mid.cuda(), ds, (kx, ky, kx2, myc, mxc)


def chain(row, col, mid, ds, ext):
    """The three shears; with col None, pass 2 runs in row mode on the
    transposed image, made contiguous before and after (two copies)."""
    kx, ky, kx2, myc, mxc = ext
    d1e, d2, d1 = ds
    r3 = row(mid, d1e, kx2, -kx, SIZE + 2 * kx, -mxc)
    if col is None:
        r2 = row(r3.transpose(1, 2).contiguous(), d2, ky, 0, SIZE,
                 -myc).transpose(1, 2).contiguous()
    else:
        r2 = col(r3, d2, ky, 0, SIZE, -myc)
    return row(r2, d1, kx, 0, SIZE, -kx), r3, r2


def turns(fns, flush):
    """Warm and cold ms of each fn, timed in turns A, B, ..., B, A."""
    t_w = dict.fromkeys(fns, 0.0)
    t_c = dict.fromkeys(fns, 0.0)
    order = list(fns)
    for name in order + order[::-1]:
        t_w[name] += cuda_ms(fns[name], iters=30, warmup=3) / 2
        t_c[name] += cold_ms(fns[name], flush) / 2
    return t_w, t_c


def show(label, t_w, t_c, bound_us):
    print(f"{label}: bound {bound_us:.1f} us | warm "
          + ", ".join(f"{k} {1e3 * v:.1f}" for k, v in t_w.items())
          + " | cold "
          + ", ".join(f"{k} {1e3 * v:.1f} ({bound_us / (1e3 * v):.0%})"
                      for k, v in t_c.items()) + " us")


def by_name(label, fn):
    dev = device_us(fn, iters=10)
    total = sum(dev.values()) / 10
    print(f"  {label}: device time "
          + (f"{total:.1f} us a call" if total else "not measured")
          + "".join(f"\n      {us / 10:8.1f} us  {k[:80]}"
                    for k, us in sorted(dev.items(), key=lambda kv: -kv[1])))


def compare_k2(old, variants, flush):
    mid, ds, ext = chain_inputs()
    kx, ky, kx2, myc, mxc = ext
    builds = {}
    if old is not None:
        builds["old"] = (ctypes_shift(old, "bcnn_row_shift"), None)
    builds["repo"] = (
        lambda *a: k2.row_shift(*a, FILL), lambda *a: k2.col_shift(*a, FILL))
    for name, lib in variants.items():
        builds[name] = (ctypes_shift(lib, "bcnn_row_shift"),
                        ctypes_shift(lib, "bcnn_col_shift"))
    ref = k2.row_shift_ref
    want_out, want_r3, want_r2 = None, None, None
    for name, (row, col) in builds.items():
        out, r3, r2 = chain(row, col, mid, ds, ext)
        if want_out is None:  # the plain version, pass by pass
            want_r3 = ref(mid, ds[0], kx2, -kx, SIZE + 2 * kx, -mxc, FILL)
            want_r2 = k2.col_shift_ref(want_r3, ds[1], ky, 0, SIZE, -myc,
                                       FILL)
            want_out = ref(want_r2, ds[2], kx, 0, SIZE, -kx, FILL)
        for got, want in ((r3, want_r3), (r2, want_r2), (out, want_out)):
            if not torch.equal(got, want):
                raise RuntimeError(f"K2 {name} differs from the plain "
                                   "version")
    # the three launches alone, each on the input the path gives it
    r3t = want_r3.transpose(1, 2).contiguous()
    passes = [  # (label, input, shifts, arguments, output, column mode)
        ("pass 1 row", mid, ds[0], (kx2, -kx, SIZE + 2 * kx, -mxc),
         want_r3, False),
        ("pass 2 column", want_r3, ds[1], (ky, 0, SIZE, -myc), want_r2,
         True),
        ("pass 3 row", want_r2, ds[2], (kx, 0, SIZE, -kx), want_out, False),
    ]
    total = {}
    for label, img, d, args, out, column in passes:
        fns = {}
        for name, (row, col) in builds.items():
            if column and col is None:  # row mode on the transposed image
                fns[name] = lambda row=row, d=d, args=args: row(r3t, d, *args)
            else:
                fns[name] = (lambda fn=(col if column else row), img=img, d=d,
                             args=args: fn(img, d, *args))
        t_w, t_c = turns(fns, flush)
        nbytes = 4 * (img.numel() + d.numel() + out.numel())
        show(f"K2 {label} {tuple(img.shape)}", t_w, t_c,
             nbytes / PEAK_BYTES * 1e6)
        for name in fns:
            acc = total.setdefault(name, [0.0, 0.0])
            acc[0] += t_w[name]
            acc[1] += t_c[name]
    print("K2, the three launches, ms [warm, cold]: "
          + ", ".join(f"{k} [{v[0]:.4f}, {v[1]:.4f}]"
                      for k, v in total.items()))
    chains = {name: (lambda row=row, col=col: chain(row, col, mid, ds, ext))
              for name, (row, col) in builds.items()}
    t_w, t_c = turns(chains, flush)
    nbytes = 4 * (mid.numel() + want_r3.numel() * 2 + want_r2.numel() * 2
                  + want_out.numel())
    show("shear chain (three passes; old: and two transposing copies)",
         t_w, t_c, nbytes / PEAK_BYTES * 1e6)
    for name, fn in chains.items():
        by_name(f"chain {name}", fn)


def compare_k1(old, flush):
    gen = torch.Generator().manual_seed(0)
    for g, mask in HEADS:
        x = (3 * torch.randn(DET_BATCH, 3 * (5 + CLASSES), g, g,
                             generator=gen)).cuda()
        p = dict(num=3, classes=CLASSES, mask=mask, anchors=ANCHORS)
        want = decode_grid_ref(x, p, SIZE, SIZE)
        fns = {}
        if old is not None:
            outs = [torch.empty_like(w) for w in want]
            awh = (ctypes.c_float * 6)(
                *[float(ANCHORS[2 * m + j]) for m in mask for j in (0, 1)])

            def run_old(outs=outs, awh=awh, x=x, g=g):
                rc = old.bcnn_yolo_decode(
                    x.data_ptr(), *[o.data_ptr() for o in outs],
                    ctypes.cast(awh, ctypes.c_void_p), DET_BATCH, 3, CLASSES,
                    g, g, float(SIZE), float(SIZE),
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"old K1: CUDA error {rc}")
                return outs
            fns["old"] = run_old
        fns["repo"] = lambda x=x, p=p: decode_fused(x, p, SIZE, SIZE)
        for name, fn in fns.items():
            for got, w in zip(fn(), want):
                torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-6)
        t_w, t_c = turns(fns, flush)
        nbytes = 4 * (x.numel() + sum(w.numel() for w in want))
        show(f"K1 {tuple(x.shape)}", t_w, t_c, nbytes / PEAK_BYTES * 1e6)
        for name, fn in fns.items():
            by_name(f"K1 {name} {tuple(x.shape)}", fn)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-k2", type=Path)
    ap.add_argument("--old-k1", type=Path)
    ap.add_argument("--variant-k2", type=Path, action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1k2_compare: CUDA is not available", file=sys.stderr)
        return 1
    print(gpu_line())
    old_k2 = build(args.old_k2, ["bcnn_row_shift"]) if args.old_k2 else None
    old_k1 = build(args.old_k1, ["bcnn_yolo_decode"]) if args.old_k1 else None
    variants = {src.stem: build(src, ["bcnn_row_shift", "bcnn_col_shift"])
                for src in args.variant_k2}
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    compare_k2(old_k2, variants, flush)
    compare_k1(old_k1, flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
