#!/usr/bin/env python3
"""Time the depthwise kernel K3 (bcnn_tpu_torch/csrc/depthwise.cu) on one
GPU against other builds of it, and against every candidate tile plan,
at the nine depthwise shapes of MobileNet-v1 at batch 64 (k 3, pad 1,
ReLU). Every build runs in this one process, in turns (A, B, ..., B,
A), warm and cold (tools/card_timing.py's cuda_ms and cold_ms).

    git show <commit>:bcnn_tpu_torch/csrc/depthwise.cu > _checkout/k3_old.cu
    python3 tools/k3_compare.py --old _checkout/k3_old.cu \\
        [--variant other.cu ...] [--sweep]

--old takes a source with the first C signature (no tile plan);
--variant takes sources with the repo's signature, each run on the
repo's plan. Every output must equal the plain version's. --sweep times
each candidate plan (whole planes g at a time or bands of 7-row strips,
stages of up to 48 KB, a ring of 2 or 3, three blocks an SM) and prints
the fastest beside the one plan_tiles picks. Builds go to _checkout/
(gitignored). Needs CUDA and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bcnn_tpu_torch import kernels  # noqa: E402
from bcnn_tpu_torch.ops import depthwise as dw  # noqa: E402
from bcnn_tpu_torch.types import Activation  # noqa: E402
from benchmark.roofline import PEAK_BYTES  # noqa: E402
from tools.card_timing import (  # noqa: E402
    FLUSH_FLOATS, cold_ms, cuda_ms, gpu_line)

OUT = ROOT / "_checkout" / "k3_compare"
# (n, c, h, w, stride, launches a forward)
SHAPES = [(64, 32, 112, 112, 1, 1), (64, 64, 112, 112, 2, 1),
          (64, 128, 56, 56, 1, 1), (64, 128, 56, 56, 2, 1),
          (64, 256, 28, 28, 1, 1), (64, 256, 28, 28, 2, 1),
          (64, 512, 14, 14, 1, 5), (64, 512, 14, 14, 2, 1),
          (64, 1024, 7, 7, 1, 1)]
RELU = 1


def build(src: Path, argtypes) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{src.stem}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.bcnn_depthwise.argtypes = argtypes
    lib.bcnn_depthwise.restype = ctypes.c_int
    return lib


def sweep_plans(n, c, h, w, s):
    """Every candidate plan of a shape (the kinds plan_tiles chooses
    among, at a wider range of sizes)."""
    oh = (h - 1) // s + 1
    cands = [(g, oh, 1, g * h * w) for g in range(1, 12288 // (h * w) + 1)]
    cands += [(1, th, -(-oh // th), min(h, (th - 1) * s + 3) * w)
              for th in range(7, oh, 7)
              if min(h, (th - 1) * s + 3) * w <= 12288]
    for (g, th, tiles_h, length), stages in itertools.product(cands, (2, 3)):
        stage = -(-(length + 3) // 4) * 4
        tiles = -(-(n * c) // g) * tiles_h
        yield dw.TilePlan(g, th, tiles_h, tiles, 7, -(-th // 7), stages,
                          stage, min(tiles, 132 * dw.BLOCKS_PER_SM))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path)
    ap.add_argument("--variant", type=Path, action="append", default=[])
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_compare: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    print(gpu_line())
    lib = kernels.library()
    p, i = ctypes.c_void_p, ctypes.c_int
    old = build(args.old, [p] * 4 + [i] * 8 + [p]) if args.old else None
    variants = {src.stem: build(src, lib.bcnn_depthwise.argtypes)
                for src in args.variant}
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    gen = torch.Generator().manual_seed(0)
    total: dict[str, list[float]] = {}
    for n, c, h, w, s, per_fwd in SHAPES:
        x = torch.randn(n, c, h, w, generator=gen).cuda()
        wt = (torch.randn(c, 1, 3, 3, generator=gen) * (2 / 9) ** 0.5).cuda()
        b = (0.2 * torch.rand(c, generator=gen) - 0.1).cuda()
        want = dw.depthwise_fused_ref(x, wt, b, s, 1, Activation.RELU)
        st = torch.cuda.current_stream().cuda_stream
        plan = dw.plan_tiles(n, c, h, w, 3, s, 1)
        fns, outs = {}, {}
        if old is not None:
            outs["old"] = torch.empty_like(want)
            fns["old"] = lambda y=outs["old"]: old.bcnn_depthwise(
                x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(), n, c,
                h, w, 3, s, 1, RELU, st)
        fns["repo"] = lambda: dw.depthwise_fused(x, wt, b, s, 1,
                                                 Activation.RELU)
        for name, vlib in variants.items():
            outs[name] = torch.empty_like(want)
            fns[name] = lambda L=vlib, y=outs[name]: L.bcnn_depthwise(
                x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(), n, c,
                h, w, 3, s, 1, RELU, *plan, st)
        fns["library"] = lambda: F.conv2d(x, wt, b, s, 1, 1, c)
        outs["repo"] = fns["repo"]()
        for name in outs:
            if name != "repo" and fns[name]() != 0:
                raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        for name, y in outs.items():
            if not torch.equal(y, want):
                raise RuntimeError(f"{name} differs from the plain version")
        order = list(fns)
        t_w = dict.fromkeys(order, 0.0)
        t_c = dict.fromkeys(order, 0.0)
        for name in order + order[::-1]:
            t_w[name] += cuda_ms(fns[name], iters=30, warmup=3) / 2
            t_c[name] += cold_ms(fns[name], flush) / 2
        for name in order:
            acc = total.setdefault(name, [0.0, 0.0])
            acc[0] += per_fwd * t_w[name]
            acc[1] += per_fwd * t_c[name]
        bound = 4 * (x.numel() + want.numel()) / PEAK_BYTES * 1e6
        print(f"{(n, c, h, w)} s{s}, bound {bound:.1f} us | warm "
              + ", ".join(f"{k} {1e3 * v:.1f}" for k, v in t_w.items())
              + " | cold "
              + ", ".join(f"{k} {1e3 * v:.1f}" for k, v in t_c.items())
              + f" us | plan {tuple(plan)}")
    print("per forward (13 launches), ms [warm, cold]: "
          + ", ".join(f"{k} [{v[0]:.4f}, {v[1]:.4f}]"
                      for k, v in total.items()))
    if not args.sweep:
        return 0
    for n, c, h, w, s, _ in SHAPES:
        x = torch.randn(n, c, h, w, device="cuda")
        wt = torch.randn(c, 1, 3, 3, device="cuda")
        b = torch.randn(c, device="cuda")
        want = dw.depthwise_fused(x, wt, b, s, 1)
        y = torch.empty_like(want)
        st = torch.cuda.current_stream().cuda_stream
        res = []
        for plan in sweep_plans(n, c, h, w, s):
            def run(plan=plan):
                return lib.bcnn_depthwise(
                    x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(),
                    n, c, h, w, 3, s, 1, 0, *plan, st)
            if run() != 0:
                raise RuntimeError(f"plan {plan} refused")
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise RuntimeError(f"plan {plan} computes another output")
            res.append((cold_ms(run, flush, 5),
                        cuda_ms(run, iters=10, warmup=3), plan))
        res.sort(key=lambda r: r[0])
        mine = dw.plan_tiles(n, c, h, w, 3, s, 1)
        mine_ms = [(k + 1, r[0]) for k, r in enumerate(res) if r[2] == mine]
        print(f"{(n, c, h, w)} s{s}: {len(res)} plans; plan_tiles' plan "
              + (f"is #{mine_ms[0][0]}, cold {1e3 * mine_ms[0][1]:.1f} us"
                 if mine_ms else f"{tuple(mine)} is not among them")
              + "; fastest:")
        for r in res[:3]:
            print(f"    cold {1e3 * r[0]:.1f} warm {1e3 * r[1]:.1f} us "
                  f"{tuple(r[2])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
