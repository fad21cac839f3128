#!/usr/bin/env python3
"""Time the int8 conv kernel K4 (bcnn_tpu_torch/csrc/conv_int8.cu) on one
GPU against an older build of it, at the 13 convs of YOLOv3-tiny 416 at
batch 8 in the form the int8 path runs them (BN, LRELU and int8 out on
the trunk; linear fp32 out on the two heads), beside the bound and
cuDNN's bf16 conv of the same values. Every build runs in this one
process, in turns (old, repo, library, library, repo, old), warm and
cold (tools/card_timing.py's cuda_ms and cold_ms).

    git show <commit>:bcnn_tpu_torch/csrc/conv_int8.cu > _checkout/k4_old.cu
    python3 tools/k4_compare.py --old _checkout/k4_old.cu [--sweep] \\
        [--ptxas] [--variant _checkout/k4_x.cu ...]

--old takes a source with the first K4's C signature (x and w NCHW, no
plan): it gets NCHW copies of the inputs, the repo's build channels-last
x and the (O, k, k, C) weight. --variant takes a copy of the repo's
source with something changed (same C signature and plan), timed in
turns beside the repo's build under its file's stem. Both outputs must equal the plain version's
before anything is timed. --sweep times every tile shape and split of K
at each shape and prints the fastest beside plan_conv_int8's. --ptxas
prints the compiler's registers, shared memory and spills a kernel.
Builds go to _checkout/ (gitignored). Needs CUDA and nvcc; imports no
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bcnn_tpu_torch import kernels  # noqa: E402
from bcnn_tpu_torch.models import yolov3_tiny  # noqa: E402
from bcnn_tpu_torch.ops import conv_int8 as k4  # noqa: E402
from bcnn_tpu_torch.types import Activation  # noqa: E402
from benchmark.roofline import PEAK_BYTES, PEAK_OPS  # noqa: E402
from tools.card_timing import (  # noqa: E402
    FLUSH_FLOATS, cold_ms, cuda_ms, gpu_line)

OUT = ROOT / "_checkout" / "k4_compare"


def path_shapes(batch=8, size=416, classes=80):
    """(name, (n, c, h, w, o, k, stride, pad), int8 out) of the 13 convs;
    the trunk's carry BN and LRELU, the heads neither."""
    net = yolov3_tiny(batch, size, size, classes)
    out = []
    for node in net.nodes:
        if node.type.name != "CONV2D":
            continue
        s, d, p = net.tensors[node.src[0]], net.tensors[node.dst[0]], node.param
        out.append((d.name, (s.n, s.c, s.h, s.w, d.c, p["size"], p["stride"],
                             p["pad"]), bool(p["batch_norm"])))
    return out


def build_old(src: Path) -> ctypes.CDLL:
    """A build of the first K4's source (x and w NCHW, no plan)."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{src.stem}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bcnn_conv_int8.argtypes = [p] * 8 + [i] * 11 + [f, p]
    lib.bcnn_conv_int8.restype = ctypes.c_int
    return lib


def build_variant(src: Path) -> ctypes.CDLL:
    """A build of a changed copy of the repo's source (same C entry
    point and plan)."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{src.stem}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.bcnn_conv_int8.argtypes = kernels.library().bcnn_conv_int8.argtypes
    lib.bcnn_conv_int8.restype = ctypes.c_int
    return lib


def ptxas_report() -> str:
    OUT.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(OUT / "conv_int8.o"),
         str(kernels.SRC_DIR / "conv_int8.cu")],
        capture_output=True, text=True, check=True)
    return res.stderr.strip()


def make_args(shape, trunk, gen):
    """NCHW int8 x and w on the card, the epilogue's vectors and kwargs."""
    n, c, h, w, o, k, stride, pad = shape
    x = torch.randint(-127, 128, (n, c, h, w), generator=gen,
                      dtype=torch.int8).cuda()
    wt = torch.randint(-127, 128, (o, c, k, k), generator=gen,
                       dtype=torch.int8).cuda()
    u = lambda lo, hi: (lo + (hi - lo) * torch.rand(o, generator=gen)  # noqa
                        ).cuda()
    d = u(0.5, 1.5) * (3.0 / (127.0**2 * (c * k * k) ** 0.5))
    kw = dict(act=Activation.LRELU if trunk else Activation.NONE,
              s_out=2.0 / 127 if trunk else None)
    if trunk:
        kw.update(scale=u(0.8, 1.2), mean=u(-0.1, 0.1),
                  inv=1 / torch.sqrt(u(0.5, 1.5) + 1e-6))
    return x, wt, d, u(-0.1, 0.1), kw


def launch_plan(lib, x, w, d, bias, stride, pad, kw, out, plan):
    """The repo's kernel on an explicit plan (for --sweep)."""
    n, c, h, wd = x.shape
    o, _, k, _ = w.shape
    ws = counters = None
    if plan.splits > 1:
        ws = torch.empty(plan.workspace_ints, dtype=torch.int32,
                         device=x.device)
        counters = torch.empty(plan.tiles_m * plan.tiles_n,
                               dtype=torch.int32, device=x.device)
    s_out = kw.get("s_out")
    bn = 0 if kw.get("scale") is None else 1 if kw.get("mean") is None else 2
    ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
    return lib.bcnn_conv_int8(
        x.data_ptr(), w.data_ptr(), d.data_ptr(), ptr(kw.get("scale")),
        bias.data_ptr(), ptr(kw.get("mean")), ptr(kw.get("inv")),
        out.data_ptr(), n, c, h, wd, o, k, stride, pad, bn,
        k4.FUSED_ACT[kw["act"]], int(s_out is not None),
        0.0 if s_out is None else float(s_out), plan.cfg, plan.splits,
        plan.split_steps, ptr(ws), ptr(counters),
        torch.cuda.current_stream().cuda_stream)


def sweep_plans(shape):
    n, c, h, w, o, k, stride, pad = shape
    oh, ow = k4.out_size(h, w, k, stride, pad)
    m, steps = n * oh * ow, -(-c * k * k // k4.STAGE_K)
    for cfg, (bm, bn, wm, wn) in enumerate(k4.CONFIGS):
        if bn < min(o, 64) // 2:
            continue  # far too narrow: a tile column of 16 for O = 1024
        tm, tn = -(-m // bm), -(-o // bn)
        seen = set()
        for want in (1, 2, 3, 4, 6, 8, 12, 16):
            ss = -(-steps // min(want, steps))
            sp = -(-steps // ss)
            if sp in seen:
                continue
            seen.add(sp)
            yield k4.ConvPlan(cfg, bm, bn, 32 * wm * wn, tm, tn, sp, ss,
                              steps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--variant", type=Path, action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_compare: CUDA is not available", file=sys.stderr)
        return 1
    print(gpu_line())
    if args.ptxas:
        print(ptxas_report())
    lib = kernels.library()
    old = build_old(args.old) if args.old else None
    variants = {src.stem: build_variant(src) for src in args.variant}
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    gen = torch.Generator().manual_seed(0)
    sms = kernels.sm_count(torch.device("cuda"))
    total: dict[str, list[float]] = {}
    bound_total = 0.0
    cl = torch.channels_last
    for name, shape, trunk in path_shapes():
        n, c, h, w, o, k, stride, pad = shape
        x, wt, d, bias, kw = make_args(shape, trunk, gen)
        xc, wc = x.contiguous(memory_format=cl), k4.channels_last_weight(wt)
        want = k4.conv_int8_fused_ref(x, wt, d, bias, stride, pad, **kw)
        fns = {}
        if old is not None:
            y_old = torch.empty_like(want, memory_format=torch.contiguous_format)
            s_out = kw.get("s_out")
            bn = 0 if not trunk else 2
            ptr = lambda v: None if v is None else v.data_ptr()  # noqa
            fns["old"] = lambda: old.bcnn_conv_int8(
                x.data_ptr(), wt.data_ptr(), d.data_ptr(),
                ptr(kw.get("scale")), bias.data_ptr(), ptr(kw.get("mean")),
                ptr(kw.get("inv")), y_old.data_ptr(), n, c, h, w, o, k,
                stride, pad, bn, k4.FUSED_ACT[kw["act"]],
                int(s_out is not None), 0.0 if s_out is None else s_out,
                torch.cuda.current_stream().cuda_stream)
            if fns["old"]() != 0:
                raise RuntimeError(f"old build: launch failed at {name}")
        fns["repo"] = lambda: k4.conv_int8_fused(xc, wc, d, bias, stride,
                                                 pad, **kw)
        got = fns["repo"]()
        plan = k4.plan_conv_int8(n, c, h, w, o, k, stride, pad, sms)
        y_var = {}
        for key, vlib in variants.items():
            y_var[key] = out = torch.empty_like(got)
            fns[key] = lambda vlib=vlib, out=out: launch_plan(  # noqa
                vlib, xc, wc, d, bias, stride, pad, kw, out, plan)
            if fns[key]() != 0:
                raise RuntimeError(f"{key}: launch failed at {name}")
        xb, wb = x.to(torch.bfloat16), wt.to(torch.bfloat16)
        fns["library"] = lambda: F.conv2d(xb, wb, None, stride, pad)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"repo build: {name} differs from the plain "
                               "version")
        if old is not None and not torch.equal(y_old, want):
            raise RuntimeError(f"old build: {name} differs from the plain "
                               "version")
        for key, out in y_var.items():
            if not torch.equal(out, want):
                raise RuntimeError(f"{key}: {name} differs from the plain "
                                   "version")
        order = list(fns)
        t_w = dict.fromkeys(order, 0.0)
        t_c = dict.fromkeys(order, 0.0)
        for key in order + order[::-1]:
            t_w[key] += cuda_ms(fns[key], iters=50, warmup=5) / 2
            t_c[key] += cold_ms(fns[key], flush) / 2
        for key in order:
            acc = total.setdefault(key, [0.0, 0.0])
            acc[0] += t_w[key]
            acc[1] += t_c[key]
        nbytes = x.numel() + wt.numel() + got.numel() * got.element_size()
        ops = 2 * got.shape[0] * got.shape[2] * got.shape[3] * o * c * k * k
        bound = 1e3 * max(nbytes / PEAK_BYTES, ops / PEAK_OPS["int8"])
        bound_total += bound
        print(f"{name} {shape}: bound {1e3 * bound:.2f} us "
              f"({'bytes' if nbytes / PEAK_BYTES >= ops / PEAK_OPS["int8"] else 'operations'})"
              " | warm " + ", ".join(f"{key} {1e3 * v:.1f}"
                                     for key, v in t_w.items())
              + " | cold " + ", ".join(f"{key} {1e3 * v:.1f}"
                                       for key, v in t_c.items())
              + f" us | repo {bound / t_w['repo']:.1%} of the bound warm"
              f" | plan {plan.bm}x{plan.bn} split {plan.splits}x"
              f"{plan.split_steps} steps, {plan.blocks} blocks")
        if args.sweep:
            res = []
            for cand in sweep_plans(shape):
                out = torch.empty_like(got)
                run = lambda cand=cand, out=out: launch_plan(  # noqa: E731
                    lib, xc, wc, d, bias, stride, pad, kw, out, cand)
                if run() != 0:
                    print(f"    {name}: plan {cand} refused")
                    continue
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise RuntimeError(f"{name}: plan {cand} computes "
                                       "another output")
                res.append((cuda_ms(run, iters=20, warmup=5),
                            cold_ms(run, flush, 5), cand))
            res.sort(key=lambda r: r[0])
            rank = [i for i, r in enumerate(res) if r[2] == plan]
            print(f"    {len(res)} plans; plan_conv_int8's is "
                  + (f"#{rank[0] + 1}" if rank else "not among them")
                  + "; fastest warm: " + "; ".join(
                      f"{r[2].bm}x{r[2].bn} split {r[2].splits} "
                      f"{1e3 * r[0]:.1f}/{1e3 * r[1]:.1f} us"
                      for r in res[:3]))
    print(f"per YOLOv3-tiny 416 int8 request (13 launches, batch 8), bound "
          f"{bound_total:.4f} ms; ms [warm, cold]: "
          + ", ".join(f"{key} [{v[0]:.4f}, {v[1]:.4f}]"
                      for key, v in total.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
