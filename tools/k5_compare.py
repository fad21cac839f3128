#!/usr/bin/env python3
"""Time the int8 grouped/depthwise conv kernel K5
(bcnn_tpu_torch/csrc/grouped_int8.cu) on one GPU against an older build
of it and cuDNN's bf16 grouped conv of the same values (channels-last),
at the nine depthwise shapes of MobileNet-v1 at batch 64 (k 3, pad 1,
RELU, int8 out; per shape and per forward, at the launches a forward
makes) and at the grouped shape (8, 256, 26, 26) in 4 groups (BN, LRELU).
Every build runs in this one process, in turns (old, repo, library,
library, repo, old), warm and cold (tools/card_timing.py's cuda_ms and
cold_ms).

    git show 5292da2:bcnn_tpu_torch/csrc/grouped_int8.cu > _checkout/k5_old.cu
    python3 tools/k5_compare.py --old _checkout/k5_old.cu [--sweep] [--ptxas] \
        [--variant _checkout/k5_x.cu ...]

--old takes a source with the first K5's C signature and plan (quads,
rows, pix, staged) and its (k, k, C/G, O) weight layout; it gets its own
copy of a grouped weight. Every output must equal the plain version's
before anything is timed. --variant takes a copy of the repo's source
with something changed (same C signature and plan), timed in turns
beside the repo's build under its file's stem. --sweep times candidate
plans (pixels a strip, lanes a block, threads a block) at each shape and
prints the fastest beside the one plan_grouped_int8 picks. --ptxas prints the compiler's
registers, shared memory and spills for each branch, and counts the
SASS instructions of each branch (cuobjdump) beside its multiply-adds a
thread. Builds go to _checkout/ (gitignored). Needs CUDA and nvcc;
imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bcnn_tpu_torch import kernels  # noqa: E402
from bcnn_tpu_torch.ops import grouped_int8 as k5  # noqa: E402
from bcnn_tpu_torch.types import Activation  # noqa: E402
from benchmark.roofline import PEAK_BYTES, PEAK_OPS  # noqa: E402
from tools.card_timing import (  # noqa: E402
    FLUSH_FLOATS, cold_ms, cuda_ms, gpu_line)

OUT = ROOT / "_checkout" / "k5_compare"
# (n, c, h, w, o, k, stride, pad, groups, bn, act, launches a forward)
SHAPES = [(64, c, hw, hw, c, 3, s, 1, c, None, Activation.RELU, m)
          for c, hw, s, m in [(32, 112, 1, 1), (64, 112, 2, 1),
                              (128, 56, 1, 1), (128, 56, 2, 1),
                              (256, 28, 1, 1), (256, 28, 2, 1),
                              (512, 14, 1, 5), (512, 14, 2, 1),
                              (1024, 7, 1, 1)]]
GROUPED = (8, 256, 26, 26, 256, 3, 1, 1, 4, "unfolded", Activation.LRELU, 1)


def old_plan(n, c, h, w, o, k, stride, pad, groups, sms):
    """The first K5's plan (quads, rows, pix, staged), as its
    ops/grouped_int8.py chose it."""
    oh, ow = k5.out_size(h, w, k, stride, pad)
    m, cg, nq = n * oh * ow, c // groups, -(-o // 4)
    widest = min(64, 1 << (nq - 1).bit_length())
    quads = widest
    while quads > 1 and k * k * cg * 4 * quads > 48 * 1024:
        quads //= 2
    staged = k * k * cg * 4 * quads <= 48 * 1024
    if not staged:
        quads = widest
    rows, tiles_q, pix = 256 // quads, -(-nq // quads), 8
    while pix > 1 and -(-m // (rows * pix)) * tiles_q < 2 * sms:
        pix //= 2
    return quads, rows, pix, int(staged)


def build_old(src: Path) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{src.stem}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                    str(kernels.SRC_DIR), "-shared", "-o", str(so),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bcnn_grouped_int8.argtypes = [p] * 8 + [i] * 12 + [f] + [i] * 4 + [p]
    lib.bcnn_grouped_int8.restype = ctypes.c_int
    return lib


def build_variant(src: Path) -> ctypes.CDLL:
    """A build of a changed copy of the repo's source (same C entry point
    and plan)."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{src.stem}.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                    str(kernels.SRC_DIR), "-shared", "-o", str(so),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.bcnn_grouped_int8.argtypes = \
        kernels.library().bcnn_grouped_int8.argtypes
    lib.bcnn_grouped_int8.restype = ctypes.c_int
    return lib


def sass_ops(src: Path, stem: str, verbose: bool):
    """Compile `src` (with -Xptxas -v when verbose); per kernel its SASS
    opcodes (static counts); and ptxas's report."""
    OUT.mkdir(parents=True, exist_ok=True)
    obj = OUT / f"{stem}.o"
    res = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose
                                                 else []),
         "-I", str(kernels.SRC_DIR), "-c", "-o", str(obj), str(src)],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)",
                                 sass, re.S):
        ops = collections.Counter(
            m.split(".")[0] for m in re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                body))
        ops.pop("NOP", None)
        out[name] = ops
    return out, res.stderr.strip()


def ptxas_report() -> str:
    """ptxas's registers, shared memory and spills a kernel, each
    kernel's SASS instructions by opcode (static counts), then the
    depthwise kernels' int8 hot path alone (the rare exact requantize and
    the fp32 output cut out: all of it straight-line code a thread runs
    once, with the block's weight stage), per multiply-add of a thread's
    strip: 2 pixels x 16 channels x 9 taps = 288."""
    src = kernels.SRC_DIR / "grouped_int8.cu"
    ops_all, report = sass_ops(src, "grouped_int8", True)
    lines = [report]
    for name, ops in ops_all.items():
        lines.append(f"{name}: {sum(ops.values())} instructions; " + ", ".join(
            f"{op} {cnt}" for op, cnt in ops.most_common(14)))
    text = src.read_text()
    marker = "    if (bad) {\n      // a code near a half-integer (rare)"
    int8_out = "  if (p.out_int8) {  // int8 channels-last"
    if marker not in text or int8_out not in text:
        raise RuntimeError("grouped_int8.cu: the depthwise branch's "
                           "markers are gone")
    hot = OUT / "grouped_int8_hot.cu"
    # the check that sets `bad` stays (it flips a bit of the output where
    # the exact decision was)
    hot.write_text(text.replace(marker, marker.replace(
        "(bad) {", "(bad) res[0][0] ^= 1u;\n    if (false) {")).replace(
            int8_out, int8_out.replace("(p.out_int8)",
                                       "(true || p.out_int8)")))
    macs = 2 * 16 * 9
    for name, ops in sass_ops(hot, "grouped_int8_hot", False)[0].items():
        if "ILi0E" not in name:  # kDw = 0 is the first template argument
            continue
        total = sum(ops.values())
        mac_part = ops["IDP"] + ops["PRMT"] + ops["LDS"]
        lines.append(
            f"hot path {name}: {total} instructions, {total / macs:.2f} a "
            f"MAC; IDP {ops['IDP']}, PRMT {ops['PRMT']}, LDS {ops['LDS']}, "
            f"LDG {ops['LDG']} ({mac_part / macs:.2f} a MAC); " + ", ".join(
                f"{op} {cnt}" for op, cnt in ops.most_common(12)))
    return "\n".join(lines)


def make_args(shape, gen):
    """x channels-last, w in K5's layout, the vectors, on the card, d
    scaled so that y spreads over the codes of s_out = 2/127."""
    n, c, h, w, o, k, stride, pad, groups, bn, act, _ = shape
    x = torch.randint(-127, 128, (n, c, h, w), generator=gen,
                      dtype=torch.int8).contiguous(
                          memory_format=torch.channels_last).cuda()
    wt = torch.randint(-127, 128, (o, c // groups, k, k), generator=gen,
                       dtype=torch.int8)
    u = lambda lo, hi: (lo + (hi - lo) * torch.rand(o, generator=gen)  # noqa
                        ).cuda()
    d = u(0.5, 1.5) * (3.0 / (127.0**2 * (c // groups * k * k) ** 0.5))
    kw = dict(act=act, s_out=2.0 / 127)
    if bn:
        kw.update(scale=u(0.8, 1.2))
    if bn == "unfolded":
        kw.update(mean=u(-0.1, 0.1), inv=1 / torch.sqrt(u(0.5, 1.5) + 1e-6))
    return x, wt, d, u(-0.1, 0.1), kw


def sweep_plans(shape):
    n, c, h, w, o, k, stride, pad, groups = shape[:9]
    seen = set()
    dw = k5.k5_branch(c, o, k, stride, groups) == k5.DW
    for s in (2,) if dw else (2, 4):
        for lanes in (1, 2, 4, 8, 16, 32, 64):
            for aim in (64, 128, 256):
                plan = k5.plan_grouped_int8(n, c, h, w, o, k, stride, pad,
                                            groups, s=s, lanes=lanes,
                                            aim=aim)
                if plan not in seen:
                    seen.add(plan)
                    yield plan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--variant", type=Path, action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_compare: CUDA is not available", file=sys.stderr)
        return 1
    print(gpu_line())
    if args.ptxas:
        print(ptxas_report())
    kernels.library()
    old = build_old(args.old) if args.old else None
    variants = {src.stem: build_variant(src) for src in args.variant}
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    gen = torch.Generator().manual_seed(0)
    sms = kernels.sm_count(torch.device("cuda"))
    total: dict[str, list[float]] = {}
    bound_total = 0.0
    for shape in SHAPES + [GROUPED]:
        n, c, h, w, o, k, stride, pad, groups, bn, act, per_fwd = shape
        x, wt, d, bias, kw = make_args(shape, gen)
        wg = k5.grouped_weight(wt).cuda()
        want = k5.grouped_int8_fused_ref(x, wg, d, bias, stride, pad, groups,
                                         **kw)
        fns = {}
        if old is not None:
            # the first K5's layout: (k, k, C/G, O) in memory
            w_old = wt.permute(2, 3, 1, 0).contiguous().cuda()
            y_old = torch.empty_like(want,
                                     memory_format=torch.channels_last)
            plan_o = old_plan(n, c, h, w, o, k, stride, pad, groups, sms)
            ptr = lambda v: None if v is None else v.data_ptr()  # noqa
            bn_i = 0 if not bn else 1 if bn == "folded" else 2
            fns["old"] = lambda: old.bcnn_grouped_int8(
                x.data_ptr(), w_old.data_ptr(), d.data_ptr(),
                ptr(kw.get("scale")), bias.data_ptr(), ptr(kw.get("mean")),
                ptr(kw.get("inv")), y_old.data_ptr(), n, c, h, w, o, k,
                stride, pad, groups, bn_i, k5.FUSED_ACT[act], 1,
                kw["s_out"], *plan_o,
                torch.cuda.current_stream().cuda_stream)
            if fns["old"]() != 0:
                raise RuntimeError(f"old build: launch failed at {shape}")
        fns["repo"] = lambda: k5.grouped_int8_fused(x, wg, d, bias, stride,
                                                    pad, groups, **kw)
        got = fns["repo"]()
        plan = k5.plan_grouped_int8(n, c, h, w, o, k, stride, pad, groups,
                                    k5.alignment(x, wg, d, got))
        y_var = {}
        for key, vlib in variants.items():
            y_var[key] = out = torch.empty_like(got)
            fns[key] = lambda vlib=vlib, out=out: k5.launch(  # noqa: E731
                plan, x, wg, d, bias, stride, pad, groups, act,
                kw.get("scale"), kw.get("mean"), kw.get("inv"), kw["s_out"],
                out, vlib)
            fns[key]()
        xb = x.to(torch.bfloat16)
        wb = wt.cuda().to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        fns["library"] = lambda: F.conv2d(xb, wb, None, stride, pad, 1,
                                          groups)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"repo build: {shape[:9]} differs from the "
                               "plain version")
        if old is not None and not torch.equal(y_old, want):
            raise RuntimeError(f"old build: {shape[:9]} differs from the "
                               "plain version")
        for key, out in y_var.items():
            if not torch.equal(out, want):
                raise RuntimeError(f"{key}: {shape[:9]} differs from the "
                                   "plain version")
        order = list(fns)
        t_w = dict.fromkeys(order, 0.0)
        t_c = dict.fromkeys(order, 0.0)
        for key in order + order[::-1]:
            t_w[key] += cuda_ms(fns[key], iters=50, warmup=5) / 2
            t_c[key] += cold_ms(fns[key], flush) / 2
        nbytes = x.numel() + wt.numel() + got.numel() + 4 * 5 * o
        ops = 2 * got.numel() * (c // groups) * k * k
        bound = 1e3 * max(nbytes / PEAK_BYTES, ops / PEAK_OPS["int8"])
        if shape is not GROUPED:
            bound_total += per_fwd * bound
            for key in order:
                acc = total.setdefault(key, [0.0, 0.0])
                acc[0] += per_fwd * t_w[key]
                acc[1] += per_fwd * t_c[key]
        print(f"{shape[:9]} x{per_fwd}: {nbytes / 1e6:.2f} MB, bound "
              f"{1e3 * bound:.2f} us | warm " + ", ".join(
                  f"{key} {1e3 * v:.1f}" for key, v in t_w.items())
              + " | cold " + ", ".join(f"{key} {1e3 * v:.1f}"
                                       for key, v in t_c.items())
              + f" us | repo {bound / t_c['repo']:.1%} of the bound cold | "
              f"plan {plan.describe()}, {plan.blocks(n)} blocks")
        if args.sweep:
            res = []
            for cand in sweep_plans(shape):
                out = torch.empty_like(got)
                run = lambda cand=cand, out=out: k5.launch(  # noqa: E731
                    cand, x, wg, d, bias, stride, pad, groups, act,
                    kw.get("scale"), kw.get("mean"), kw.get("inv"),
                    kw["s_out"], out)
                run()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise RuntimeError(f"{shape[:9]}: plan {cand} computes "
                                       "another output")
                res.append((cuda_ms(run, iters=20, warmup=5),
                            cold_ms(run, flush, 5), cand))
            res.sort(key=lambda r: r[1])
            rank = [i for i, r in enumerate(res) if r[2] == plan]
            print(f"    {len(res)} plans; plan_grouped_int8's is "
                  + (f"#{rank[0] + 1} cold" if rank else "not among them")
                  + "; fastest cold (warm/cold us): " + "; ".join(
                      f"{r[2].describe()} {1e3 * r[0]:.1f}/{1e3 * r[1]:.1f}"
                      for r in res[:4]))
    print(f"per int8 MobileNet-v1 forward (13 launches, batch 64), bound "
          f"{bound_total:.4f} ms; ms [warm, cold]: "
          + ", ".join(f"{key} [{v[0]:.4f}, {v[1]:.4f}]"
                      for key, v in total.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
