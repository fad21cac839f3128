#!/usr/bin/env python3
"""The upload of a host batch to the card, two ways, at the benchmark's
two batch sizes (64 frames of 3x416x416 and of 3x608x608 fp32, 132.9 and
283.9 MB, pageable numpy as the benchmark's clients hold them):

  - `pageable`: `torch.as_tensor(x, dtype=torch.float32, device="cuda")`,
    the upload before the pinned ring;
  - `ring`: `bcnn_tpu_torch.upload.Uploader`, the session's path, over
    chunk sizes of 4, 8 and 16 MB, 2 and 3 slots, and 1, 2, 4 and all of
    torch's intra-op threads (`torch.set_num_threads`); each setting gets
    a ring of its own (the module's constants are set before it is made);
  - `host`: the ring's host copies alone, the batch copied chunk by
    chunk into one pinned slot of the module's chunk size, no copy to
    the card: what the ring's time would be if the card's copies were
    free.

Each upload is timed the way `Session._input` ends: the host clock until
the call returns (`return_ms`), then until a `torch.cuda.synchronize()`
(`sync_ms`); `device_ms` is a CUDA-event span around it. `pinned` times
one copy of the whole batch from a pinned tensor, the link's own rate.
A row gives the median (and the range) over `--repeats` uploads that
cycle through 4 distinct batches, after 2 to warm up.

    python3 tools/upload_compare.py [--repeats 10] [--out FILE]

Prints one JSON line a row and the card's name and power limit, the
CPUs this process may run on and torch's thread count; with --out the
rows go to FILE too. Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bcnn_tpu_torch import upload  # noqa: E402

SIZES = (416, 608)
BATCH = 64
CHUNK_MB = (4, 8, 16)
SLOTS = (2, 3)
POOL = 4


def card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return res.stdout.strip() or f"not read ({res.stderr.strip()[:80]})"


def timed(fn, xs, repeats):
    """{return_ms, sync_ms, device_ms}: median, least and most of
    `repeats` calls of fn(x), x cycling through xs, after 2 warm-up."""
    rows = []
    for i in range(repeats + 2):
        x = xs[i % len(xs)]
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        t0 = time.perf_counter()
        fn(x)
        t1 = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= 2:
            rows.append((1e3 * (t1 - t0), 1e3 * (t2 - t0),
                         start.elapsed_time(end)))
    out = {}
    for k, name in enumerate(("return_ms", "sync_ms", "device_ms")):
        v = [r[k] for r in rows]
        out[name] = [round(statistics.median(v), 3), round(min(v), 3),
                     round(max(v), 3)]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("upload_compare: needs a CUDA device")
    dev = torch.device("cuda")
    every = torch.get_num_threads()
    head = {"card": card(), "affinity": len(os.sched_getaffinity(0)),
            "torch_threads": every, "torch": torch.__version__}
    print(json.dumps(head), flush=True)
    lines = [head]
    threads = sorted({1, 2, 4, every})
    keep = (upload.CHUNK_BYTES, upload.SLOTS)
    try:
        for size in SIZES:
            gen = torch.Generator(device=dev).manual_seed(size)
            xs = [torch.rand((BATCH, 3, size, size), generator=gen,
                             device=dev).cpu().numpy() for _ in range(POOL)]
            mb = xs[0].nbytes / 1e6
            pinned = torch.from_numpy(xs[0]).pin_memory()
            slot = torch.empty(keep[0] // 4, pin_memory=True)

            def host_copy(x, slot=slot):
                src = torch.from_numpy(x).view(-1)
                for a, b in upload.chunks(src.numel(), slot.numel()):
                    slot[:b - a].copy_(src[a:b])
            rows = [("pinned", None, None, every,
                     lambda x: pinned.to(dev, non_blocking=True))]
            for t in threads:
                rows.append(("pageable", None, None, t,
                             lambda x: torch.as_tensor(
                                 x, dtype=torch.float32, device=dev)))
                rows += [("ring", c, s, t, upload.Uploader(dev))
                         for c in CHUNK_MB for s in SLOTS]
                rows.append(("host", None, None, t, host_copy))
            for path, c, s, t, fn in rows:
                # the ring reads them when it is made, at its first call
                upload.CHUNK_BYTES, upload.SLOTS = (
                    keep if c is None else (c << 20, s))
                torch.set_num_threads(t)
                line = {"size": size, "mb": round(mb, 1), "path": path,
                        "chunk_mb": c, "slots": s, "threads": t,
                        **timed(fn, xs, args.repeats)}
                line["gb_s"] = round(mb / line["sync_ms"][0], 2)
                print(json.dumps(line), flush=True)
                lines.append(line)
            del xs, pinned, slot, rows
    finally:
        upload.CHUNK_BYTES, upload.SLOTS = keep
        torch.set_num_threads(every)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(v) + "\n"
                                          for v in lines))


if __name__ == "__main__":
    main()
