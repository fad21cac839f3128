"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up the cell (seeded weights and inputs, the port's session, warm-up
of the cell's shapes), measures for --seconds, checks the timed outputs
against the plain reference, and prints one JSON line as the last line
of standard output: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device,
breakdown (--trace 1) and check (each number compared with its limit).
The numbers compared are also the last lines of standard error.

Needs a CUDA device: without one, or with fewer than the cell asks
for, it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from benchmark import harness

    chips = harness.load_cell(a.workload)["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s), the "
              f"machine has {have}", file=sys.stderr)
        return 2
    try:
        out = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                               T_START)
    except Exception:
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
