"""The readings the limits of `correct` are set from, at a cell's own
size, on the chip:

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

For each seed it builds the cell's inputs and program as a run does and
prints, for as many requests as a run checks:

- sound: the program's `heads`, `dets` and `select` (the numbers a run
  compares);
  and, to read them by, the fewest candidates an image has above the
  threshold and the most detections an image kept;
- control: the same numbers with the next lower precision in the
  program's place. heads: an int8 cell's reference at int4 (the
  program has no int4 path), a bf16 cell's program on its own int8 path
  (the port's absmax PTQ); dets: the detections of the program's heads
  decoded with every step rounded to bf16 (an fp32 decode) or to
  float8 e4m3 (a bf16 decode).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import check, harness, traffic  # noqa: E402
from benchmark.program import Served, build_kernels  # noqa: E402

LOWER = {"int8": torch.bfloat16, "bf16": torch.float8_e4m3fn}


def readings(name: str, seed: int, device="cuda") -> dict:
    cell = harness.load_cell(name)
    prec, size = cell["precision"], cell["cfg"]["input_size"]
    ref = cell["ref"]
    layers, weights, calib, pool = harness.make_inputs(cell, seed, device)
    sched = traffic.Schedule(cell, seed)
    xs = [pool[sched.input_of(i)] for i in range(cell["check"]["requests"])]
    params = [p for _, p in ref.heads(layers)]
    d = cell["detect"]
    served = Served(cell["cfg"], cell, weights, calib.cpu().numpy(), device)
    outs = [served.detect(x) for x in xs]
    heads = [served.heads(x) for x in xs]
    served.free()
    if prec == "bf16":
        low = Served(cell["cfg"], dict(cell, precision="int8"), weights,
                     calib.cpu().numpy(), device)
        low_heads = [low.heads(x) for x in xs]
        low.free()
    quant = ref.calibrate(layers, weights, calib) if prec == "int8" \
        else None
    quant4 = ref.calibrate(layers, weights, calib, bits=4) \
        if prec == "int8" else None
    block = cell["check"].get("block", 16)
    out = {"seed": seed, "heads": 0.0, "dets": 0.0, "select": 0,
           "control_heads": 0.0, "control_dets": 0.0, "control_select": 0}
    for i, x in enumerate(xs):
        xt = torch.as_tensor(x, device=device)
        rh = check.ref_heads(ref, layers, weights, xt, prec, quant, block)
        ph = [h.to(device) for h in heads[i]]
        out["heads"] = check.worst(out["heads"], check.head_gap(ph, rh))
        g = lambda srv: check.det_numbers(  # noqa: E731
            ref, srv, ph, params, size, size, d["max_dets"], d["thresh"],
            cell["check"]["margins"])
        gap, faults = g(outs[i])
        rp = torch.sigmoid(ref.decode(ph, params, size, size)[1])
        out["valid_least"] = min(out.get("valid_least", 1 << 30),
                                 int((rp > d["thresh"]).sum(1).min()))
        out["kept_most"] = max(out.get("kept_most", 0),
                               int((outs[i][2] > 0).sum(1).max()))
        out["dets"] = check.worst(out["dets"], gap)
        out["select"] += faults
        if prec == "int8":
            low_h = check.ref_heads(ref, layers, weights, xt, prec, quant4,
                                    block)
        else:
            low_h = [h.to(device) for h in low_heads[i]]
        out["control_heads"] = check.worst(out["control_heads"],
                                           check.head_gap(low_h, rh))
        low_det = ref.detections(ph, params, size, size, d["max_dets"],
                                 d["thresh"], LOWER[prec])
        gap, faults = g(low_det)
        out["control_dets"] = check.worst(out["control_dets"], gap)
        out["control_select"] += faults
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args()
    build_kernels("cuda")
    for s in a.seeds:
        print(json.dumps({"workload": a.workload, **readings(a.workload, s)}),
              flush=True)


if __name__ == "__main__":
    main()
