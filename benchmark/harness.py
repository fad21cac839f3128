"""One run of one cell: set-up, the measured window, the check, the
result line.

Everything a cell, a configuration or a metric needs is found by name:
`benchmark/workloads/<cell>.json`, `benchmark/configs/<config>.json`
(and the frozen cfg and the plain reference it names),
`benchmark/metrics/<metric>.py`, and the cell's metrics in
`BENCHMARK.json` at the checkout's root.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import check, roofline, trace, traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bcnn_tpu")

# What a configuration's plain reference provides: the module
# `benchmark/reference/<name>.py` that its `"reference"` key names. It
# imports nothing of the program under test.
#
# - the layer list: `build(cfg_path, size)` the layers of the cfg at a
#   square input (each with `shape` and `in_shape`, (C, H, W) of its
#   output and of its first source, and `opts`, the cfg's options);
#   `conv_layers(layers)` the convs' indices in cfg order;
#   `conv_ops(layers, i, batch)` conv i's operations (2 x multiply-adds);
#   `heads(layers)` (source layer, params) of each detection head;
# - `make_weights(layers, seed, device)`: seeded weights, one dict a conv;
# - `forward(layers, weights, x, quant)`: the raw heads of x, in float32
#   (quant None) or by the integer scheme;
# - the integer scheme: `calibrate(layers, weights, calib, bits=8)` a
#   `Quant` (with `flow`, the tensors that flow as codes);
#   `watch_tensors(layers)` the tensors that get a calibrated scale;
# - the decode and the rule: `decode(heads, params, net_w, net_h)` every
#   candidate (boxes, objectness logits, class logits);
#   `detections(heads, params, net_w, net_h, max_dets, thresh, dtype)` a
#   detection request's output; `NMS_THRESH`, the rule's IoU limit.
REFERENCE = ("build", "conv_layers", "conv_ops", "heads", "make_weights",
             "forward", "calibrate", "Quant", "watch_tensors", "decode",
             "detections", "NMS_THRESH")


def load_reference(config: str, name) -> ModuleType:
    """The plain reference that configuration `config` names."""
    if not (isinstance(name, str) and name.isidentifier()
            and (HERE / "reference" / f"{name}.py").is_file()):
        raise ValueError(f"configuration {config!r}: reference {name!r} is "
                         "not an identifier <name> with a "
                         "benchmark/reference/<name>.py")
    ref = importlib.import_module(f"benchmark.reference.{name}")
    missing = [n for n in REFERENCE if not hasattr(ref, n)]
    if missing:
        raise ValueError(f"configuration {config!r}: reference {name!r} "
                         f"lacks {', '.join(missing)}")
    return ref


def load_cell(name: str) -> Dict:
    """The cell's workload, with its configuration under "cfg" and the
    configuration's plain reference under "ref"."""
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    config = cell["config"]
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    if "reference" not in cfg:
        raise ValueError(f"configuration {config!r} names no reference")
    cfg["cfg_path"] = str(HERE / "configs" / cfg["cfg"])
    cell["name"], cell["cfg"] = name, cfg
    cell["ref"] = load_reference(config, cfg["reference"])
    return cell


def cell_metrics(name: str, bench: Dict, traced: bool) -> List[str]:
    """The names of the metrics a run of the cell reports: its end-to-end
    ones, or with the trace its per-layer ones."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not traced:
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e
                             else [])]


def load_reader(metric: str) -> Callable:
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bm_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What the metric readers read."""

    cell: Dict
    setup_s: float
    requests: List[Dict] = field(default_factory=list)  # start/end/images
    window: tuple = (0.0, 0.0)  # host clock
    trace: Optional[trace.Trace] = None
    traced: List[Dict] = field(default_factory=list)  # the traced requests
    ops_per_request: float = 0.0
    peak_ops: float = 0.0
    k4_bound_s: Optional[float] = None  # a request's int8 convs
    k4_launches: int = 0  # a request's


def make_inputs(cell: Dict, seed: int, device):
    """(weights, calibration batch, input pool) from the seed, made on
    the device in a few calls; the pool is copied to pageable host
    memory, where a client's frames are."""
    cfg, ref = cell["cfg"], cell["ref"]
    size = cfg["input_size"]
    layers = ref.build(cfg["cfg_path"], size)
    weights = ref.make_weights(layers, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x1A9E)
    calib = torch.rand((cell.get("calib_images", 4), 3, size, size),
                       generator=gen, device=device)
    pool = [torch.rand((cell["batch"], 3, size, size), generator=gen,
                       device=device).cpu().numpy()
            for _ in range(cell["pool"])]
    return layers, weights, calib, pool


def serve_window(served, pool, sched: traffic.Schedule, seconds: float,
                 tracer: trace.Tracer) -> Dict:
    """The measured window: one client's requests, each sent when the
    last one's detections are on the host, until the window's time is
    up."""
    reqs, outs, failed = [], [], 0
    gc.collect()  # what set-up left behind; the collector stays on
    with tracer:
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            start = time.perf_counter()
            x = pool[sched.input_of(i)]
            try:
                with tracer.span():
                    out = served.detect(x)
            except Exception as e:  # counted, and the run is not correct
                print(f"request {i}: {type(e).__name__}: {e}",
                      file=sys.stderr)
                failed += 1
                out = None
            end = time.perf_counter()
            reqs.append({"start": start, "end": end, "images": x.shape[0],
                         "input": sched.input_of(i)})
            outs.append(out)
            tracer.step()
            i += 1
    return {"requests": reqs, "outputs": outs, "failed": failed,
            "window": (t0, reqs[-1]["end"])}


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             t_start: float, device="cuda",
             served_factory: Optional[Callable] = None,
             bench: Optional[Dict] = None) -> Dict:
    """One run; returns the result line's object. served_factory (the
    tests) stands in for `program.Served`."""
    cell = load_cell(name)
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    names = cell_metrics(name, bench, traced)
    readers = {m: load_reader(m) for m in names}
    cfg = cell["cfg"]
    note = lambda what: print(f"bm: {what} at {time.perf_counter() - t_start:.3f} s",  # noqa: E731
                              file=sys.stderr, flush=True)
    note("imported")
    layers, weights, calib, pool = make_inputs(cell, seed, device)
    note("inputs made")
    if served_factory is None:
        from benchmark import program

        program.build_kernels(device)
        served_factory = program.Served
        note("kernels built")
    served = served_factory(cfg, cell, weights, calib.cpu().numpy(), device)
    note("program built")
    for i in range(cell.get("warmup", 2)):
        served.detect(pool[i % len(pool)])
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    sync()
    sched = traffic.Schedule(cell, seed)
    tracer = trace.Tracer(traced, cell.get("trace_skip", 2),
                          cell.get("trace_requests", 8))
    setup_s = time.perf_counter() - t_start
    note("set up")
    win = serve_window(served, pool, sched, seconds, tracer)
    svc = [(r["end"] - r["start"]) * 1e3 for r in win["requests"]]
    note(f"window closed, {len(svc)} requests, service ms p50 "
         f"{np.percentile(svc, 50):.3f} p90 {np.percentile(svc, 90):.3f} "
         f"max {max(svc):.3f}")
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)

    # -- the check, after the window ---------------------------------- #
    reqs, outs = win["requests"], win["outputs"]
    ok_idx = [i for i, o in enumerate(outs) if o is not None]
    chk = cell["check"]
    picked = [ok_idx[j] for j in check.sample(len(ok_idx), chk["requests"],
                                             seed)] if ok_idx else []
    xs = [pool[reqs[i]["input"]] for i in picked]
    prog_heads = [served.heads(x) for x in xs]
    served.free()
    del served
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = check_numbers(cell, layers, weights, calib, xs,
                            [outs[i] for i in picked], prog_heads)
    note("checked")
    limits = chk["limits"]
    correct = bool(picked) and win["failed"] == 0 and check.judge(
        numbers, limits)

    # -- the metrics --------------------------------------------------- #
    batch, ref = cell["batch"], cell["ref"]
    run = Run(cell, setup_s, reqs, win["window"])
    run.ops_per_request = float(sum(roofline.conv_ops(ref, layers, batch)))
    run.peak_ops = roofline.PEAK_OPS[cell["precision"]]
    if cell["precision"] == "int8":
        flow = numbers.pop("_flow")
        run.k4_bound_s = roofline.int8_conv_bound_s(ref, layers, batch, flow)
        run.k4_launches = len(ref.conv_layers(layers))
    if traced and tracer.events is not None:
        run.trace = trace.parse(tracer.events)
        run.traced = reqs[tracer.first:tracer.first + tracer.n]
    numbers.pop("_flow", None)
    note("trace read")
    metrics = {}
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    for m, read in readers.items():
        v = read(run)
        if v is not None:
            metrics[m] = {"value": v, "unit": units[m]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(reqs),
           "failed": win["failed"], "metrics": metrics, "device": dev}
    if run.trace is not None:
        a, b = run.trace.window
        dev["busy_s"] = run.trace.busy()
        dev["window_s"] = b - a
        out["breakdown"] = trace.breakdown(run.trace)
    out["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                    for k in limits}
    return out


def check_numbers(cell, layers, weights, calib, xs, served_outs,
                  prog_heads) -> Dict[str, float]:
    """The numbers compared (see `check`), and under "_flow" the
    reference's int8 flow plan."""
    prec, ref = cell["precision"], cell["ref"]
    quant = ref.calibrate(layers, weights, calib) if prec == "int8" \
        else None
    chk = cell["check"]
    params = [p for _, p in ref.heads(layers)]
    size = cell["cfg"]["input_size"]
    d = cell["detect"]
    heads_gap, dets, select = 0.0, 0.0, 0
    for x, srv, ph in zip(xs, served_outs, prog_heads):
        xt = torch.as_tensor(x, device=calib.device)
        rh = check.ref_heads(ref, layers, weights, xt, prec, quant,
                             chk.get("block", 16))
        heads_gap = check.worst(heads_gap, check.head_gap(ph, rh))
        ph = [h.to(calib.device) for h in ph]
        gap, faults = check.det_numbers(ref, srv, ph, params, size, size,
                                        d["max_dets"], d["thresh"],
                                        chk["margins"])
        dets, select = check.worst(dets, gap), select + faults
    out = {"heads": heads_gap, "dets": dets, "select": select}
    if quant is not None:
        out["_flow"] = quant.flow
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
