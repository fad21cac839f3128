"""One run of one cell: set-up, the measured window, the check, the
result line.

Everything a cell, a configuration or a metric needs is found by name:
`benchmark/workloads/<cell>.json`, `benchmark/configs/<config>.json`
(and the frozen cfg it names), `benchmark/metrics/<metric>.py`, and the
cell's metrics in `BENCHMARK.json` at the checkout's root.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import check, roofline, trace, traffic
from benchmark.reference import darknet

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bcnn_tpu")


def load_cell(name: str) -> Dict:
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    cfg = json.loads(
        (HERE / "configs" / f"{cell['config']}.json").read_text())
    cfg["cfg_path"] = str(HERE / "configs" / cfg["cfg"])
    cell["name"], cell["cfg"] = name, cfg
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
    cfg = cell["cfg"]
    size = cfg["input_size"]
    layers = darknet.build(cfg["cfg_path"], size)
    weights = darknet.make_weights(layers, seed, device)
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
    batch = cell["batch"]
    run = Run(cell, setup_s, reqs, win["window"])
    run.ops_per_request = float(sum(roofline.conv_ops(layers, batch)))
    run.peak_ops = roofline.PEAK_OPS[cell["precision"]]
    if cell["precision"] == "int8":
        flow = numbers.pop("_flow")
        run.k4_bound_s = roofline.int8_conv_bound_s(layers, batch, flow)
        run.k4_launches = len(darknet.conv_layers(layers))
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
    prec = cell["precision"]
    quant = darknet.calibrate(layers, weights, calib) if prec == "int8" \
        else None
    chk = cell["check"]
    params = [p for _, p in darknet.heads(layers)]
    size = cell["cfg"]["input_size"]
    d = cell["detect"]
    heads_gap, dets, select = 0.0, 0.0, 0
    for x, srv, ph in zip(xs, served_outs, prog_heads):
        xt = torch.as_tensor(x, device=calib.device)
        rh = check.ref_heads(layers, weights, xt, prec, quant,
                             chk.get("block", 16))
        heads_gap = check.worst(heads_gap, check.head_gap(ph, rh))
        ph = [h.to(calib.device) for h in ph]
        gap, faults = check.det_numbers(srv, ph, params, size, size,
                                        d["max_dets"], d["thresh"],
                                        chk["margins"])
        dets, select = check.worst(dets, gap), select + faults
    out = {"heads": heads_gap, "dets": dets, "select": select}
    if quant is not None:
        out["_flow"] = quant.flow
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
