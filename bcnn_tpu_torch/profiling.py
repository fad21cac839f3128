"""Tracing and profiling, the port of `bcnn_tpu.profiling`.

  - `trace(logdir)`: `torch.profiler` (the host, and the card where
    there is one) around a block, written to `logdir` as a Chrome trace
    (`trace_<pid>_<ns>.json`; chrome://tracing or Perfetto open it).
    The trace holds the port's own spans beside the kernels and copies,
    on the same clock;
  - `span(name)`: one of those spans, a `record_function` range while a
    torch profiler records (`recording()`, the profiler's own flag) and
    nothing otherwise: no allocation, no string formatted, no device
    work and no sync, so outputs are the same with the profiler on or
    off, and `torch.export` sees none. The serving path's spans, on the
    calling thread:
      `bcnn.detect`   `Session.detect_on_batch`, the request's root;
      `bcnn.upload`   `Session._input`, the host batch to the device;
                      inside it `bcnn.upload.stage`, each chunk's host
                      copy into the pinned ring (`upload.stage`; the
                      staged uploads, direct uploads and chunks are
                      counted by `upload.counts()`);
      `bcnn.execute`  `compile._Executor.run`, one pass (or a pipeline
                      stage's range of nodes);
      `bcnn.node.<type>`  each node of the pass (`conv2d`, `eltwise`,
                      `concat`, `upsample`, `yolov3`, ...);
      `bcnn.heads`    `ops.yolo.device_detect_topk` or
                      `device_decode_nms`, inside it `bcnn.select`
                      (top-k and gather), `bcnn.decode`, `bcnn.nms`
                      (the greedy loop); on the decode-everything
                      branch `bcnn.decode` comes before `bcnn.heads`;
      `bcnn.build.<what>`  work redone on every request that depends
                      only on the net and the shapes: `detect_fn`
                      (`compile.make_detect_fn`), `int8_flow`
                      (`ops.quant.plan_int8_flow`), `candidates`
                      (`ops.yolo._candidate_table`), `nms_order` (the
                      greedy loop's pair order), `epilogue` (K4's and
                      K5's per-channel vectors), `k4_plan`
                      (`ops.conv_int8.plan_conv_int8`, on the card),
                      `scale` (`ops.quant.quantize_tensor`'s 0-d scale),
                      `bn_consts` (`ops.norm.batch_norm`'s per-channel
                      operands) and `weight_cast` (a conv's weight in
                      the compute dtype);
  - `profile_forward(session, x)`: the per-node wall-clock mode: the
    graph run node by node, with a device synchronize after each node on
    the card, best of `runs`. The host's launch time is in each number;
    use it to rank nodes, and the trace for device time;
  - `memory_report(fn, *args)`: one run of fn with its argument and
    output bytes, the peak device memory on the card
    (`torch.cuda.max_memory_allocated`, absent on the CPU) and the flops
    `torch.utils.flop_counter.FlopCounterMode` counts, the kernels'
    (K3-K5, `ops.library`) included. `bcnn_tpu` reads XLA's memory and
    cost analysis of the compiled program instead;
  - `print_profile`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._pytree import tree_leaves

_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch profiler records now (outside a `torch.export` or
    `torch.compile` trace)."""
    return (_autograd_profiler._is_profiler_enabled
            and not torch.compiler.is_compiling())


def span(name: str):
    """A context: the range `name` in the trace while a torch profiler
    records, else one shared no-op context."""
    return torch.profiler.record_function(name) if recording() else _OFF


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler and write its Chrome trace
    under `logdir` (made if missing)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def profile_forward(
    session, x, mode=None, runs: int = 3
) -> List[Tuple[str, str, float]]:
    """[(layer type, dst tensor name, best ms)] a node, the forward in
    `mode` (PREDICT by default) on the session's device, without
    autograd; each node timed to a device synchronize on the card."""
    from .compile import _Executor
    from .types import Mode

    net = session.net
    mode = mode if mode is not None else Mode.PREDICT
    xt = torch.as_tensor(np.asarray(x), dtype=torch.float32,
                         device=session.device)
    sync = (torch.cuda.synchronize if session.device.type == "cuda"
            else (lambda: None))
    best: Dict[int, float] = {}
    with torch.inference_mode():
        for _ in range(runs):
            ex = _Executor(net, session.params, session.state, mode, seed=0)
            ex.values[0] = xt
            sync()
            for i, node in enumerate(net.nodes):
                ex.pos = i
                t0 = time.perf_counter()
                getattr(ex, f"_{node.type.name.lower()}")(node)
                sync()
                dt = (time.perf_counter() - t0) * 1e3
                best[i] = min(best.get(i, float("inf")), dt)
    return [(node.type.name,
             net.tensors[node.dst[0]].name if node.dst else "-", best[i])
            for i, node in enumerate(net.nodes)]


def _tensors(tree) -> List[Any]:
    """The tensors and arrays among the leaves of nested containers."""
    return [t for t in tree_leaves(tree)
            if isinstance(t, (torch.Tensor, np.ndarray))]


def _nbytes(tree) -> float:
    return float(sum(t.nbytes for t in _tensors(tree)))


def memory_report(fn, *args, **kwargs) -> Dict[str, float]:
    """Run fn(*args, **kwargs) once and report, in bytes and operations:
    argument_size_in_bytes and output_size_in_bytes (the tensors and
    arrays in them), peak_bytes (the card's peak allocation during the
    run, where an argument lies on the card) and flops (FlopCounterMode:
    aten's convs and matmuls, K3-K5 by their formulas, the backward's
    where fn runs one)."""
    from torch.utils.flop_counter import FlopCounterMode

    cuda = any(isinstance(t, torch.Tensor) and t.is_cuda
               for t in _tensors((args, kwargs)))
    out: Dict[str, float] = {
        "argument_size_in_bytes": _nbytes((args, kwargs))}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        result = fn(*args, **kwargs)
    if cuda:
        torch.cuda.synchronize()
        out["peak_bytes"] = float(torch.cuda.max_memory_allocated())
    out["output_size_in_bytes"] = _nbytes(result)
    out["flops"] = float(counter.get_total_flops())
    return out


def print_profile(timings: List[Tuple[str, str, float]]):
    total = sum(t for _, _, t in timings)
    print(f"{'layer':<20} {'tensor':<16} {'ms':>8} {'%':>6}")
    for typ, name, ms in timings:
        print(f"{typ:<20} {name:<16} {ms:8.3f} {100 * ms / total:5.1f}%")
    print(f"{'total':<37} {total:8.3f}")
