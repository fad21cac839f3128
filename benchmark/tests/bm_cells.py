"""Small CPU copies of the benchmark's cells for the tests: the cell's
own files with the input cut to `size` and the batch to `batch`, written
as a temporary configuration and workload beside the real ones and
removed afterwards."""

from __future__ import annotations

import contextlib
import json
import os
import uuid

from benchmark import harness


@contextlib.contextmanager
def small_cell(cell: str, size: int = 64, batch: int = 2, requests: int = 2,
               **over):
    src = json.loads((harness.HERE / "workloads" / f"{cell}.json").read_text())
    cfg = json.loads(
        (harness.HERE / "configs" / f"{src['config']}.json").read_text())
    tag = "_t" + uuid.uuid4().hex[:8]
    cfg["input_size"] = size
    src.update(config=tag, batch=batch, pool=2, trace_skip=0,
               trace_requests=2, **over)
    src["check"]["requests"] = requests
    paths = [harness.HERE / "configs" / f"{tag}.json",
             harness.HERE / "workloads" / f"{tag}.json"]
    paths[0].write_text(json.dumps(cfg))
    paths[1].write_text(json.dumps(src))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if cell in m.get("workloads", []):
            m["workloads"].append(tag)
    try:
        yield tag, bench
    finally:
        for p in paths:
            os.remove(p)
