"""Small CPU copies of the benchmark's cells for the tests: the cell's
own files with the input cut to `size` and the batch to `batch`, written
as a temporary configuration and workload beside the real ones and
removed afterwards; and the top-level modules a fresh interpreter
loads."""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
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


def modules_after(code: str) -> set:
    """The top-level names in `sys.modules` once a fresh interpreter at
    the checkout's root has run `code`."""
    p = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        capture_output=True, text=True, cwd=str(harness.ROOT),
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))
