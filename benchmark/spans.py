"""The program's own spans in the traced stretch, and the card's idle
time put down to them.

The port names its spans `bcnn.*` (`bcnn_tpu_torch/profiling.py`); they
reach the parsed trace as host events (`Trace.host`, `user_annotation`)
on the clock of the card's kernels and copies. Each traced request
(`bm.request`) must hold exactly one `bcnn.detect`, the request's root;
otherwise the run holds nothing to read and every reader gives None.

An idle stretch of the card (`Trace.gaps`) goes to the innermost program
span open at its middle, as `trace.breakdown` puts a gap down to a host
event: to "build" where a `bcnn.build.*` span is open there (a build
wins over the phase around it), else to the innermost phase open:
"upload" (`bcnn.upload`), "execute" (`bcnn.execute`) or "heads"
(`bcnn.heads`), else to "detect" inside `bcnn.detect`, else to None:
the harness's readback and the time between requests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from benchmark import readers

PREFIX = "bcnn."
ROOT = "bcnn.detect"
BUILD = "bcnn.build."
PHASES = {"bcnn.upload": "upload", "bcnn.execute": "execute",
          "bcnn.heads": "heads", ROOT: "detect"}
SPAN_OF = {**{w: n for n, w in PHASES.items()}, "build": BUILD}

Span = Tuple[str, float, float]  # (name, start, end), trace clock


def _matches(name: str, want: str) -> bool:
    """`want` is a name, or a prefix ending in "."."""
    return name.startswith(want) if want.endswith(".") else name == want


@dataclass
class Spans:
    """The program spans of the traced requests (each with its request's
    index), and the card's idle seconds by owner."""

    requests: int
    spans: List[Tuple[int, str, float, float]]
    idle: Dict[Optional[str], float]

    def counts(self, want: str) -> List[int]:
        """Spans named `want` (or of the prefix) in each request."""
        out = [0] * self.requests
        for r, n, _, _ in self.spans:
            if _matches(n, want):
                out[r] += 1
        return out

    def host_s(self, want: str) -> float:
        return sum(e - s for _, n, s, e in self.spans if _matches(n, want))


def owner(open_spans: List[Span]) -> Optional[str]:
    """What a gap goes to, from the spans open at its middle."""
    if any(n.startswith(BUILD) for n, _, _ in open_spans):
        return "build"
    for n, _, _ in sorted(open_spans, key=lambda v: -v[1]):
        if n in PHASES:
            return PHASES[n]
    return None


def attribute(spans: List[Span], gaps: List[Tuple[float, float]]
              ) -> Dict[Optional[str], float]:
    """Idle seconds by owner: one sweep over the gaps' middles and the
    spans in start order, the spans open kept on a stack (the spans of
    one thread nest)."""
    spans = sorted(spans, key=lambda v: (v[1], -v[2]))
    idle: Dict[Optional[str], float] = {}
    stack: List[Span] = []
    j = 0
    for a, b in sorted(gaps):
        mid = (a + b) / 2
        while j < len(spans) and spans[j][1] <= mid:
            while stack and stack[-1][2] < spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        who = owner([s for s in stack if s[2] >= mid])
        idle[who] = idle.get(who, 0.0) + (b - a)
    return idle


def read(run) -> Optional[Spans]:
    """The traced requests' program spans and the idle time by owner;
    None unless each traced request holds exactly one `bcnn.detect`."""
    tr = readers.traced(run)
    if tr is None:
        return None
    spans = []
    for n, s, d in tr.host:
        if not n.startswith(PREFIX):
            continue
        for r, (a, b) in enumerate(tr.requests):
            if a <= s and s + d <= b:
                spans.append((r, n, s, s + d))
                break
    out = Spans(len(tr.requests), spans, {})
    if out.counts(ROOT) != [1] * out.requests:
        return None
    out.idle = attribute([v[1:] for v in spans], tr.gaps())
    return out


def idle_ms(run, what: str) -> Optional[float]:
    """The card's idle ms a request while `what` ("build" or a phase)
    owns the host; None where a traced request holds no such span."""
    sp = read(run)
    if sp is None or not all(sp.counts(SPAN_OF[what])):
        return None
    return 1e3 * sp.idle.get(what, 0.0) / sp.requests


def builds_per_request(run) -> Optional[float]:
    sp = read(run)
    return None if sp is None else sum(sp.counts(BUILD)) / sp.requests


def execute_host_ms(run) -> Optional[float]:
    """Host ms a request inside `bcnn.execute`, builds included."""
    sp = read(run)
    if sp is None or not all(sp.counts("bcnn.execute")):
        return None
    return 1e3 * sp.host_s("bcnn.execute") / sp.requests
