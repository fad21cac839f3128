"""Request schedules, made from a cell's traffic parameters and the seed.

Closed loop: one client sends its next request when the last one's
detections are on the host; the run measures as many as the window
holds. Each request takes one batch of the cell's input pool, in an
order drawn from the run seed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class Schedule:
    def __init__(self, cell: Dict, seed: int):
        if cell["loop"] != "closed":
            raise ValueError(f"unknown loop {cell['loop']!r}")
        rng = np.random.default_rng(seed)
        self.inputs = rng.integers(0, cell["pool"], 1 << 16).tolist()

    def input_of(self, i: int) -> int:
        return self.inputs[i % len(self.inputs)]
