"""`control.py`'s readings for a bf16 cell whose program has no int8
path (YOLOv4: K4 does not fuse Mish, and int8 serving of a Mish net
raises on the card):

    python3 benchmark/control_fp8.py --workload <cell> --seeds 1 2 3

It runs `control.py` with one part changed: the control heads are the
cell's reference at float8 e4m3, the precision below bf16 (each layer's
output and each conv's weight rounded to e4m3, `forward(..., dtype=)`),
where control.py takes the program's own int8 heads. The sound numbers
and the control detections (the program's heads decoded at e4m3) are
control.py's.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import control, program  # noqa: E402

LOW = torch.float8_e4m3fn


class ReferenceLow:
    """The session `control.readings` reads the control heads from: the
    reference's heads at `LOW`, in the check's blocks."""

    def __init__(self, config, cell, weights, calib, device):
        self.ref, self.weights, self.device = cell["ref"], weights, device
        self.layers = self.ref.build(config["cfg_path"],
                                     config["input_size"])
        self.block = cell["check"].get("block", 16)

    def heads(self, x):
        xt = torch.as_tensor(x, device=self.device)
        parts = []
        for i in range(0, xt.shape[0], self.block):
            with torch.no_grad():
                parts.append(self.ref.forward(
                    self.layers, self.weights, xt[i:i + self.block],
                    dtype=LOW))
        return [torch.cat(p) for p in zip(*parts)]

    def free(self):
        self.weights = None


def served(config, cell, weights, calib, device):
    """`control.readings`' sessions: the program at the cell's precision;
    in place of its int8 one, the reference at `LOW`."""
    if cell["precision"] == "int8":
        return ReferenceLow(config, cell, weights, calib, device)
    return program.Served(config, cell, weights, calib, device)


def main():
    control.Served = served
    control.main()


if __name__ == "__main__":
    main()
