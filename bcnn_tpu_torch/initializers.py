"""Weight initializers (fillers), with the distributions of
`bcnn_tpu.initializers` and of bcnn_tensor_fill (bcnn_tensor.c:47-77):

  XAVIER: uniform(-sqrt(3/range), +sqrt(3/range))
  MSRA:   normal(0, sqrt(2/range))
  FIXED:  constant

`range` is the fan-in each layer builder chooses. The numbers come from a
`torch.Generator` the caller passes in. Torch's generator and JAX's give
different streams from one seed, so a parity test makes its weights with
one package and hands them to the other (`bridge.params_from_numpy`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from .types import FillerType


@dataclass(frozen=True)
class Filler:
    type: FillerType
    range: float = 1.0
    value: float = 0.0

    def __call__(
        self, generator: torch.Generator, shape: Tuple[int, ...]
    ) -> torch.Tensor:
        """A CPU float32 tensor of `shape`, drawn from `generator`."""
        if self.type == FillerType.XAVIER:
            std = math.sqrt(3.0 / self.range)
            return torch.empty(shape, dtype=torch.float32).uniform_(
                -std, std, generator=generator
            )
        if self.type == FillerType.MSRA:
            std = math.sqrt(2.0 / self.range)
            return std * torch.randn(
                shape, dtype=torch.float32, generator=generator
            )
        return torch.full(shape, self.value, dtype=torch.float32)
