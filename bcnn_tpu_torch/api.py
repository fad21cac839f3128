"""Stateful net handle, the PREDICT subset of `bcnn_tpu.api.Session`.

The device is explicit: `Session(net, seed, device="cuda")` raises when
CUDA is asked for and absent; nothing moves to the CPU on its own. Every
forward runs under `torch.inference_mode()`. Inputs and outputs are NCHW.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .compile import execute, init_params, make_detect_fn, output_value
from .graph import Net
from .types import LayerType, Mode


class Session:
    def __init__(self, net: Net, seed: int = 0, device="cuda"):
        if net.mode != Mode.PREDICT:
            raise NotImplementedError(
                "bcnn_tpu_torch runs PREDICT only so far"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Session(device={device!r}): CUDA is not available"
            )
        self.net = net
        self.seed = seed
        self.params: Dict[str, torch.Tensor] = {}
        self.state: Dict[str, torch.Tensor] = {}

    def compile_net(self):
        """bcnn_compile_net analogue: materialize params/state on the
        device. Keeps values already set whose shapes agree, so weights
        staged before compile survive."""
        params, state = init_params(self.net, self.seed, self.device)
        for have, fresh in ((self.params, params), (self.state, state)):
            for k, v in have.items():
                if k in fresh and fresh[k].shape == v.shape:
                    fresh[k] = v.to(self.device)
        self.params, self.state = params, state
        return self

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _default_output_name(self) -> str:
        for node in reversed(self.net.nodes):
            if node.type != LayerType.COST:
                return self.net.tensors[node.dst[0]].name
        raise ValueError("net has no non-cost nodes")

    def predict_on_batch(
        self, x, outputs: Optional[Sequence[str]] = None
    ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        """bcnn_predict_on_batch (bcnn_net.c:465-483): forward; returns
        (outputs, loss). The default output is the last tensor produced;
        the loss of a net without cost layers is 0."""
        if outputs is None:
            outputs = [self._default_output_name()]
        idx = [self.net.get_tensor_index_by_name(n) for n in outputs]
        with torch.inference_mode():
            ex = execute(
                self.net, self.params, self.state,
                {"input": self._input(x)}, self.net.mode,
            )
            outs = tuple(output_value(ex, i) for i in idx)
        return outs, torch.zeros((), device=self.device)

    def detect_on_batch(
        self,
        x,
        thresh: float = 0.5,
        max_dets: int = 100,
        use_pallas: Optional[bool] = None,
        topk_first: bool = True,
    ):
        """Batched detection on the device: forward + decode + NMS.
        Returns (boxes (N,K,4), scores (N,K,Kcls), objectness (N,K)).

        topk_first (default) selects candidates on the raw objectness
        logits and decodes only those. Otherwise every candidate is
        decoded, by the K1 CUDA kernel when use_pallas is set (None: set
        exactly when the session's device is CUDA)."""
        if topk_first:
            use_pallas = False
        elif use_pallas is None:
            use_pallas = self.device.type == "cuda"
        detect = make_detect_fn(
            self.net, thresh, max_dets,
            use_pallas=use_pallas, topk_first=topk_first,
        )
        with torch.inference_mode():
            return detect(self.params, self.state, {"input": self._input(x)})

    def get_tensor(self, name: str) -> np.ndarray:
        """Host copy of a param/state tensor, in the port's layout."""
        t = self.net.tensor(name)
        for table in (self.params, self.state):
            if t.key in table:
                return table[t.key].cpu().numpy()
        raise KeyError(name)
