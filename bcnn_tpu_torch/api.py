"""Stateful net handle, the ported subset of `bcnn_tpu.api.Session`:
compile, predict, detect and train on a batch, the split-phase
forward / backward / update, weight files, and the host-exact YOLO
detections.

The device is explicit: `Session(net, seed, device="cuda")` raises when
CUDA is asked for and absent; nothing moves to the CPU on its own.
Forwards outside training run under `torch.inference_mode()`. Inputs and
outputs are NCHW. Inputs are uploaded as fp32; the executor honours the
net's compute_dtype, act_dtype and quant (`compile._Executor`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .compile import (
    child_generators,
    execute,
    get_loss,
    init_params,
    make_detect_fn,
    make_train_step,
    output_value,
)
from .graph import Net
from .types import LayerType, Mode


class Session:
    def __init__(self, net: Net, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Session(device={device!r}): CUDA is not available"
            )
        self.net = net
        self.seed = seed
        self.params: Dict[str, torch.Tensor] = {}
        self.state: Dict[str, torch.Tensor] = {}
        self.opt_state = None
        # a detection stream for metrics_det.map_eval: any object whose
        # next_batch() returns (x, labels); the data loaders are not
        # ported yet
        self.loader = None
        self._train_step = None
        # the per-step generators derive from this one, as bcnn_tpu's
        # step keys derive from PRNGKey(seed ^ 0x5EED)
        self._rng = torch.Generator().manual_seed(seed ^ 0x5EED)
        # set by train_on_batch when net.yolo_stats: one dict of floats a
        # YOLO layer (bcnn_tpu/api.py:52-54)
        self.last_yolo_stats = None
        # the split-phase API: the last TRAIN forward's (surrogate, leaves)
        self._cur = None

    def compile_net(self):
        """bcnn_compile_net analogue: materialize params/state (and, outside
        PREDICT, the optimizer state) on the device. Keeps values already
        set whose shapes agree, so weights staged before compile survive;
        weights that config.load_net staged on the net come first
        (`bcnn_tpu/api.py:63-69`)."""
        params, state = init_params(self.net, self.seed, self.device)
        loaded_p = getattr(self.net, "_loaded_params", None)
        if loaded_p is not None:
            self.params = dict(loaded_p)
            self.state = dict(getattr(self.net, "_loaded_state", {}))
        for have, fresh in ((self.params, params), (self.state, state)):
            for k, v in have.items():
                if k in fresh and fresh[k].shape == v.shape:
                    fresh[k] = v.to(self.device)
        self.params, self.state = params, state
        if self.net.mode != Mode.PREDICT and self.net.learner is not None:
            from .learner import init_opt_state

            self.opt_state = init_opt_state(self.net, self.params)
        self._train_step = None
        return self

    def set_mode(self, mode: Mode):
        """bcnn_set_mode (bcnn_net.c:490-504)."""
        self.net.set_mode(mode)

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _default_output_name(self) -> str:
        for node in reversed(self.net.nodes):
            if node.type != LayerType.COST:
                return self.net.tensors[node.dst[0]].name
        raise ValueError("net has no non-cost nodes")

    def train_on_batch(self, x=None, label=None) -> torch.Tensor:
        """bcnn_train_on_batch (bcnn_net.c:452-463): one forward, backward
        and update (compile.make_train_step, with net.device_augment when
        set); returns the reported loss as a 0-d tensor on the device.
        x is uploaded in its own dtype, so a uint8 batch stays uint8 until
        the device casts it."""
        if x is None:
            raise NotImplementedError(
                "train_on_batch(): the data loaders are not ported to "
                "bcnn_tpu_torch yet; pass the batch and its labels"
            )
        if self._train_step is None:
            self._train_step = make_train_step(self.net)
        x = torch.as_tensor(x, device=self.device)
        batch = {"input": x, "label": self._input(label)}
        (gen,) = child_generators(self._rng, 1)
        out = self._train_step(
            self.params, self.state, self.opt_state, batch, gen
        )
        self.params, self.state, self.opt_state, loss = out[:4]
        if len(out) == 5:  # net.yolo_stats
            self.last_yolo_stats = [
                {k: float(v) for k, v in st.items()} for st in out[4]]
        return loss

    def train_scan_on_batches(self, k: int):
        """bcnn_tpu's k loader batches in one call: the loaders are not
        ported yet. `compile.make_train_scan` runs k staged batches."""
        raise NotImplementedError(
            "train_scan_on_batches(): the data loaders are not ported to "
            "bcnn_tpu_torch yet; call compile.make_train_scan on staged "
            "batches"
        )

    def train_scan_resident_on_batches(self, k: int, shuffle: bool = False):
        """bcnn_tpu's scan over a record set uploaded once: the record
        loader is not ported yet. `compile.make_train_scan_resident`
        runs on a dataset and an index already on the device."""
        raise NotImplementedError(
            "train_scan_resident_on_batches(): the data loaders are not "
            "ported to bcnn_tpu_torch yet; call "
            "compile.make_train_scan_resident on a device dataset"
        )

    # -- split-phase API (bcnn_forward / bcnn_backward / bcnn_update) ----- #

    def forward(self, x=None, label=None) -> torch.Tensor:
        """bcnn_forward (`bcnn_tpu/api.py:349-381`): the forward in the
        net's mode; in TRAIN its autograd record is kept for backward()
        and the new running stats are written. No augmentation runs
        here. Returns the loss."""
        if x is None:
            raise NotImplementedError(
                "forward(): the data loaders are not ported to "
                "bcnn_tpu_torch yet; pass the batch"
            )
        batch = {"input": self._input(x)}
        if label is not None:
            batch["label"] = self._input(label)
        mode = self.net.mode
        self._cur = None
        if mode == Mode.TRAIN:
            specs = {t.key: t for t in self.net.param_specs()}
            leaves = {k: v.detach().requires_grad_(specs[k].trainable)
                      for k, v in self.params.items()}
            ex = execute(self.net, leaves, self.state, batch, mode)
            self.state = ex.state
            self._cur = (ex.surrogate, leaves)
        else:
            with torch.inference_mode():
                ex = execute(self.net, self.params, self.state, batch, mode)
        return get_loss(ex).detach()

    def backward(self) -> Dict[str, torch.Tensor]:
        """bcnn_backward: the gradients of the last TRAIN forward's
        surrogate in the trainable params, kept for update(). The port
        differentiates that forward's own record, as the reference's
        backward reads the forward's buffers; bcnn_tpu runs the forward
        again, after its running stats were written."""
        if self._cur is None:
            raise RuntimeError("backward() needs a forward() in TRAIN mode")
        sur, leaves = self._cur
        self._cur = None  # the record is spent
        if sur is not None:
            sur.backward()
        self._cur_grads = {
            k: v.grad if v.grad is not None else torch.zeros_like(v)
            for k, v in leaves.items() if v.requires_grad
        }
        return self._cur_grads

    def update(self):
        """bcnn_update: one optimizer step with backward()'s gradients."""
        from .learner import apply_updates

        self.params, self.opt_state = apply_updates(
            self.net, self.params, self._cur_grads, self.opt_state
        )

    def predict_on_batch(
        self,
        x=None,
        label=None,
        outputs: Optional[Sequence[str]] = None,
    ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        """bcnn_predict_on_batch (bcnn_net.c:465-483): forward in the net's
        current mode (VALID when it is TRAIN); returns (outputs, loss). The
        default output is the last tensor produced; the loss of a net
        without cost layers is 0. The parameters come in the order of
        `bcnn_tpu.api.Session.predict_on_batch`."""
        if x is None:
            raise NotImplementedError(
                "predict_on_batch(): the data loaders are not ported to "
                "bcnn_tpu_torch yet; pass the batch"
            )
        mode = self.net.mode if self.net.mode != Mode.TRAIN else Mode.VALID
        if outputs is None:
            outputs = [self._default_output_name()]
        idx = [self.net.get_tensor_index_by_name(n) for n in outputs]
        batch = {"input": self._input(x)}
        if label is not None:
            batch["label"] = self._input(label)
        with torch.inference_mode():
            ex = execute(self.net, self.params, self.state, batch, mode)
            outs = tuple(output_value(ex, i) for i in idx)
            loss = get_loss(ex)
        return outs, loss

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

    def yolo_get_detections(
        self,
        x,
        w: int,
        h: int,
        netw: int,
        neth: int,
        thresh: float,
        relative: int = 1,
        batch_item: int = 0,
    ):
        """bcnn_yolo_get_detections (bcnn_yolo.c:548-643), host-exact as
        `bcnn_tpu/api.py:436-475`: the forward, then on the host every
        YOLO layer's boxes above `thresh` for image `batch_item`, the
        letterbox undone, greedy NMS. A list of dicts (x, y, w, h,
        objectness, num_classes, prob); a suppressed box keeps its slot
        with objectness 0, as in the reference."""
        from .ops import yolo as yolo_ops

        yolo_nodes = [
            n for n in self.net.nodes if n.type == LayerType.YOLOV3
        ]
        if not yolo_nodes:
            return []
        names = [self.net.tensors[n.dst[0]].name for n in yolo_nodes]
        outs, _ = self.predict_on_batch(x, outputs=names)
        dets = []
        for node, out in zip(yolo_nodes, outs):
            # (C, H, W) -> (H, W, C)
            arr = out[batch_item].float().cpu().numpy().transpose(1, 2, 0)
            dets += yolo_ops.decode_layer(
                arr, node.param, self.net.tensors[0].w,
                self.net.tensors[0].h, thresh,
            )
        if not dets:
            return []
        for d in dets:
            d["x"], d["y"], d["w"], d["h"] = yolo_ops.correct_region_boxes(
                d["x"], d["y"], d["w"], d["h"], w, h, netw, neth, relative
            )
        return yolo_ops.nms_obj(dets)

    def save_weights(self, path: str):
        """bcnn_save_weights: the bit-compatible .bcnnmodel format."""
        from .serialization import save_weights

        save_weights(self.net, self.params, self.state, path)

    def load_weights(self, path: str):
        """bcnn_load_weights: .bcnnmodel or Darknet .weights, by the
        extension, onto the session's device; in PREDICT the BN constants
        are folded (net.bn_folded)."""
        from .serialization import load_weights

        load_weights(self.net, self.params, self.state, path, self.device)
        return self

    def get_tensor(self, name: str) -> np.ndarray:
        """Host copy of a param/state tensor, in the port's layout."""
        t = self.net.tensor(name)
        for table in (self.params, self.state):
            if t.key in table:
                return table[t.key].cpu().numpy()
        raise KeyError(name)
