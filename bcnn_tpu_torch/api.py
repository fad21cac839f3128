"""Stateful net handle, the port of `bcnn_tpu.api.Session`: compile,
the data loader (`set_data_loader`), predict, detect and train on a batch
(given, or the loader's next), the K-step scans over loader batches and
over a record file held on the device, the split-phase forward /
backward / update and `get_tensor_value`, weight files, full-state
checkpoints (`save_checkpoint` / `load_checkpoint`), the serving export
(`export_serving`), the host-exact YOLO detections, and `freeze_qat` (a
net trained with net.qat into its int8 dict).

The device is explicit: `Session(net, seed, device="cuda")` raises when
CUDA is asked for and absent; nothing moves to the CPU on its own.

`Session(net, seed, mesh=mesh)` (a `parallel.Mesh`, `bcnn_tpu/api.py:
31-41`) trains data-parallel, every rank of the mesh making the same
calls with the same global batches: `compile_net` replicates rank 0's
values onto each rank's device (the mesh's), `train_on_batch` and the
scans run this rank's stripe of each batch (`parallel.make_dp_*`); with
zero=1 the optimizer slots are sharded over the ranks (ZeRO-1), with
zero=3 the parameters too (FSDP). `save_checkpoint` gathers the shards
and rank 0 writes the single-device file; `load_checkpoint` resumes at
any world size.
Forwards outside training run under `torch.inference_mode()`. Inputs and
outputs are NCHW. Inputs are uploaded as fp32, a large host batch through
the session's pinned ring (`upload.py`); the executor honours the net's
compute_dtype, act_dtype and quant (`compile._Executor`).
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
from .profiling import span
from .types import LayerType, Mode
from .upload import Uploader


class Session:
    def __init__(self, net: Net, seed: int = 0, device=None, mesh=None,
                 zero: int = 0):
        if zero not in (0, 1, 3):
            raise ValueError(f"zero={zero}: 0 (replicated), 1 (ZeRO-1) or "
                             "3 (FSDP)")
        if zero and mesh is None:
            raise ValueError("Session(zero=...) shards over a mesh: pass "
                             "mesh=")
        if mesh is not None:
            if device is not None and torch.device(device) not in (
                    mesh.device, torch.device(mesh.device.type)):
                raise ValueError(f"Session(device={device!r}) is not the "
                                 f"mesh's rank device {mesh.device}")
            device = mesh.device
        self.mesh, self.zero = mesh, zero
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Session(device={device!r}): CUDA is not available"
            )
        # the host batches' way to the device, with its pinned ring
        self._upload = Uploader(self.device)
        self.net = net
        self.seed = seed
        self.params: Dict[str, torch.Tensor] = {}
        self.state: Dict[str, torch.Tensor] = {}
        self.opt_state = None
        # the data loader (set_data_loader), or any object whose
        # next_batch() returns host (x, labels)
        self.loader = None
        self._train_step = None
        self._train_scan = None
        # train_scan_resident_on_batches: (scan, dataset on the device,
        # index stream), built at its first call
        self._resident = None
        # the per-step generators derive from this one, as bcnn_tpu's
        # step keys derive from PRNGKey(seed ^ 0x5EED)
        self._rng = torch.Generator().manual_seed(seed ^ 0x5EED)
        # set by train_on_batch when net.yolo_stats: one dict of floats a
        # YOLO layer (bcnn_tpu/api.py:52-54)
        self.last_yolo_stats = None
        # the split-phase API: the last TRAIN forward's (surrogate, leaves)
        self._cur = None
        # the last forward()'s tensor values by index (get_tensor_value)
        self._cur_values: Dict[int, torch.Tensor] = {}
        # training steps taken (bcnn_tpu/api.py:58), kept in checkpoints
        self._step_count = 0

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
        self._place()
        self._train_step = None
        self._train_scan = None
        self._resident = None
        return self

    def _place(self):
        """Under a mesh: rank 0's params, state and optimizer state on
        every rank, the ZeRO ones sharded (`bcnn_tpu/api.py:82-88`)."""
        if self.mesh is None:
            return
        from .parallel import replicate, shard_zero_state

        if self.zero and self.opt_state is not None:
            self.params, self.state, self.opt_state = shard_zero_state(
                self.net, self.mesh, self.params, self.state,
                self.opt_state, params_too=self.zero == 3)
            return
        self.params, self.state = replicate(self.mesh,
                                            (self.params, self.state))
        if self.opt_state is not None:
            self.opt_state = replicate(self.mesh, self.opt_state)

    def _full_params(self) -> Dict[str, torch.Tensor]:
        """The whole parameters (FSDP's gathered: a collective)."""
        if self.zero != 3 or self.opt_state is None:
            return self.params
        from .parallel import gather_zero_state

        return gather_zero_state(self.net, self.mesh, self.params, {},
                                 None)[0]

    def _refuse_sharded(self, what: str):
        if self.zero:
            raise ValueError(f"{what} runs on replicated state; "
                             f"Session(zero={self.zero}) trains with "
                             "train_on_batch")

    def _stripe(self, tree):
        """Under a mesh, this rank's stripe of each global-batch array
        on its device (a batch of batch_size / D rows already on the
        device, a sharded pipeline's, is the stripe); else the arrays on
        the device."""
        if self.mesh is None:
            return {k: torch.as_tensor(v, device=self.device)
                    for k, v in tree.items()}
        from .parallel import shard_batch

        n = tree["input"].shape[0]
        if n * self.mesh.size == self.net.batch_size and n != \
                self.net.batch_size:
            return {k: torch.as_tensor(v, device=self.device)
                    for k, v in tree.items()}
        return shard_batch(self.mesh, tree)

    def _make_train_step(self):
        if self.mesh is None:
            return make_train_step(self.net)
        from .parallel import (make_dp_train_step, make_fsdp_train_step,
                               make_zero1_train_step)

        return {0: make_dp_train_step, 1: make_zero1_train_step,
                3: make_fsdp_train_step}[self.zero](self.net, self.mesh)

    # -- data loader + mode plumbing -------------------------------------- #

    def set_data_loader(self, loader_type, train_path, train_path_extra=None,
                        test_path=None, test_path_extra=None):
        """bcnn_set_data_loader (bcnn.h:466, bcnn_data.c:377-390): one of
        the five loaders of `data.loaders`, in the net's mode. With
        net.device_augment set the loader runs in raw mode (no host
        augmentation or normalization)."""
        from .data import make_loader

        self.loader = make_loader(self.net, loader_type, train_path,
                                  train_path_extra, test_path,
                                  test_path_extra)
        self.loader.set_mode(self.net.mode)
        return self

    def set_mode(self, mode: Mode):
        """bcnn_set_mode (bcnn_net.c:490-504): switches the mode and, with
        a loader set, its stream (switching out of TRAIN rewinds the
        eval stream)."""
        self.net.set_mode(mode)
        if self.loader is not None:
            self.loader.set_mode(Mode(mode))

    def _next_batch(self):
        """The loader's next host batch (x, labels); a raw-mode batch
        (net.device_augment) goes as uint8, its values being whole pixel
        levels, and the device normalizes it."""
        if self.loader is None:
            raise RuntimeError(
                "no data loader: call Session.set_data_loader, or pass "
                "the batch")
        x, y = self.loader.next_batch()
        if getattr(self.loader, "raw_mode", False) and x.dtype != np.uint8:
            x = x.astype(np.uint8)
        return x, y

    def get_batch_size(self) -> int:
        return self.net.batch_size

    def get_num_threads(self) -> int:
        """bcnn_get_num_threads: the net's host thread cap
        (Net.set_num_threads)."""
        return self.net.num_threads

    def fill_tensor_with_image(self, img_u8, batch_index: int, x_buffer,
                               norm_coeff=1 / 127.5, swap_to_bgr=0,
                               mean_r=127.5, mean_g=127.5, mean_b=127.5):
        """bcnn_fill_tensor_with_image (bcnn_data.c:42-68): normalize one
        HWC uint8 image into row `batch_index` of a host NCHW batch."""
        from .data.augment import convert_img_to_float

        x_buffer[batch_index] = convert_img_to_float(
            img_u8, norm_coeff, swap_to_bgr, mean_r, mean_g, mean_b)
        return x_buffer

    def _input(self, x) -> torch.Tensor:
        """x on the device as fp32, through the session's pinned ring
        where x is a large contiguous host batch (`upload.Uploader`)."""
        with span("bcnn.upload"):
            return self._upload(x)

    def _default_output_name(self) -> str:
        for node in reversed(self.net.nodes):
            if node.type != LayerType.COST:
                return self.net.tensors[node.dst[0]].name
        raise ValueError("net has no non-cost nodes")

    def train_on_batch(self, x=None, label=None) -> torch.Tensor:
        """bcnn_train_on_batch (bcnn_net.c:452-463): one forward, backward
        and update (compile.make_train_step, with net.device_augment when
        set); returns the reported loss as a 0-d tensor on the device.
        With no batch the data loader supplies it, as in the reference.
        x is uploaded in its own dtype, so a uint8 batch stays uint8 until
        the device casts it; a tensor already on the device is taken as
        it is (a pipeline's batch)."""
        if x is None:
            x, label = self._next_batch()
        if self._train_step is None:
            self._train_step = self._make_train_step()
        lab = (label.to(torch.float32) if torch.is_tensor(label)
               else np.asarray(label, np.float32))
        batch = self._stripe({"input": x, "label": lab})
        (gen,) = child_generators(self._rng, 1)
        out = self._train_step(
            self.params, self.state, self.opt_state, batch, gen
        )
        self.params, self.state, self.opt_state, loss = out[:4]
        if len(out) == 5:  # net.yolo_stats
            self.last_yolo_stats = [
                {k: float(v) for k, v in st.items()} for st in out[4]]
        self._step_count += 1
        return loss

    def _refuse_scan_forms(self, what: str):
        """The scans run the bare step (`bcnn_tpu/api.py:189-205`)."""
        for name, on in (
            ("remat", bool(getattr(self.net, "remat", False))),
            ("accum_steps",
             int(getattr(self.net, "accum_steps", 1) or 1) > 1),
        ):
            if on:
                raise ValueError(
                    f"{what} does not support {name} (the scan runs the "
                    "bare step); use train_on_batch for such nets")

    def _take_scan(self, out) -> float:
        self.params, self.state, self.opt_state, losses = out[:4]
        if len(out) == 5:  # net.yolo_stats: per-step stats, leading axis k
            self.last_yolo_stats = [
                {kk: v.cpu().numpy() for kk, v in st.items()}
                for st in out[4]]
        self._step_count += losses.shape[0]
        return float(losses.sum())

    def train_scan_on_batches(self, k: int) -> float:
        """k loader batches staged on the device and trained in one call
        (compile.make_train_scan, `bcnn_tpu/api.py:171-235`); returns the
        SUM of the k steps' reported losses, so a caller accumulates it
        as it would k train_on_batch calls. With net.device_augment the
        raw batches are staged as uint8. Under a mesh each rank stages
        its stripe of the k batches (`parallel.make_dp_train_scan`), and
        a net with device_augment is refused, as bcnn_tpu refuses it
        (`bcnn_tpu/api.py:183-193`)."""
        self._refuse_scan_forms("train_scan_on_batches")
        if self.mesh is not None:
            self._refuse_sharded("train_scan_on_batches")
            if getattr(self.net, "device_augment", None) is not None:
                raise ValueError(
                    "train_scan_on_batches does not support device_augment "
                    "under a mesh (make_dp_train_scan runs the bare step); "
                    "use train_on_batch or the resident scan")
        xs, ys = zip(*(self._next_batch() for _ in range(k)))
        staged = {"input": np.stack(xs),
                  "label": np.stack(ys).astype(np.float32)}
        (gen,) = child_generators(self._rng, 1)
        if self.mesh is not None:
            from .parallel import make_dp_train_scan, shard_batch

            if self._train_scan is None:
                self._train_scan = make_dp_train_scan(self.net, self.mesh)
            staged = shard_batch(self.mesh, staged, axis=1)
            return self._take_scan(self._train_scan(
                self.params, self.state, self.opt_state, staged["input"],
                staged["label"], gen))
        staged = {k: torch.as_tensor(v, device=self.device)
                  for k, v in staged.items()}
        if self._train_scan is None:
            from .compile import make_train_scan

            self._train_scan = make_train_scan(self.net)
        return self._take_scan(self._train_scan(
            self.params, self.state, self.opt_state, staged, gen))

    def train_scan_resident_on_batches(self, k: int,
                                       shuffle: bool = False) -> float:
        """train_scan_on_batches over a record file held on the device
        (`bcnn_tpu/api.py:237-318`): at the first call the loader, a
        RawRecordLoader, is read whole (read_all) and uploaded once; each
        call then trains k steps whose batches are gathered on the device
        by a (k, B) index (compile.make_train_scan_resident), so a call
        moves only the index. Needs net.device_augment (records hold raw
        uint8; {} normalizes only). shuffle=False walks the records in
        the loader's sequential mod-n order; shuffle=True draws a
        per-epoch permutation (EpochIndexStream), fixed at the first
        call. Returns the sum of the k losses. Under a mesh every rank
        uploads the whole record set (each reads the same file) and
        gathers its stripe of each batch
        (`parallel.make_dp_train_scan_resident`)."""
        from .data.records import EpochIndexStream, RawRecordLoader

        if getattr(self.net, "device_augment", None) is None:
            raise ValueError(
                "train_scan_resident_on_batches requires net.device_augment "
                "(records are raw uint8; {} gives device-side normalization "
                "only)")
        if not isinstance(self.loader, RawRecordLoader):
            raise ValueError(
                "train_scan_resident_on_batches needs a RawRecordLoader "
                "(records_from_loader writes one); got "
                f"{type(self.loader).__name__}")
        self._refuse_scan_forms("train_scan_resident_on_batches")
        if self.mesh is not None:
            self._refuse_sharded("train_scan_resident_on_batches")
        if self._resident is None:
            if self.mesh is not None:
                from .parallel import make_dp_train_scan_resident

                scan = make_dp_train_scan_resident(self.net, self.mesh)
            else:
                from .compile import make_train_scan_resident

                scan = make_train_scan_resident(self.net)
            xa, ya = self.loader.read_all()
            ds = {"input": torch.as_tensor(xa, device=self.device),
                  "label": self._input(ya)}
            stream = EpochIndexStream(self.loader.n, self.net.batch_size,
                                      seed=self.seed, shuffle=shuffle)
            self._resident = (scan, ds, stream)
        scan, ds, stream = self._resident
        if stream.shuffle != shuffle:
            raise ValueError(
                "shuffle is fixed at the first "
                f"train_scan_resident_on_batches call ({stream.shuffle}); "
                "compile_net() resets the resident state")
        idx = torch.as_tensor(stream.next(k), dtype=torch.int64)
        if self.mesh is not None:
            from .parallel import shard_batch

            idx = shard_batch(self.mesh, idx, axis=1)
        idx = idx.to(self.device)
        (gen,) = child_generators(self._rng, 1)
        return self._take_scan(scan(
            self.params, self.state, self.opt_state, ds, idx, gen))

    # -- split-phase API (bcnn_forward / bcnn_backward / bcnn_update) ----- #

    def forward(self, x=None, label=None) -> torch.Tensor:
        """bcnn_forward (`bcnn_tpu/api.py:349-381`): the forward in the
        net's mode; in TRAIN its autograd record is kept for backward()
        and the new running stats are written. No augmentation runs
        here; a net with dropout draws its masks from a seed taken from
        the session's generator. Every tensor's value is kept for
        get_tensor_value (int8-flow tensors dequantized). Returns the
        loss. Under a mesh each rank runs the whole batch, as the JAX
        package's replicated forward does; not with sharded state."""
        self._refuse_sharded("forward")
        if x is None:
            x, label = self._next_batch()
        batch = {"input": self._input(x)}
        if label is not None:
            batch["label"] = self._input(label)
        mode = self.net.mode
        self._cur = None
        if mode == Mode.TRAIN:
            specs = {t.key: t for t in self.net.param_specs()}
            leaves = {k: v.detach().requires_grad_(specs[k].trainable)
                      for k, v in self.params.items()}
            seed = None
            if any(n.type == LayerType.DROPOUT for n in self.net.nodes):
                (gen,) = child_generators(self._rng, 1)
                seed = int(torch.randint(2**62, (), generator=gen))
            ex = execute(self.net, leaves, self.state, batch, mode, seed)
            self.state = ex.state
            self._cur = (ex.surrogate, leaves)
        else:
            with torch.inference_mode():
                ex = execute(self.net, self.params, self.state, batch, mode)
        self._cur_values = {i: output_value(ex, i).detach()
                            for i in ex.values}
        return get_loss(ex).detach()

    def get_tensor_value(self, name: str) -> np.ndarray:
        """bcnn_get_tensor_by_name for activations (`bcnn_tpu/api.py:
        401-406`): the tensor's value from the last forward(), NCHW, on
        the host (bf16 as fp32)."""
        v = self._cur_values[self.net.get_tensor_index_by_name(name)]
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        return v.cpu().numpy()

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
        `bcnn_tpu.api.Session.predict_on_batch`. With no batch the data
        loader supplies it."""
        if x is None:
            x, label = self._next_batch()
        mode = self.net.mode if self.net.mode != Mode.TRAIN else Mode.VALID
        if outputs is None:
            outputs = [self._default_output_name()]
        idx = [self.net.get_tensor_index_by_name(n) for n in outputs]
        batch = {"input": self._input(x)}
        if label is not None:
            batch["label"] = self._input(label)
        params = self._full_params()
        with torch.inference_mode():
            ex = execute(self.net, params, self.state, batch, mode)
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
        exactly when the session's device is CUDA). The call is the span
        `bcnn.detect` where a profiler records (`profiling.span`)."""
        with span("bcnn.detect"):
            if topk_first:
                use_pallas = False
            elif use_pallas is None:
                use_pallas = self.device.type == "cuda"
            with span("bcnn.build.detect_fn"):
                detect = make_detect_fn(
                    self.net, thresh, max_dets,
                    use_pallas=use_pallas, topk_first=topk_first,
                )
            params = self._full_params()
            with torch.inference_mode():
                return detect(params, self.state,
                              {"input": self._input(x)})

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

    def freeze_qat(self):
        """Freeze a net trained with net.qat into the int8 dict
        (`bcnn_tpu/api.py:520-527`): activation scales from the trained
        EMA ranges in the state, per-channel int8 weights from the
        params (`ops.quant.qat_export`), set as net.quant; the cached
        steps are dropped. predict_on_batch and detect_on_batch in
        PREDICT then take the int8 path unchanged. Returns net.quant."""
        from .ops.quant import qat_export

        self.net.quant = qat_export(self.net, self._full_params(),
                                    self.state)
        self._train_step = None
        self._train_scan = None
        self._resident = None
        return self.net.quant

    def save_weights(self, path: str):
        """bcnn_save_weights: the bit-compatible .bcnnmodel format."""
        from .serialization import save_weights

        save_weights(self.net, self._full_params(), self.state, path)

    def load_weights(self, path: str):
        """bcnn_load_weights: .bcnnmodel or Darknet .weights, by the
        extension, onto the session's device; in PREDICT the BN constants
        are folded (net.bn_folded)."""
        from .serialization import load_weights

        load_weights(self.net, self.params, self.state, path, self.device)
        return self

    # -- checkpoint / resume (full state, beyond the reference's
    #    weights-only bcnn_save_weights) ---------------------------------- #

    def save_checkpoint(self, path: str):
        """Params, state, optimizer state and the step count in
        `bcnn_tpu`'s `.npz` checkpoint format (`checkpoint.py`), which
        `bcnn_tpu.api.Session.load_checkpoint` reads too. Under a mesh
        every rank calls it: the ZeRO shards are gathered, rank 0 writes
        the single-device file, and the ranks wait for it."""
        from .checkpoint import save_checkpoint

        params, state, opt = self.params, self.state, self.opt_state
        if self.zero:
            from .parallel import gather_zero_state

            params, state, opt = gather_zero_state(self.net, self.mesh,
                                                   params, state, opt)
        if self.mesh is None or self.mesh.rank == 0:
            save_checkpoint(self.net, path, params, state, opt,
                            extra={"step_count": self._step_count})
        if self.mesh is not None:
            self.mesh.barrier()

    def load_checkpoint(self, path: str):
        """A checkpoint of either package onto the session's device; the
        optimizer state is taken where the file has one. Under a mesh,
        at any world size: rank 0's file is replicated (and sharded
        for ZeRO) as compile_net places the state."""
        from .checkpoint import load_checkpoint

        self.params, self.state, opt, extra = load_checkpoint(
            self.net, path, self.device)
        if opt:
            self.opt_state = opt
        self._place()
        self._train_step = None
        self._step_count = int(extra.get("step_count", 0))
        return self

    def export_serving(
        self,
        path: Optional[str],
        detect: bool = False,
        outputs=None,
        thresh: float = 0.5,
        max_dets: int = 100,
        platforms=None,
    ) -> bytes:
        """Export the PREDICT forward (or, with detect=True, the detection
        program: forward + top-k-first decode + on-device NMS) with the
        weights baked in (`deploy.py`, on `torch.export`; the kernels are
        the `bcnn_tpu_torch` ops in its graph). `platforms` defaults to
        the session's device, where its weights lie. Load with
        `deploy.load_exported`. Returns
        the bytes, also written to `path` unless it is None."""
        from . import deploy

        if detect:
            if outputs is not None:
                raise ValueError(
                    "outputs= applies to forward export only; the detect "
                    "pipeline returns (boxes, scores, objectness)"
                )
            return deploy.export_detect(
                self.net, self._full_params(), self.state, path,
                thresh=thresh, max_dets=max_dets, platforms=platforms,
            )
        if thresh != 0.5 or max_dets != 100:
            raise ValueError(
                "thresh/max_dets apply to detect=True export only"
            )
        return deploy.export_forward(
            self.net, self._full_params(), self.state, path,
            outputs=outputs, platforms=platforms,
        )

    def get_tensor(self, name: str) -> np.ndarray:
        """Host copy of a param/state tensor, in the port's layout."""
        t = self.net.tensor(name)
        for table in (self._full_params(), self.state):
            if t.key in table:
                return table[t.key].cpu().numpy()
        raise KeyError(name)
