"""Graph executor: runs the declarative Net on torch tensors, the PREDICT
subset of `bcnn_tpu.compile`.

PyTorch runs eagerly, so the executor is a loop over the nodes that
calls one op per node; nothing is traced. Conventions:
  - `params`: dict key -> tensor, the learned tensors (PARAM specs);
  - `state`:  dict key -> tensor, BN running stats (STATE specs);
  - `values`: tensor index -> tensor; activations are NCHW throughout,
    conv weights OIHW.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import ops
from .graph import Net, Node, TensorKind
from .types import LayerType, Mode


def init_params(
    net: Net, seed: int = 0, device="cpu"
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Create (params, state) from the tensor specs' fillers, drawn in
    tensor order from one `torch.Generator` seeded with `seed`;
    unfilled tensors are zeros (calloc semantics, bh_align_calloc)."""
    gen = torch.Generator().manual_seed(seed)
    params: Dict[str, torch.Tensor] = {}
    state: Dict[str, torch.Tensor] = {}
    for t in net.tensors:
        if t.kind == TensorKind.PARAM:
            v = (
                t.filler(gen, t.mem_shape)
                if t.filler is not None
                else torch.zeros(t.mem_shape, dtype=torch.float32)
            )
            params[t.key] = v.to(device)
        elif t.kind == TensorKind.STATE:
            state[t.key] = torch.zeros(
                t.mem_shape, dtype=torch.float32, device=device
            )
    return params, state


class _Executor:
    """One pass over the graph in PREDICT or VALID mode."""

    def __init__(
        self,
        net: Net,
        params: Dict[str, torch.Tensor],
        state: Dict[str, torch.Tensor],
        mode: Mode,
    ):
        if mode == Mode.TRAIN:
            raise NotImplementedError(
                "bcnn_tpu_torch has no TRAIN path yet"
            )
        self.net = net
        self.params = params
        self.state = state
        self.mode = mode
        self.values: Dict[int, torch.Tensor] = {}

    def key_of(self, idx: int) -> str:
        return self.net.tensors[idx].key

    def p(self, idx: int) -> torch.Tensor:
        return self.params[self.key_of(idx)]

    def run(self):
        for i, node in enumerate(self.net.nodes):
            fn = getattr(self, f"_{node.type.name.lower()}", None)
            if fn is None:
                raise NotImplementedError(
                    f"layer {node.type.name} (node {i}) is not ported to "
                    "bcnn_tpu_torch yet"
                )
            fn(node)
        return self

    # ------------------------------------------------------------------ #

    def _apply_conv_epilogue(self, node: Node, y, bias_idx, extra):
        """Bias or BN, then the activation. With batch_norm the bias
        tensor is the BN shift, added after normalisation."""
        p = node.param
        if p.get("batch_norm"):
            y = ops.batch_norm(
                y,
                self.p(node.src[extra["scales"]]),
                self.p(bias_idx),
                self.state[self.key_of(node.src[extra["mean"]])],
                self.state[self.key_of(node.src[extra["var"]])],
                folded=self.net.bn_folded and self.mode == Mode.PREDICT,
            )
        else:
            y = y + self.p(bias_idx).reshape(1, -1, 1, 1)
        return ops.apply_activation(y, p["activation"])

    def _conv2d(self, node: Node):
        p = node.param
        y = ops.conv2d(
            self.values[node.src[0]],
            self.p(node.src[1]),
            p["stride"],
            p["pad"],
            p["num_groups"],
        )
        extra = {"mean": 3, "var": 4, "scales": 5}
        self.values[node.dst[0]] = self._apply_conv_epilogue(
            node, y, node.src[2], extra
        )

    def _maxpool(self, node: Node):
        p = node.param
        d = self.net.tensors[node.dst[0]]
        self.values[node.dst[0]] = ops.maxpool(
            self.values[node.src[0]], p["size"], p["stride"], d.h, d.w
        )

    def _concat(self, node: Node):
        self.values[node.dst[0]] = ops.concat_channels(
            [self.values[i] for i in node.src]
        )

    def _upsample(self, node: Node):
        self.values[node.dst[0]] = ops.upsample_nn(
            self.values[node.src[0]], node.param["size"]
        )

    def _yolov3(self, node: Node):
        from .ops import yolo as yolo_ops

        self.values[node.dst[0]] = yolo_ops.yolo_forward(
            self.values[node.src[0]], self.values.get(1), node.param,
            self.mode,
        )


def execute(
    net: Net,
    params: Dict[str, torch.Tensor],
    state: Dict[str, torch.Tensor],
    inputs: Dict[str, torch.Tensor],
    mode: Mode,
) -> _Executor:
    """inputs: name -> NCHW tensor ('input' required, 'label' optional)."""
    ex = _Executor(net, params, state, mode)
    for name, arr in inputs.items():
        if name == "input":
            idx = 0
        elif name == "label":
            idx = 1
        else:  # extra named inputs (bcnn_add_input)
            idx = net.get_tensor_index_by_name(name)
        ex.values[idx] = arr
    return ex.run()


def output_value(ex: _Executor, i: int) -> torch.Tensor:
    """Tensor i as the caller sees it: NCHW, the executor's own layout."""
    return ex.values[i]


def make_detect_fn(
    net: Net,
    thresh: float,
    max_dets: int,
    use_pallas: bool = False,
    topk_first: bool = True,
):
    """Full detection program — forward + decode + on-device NMS,
    returning (boxes (N,K,4), scores (N,K,classes), objectness (N,K)).
    topk_first selects on the objectness logits and decodes only the
    selected rows; otherwise every candidate is decoded, by the K1 CUDA
    kernel (`ops.yolo_decode.decode_fused`, the port of the Pallas
    kernel) when use_pallas is set, else by its plain version."""
    from .ops.yolo import device_decode_nms, device_detect_topk
    from .ops.yolo_decode import decode_fused, decode_grid_ref

    yolo_nodes = [
        (n.src[0], dict(n.param))
        for n in net.nodes
        if n.type == LayerType.YOLOV3
    ]
    if not yolo_nodes:
        raise ValueError("detection program requires a net with YOLO layers")
    net_w, net_h = net.tensors[0].w, net.tensors[0].h

    def detect(params, state, batch):
        ex = execute(net, params, state, batch, Mode.PREDICT)
        raws = [ex.values[src_idx] for src_idx, _ in yolo_nodes]
        if topk_first:
            return device_detect_topk(
                raws, [prm for _, prm in yolo_nodes],
                net_w, net_h, max_dets=max_dets, thresh=thresh,
            )
        dec = decode_fused if use_pallas else decode_grid_ref
        all_b, all_o, all_p = [], [], []
        for raw, (_, prm) in zip(raws, yolo_nodes):
            b, o, p = dec(raw, prm, net_w, net_h)
            all_b.append(b)
            all_o.append(o)
            all_p.append(p)
        return device_decode_nms(
            torch.cat(all_b, dim=1),
            torch.cat(all_o, dim=1),
            torch.cat(all_p, dim=1),
            max_dets=max_dets,
            thresh=thresh,
        )

    return detect
