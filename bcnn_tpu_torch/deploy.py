"""Serving artifacts on `torch.export`, the port of `bcnn_tpu.deploy`.

`export_forward` and `export_detect` trace the PREDICT forward
(`compile.make_forward`'s primitives) or the whole detection program
(`compile.make_detect_fn(net, thresh, max_dets)`: forward, top-k-first
decode, on-device NMS; `bcnn_tpu/deploy.py:125`) with the weights baked
in as constants, and serialize the `ExportedProgram` with
`torch.export.save`. The hand-written kernels are `torch.library` ops
(`ops.library`), so the graph holds one `bcnn_tpu_torch::<op>` node per
launch, whatever device it was traced on: a program traced on the CPU
runs the plain versions there, and on the card it launches the kernels.
`load_exported` runs an artifact with no graph build, config or weight
handling.

An exported program is tied to the device it was traced on, so an
artifact's platforms default to the weights' device. With several
platforms (`("cuda", "cpu")`) the file is a zip that holds one
`torch.export.save` archive per platform and `platforms.json`; a single
platform's file is that archive itself. A platform whose device this
machine lacks (the card, on a CPU-only machine) gets the program traced
on the CPU, marked to be moved to its device when it is loaded
(`torch.export.passes.move_to_device_pass`).

Known costs: the greedy NMS loop (`ops.yolo._greedy_nms_mask`) unrolls
`max_dets` steps into the graph, and `_candidate_table` becomes a
constant. The tracing runs under `torch.no_grad()`, where the Session's
forwards run under `torch.inference_mode()`. An exported graph keeps no
cuDNN flag, so the loaded program runs under the port's fp32 setting,
TF32 off (`ops/conv.py`), which the live fp32 convs set around each call.
"""

from __future__ import annotations

import contextlib
import io
import json
import zipfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import ops  # noqa: F401  (registers the kernels' ops)
from .graph import Net
from .types import LayerType, Mode

MANIFEST = "platforms.json"


def default_outputs(net: Net):
    """Every YOLO head's output on a detection net; else the last node's
    that is not a cost layer (`bcnn_tpu/deploy.py:76-90`)."""
    yolo_dst = [net.tensors[n.dst[0]].name for n in net.nodes
                if n.type == LayerType.YOLOV3]
    if yolo_dst:
        return yolo_dst
    last = [n for n in net.nodes if n.type != LayerType.COST][-1]
    return [net.tensors[last.dst[0]].name]


class _Serve(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _available(device: torch.device) -> bool:
    return device.type == "cpu" or (device.type == "cuda"
                                    and torch.cuda.is_available())


def _moved(tree, device):
    """A copy of a dict (nested, as net.quant) with its tensors on
    `device`, each keeping its strides."""
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    return tree


@contextlib.contextmanager
def _quant_on(net: Net, device):
    """net.quant's tensors on `device` for the trace."""
    quant = getattr(net, "quant", None)
    if quant:
        net.quant = _moved(quant, device)
    try:
        yield
    finally:
        if quant:
            net.quant = quant


def _trace(make_serve, net, params, state, shape, device) -> bytes:
    """The serving function traced with the weights on `device`, saved."""
    p, s = _moved(params, device), _moved(state, device)
    x = torch.zeros(shape, dtype=torch.float32, device=device)
    with _quant_on(net, device), torch.no_grad():
        ep = torch.export.export(_Serve(make_serve(p, s)), (x,),
                                 strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _export(make_serve, net, params, state, platforms, path) -> bytes:
    if platforms is None:
        have = [*params.values(), *state.values()]
        platforms = (have[0].device.type if have else "cuda",)
    platforms = tuple(platforms)
    if not platforms or any(p not in ("cuda", "cpu") for p in platforms):
        raise ValueError(f"platforms {platforms}: each is 'cuda' or 'cpu'")
    n, c, h, w = (net.batch_size, net.tensors[0].c, net.tensors[0].h,
                  net.tensors[0].w)
    blobs, moved = {}, []
    for plat in platforms:
        dev = torch.device(plat)
        if not _available(dev):
            dev = torch.device("cpu")
            moved.append(plat)
        blobs[plat] = _trace(make_serve, net, params, state, (n, c, h, w),
                             dev)
    if len(platforms) == 1 and not moved:
        blob = blobs[platforms[0]]
    else:
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
            z.writestr(MANIFEST, json.dumps(
                {"platforms": list(platforms), "move_at_load": moved}))
            for plat, b in blobs.items():
                z.writestr(f"{plat}.pt2", b)
        blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as fp:
            fp.write(blob)
    return blob


def export_forward(
    net: Net,
    params: Dict[str, torch.Tensor],
    state: Dict[str, torch.Tensor],
    path: Optional[str] = None,
    outputs: Optional[Sequence[str]] = None,
    platforms: Optional[Sequence[str]] = None,
) -> bytes:
    """The PREDICT forward as a `torch.export` artifact: call(x) ->
    the `outputs` tensors (NCHW, as predict_on_batch gives them; default
    `default_outputs`), weights (params, running stats, net.quant) baked
    in. Returns the bytes; also writes them to `path` when given."""
    from .compile import make_forward

    fwd = make_forward(net, list(outputs or default_outputs(net)),
                       Mode.PREDICT)

    def make_serve(p, s):
        return lambda x: fwd(p, s, {"input": x})[0]

    return _export(make_serve, net, params, state, platforms, path)


def export_detect(
    net: Net,
    params: Dict[str, torch.Tensor],
    state: Dict[str, torch.Tensor],
    path: Optional[str] = None,
    thresh: float = 0.5,
    max_dets: int = 100,
    platforms: Optional[Sequence[str]] = None,
) -> bytes:
    """The detection program as a `torch.export` artifact, the same
    program as `Session.detect_on_batch` runs live (top-k-first):
    call(x) -> (boxes (N,K,4), scores (N,K,classes), objectness (N,K)).
    Raises ValueError on a net without YOLO layers."""
    from .compile import make_detect_fn

    detect = make_detect_fn(net, thresh, max_dets)  # raises without YOLO

    def make_serve(p, s):
        return lambda x: detect(p, s, {"input": x})

    return _export(make_serve, net, params, state, platforms, path)


def _load(blob: bytes, plat: Optional[str] = None):
    """An archive's ExportedProgram; moved to `plat` where given."""
    ep = torch.export.load(io.BytesIO(blob))
    if plat is not None:
        ep = torch.export.passes.move_to_device_pass(ep, plat)
    return ep


def _device_of(ep) -> str:
    """The device type of the program's input, the one it was traced
    on."""
    return next(n.meta["val"].device.type for n in ep.graph.nodes
                if n.op == "placeholder"
                and n.name in ep.graph_signature.user_inputs)


@contextlib.contextmanager
def _fp32_flags():
    """cuDNN's fp32 convs without TF32, as the live executor runs them."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def load_exported(path_or_bytes):
    """An artifact (a path or its bytes) as call(x), which runs the
    program of x's device: a CUDA tensor goes straight in (cast to fp32
    there), a CPU tensor runs the CPU program; a program for another
    device raises rather than copy x over. An array (numpy, a list) is
    uploaded once, to the first of the artifact's platforms this machine
    has. `call.platforms` lists the artifact's platforms."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fp:
            blob = fp.read()
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        manifest = (json.loads(z.read(MANIFEST)) if MANIFEST in z.namelist()
                    else None)
        if manifest is None:
            ep = _load(blob)
            platforms = (_device_of(ep),)
            programs = {platforms[0]: ep.module()}
        else:
            platforms = tuple(manifest["platforms"])
            programs = {
                p: _load(z.read(f"{p}.pt2"),
                         p if p in manifest["move_at_load"] else None
                         ).module()
                for p in platforms if _available(torch.device(p))}

    def call(x):
        if isinstance(x, torch.Tensor):
            prog = programs.get(x.device.type)
            if prog is None:
                raise ValueError(
                    f"load_exported: a {x.device.type} input, but the "
                    f"artifact's programs run on {platforms} (those this "
                    f"machine has: {tuple(programs)})")
            x = x.to(torch.float32)
        else:
            if not programs:
                raise RuntimeError(
                    f"load_exported: no platform of {platforms} here")
            dev = next(iter(programs))
            prog = programs[dev]
            x = torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                device=dev)
        with _fp32_flags(), torch.inference_mode():
            return prog(x)

    call.platforms = platforms
    return call
