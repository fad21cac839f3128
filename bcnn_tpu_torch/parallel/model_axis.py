"""The model axis of `bcnn_tpu.parallel.mesh` on torch.distributed: the
2-D (batch x model) mesh, tensor parallelism (output channels sharded),
spatial parallelism (the image height sharded) in training, and the
spatial forward.

The model of execution is `mesh.py`'s: one process a rank, every rank
calls the same function, and each returns what JAX's global arrays hold.
JAX writes these programs as sharding annotations and GSPMD derives the
collectives; here they are written by hand, in the executor's per-node
dispatch (`compile._Executor._dispatch`, `_out_rows`).

The mesh (`make_mesh_2d`): rank r sits at (r // m, r % m) of a (dp, m)
grid, as JAX's `reshape(dp, n // dp)` lays the devices out; its `batch`
mesh holds the ranks of its column (the batch axis: the same model
index), its `model` mesh those of its row, and `world` all of them.

Tensor parallelism (`make_dp_tp_train_step`; GSPMD's column-parallel
result). `tp_param_specs` shards the output channels of every conv,
depthwise, deconv and FC weight whose count divides the model axis, and
the per-channel vectors of the same node. A sharded node computes its
rank's channels (bias, BN and the activation on the slice; BN's batch
statistics over the batch axis only, as the channels are whole there),
then gathers the channels, so that every later node sees the whole
tensor; a depthwise node takes its rank's input channels. The loss is
replicated on the model axis, so the gather's backward keeps the rank's
own channels of the gradient, and the node's input gradient, a partial
sum, is summed over the model axis. Every gradient is then complete on
each model rank and is summed over the batch axis; the replicated ones
are broadcast from the row's first rank, so that the ranks stay equal
bit for bit whatever order a card sums in.

Spatial parallelism (`make_dp_sp_train_step`, `make_spatial_forward`).
Each model rank holds a band of rows of each activation (`plan_bands`).
Conv, depthwise and deconv fetch the halo rows their windows need from
the ranks that hold them, and send the rows' gradients back in the
backward; max pool (the size-2 stride-1 `lid12` too) and upsample do
the same; BN's statistics are reduced over every rank of both axes;
activations, route, shortcut, LRN and dropout (its mask drawn for the
global rows and sliced) work on the band; the YOLO layer and its loss
work on the rank's grid rows, each truth counted by the rank that holds
its cell, and its partial loss and metric are summed over both axes.
Layers with no height rule (FC, global avgpool, softmax, the cost
layer), and tensors of fewer rows than the model axis has ranks (a band
may not be empty), gather the height and run whole on every model rank,
as GSPMD does: exact, and their loss is replicated on the model axis,
so a gather's backward keeps the rank's own rows and a band cut from a
whole tensor sums its gradient over the model axis. The gradients of
the band nodes' parameters are partial sums, summed over both axes; the
whole nodes' are complete on each model rank, summed over the batch
axis and broadcast over the model axis.

Collectives: all_reduce alone (and broadcast). A channel or row gather
is an all_reduce of a zero-filled whole tensor into which each rank has
written its part; a halo exchange is an all_reduce of a buffer with one
slot per rank, each rank writing the rows it holds into the slots of
the ranks that need them. Both are exact (x + 0) and run on gloo on
the CPU, on gloo on CUDA tensors (which has no all_gather) and on NCCL;
they move D times the bytes of a gather, and tensors other than fp32
and fp64 go on the wire as fp32. Every rank makes them in the same
order: the plan and the shard sizes are the same on every rank, so
every rank runs the same nodes, and autograd the same backward.

What bcnn_tpu's two steps drop, they refuse (`mesh._refuse`): both go
through `_make_sharded_train_step` (`bcnn_tpu/parallel/mesh.py:67-89`),
which calls `execute` with no augmentation, no remat, no accum_steps and
returns no YOLO stats. The spatial step refuses net.ref_deconv_quirk
(the reference's misread col2im is not a function of a band of rows).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..compile import _data_srcs, _Executor, get_loss
from ..graph import Net, TensorKind
from ..learner import apply_updates
from ..types import LayerType, Mode
from .mesh import (BATCH_AXIS, OPT_BUFFERS, Mesh, _as_tensor, _check_stripe,
                   _flat_collective, _opt_shardings, _refuse,
                   all_reduce_flat, replicate)

MODEL_AXIS = "model"
WORLD_AXIS = "world"


# -- the mesh ----------------------------------------------------------- #


class Mesh2D:
    """A (dp, m) mesh over the ranks of a process group: this rank's
    `coords`, its `batch` mesh (the ranks of its column), its `model`
    mesh (the ranks of its row) and the `world` mesh of all of them, on
    one device."""

    def __init__(self, group=None, dp: Optional[int] = None, device=None,
                 axes: Tuple[str, str] = (BATCH_AXIS, MODEL_AXIS)):
        self.world = Mesh(group, device, WORLD_AXIS)
        n = self.world.size
        if dp is None:
            dp = 2 if n % 2 == 0 else 1
        if dp < 1 or n % dp:
            raise ValueError(f"dp={dp} does not divide {n} devices")
        m = n // dp
        self.axes = tuple(axes)
        self.shape = {axes[0]: dp, axes[1]: m}
        self.device = self.world.device
        r = self.world.rank
        self.coords = (r // m, r % m)
        glob = [dist.get_global_rank(group, i) if group is not None else i
                for i in range(n)]
        # every rank creates every sub-group, in the same order
        cols = [dist.new_group([glob[b * m + j] for b in range(dp)])
                for j in range(m)]
        rows = [dist.new_group([glob[b * m + j] for j in range(m)])
                for b in range(dp)]
        self.batch = Mesh(cols[self.coords[1]], self.device, axes[0])
        self.model = Mesh(rows[self.coords[0]], self.device, axes[1])

    def sub(self, axis: str) -> Mesh:
        if axis == self.axes[0]:
            return self.batch
        if axis == self.axes[1]:
            return self.model
        raise ValueError(f"the mesh's axes are {self.axes}, not {axis!r}")

    def __repr__(self):
        return (f"Mesh2D({self.axes[0]}={self.shape[self.axes[0]]}, "
                f"{self.axes[1]}={self.shape[self.axes[1]]}, rank "
                f"{self.world.rank} at {self.coords}, {self.world.backend}, "
                f"{self.device})")


def make_mesh_2d(group=None, dp: Optional[int] = None, device=None,
                 axes: Tuple[str, str] = (BATCH_AXIS, MODEL_AXIS)) -> Mesh2D:
    """The (batch, model) mesh over the ranks of `group` (None: the
    default process group), `bcnn_tpu/parallel/mesh.py:38-53`: dp
    defaults to 2 when the count is even, else 1, and must divide it.
    device: the rank's device (None: `cuda:<local rank>`; "cpu" for gloo
    ranks on the CPU)."""
    return Mesh2D(group, dp, device, axes)


# -- collectives on all_reduce ------------------------------------------ #


def _wire(dtype: torch.dtype) -> torch.dtype:
    return dtype if dtype in (torch.float32, torch.float64) else torch.float32


def _layout(y: torch.Tensor) -> torch.Tensor:
    """int8 activations are channels-last (the int8 flow's layout), the
    rest contiguous."""
    if y.dtype == torch.int8 and y.dim() == 4:
        return y.contiguous(memory_format=torch.channels_last)
    return y.contiguous()


def _sum(mesh: Mesh, t: torch.Tensor) -> None:
    if mesh is not None and mesh.size > 1:
        mesh.all_reduce(t)


def _assemble(mesh: Mesh, x: torch.Tensor, dim: int, lo: int,
              full: int) -> torch.Tensor:
    """The ranks' parts of a tensor along dim joined: each writes its part
    (at lo) into a zero-filled whole one, then one SUM all_reduce."""
    shape = list(x.shape)
    shape[dim] = full
    buf = torch.zeros(shape, dtype=_wire(x.dtype), device=x.device)
    buf.narrow(dim, lo, x.shape[dim]).copy_(x)
    _sum(mesh, buf)
    return _layout(buf.to(x.dtype))


class _ToModel(torch.autograd.Function):
    """The identity, whose gradient is summed over the model axis: a
    sharded node's input, each rank's gradient in it a partial sum."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.to(_wire(g.dtype), copy=True).contiguous()
        _sum(ctx.mesh, g)
        return g, None


class _Join(torch.autograd.Function):
    """The ranks' parts of a tensor along dim, [lo, hi) this rank's, joined
    into the whole one; the gradient is this rank's part of the incoming
    one (the whole tensor's consumers run on every rank alike, so their
    gradient is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, lo, full):
        ctx.dim, ctx.lo, ctx.n = dim, lo, x.shape[dim]
        return _assemble(mesh, x, dim, lo, full)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.lo, ctx.n).contiguous(),
                None, None, None, None)


class _Cut(torch.autograd.Function):
    """This rank's part [lo, hi) along dim of a whole tensor; the
    gradient, zero outside the part, is summed over the model axis (each
    rank's consumers see only their part)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, lo, hi):
        ctx.mesh, ctx.dim, ctx.lo, ctx.full = mesh, dim, lo, x.shape[dim]
        return _layout(x.narrow(dim, lo, hi - lo).clone())

    @staticmethod
    def backward(ctx, g):
        shape = list(g.shape)
        shape[ctx.dim] = ctx.full
        buf = torch.zeros(shape, dtype=_wire(g.dtype), device=g.device)
        buf.narrow(ctx.dim, ctx.lo, g.shape[ctx.dim]).copy_(g)
        _sum(ctx.mesh, buf)
        return buf.to(g.dtype), None, None, None, None


def _halo_slots(bands, needs):
    """Each rank's slot of the halo buffer: (offset, the row intervals it
    needs from other ranks: those of its need above and below its own
    band), and the buffer's rows."""
    slots, off = [], 0
    for (lo, hi), (a, b) in zip(bands, needs):
        ivs = []
        if a < min(b, lo):
            ivs.append((a, min(b, lo)))
        if max(a, hi) < b:
            ivs.append((max(a, hi), b))
        slots.append((off, ivs))
        off += sum(e - s for s, e in ivs)
    return slots, off


class _Halo(torch.autograd.Function):
    """The rows this rank needs from the other ranks' bands (its slot's
    intervals, in order): every rank writes the rows it holds into the
    slots of the ranks that need them, then one SUM all_reduce. The
    backward sends the rows' gradients back the same way and adds them
    into the holders' bands."""

    @staticmethod
    def forward(ctx, x, mesh, bands, slots, rows):
        me = mesh.rank
        lo, hi = bands[me]
        ctx.mesh, ctx.bands, ctx.slots, ctx.rows = mesh, bands, slots, rows
        shape = (x.shape[0], x.shape[1], rows, x.shape[3])
        buf = torch.zeros(shape, dtype=_wire(x.dtype), device=x.device)
        for r, (off, ivs) in enumerate(slots):
            for s, e in ivs:
                a, b = max(s, lo), min(e, hi)
                if r != me and a < b:
                    buf[:, :, off + a - s:off + b - s].copy_(
                        x[:, :, a - lo:b - lo])
                off += e - s
        _sum(mesh, buf)
        off, ivs = slots[me]
        n = sum(e - s for s, e in ivs)
        return _layout(buf[:, :, off:off + n].to(x.dtype))

    @staticmethod
    def backward(ctx, g):
        mesh, bands, slots = ctx.mesh, ctx.bands, ctx.slots
        me = mesh.rank
        lo, hi = bands[me]
        shape = (g.shape[0], g.shape[1], ctx.rows, g.shape[3])
        buf = torch.zeros(shape, dtype=_wire(g.dtype), device=g.device)
        off, ivs = slots[me]
        buf[:, :, off:off + g.shape[2]].copy_(g)
        _sum(mesh, buf)
        gx = torch.zeros((g.shape[0], g.shape[1], hi - lo, g.shape[3]),
                         dtype=buf.dtype, device=g.device)
        for r, (off, ivs) in enumerate(slots):
            for s, e in ivs:
                a, b = max(s, lo), min(e, hi)
                if r != me and a < b:
                    gx[:, :, a - lo:b - lo] += buf[:, :, off + a - s:
                                                   off + b - s]
                off += e - s
        return gx.to(g.dtype), None, None, None, None


# -- tensor-parallel specs and state ------------------------------------ #

# the output-channel axis of each layer's weight in the port's layouts
# (`bridge.py`: conv OIHW, depthwise (C, 1, k, k), deconv (C, O, k, k),
# FC (in, out)); bcnn_tpu's are 3, 3, 2 and 1 of HWIO-like ones
_OUT_AXIS = {
    LayerType.CONV2D: 0,
    LayerType.DEPTHWISE_CONV2D: 0,
    LayerType.TRANSPOSE_CONV2D: 1,
    LayerType.FULL_CONNECTED: 1,
}


def _axis_size(mesh, axis: str) -> int:
    if isinstance(mesh, Mesh2D):
        return mesh.shape[axis]
    if mesh.axis != axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    return mesh.size


def tp_param_specs(net: Net, mesh, axis: str = MODEL_AXIS
                   ) -> Tuple[Dict[str, Optional[int]],
                              Dict[str, Optional[int]]]:
    """(param dims, state dims): the dimension each PARAM and STATE
    tensor is sharded along over `axis`, None where replicated
    (`bcnn_tpu/parallel/mesh.py:316-366`): the output channels of every
    conv / depthwise / deconv / FC weight whose count divides the axis,
    and the per-output-channel vectors of the same node (bias, BN stats
    and scales, PReLU slopes); grouped convs stay replicated."""
    size = _axis_size(mesh, axis)
    pspecs = {t.key: None for t in net.tensors
              if t.kind == TensorKind.PARAM}
    sspecs = {t.key: None for t in net.tensors
              if t.kind == TensorKind.STATE}
    for node in net.nodes:
        ax = _OUT_AXIS.get(node.type)
        if ax is None or len(node.src) < 2:
            continue
        if node.param.get("num_groups", 1) != 1:
            continue  # grouped conv: keep group boundaries intact
        w = net.tensors[node.src[1]]
        out_ch = w.mem_shape[ax]
        if out_ch % size:
            continue
        pspecs[w.key] = ax
        for si in node.src[2:]:
            t = net.tensors[si]
            if t.mem_shape == (out_ch,):
                (pspecs if t.kind == TensorKind.PARAM else sspecs)[t.key] = 0
    return pspecs, sspecs


def _tp_cut(mesh: Mesh2D, v: torch.Tensor, d: Optional[int]):
    if d is None:
        return v
    m, j = mesh.model.size, mesh.model.rank
    n = v.shape[d] // m
    return v.narrow(d, j * n, n).clone()


def shard_train_state(net: Net, mesh: Mesh2D, params, state, opt_state,
                      axis: str = MODEL_AXIS):
    """(params, state, opt_state) placed with tensor-parallel shardings
    (`bcnn_tpu/parallel/mesh.py:394-415`): rank 0's values broadcast,
    each sharded tensor (and optimizer slot, following its parameter)
    cut to this rank's part along its dimension over the model axis."""
    pspecs, sspecs = tp_param_specs(net, mesh, axis)
    params, state, opt_state = replicate(mesh.world,
                                         (params, state, opt_state))
    params = {k: _tp_cut(mesh, v, pspecs.get(k)) for k, v in params.items()}
    state = {k: _tp_cut(mesh, v, sspecs.get(k)) for k, v in state.items()}
    slots = _opt_shardings(net, mesh.world, pspecs)
    opt = dict(opt_state)
    for name in OPT_BUFFERS:
        opt[name] = {k: _tp_cut(mesh, v, slots[name].get(k))
                     for k, v in opt_state[name].items()}
    return params, state, opt


def gather_train_state(net: Net, mesh: Mesh2D, params, state, opt_state,
                       axis: str = MODEL_AXIS):
    """The inverse of `shard_train_state`: every sharded tensor joined
    whole over the model axis (a collective; every rank gets them), the
    port's way to read JAX's global arrays."""
    pspecs, sspecs = tp_param_specs(net, mesh, axis)
    m, j = mesh.model.size, mesh.model.rank

    def whole(v, d):
        if d is None:
            return v
        n = v.shape[d]
        return _assemble(mesh.model, v.contiguous(), d, j * n, n * m)

    params = {k: whole(v, pspecs.get(k)) for k, v in params.items()}
    state = {k: whole(v, sspecs.get(k)) for k, v in state.items()}
    if opt_state:
        slots = _opt_shardings(net, mesh.world, pspecs)
        opt_state = dict(opt_state)
        for name in OPT_BUFFERS:
            opt_state[name] = {k: whole(v, slots[name].get(k))
                               for k, v in opt_state[name].items()}
    return params, state, opt_state


# -- the band plan ------------------------------------------------------- #

# the layers a height band runs; the rest gather the height
_BAND_TYPES = frozenset({
    LayerType.CONV2D, LayerType.DEPTHWISE_CONV2D,
    LayerType.TRANSPOSE_CONV2D, LayerType.MAXPOOL, LayerType.UPSAMPLE,
    LayerType.CONCAT, LayerType.ELTWISE, LayerType.ACTIVATION,
    LayerType.DROPOUT, LayerType.BATCHNORM, LayerType.LRN,
    LayerType.YOLOV3,
})


class SpatialPlan:
    """Where each model rank's rows lie. `node_band[i]`: node i runs on
    bands (else whole, its inputs gathered); `bands(h)`: the D row
    intervals of a tensor of h rows. The cuts are the coarsest band
    tensor's (hmin rows, D ranks) scaled: c_r = ceil(r * hmin / D),
    cut_r(h) = floor(c_r * h / hmin), so that where the heights are
    multiples of hmin (a net of stride-2 stages) every stride stays
    aligned: YOLOv3-tiny at 416 on 2 ranks cuts its 13 rows 7 + 6 and
    its input 224 + 192. Every band of a tensor of at least hmin rows
    is non-empty."""

    def __init__(self, net: Net, d: int):
        self.d = d
        quirk = bool(getattr(net, "ref_deconv_quirk", False))
        quant = bool(getattr(net, "quant", None))
        self.node_band: List[bool] = []
        heights = []
        for node in net.nodes:
            srcs = [net.tensors[s] for s in _data_srcs(node)]
            dsts = [net.tensors[s] for s in node.dst]
            band = node.type in _BAND_TYPES and all(
                t.h >= d for t in srcs + dsts)
            if node.type == LayerType.ELTWISE:
                band = band and tuple(node.param.get("stride", (1, 1))) == (
                    1, 1) and srcs[0].shape() == srcs[1].shape()
            if node.type == LayerType.TRANSPOSE_CONV2D:
                band = band and not quirk and not quant
            self.node_band.append(band)
            if band:
                heights += [t.h for t in srcs + dsts]
        self.input_band = net.tensors[0].h >= d
        if self.input_band:
            heights.append(net.tensors[0].h)
        self.hmin = min(heights) if heights else 0
        self.base = [-(-r * self.hmin // d) for r in range(d + 1)]

    def bands(self, h: int) -> List[Tuple[int, int]]:
        if h < self.hmin:
            raise ValueError(f"{h} rows cannot be cut into {self.d} bands "
                             f"of the plan (its coarsest band tensor has "
                             f"{self.hmin} rows)")
        cuts = [c * h // self.hmin for c in self.base]
        return list(zip(cuts[:-1], cuts[1:]))


def plan_bands(net: Net, d: int) -> SpatialPlan:
    """The band plan of `net` over d model ranks (`SpatialPlan`)."""
    return SpatialPlan(net, d)


def conv_window(o0: int, o1: int, size: int, stride: int, pad: int):
    """The input rows [e, f) (outside the image: zero rows) a conv of
    symmetric `pad` runs on for output rows [o0, o1), and t, the first
    of its outputs to keep: run on them with the same pad, its outputs
    t .. t + (o1 - o0) are rows o0 .. o1 of the whole conv. e = (o0 -
    t) * stride with t = ceil(pad / stride), so that the conv's own
    zero pad above row e falls only on outputs before t."""
    t = -(-pad // stride)
    return (o0 - t) * stride, (o1 - 1) * stride - pad + size, t


def pool_window(o0: int, o1: int, size: int, stride: int):
    """The input rows [a, b) max-pool outputs [o0, o1) read."""
    return o0 * stride, (o1 - 1) * stride + size


def upsample_window(o0: int, o1: int, f: int):
    return o0 // f, (o1 - 1) // f + 1


def deconv_window(o0: int, o1: int, size: int, stride: int, pad: int):
    """The input rows [e, f) that add into deconv outputs [o0, o1)
    (output o = i * stride - pad + k for k < size)."""
    return -(-(o0 + pad - size + 1) // stride), (o1 - 1 + pad) // stride + 1


# -- the executors -------------------------------------------------------- #


def _dropout_seed(net: Net, generator):
    if generator is not None and any(
            n.type == LayerType.DROPOUT for n in net.nodes):
        return int(torch.randint(2**62, (), generator=generator))
    return None


class _TPExecutor(_Executor):
    """A channel-sharded node computes its rank's output channels and
    gathers them; the rest run as on one device, under the batch mesh."""

    def __init__(self, net, params, state, mode, seed, mesh: Mesh2D,
                 sharded: Dict[int, int]):
        super().__init__(net, params, state, mode, seed,
                         mesh=mesh.batch if mesh.batch.size > 1 else None)
        self.model = mesh.model
        self.sharded = sharded  # node position -> local output channels

    def _dispatch(self, fn, node):
        n = self.sharded.get(self.pos)
        if n is None:
            fn(node)
            return
        j, m = self.model.rank, self.model.size
        src = node.src[0]
        x = self.values[src]
        xin = _ToModel.apply(x, self.model)
        if node.type == LayerType.DEPTHWISE_CONV2D:
            xin = xin.narrow(1, j * n, n)
        self.values[src] = xin
        try:
            fn(node)
        finally:
            if src not in node.dst:
                self.values[src] = x
        y = self.values[node.dst[0]]
        self.values[node.dst[0]] = _Join.apply(y, self.model, 1, j * n,
                                               n * m)


class _SpatialExecutor(_Executor):
    """Runs the plan's band nodes on this rank's rows (halos fetched from
    the other ranks) and the rest whole; `form[i]` says which form
    values[i] holds."""

    def __init__(self, net, params, state, mode, seed, plan: SpatialPlan,
                 height: Mesh, world: Mesh, batch: Optional[Mesh]):
        batch = batch if batch is not None and batch.size > 1 else None
        super().__init__(net, params, state, mode, seed, mesh=batch)
        self.plan, self.height, self.world, self.batch = (plan, height,
                                                           world, batch)
        self.form: Dict[int, str] = {0: "band" if plan.input_band
                                     else "whole"}
        self._conv: Dict[Tuple[int, str], Tuple] = {}
        self._crop = None

    # the forms ------------------------------------------------------------

    def band_of(self, idx: int) -> Tuple[int, int]:
        return self.plan.bands(self.net.tensors[idx].h)[self.height.rank]

    def _as(self, idx: int, want: str):
        x = self.values[idx]
        if self.form.get(idx, "whole") == want:
            return x
        hit = self._conv.get((idx, want))
        if hit is not None and hit[0] is x:
            return hit[1]
        lo, hi = self.band_of(idx)
        if want == "whole":
            y = _Join.apply(x, self.height, 2, lo, self.net.tensors[idx].h)
        else:
            y = _Cut.apply(x, self.height, 2, lo, hi)
        self._conv[(idx, want)] = (x, y)
        return y

    def _fetch(self, idx: int, need_of, zero_pad: bool):
        """Rows [a, b) of tensor idx for this rank, need_of(r) giving
        every rank's: the rows of the image it holds, the halo from the
        others, zero rows outside the image where zero_pad (else the
        interval clipped to it)."""
        h = self.net.tensors[idx].h
        bands = self.plan.bands(h)
        raw = [need_of(r) for r in range(self.plan.d)]
        needs = [(max(a, 0), min(b, h)) for a, b in raw]
        slots, rows = _halo_slots(bands, needs)
        x = self.values[idx]
        me = self.height.rank
        lo, hi = bands[me]
        (a_raw, b_raw), (a, b) = raw[me], needs[me]
        halo = (_Halo.apply(x, self.height, bands, slots, rows) if rows
                else None)
        parts, k = [], 0
        shape = (x.shape[0], x.shape[1], 0, x.shape[3])

        def zeros(n):
            return x.new_zeros(shape[:2] + (n,) + shape[3:])

        if zero_pad and a_raw < 0:
            parts.append(zeros(-a_raw))
        ivs = slots[me][1]
        if halo is not None and not ivs:
            # no rows for this rank: its (empty) halo joins the graph all
            # the same, so that its backward's collective runs here too
            parts.append(halo)
        for s, e in ivs:
            if s < lo:
                parts.append(halo[:, :, k:k + e - s])
                k += e - s
        if max(a, lo) < min(b, hi):
            parts.append(x[:, :, max(a, lo) - lo:min(b, hi) - lo])
        for s, e in ivs:
            if s >= lo:
                parts.append(halo[:, :, k:k + e - s])
                k += e - s
        if zero_pad and b_raw > h:
            parts.append(zeros(b_raw - h))
        return _layout(torch.cat(parts, dim=2))

    # the dispatch ---------------------------------------------------------

    def _dispatch(self, fn, node):
        band = self.plan.node_band[self.pos]
        want = "band" if band else "whole"
        swapped = {}
        for s in set(_data_srcs(node)):
            if s in self.values and self.form.get(s, "whole") != want:
                swapped[s] = self.values[s]
                self.values[s] = self._as(s, want)
        self.mesh = self.world if band else self.batch
        self._reduce = (self.mesh.all_reduce
                        if self.mesh is not None and self.mesh.size > 1
                        else None)
        special = getattr(self, f"_band_{node.type.name.lower()}",
                          None) if band else None
        try:
            (special or fn)(node)
        finally:
            for s, old in swapped.items():
                if s not in node.dst:
                    self.values[s] = old
        for d in node.dst:
            self.form[d] = want

    def _qat_observe(self, idx, x):
        band = self.form.get(idx, "whole") == "band"
        saved = self.mesh
        self.mesh = self.world if band else self.batch
        try:
            return super()._qat_observe(idx, x)
        finally:
            self.mesh = saved

    def _out_rows(self, y):
        if self._crop is None:
            return y
        t, n = self._crop
        return _layout(y[:, :, t:t + n])

    def _band_conv(self, node, fn):
        """conv and depthwise on the rows `conv_window` names (the halo
        fetched, zero rows outside the image), `_out_rows` keeping the
        band's outputs before the epilogue (BN's statistics are the
        band's own rows')."""
        p = node.param
        src = node.src[0]
        bands = self.plan.bands(self.net.tensors[node.dst[0]].h)
        win = [conv_window(lo, hi, p["size"], p["stride"], p["pad"])
               for lo, hi in bands]
        o0, o1 = bands[self.height.rank]
        x = self.values[src]
        self.values[src] = self._fetch(src, lambda r: win[r][:2],
                                       zero_pad=True)
        self._crop = (win[self.height.rank][2], o1 - o0)
        try:
            fn(node)
        finally:
            self._crop = None
            if src not in node.dst:
                self.values[src] = x

    def _band_conv2d(self, node):
        self._band_conv(node, super()._conv2d)

    def _band_depthwise_conv2d(self, node):
        self._band_conv(node, super()._depthwise_conv2d)

    def _band_transpose_conv2d(self, node):
        """The fp32 / bf16 deconv on the input rows that add into the
        band, with no pad (the pad's columns cropped after), then the
        band's rows of its output (zero rows where no input row adds),
        the bias, the activation and the cast, as `_transpose_conv2d`."""
        from .. import ops

        p = node.param
        src = node.src[0]
        h_out = self.net.tensors[node.dst[0]].h
        bands = self.plan.bands(h_out)
        o0, o1 = bands[self.height.rank]
        win = [deconv_window(*bands[r], p["size"], p["stride"], p["pad"])
               for r in range(self.plan.d)]
        x = self._fetch(src, lambda r: win[r], zero_pad=False)
        e = max(win[self.height.rank][0], 0)
        w = self.p(node.src[1])
        if self._qat_on(node):
            x, w = self._qat_xw(node, x, w)
        y = ops.conv.conv2d_transpose(x, w, p["stride"], 0,
                                      self.compute_dtype)
        if p["pad"]:  # the width keeps the layer's pad
            y = y[:, :, :, p["pad"]:y.shape[3] - p["pad"]]
        off = o0 - (e * p["stride"] - p["pad"])
        top, bottom = max(-off, 0), max(off + (o1 - o0) - y.shape[2], 0)
        if top or bottom:
            y = torch.nn.functional.pad(y, (0, 0, top, bottom))
        y = y[:, :, off + top:off + top + o1 - o0]
        y = y + self.p(node.src[2]).reshape(1, -1, 1, 1)
        self.values[node.dst[0]] = self._cast_act(
            ops.apply_activation(y, p["activation"]))

    def _band_maxpool(self, node):
        from .. import ops

        p = node.param
        if "darknet_padding" in p:
            raise NotImplementedError(
                "the height bands take bcnn's max-pool windows, not a "
                "Darknet cfg's padded ones")
        src = node.src[0]
        dst = self.net.tensors[node.dst[0]]
        bands = self.plan.bands(dst.h)
        o0, o1 = bands[self.height.rank]
        x = self._fetch(src, lambda r: pool_window(*bands[r], p["size"],
                                                   p["stride"]),
                        zero_pad=False)
        self.values[node.dst[0]] = ops.maxpool(x, p["size"], p["stride"],
                                               o1 - o0, dst.w)

    def _band_upsample(self, node):
        from .. import ops

        f = node.param["size"]
        src = node.src[0]
        bands = self.plan.bands(self.net.tensors[node.dst[0]].h)
        o0, o1 = bands[self.height.rank]
        x = self._fetch(src, lambda r: upsample_window(*bands[r], f),
                        zero_pad=False)
        t = o0 - f * (o0 // f)
        self.values[node.dst[0]] = _layout(
            ops.upsample_nn(x, f)[:, :, t:t + o1 - o0])

    def _band_dropout(self, node):
        """The keep mask of the global batch and the whole height (given,
        or drawn as `_Executor._dropout` draws it), this rank's stripe of
        the batch and band of the rows of it."""
        from .. import ops

        p = node.param
        x = self.values[node.src[0]]
        if self.mode != Mode.TRAIN or p["rate"] <= 0.0:
            self.values[node.dst[0]] = x
            return
        lo, hi = self.band_of(node.src[0])
        keep = self.dropout_masks.get(self.pos)
        if keep is None:
            gen = None
            if self.seed is not None:
                gen = torch.Generator(device=x.device).manual_seed(
                    self.seed + self.pos)
            nb = self.batch.size if self.batch is not None else 1
            keep = ops.dropout_mask(
                (x.shape[0] * nb, x.shape[1],
                 self.net.tensors[node.src[0]].h, x.shape[3]),
                p["rate"], x.device, gen)
            self.dropout_masks[self.pos] = keep
        keep = keep.to(x.device)
        if self.batch is not None:
            keep = self.batch.stripe(keep)
        self.values[node.dst[0]] = ops.dropout(x, p["scale"],
                                               keep[:, :, lo:hi])

    def _band_yolov3(self, node):
        """`_Executor._yolov3` on this rank's grid rows: the head's
        activation, and in TRAIN the deltas of these rows (`ops.yolo.
        yolo_train_deltas(rows=...)`); the partial cost is summed over
        both axes."""
        from .. import ops
        from ..ops import yolo as yolo_ops

        p = dict(node.param)
        p["net_w"] = self.net.tensors[0].w
        p["net_h"] = self.net.tensors[0].h
        x = self.values[node.src[0]]
        lo, _ = self.band_of(node.src[0])
        y, aux = yolo_ops.yolo_forward(
            x if x.dtype in ops.activations.WIDE else x.to(torch.float32),
            self.values.get(1), p, self.mode,
            rows=(lo, self.net.tensors[node.src[0]].h))
        self.values[node.dst[0]] = y
        if aux is not None:
            sur, cost = aux[:2]
            self.surrogate = sur if self.surrogate is None else (
                self.surrogate + sur)
            self.metrics.append(self._global_sum(cost))

    def whole(self, idx: int) -> torch.Tensor:
        """Tensor idx whole (NCHW; an int8-flow tensor dequantized)."""
        v = self._as(idx, "whole")
        if v.dtype == torch.int8:
            v = v.to(torch.float32) * self.int8_flow[idx]
        return v


# -- the steps and the forward ------------------------------------------ #


def _start(net: Net, params):
    specs = {t.key: t for t in net.param_specs()}
    return specs, {k: v.detach().requires_grad_(specs[k].trainable)
                   for k, v in params.items()}


def _inputs(batch):
    x = batch["input"]
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    return x, batch.get("label")


def _finish(net, specs, leaves, ex, mesh: Mesh2D, params, opt_state,
            partial: set, replicated: set):
    """The backward, the gradient sums (the `partial` keys' over both
    axes, the rest over the batch axis, the `replicated` ones then
    broadcast over the model axis) and the update."""
    if ex.surrogate is not None:
        ex.surrogate.backward()
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
             for k, v in leaves.items() if specs[k].trainable}
    if mesh.world.size > 1:
        all_reduce_flat(mesh.world, [g for k, g in grads.items()
                                     if k in partial])
    if mesh.batch.size > 1:
        all_reduce_flat(mesh.batch, [g for k, g in grads.items()
                                     if k not in partial])
    if mesh.model.size > 1:
        rep = [g for k, g in grads.items() if k in replicated]
        if rep:
            _flat_collective(rep, lambda flat: dist.broadcast(
                flat, src=mesh.model.src, group=mesh.model.group))
    params, opt_state = apply_updates(net, params, grads, opt_state)
    return params, ex.state, opt_state, get_loss(ex).detach()


def make_dp_tp_train_step(net: Net, mesh: Mesh2D,
                          model_axis: str = MODEL_AXIS):
    """Batch data parallelism with tensor parallelism on the 2-D mesh
    (`bcnn_tpu/parallel/mesh.py:503-518`): the batch this rank's stripe
    over the batch axis (`shard_batch(mesh.batch, batch)`), params,
    state and optimizer slots from `shard_train_state`. step(params,
    state, opt_state, batch, generator=None) -> (params, state,
    opt_state, global loss); gather_train_state joins the shards."""
    what = "make_dp_tp_train_step"
    _refuse(net, what)
    pspecs, _ = tp_param_specs(net, mesh, model_axis)
    m = mesh.shape[model_axis]
    sharded = {}
    for i, node in enumerate(net.nodes):
        if node.type in _OUT_AXIS and len(node.src) > 1:
            w = net.tensors[node.src[1]]
            d = pspecs.get(w.key)
            if d is not None:
                sharded[i] = w.mem_shape[d] // m
    replicated = {k for k, d in pspecs.items() if d is None}

    def step(params, state, opt_state, batch, generator=None):
        _check_stripe(net, mesh.batch, batch["input"].shape[0], what)
        specs, leaves = _start(net, params)
        x, label = _inputs(batch)
        ex = _TPExecutor(net, leaves, state, Mode.TRAIN,
                         _dropout_seed(net, generator), mesh, sharded)
        ex.values[0] = x
        if label is not None:
            ex.values[1] = label
        ex.run()
        return _finish(net, specs, leaves, ex, mesh, params, opt_state,
                       set(), replicated)

    return step


def _band_keys(net: Net, plan: SpatialPlan) -> set:
    return {net.tensors[s].key for i, node in enumerate(net.nodes)
            if plan.node_band[i] for s in node.src[1:]
            if net.tensors[s].kind == TensorKind.PARAM}


def spatial_band(net: Net, mesh, axis: str = MODEL_AXIS) -> Tuple[int, int]:
    """This rank's input rows [lo, hi) under the band plan over `axis`."""
    hm = mesh.sub(axis) if isinstance(mesh, Mesh2D) else mesh
    plan = plan_bands(net, hm.size)
    if not plan.input_band:
        return 0, net.tensors[0].h
    return plan.bands(net.tensors[0].h)[hm.rank]


def shard_spatial(net: Net, mesh: Mesh2D, batch, axis: str = MODEL_AXIS):
    """This rank's part of a global batch for `make_dp_sp_train_step`:
    its stripe over the batch axis, and of the input its band of rows
    over the model axis, on the rank's device."""
    lo, hi = spatial_band(net, mesh, axis)
    out = {}
    for k, v in batch.items():
        t = mesh.batch.stripe(_as_tensor(v), 0)
        if k == "input":
            t = t[:, :, lo:hi]
        out[k] = t.to(mesh.device).contiguous()
    return out


def make_dp_sp_train_step(net: Net, mesh: Mesh2D,
                          model_axis: str = MODEL_AXIS):
    """Batch data parallelism with spatial parallelism on the 2-D mesh
    (`bcnn_tpu/parallel/mesh.py:521-537`): the input this rank's stripe
    over the batch axis and band of rows over the model axis, the label
    its stripe (`shard_spatial`); params, state and optimizer state
    replicated (`replicate(mesh.world, ...)`). step(params, state,
    opt_state, batch, generator=None) -> (params, state, opt_state,
    global loss), the same on every rank."""
    what = "make_dp_sp_train_step"
    _refuse(net, what)
    if getattr(net, "ref_deconv_quirk", False) and any(
            n.type == LayerType.TRANSPOSE_CONV2D and n.param.get("pad", 0)
            for n in net.nodes):
        raise ValueError(f"{what} does not honour net.ref_deconv_quirk: "
                         "the reference's misread col2im is not a function "
                         "of a band of rows; unset it, or train on one "
                         "device")
    height = mesh.sub(model_axis)
    plan = plan_bands(net, height.size)
    partial = _band_keys(net, plan)
    replicated = {t.key for t in net.param_specs()} - partial
    lo, hi = (plan.bands(net.tensors[0].h)[height.rank] if plan.input_band
              else (0, net.tensors[0].h))

    def step(params, state, opt_state, batch, generator=None):
        _check_stripe(net, mesh.batch, batch["input"].shape[0], what)
        if batch["input"].shape[2] != hi - lo:
            raise ValueError(f"{what}: pass this rank's {hi - lo} rows "
                             f"[{lo}, {hi}) of the input (shard_spatial), "
                             f"not {batch['input'].shape[2]}")
        specs, leaves = _start(net, params)
        x, label = _inputs(batch)
        ex = _SpatialExecutor(net, leaves, state, Mode.TRAIN,
                              _dropout_seed(net, generator), plan, height,
                              mesh.world, mesh.batch)
        ex.values[0] = x
        if label is not None:
            ex.values[1] = label
        ex.run()
        return _finish(net, specs, leaves, ex, mesh, params, opt_state,
                       partial, replicated)

    return step


def make_spatial_forward(net: Net, mesh, output_names,
                         axis: str = BATCH_AXIS):
    """Height-sharded inference (`bcnn_tpu/parallel/mesh.py:289-313`):
    the input's rows cut into bands over `axis` (a 1-D `Mesh` of that
    axis, or that axis of a `Mesh2D`), the batch whole on every rank.
    forward(params, state, x) takes the whole NCHW batch (the same on
    every rank) and returns the requested tensors whole on every rank
    (NCHW, int8-flow ones dequantized), in PREDICT."""
    hm = mesh.sub(axis) if isinstance(mesh, Mesh2D) else mesh
    if not isinstance(mesh, Mesh2D) and hm.axis != axis:
        raise ValueError(f"the mesh's axis is {hm.axis!r}, not {axis!r}")
    plan = plan_bands(net, hm.size)
    out_idx = [net.get_tensor_index_by_name(n) for n in output_names]
    lo, hi = (plan.bands(net.tensors[0].h)[hm.rank] if plan.input_band
              else (0, net.tensors[0].h))

    def forward(params, state, x):
        x = _as_tensor(x).to(hm.device)
        with torch.inference_mode():
            ex = _SpatialExecutor(net, params, state, Mode.PREDICT, None,
                                  plan, hm, hm, None)
            ex.values[0] = x[:, :, lo:hi].contiguous().to(torch.float32)
            ex.run()
            return tuple(ex.whole(i) for i in out_idx)

    return forward
