"""Data parallelism over torch.distributed: the batch-axis half of
`bcnn_tpu.parallel.mesh` (`make_mesh`, `shard_batch`, `replicate`, the
DP step and scans, the resident and sharded-resident feeds, the DP
forward, ZeRO-1 and FSDP).

The model of execution. JAX runs one program over D devices and GSPMD
inserts the collectives; the port runs one process per device (SPMD).
Every rank calls the same function with the same replicated arguments
(params, state, optimizer state, generator) and with its own stripe of
each batch-sharded one: rows rank * B/D to (rank + 1) * B/D of the
global batch, as `shard_batch` cuts them (the JAX package's in_shardings
P("batch")). Each returns what JAX's global arrays hold: the same
parameters on every rank, bit for bit, and global losses and outputs.
A mesh is a 1-D `Mesh` over the ranks of an initialized process group
(`make_mesh`; a 1-D `DeviceMesh` is taken too): NCCL with one card a
rank (`cuda:<local rank>`), or gloo, on the CPU where the caller asks
for `device="cpu"`.

What the JAX package's semantics ask of the ranks:
  - the loss is a global batch SUM (`bcnn_tpu/parallel/mesh.py:6-9`):
    the gradients are all-reduced with SUM, in one flat bucket a dtype,
    not averaged as DDP does, and `learner.apply_updates` then runs
    identically on every rank;
  - BN's statistics are the global batch's (`ops.norm`, `reduce`);
  - net.batch_size stays the global batch: `seen`, the LR schedule and
    grad_div_batch count global samples; each rank runs batch_size / D;
  - the reported metrics are global sums; the lifted-structure loss is
    pairwise over the whole batch (`gather_rows`);
  - dropout masks and on-device augmentation draws are drawn for the
    global batch and each rank takes its stripe, so D ranks equal one
    (`compile._Executor`, `compile._make_train_loss_fn`).

Settings the JAX package's DP programs drop raise here, by the port's
rule that a setting it does not honour raises (ROADMAP Queue 3,
"reference traits"): `make_dp_train_step`, `make_dp_train_scan`,
ZeRO-1 and FSDP call `execute` with no augmentation (`mesh.py:73-75`),
no remat, no accum_steps and return no YOLO stats, so they refuse
net.device_augment, net.remat, net.accum_steps > 1 and net.yolo_stats;
the resident scans take device_augment and refuse the other three.
net.qat (its ranges the global batch's abs-max), net.bn_frozen_stats,
the dtypes and the reference's routing flags are honoured, as `execute`
honours them there.

Collectives: broadcast and all_reduce (the DP step and scans, the
replicated resident scan), all_gather_into_tensor (the DP forward, the
lifted loss, ZeRO-1, FSDP) and reduce_scatter_tensor (ZeRO-1, FSDP),
all of them in torch 2.11 and later. gloo runs them all on the CPU; on
CUDA tensors it runs broadcast and all_reduce only. Every rank makes
them in the same order, in the forward and in autograd's backward.
"""

from __future__ import annotations

import os
import warnings
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..compile import (_make_train_loss_fn, child_generators, execute,
                       output_value)
from ..graph import Net, TensorKind
from ..learner import apply_updates
from ..types import Mode, Optimizer

BATCH_AXIS = "batch"
OPT_BUFFERS = ("velocity", "adam_m", "adam_v")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _all_gather_into(out, t, group):
    # torch 2.13 marks the *_tensor names deprecated; 2.11 has no other
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t, group=group)


def _reduce_scatter_into(out, t, group):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, t, op=dist.ReduceOp.SUM, group=group)


def _rank_device(device, backend: Optional[str] = None) -> torch.device:
    """The rank's device: `device`, or with None (or a bare "cuda") the
    card of the local rank (LOCAL_RANK, as torchrun sets it, else the
    rank modulo the cards); with no process group (backend None), the
    current card."""
    if device is None or (torch.device(device).type == "cuda"
                          and torch.device(device).index is None):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the "
                "CPU (gloo ranks, or one process)")
        if backend is None:
            local = torch.cuda.current_device()
        else:
            local = int(os.environ.get(
                "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r}: CUDA is not "
                               "available")
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("NCCL ranks run on the card; a rank on the CPU "
                         "needs the gloo backend")
    return device


class Mesh:
    """A 1-D mesh: the ranks of a process group (None: the default one)
    along one named axis, and this rank's device."""

    def __init__(self, group=None, device=None, axis: str = BATCH_AXIS):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "a Mesh needs an initialized process group "
                "(multihost.initialize, or torch.distributed."
                "init_process_group)")
        self.group = group
        self.axis = axis
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        self.device = _rank_device(device, self.backend)
        # the global rank of the group's rank 0, broadcast's source
        self.src = dist.get_global_rank(group, 0) if group is not None else 0

    def __repr__(self):
        return (f"Mesh({self.axis}={self.size}, rank {self.rank}, "
                f"{self.backend}, {self.device})")

    # -- collectives ------------------------------------------------------ #

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> None:
        """In place, over the ranks."""
        dist.all_reduce(t, op=_OPS[op], group=self.group)

    def stripe(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's stripe of t along dim (a view)."""
        n = t.shape[dim]
        if n % self.size:
            raise ValueError(f"extent {n} of dim {dim} does not divide by "
                             f"the mesh's {self.size} ranks")
        return t.narrow(dim, self.rank * (n // self.size), n // self.size)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' tensors t concatenated along dim, in rank order."""
        moved = t.movedim(dim, 0).contiguous()
        out = torch.empty((self.size * moved.shape[0],) + moved.shape[1:],
                          dtype=t.dtype, device=t.device)
        _all_gather_into(out, moved, self.group)
        return out.movedim(0, dim).contiguous() if dim else out

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The SUM over the ranks of t, this rank's stripe of it along
        dim."""
        moved = t.movedim(dim, 0).contiguous()
        if moved.shape[0] % self.size:
            raise ValueError(f"extent {moved.shape[0]} does not divide by "
                             f"the mesh's {self.size} ranks")
        out = torch.empty((moved.shape[0] // self.size,) + moved.shape[1:],
                          dtype=t.dtype, device=t.device)
        _reduce_scatter_into(out, moved, self.group)
        return out.movedim(0, dim).contiguous() if dim else out

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def make_mesh(group=None, axis: str = BATCH_AXIS, device=None) -> Mesh:
    """The 1-D mesh over the ranks of `group` (None: the default process
    group; or a 1-D `torch.distributed.device_mesh.DeviceMesh`). device:
    the rank's device (None: `cuda:<local rank>`; "cpu" for gloo ranks
    on the CPU)."""
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(group, DeviceMesh):
        if group.ndim != 1:
            raise ValueError("make_mesh takes a 1-D DeviceMesh (the model "
                             "axis is not ported yet)")
        if device is None and group.device_type == "cpu":
            device = "cpu"
        group = group.get_group()
    return Mesh(group, device, axis)


# -- placement ---------------------------------------------------------- #


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(
        np.ascontiguousarray(x))


def _flat_collective(tensors: List[torch.Tensor], fn) -> None:
    """fn on one flat buffer a dtype holding `tensors`, each written back
    in place."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        fn(flat)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def all_reduce_flat(mesh: Mesh, tensors: List[torch.Tensor]) -> None:
    """SUM all-reduce of `tensors`, in place, one collective a dtype."""
    if tensors:
        _flat_collective(tensors, mesh.all_reduce)


def shard_batch(mesh: Mesh, tree, axis: int = 0):
    """This rank's stripe of every array of `tree` (host arrays or
    tensors of the global batch) along `axis` (1 for staged (K, B, ...)
    batches), on the rank's device; the extent must divide by the
    ranks."""
    return _tree_map(lambda x: mesh.stripe(_as_tensor(x), axis).to(
        mesh.device).contiguous(), tree)


class _Scalar:
    def __init__(self, t, kind):
        self.t, self.kind = t, kind


def replicate(mesh: Mesh, tree):
    """rank 0's values of every array and number of `tree`, broadcast and
    placed on each rank's device (fresh tensors, never the caller's);
    one broadcast a dtype."""
    ts: List[torch.Tensor] = []

    def put(x):
        if torch.is_tensor(x) or isinstance(x, np.ndarray):
            t = _as_tensor(x).to(mesh.device, copy=True)
            ts.append(t)
            return t
        if isinstance(x, (int, float, np.number)) and not isinstance(x, bool):
            kind = int if isinstance(x, (int, np.integer)) else float
            t = torch.tensor(kind(x), device=mesh.device)
            ts.append(t)
            return _Scalar(t, kind)
        return x

    out = _tree_map(put, tree)
    _flat_collective(ts, lambda flat: dist.broadcast(
        flat, src=mesh.src, group=mesh.group))
    return _tree_map(
        lambda v: v.kind(v.t.item()) if isinstance(v, _Scalar) else v, out)


class _GatherRows(torch.autograd.Function):
    """The ranks' rows gathered in rank order; the gradient is this
    rank's rows of the incoming one. Every rank computes the same loss of
    the gathered rows, so its gradient in them is the same on every
    rank: each keeps its own rows' and the SUM all-reduce of the
    parameters' gradients counts the loss once (an all-gather's usual
    backward, a reduce-scatter, would count it D times)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_gather(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.stripe(g).contiguous(), None


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return _GatherRows.apply(x, mesh)


# -- the steps ------------------------------------------------------------ #


def _refuse(net: Net, what: str, augment: bool = False) -> None:
    """Raise on each net setting that bcnn_tpu's `what` drops (module
    docstring; ROADMAP Queue 3)."""
    dropped = [name for name, on in (
        ("device_augment",
         not augment and getattr(net, "device_augment", None) is not None),
        ("remat", bool(getattr(net, "remat", False))),
        ("accum_steps", int(getattr(net, "accum_steps", 1) or 1) > 1),
        ("yolo_stats", bool(getattr(net, "yolo_stats", False))),
    ) if on]
    if dropped:
        raise ValueError(
            f"{what} does not honour net.{', net.'.join(dropped)}: "
            f"bcnn_tpu's {what} drops {'them' if len(dropped) > 1 else 'it'}"
            " (its step calls execute bare); unset it, or train on one "
            "device")


def _check_stripe(net: Net, mesh: Mesh, n: int, what: str) -> None:
    if n * mesh.size != net.batch_size:
        raise ValueError(
            f"{what}: a batch of {n} rows on each of {mesh.size} ranks is "
            f"not net.batch_size {net.batch_size}; pass this rank's stripe "
            "of the global batch (shard_batch)")


class _GatherParam(torch.autograd.Function):
    """FSDP: a parameter's shards gathered where a node uses it; the
    gradient is reduce-scattered (SUM) back to this rank's shard."""

    @staticmethod
    def forward(ctx, shard, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(shard, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.dim), None, None


class _Regather:
    def __init__(self, shard, dim):
        self.shard, self.dim = shard, dim


class _FsdpParams(dict):
    """The executor's params under FSDP: each read of a sharded key
    gathers it (`_GatherParam`); `saved` packs a gathered tensor that
    autograd saves for the backward as its shard, and gathers it again
    there, so no whole weight outlives the node that used it (a tensor
    derived from it, such as its bf16 copy, is saved whole)."""

    def __init__(self, shards, dims, mesh):
        super().__init__(shards)
        self.dims, self.mesh = dims, mesh
        self.live: Dict[int, Any] = {}

    def __getitem__(self, k):
        v = dict.__getitem__(self, k)
        d = self.dims.get(k)
        if d is None:
            return v
        full = _GatherParam.apply(v, self.mesh, d)
        self.live[id(full)] = (weakref.ref(full), v.detach(), d)
        return full

    def pack(self, t):
        hit = self.live.get(id(t))
        if hit is not None and hit[0]() is t:
            return _Regather(hit[1], hit[2])
        return t

    def unpack(self, o):
        if isinstance(o, _Regather):
            return self.mesh.all_gather(o.shard, o.dim)
        return o


def _zero1_update(net, mesh, dims, params, grads, opt_state):
    """ZeRO-1: the replicated tensors' gradients all-reduced and updated
    on every rank; the sharded ones reduce-scattered in one flat bucket
    (rank r's chunk holds its stripe of each, in key order), each rank
    updating its stripe of the parameters with its stripe of the slots,
    then the parameters all-gathered in one bucket."""
    sharded = [k for k in grads if dims.get(k) is not None]
    repl = [k for k in grads if dims.get(k) is None]
    all_reduce_flat(mesh, [grads[k] for k in repl])
    g = {k: grads[k] for k in repl}
    p = {k: params[k] for k in repl}
    if sharded:
        shapes = {k: mesh.stripe(params[k], dims[k]).shape for k in sharded}
        sizes = [grads[k].numel() // mesh.size for k in sharded]
        flat = torch.cat([
            grads[k].narrow(dims[k], r * shapes[k][dims[k]],
                            shapes[k][dims[k]]).reshape(-1)
            for r in range(mesh.size) for k in sharded])
        chunk = torch.empty(flat.numel() // mesh.size, dtype=flat.dtype,
                            device=flat.device)
        _reduce_scatter_into(chunk, flat, mesh.group)
        for k, piece in zip(sharded, chunk.split(sizes)):
            g[k] = piece.view(shapes[k])
            p[k] = mesh.stripe(params[k], dims[k])  # updated in place
    apply_updates(net, p, g, opt_state)
    if sharded:
        local = torch.cat([p[k].reshape(-1) for k in sharded])
        full = torch.empty(local.numel() * mesh.size, dtype=local.dtype,
                           device=local.device)
        _all_gather_into(full, local, mesh.group)
        pieces = iter(full.split(sizes * mesh.size))
        for r in range(mesh.size):
            for k in sharded:
                s = shapes[k][dims[k]]
                params[k].narrow(dims[k], r * s, s).copy_(
                    next(pieces).view(shapes[k]))
    return params, opt_state


def _make_sharded_train_step(net: Net, mesh: Mesh, what: str,
                             device_augment: Optional[dict] = None,
                             zero: int = 0):
    """The one train-step core of every regime (`mesh.py:67-89`): the
    TRAIN forward on this rank's stripe under the mesh, autograd, the
    gradient SUM over the ranks, `apply_updates`. zero: 0 replicated
    state; 1 ZeRO-1 (optimizer slots sharded); 3 FSDP (parameters and
    slots sharded, `zero_param_specs`). Returns step(params, state,
    opt_state, batch, generator=None) -> (params, state, opt_state,
    global loss)."""
    loss_fn = _make_train_loss_fn(net, device_augment, mesh=mesh)
    specs = {t.key: t for t in net.param_specs()}
    dims = zero_param_specs(net, mesh) if zero else {}

    def step(params, state, opt_state, batch, generator=None):
        _check_stripe(net, mesh, batch["input"].shape[0], what)
        leaves = {k: v.detach().requires_grad_(specs[k].trainable)
                  for k, v in params.items()}
        if zero == 3:
            held = _FsdpParams(leaves, dims, mesh)
            with torch.autograd.graph.saved_tensors_hooks(held.pack,
                                                          held.unpack):
                sur, (state, loss, _) = loss_fn(held, state, batch,
                                                generator)
        else:
            sur, (state, loss, _) = loss_fn(leaves, state, batch, generator)
        if sur is not None:
            sur.backward()
        grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
                 for k, v in leaves.items() if specs[k].trainable}
        if zero == 1:
            params, opt_state = _zero1_update(net, mesh, dims, params,
                                              grads, opt_state)
        else:
            # FSDP's sharded gradients were reduce-scattered in the
            # backward; the rest are summed here
            all_reduce_flat(mesh, [g for k, g in grads.items()
                                   if dims.get(k) is None])
            params, opt_state = apply_updates(net, params, grads, opt_state)
        return params, state, opt_state, loss.detach()

    return step


def make_dp_train_step(net: Net, mesh: Mesh):
    """bcnn_train_on_batch, data-parallel (`mesh.py:92-100`): params,
    state and optimizer state replicated, the batch this rank's stripe.
    step(params, state, opt_state, batch, generator=None) -> (params,
    state, opt_state, loss); equal to `compile.make_train_step` on the
    global batch with the same generator."""
    _refuse(net, "make_dp_train_step")
    return _make_sharded_train_step(net, mesh, "make_dp_train_step")


def _scan(step, params, state, opt_state, batches, gens):
    losses = []
    for batch, gen in zip(batches, gens):
        params, state, opt_state, loss = step(params, state, opt_state,
                                              batch, gen)
        losses.append(loss)
    return params, state, opt_state, torch.stack(losses)


def make_dp_train_scan(net: Net, mesh: Mesh):
    """K data-parallel steps in one call (`mesh.py:103-144`):
    train_scan(params, state, opt_state, xs_in, xs_lab, generator) with
    xs this rank's stripe (K, B/D, ...) of the staged (K, B, ...) batches
    (`shard_batch(mesh, xs, axis=1)`); step k draws from the k-th of
    `child_generators(generator, K)`, as `compile.make_train_scan`.
    Returns (params, state, opt_state, losses (K,))."""
    _refuse(net, "make_dp_train_scan")
    step = _make_sharded_train_step(net, mesh, "make_dp_train_scan")

    def train_scan(params, state, opt_state, xs_in, xs_lab, generator=None):
        k = xs_in.shape[0]
        return _scan(step, params, state, opt_state,
                     ({"input": xs_in[i], "label": xs_lab[i]}
                      for i in range(k)),
                     child_generators(generator, k))

    return train_scan


def make_dp_train_scan_resident(net: Net, mesh: Mesh,
                                device_augment: Optional[dict] = None):
    """The resident feed, data-parallel (`mesh.py:147-193`): the dataset
    replicated on every rank (`replicate`), the (K, B) index sharded on
    its batch axis (`shard_batch(mesh, idx, axis=1)`: this rank's (K,
    B/D)); each rank gathers its stripe of every batch from its own
    copy. train_scan(params, state, opt_state, dataset, idx, generator)
    -> (params, state, opt_state, losses (K,)). device_augment (or
    net.device_augment): the dataset holds raw uint8 images and the
    augmentation runs on the rank's device, its draws the global
    batch's."""
    if device_augment is None:
        device_augment = getattr(net, "device_augment", None)
    what = "make_dp_train_scan_resident"
    _refuse(net, what, augment=True)
    step = _make_sharded_train_step(net, mesh, what, device_augment)

    def train_scan(params, state, opt_state, dataset, idx, generator=None):
        return _scan(step, params, state, opt_state,
                     ({k: v.index_select(0, i) for k, v in dataset.items()}
                      for i in idx),
                     child_generators(generator, idx.shape[0]))

    return train_scan


def shard_resident_dataset(mesh: Mesh, dataset: Dict,
                           axis: str = BATCH_AXIS) -> Dict:
    """A (n, ...) resident dataset as D shards of n/D samples, this
    rank's (1, n/D, ...) shard on its device and nothing else of it
    (`mesh.py:196-213`; n must divide by D: trim or pad the record set
    first)."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")

    def cut(x):
        t = _as_tensor(x)
        if t.shape[0] % mesh.size:
            raise ValueError(f"dataset size {t.shape[0]} not divisible "
                             f"by {mesh.size}")
        return t.reshape((mesh.size, t.shape[0] // mesh.size)
                         + tuple(t.shape[1:]))

    return shard_batch(mesh, _tree_map(cut, dataset))


def make_dp_train_scan_resident_sharded(net: Net, mesh: Mesh,
                                        device_augment: Optional[dict] = None,
                                        axis: str = BATCH_AXIS):
    """The resident feed with the dataset sharded over the ranks
    (`mesh.py:216-286`): each rank holds its (1, n/D, ...) shard
    (`shard_resident_dataset`) and gathers its stripe of every batch
    from it; nothing of the dataset crosses ranks. idx: this rank's (K,
    1, B/D) LOCAL indices, `shard_batch(mesh, stream.next(K), axis=1)`
    of a `data.ShardedEpochIndexStream`'s (K, D, B/D): each global batch
    is stratified, B/D samples from every shard. Same step numerics as
    the replicated feed given the same samples."""
    if device_augment is None:
        device_augment = getattr(net, "device_augment", None)
    what = "make_dp_train_scan_resident_sharded"
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    _refuse(net, what, augment=True)
    step = _make_sharded_train_step(net, mesh, what, device_augment)

    def train_scan(params, state, opt_state, dataset, idx, generator=None):
        if idx.dim() != 3 or idx.shape[1] != 1 or any(
                v.shape[0] != 1 for v in dataset.values()):
            raise ValueError(
                f"{what}: pass this rank's (1, n/D, ...) shard of the "
                "dataset and its (K, 1, B/D) stripe of the index")
        return _scan(step, params, state, opt_state,
                     ({k: v[0].index_select(0, i[0])
                       for k, v in dataset.items()} for i in idx),
                     child_generators(generator, idx.shape[0]))

    return train_scan


def make_dp_forward(net: Net, mesh: Mesh, output_names, mode: Mode):
    """Batch-sharded inference (`mesh.py:540-558`): forward(params, state,
    batch) with the batch this rank's stripe; every rank returns the
    requested tensors of the GLOBAL batch (NCHW, int8-flow ones
    dequantized), all-gathered in rank order."""
    out_idx = [net.get_tensor_index_by_name(n) for n in output_names]

    def forward(params, state, batch):
        _check_stripe(net, mesh, batch["input"].shape[0], "make_dp_forward")
        with torch.inference_mode():
            ex = execute(net, params, state, batch, mode, mesh=mesh)
            return tuple(mesh.all_gather(output_value(ex, i).contiguous())
                         for i in out_idx)

    return forward


# -- ZeRO-1 and FSDP -------------------------------------------------------- #


def zero_param_specs(net: Net, mesh: Mesh,
                     axis: str = BATCH_AXIS) -> Dict[str, Optional[int]]:
    """The dimension each PARAM tensor is sharded along over the ranks
    (`mesh.py:369-391`): its largest dimension whose extent divides by
    the ranks (the first of equal ones), in the port's layout (conv
    weights OIHW, where bcnn_tpu shards HWIO: with equal extents of O and
    I the two pick another; the update is elementwise either way); None
    where none divides (replicated)."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    size = mesh.size
    out: Dict[str, Optional[int]] = {}
    for t in net.tensors:
        if t.kind != TensorKind.PARAM:
            continue
        best = None
        for d, extent in enumerate(t.mem_shape):
            if extent % size == 0 and extent >= size and (
                    best is None or extent > t.mem_shape[best]):
                best = d
        out[t.key] = best
    return out


def _opt_shardings(net: Net, mesh: Mesh, pspecs: Dict[str, Optional[int]]):
    """The sharded dimension of each optimizer slot, in
    `learner.init_opt_state`'s structure (`mesh.py:418-439`): each slot
    follows its parameter."""
    adam = net.learner.optimizer == Optimizer.ADAM
    out: Dict[str, Any] = {"seen": None, "velocity": {}, "adam_m": {},
                           "adam_v": {}}
    for t in net.param_specs():
        if not t.trainable:
            continue
        names = ("adam_m", "adam_v") if adam and t.adam_capable else (
            "velocity",)
        for name in names:
            out[name][t.key] = pspecs.get(t.key)
    return out


def shard_zero_state(net: Net, mesh: Mesh, params, state, opt_state,
                     axis: str = BATCH_AXIS, params_too: bool = False):
    """(params, state, opt_state) placed for ZeRO (`mesh.py:482-500`):
    rank 0's values, each optimizer slot cut to this rank's stripe along
    `zero_param_specs`'s dimension; the params too when params_too
    (FSDP), else replicated; the state replicated."""
    params, state, opt_state = replicate(mesh, (params, state, opt_state))
    dims = zero_param_specs(net, mesh, axis)

    def cut(v, d):
        return v if d is None else mesh.stripe(v, d).clone()

    if params_too:
        params = {k: cut(v, dims[k]) for k, v in params.items()}
    slots = _opt_shardings(net, mesh, dims)
    opt = dict(opt_state)
    for name in OPT_BUFFERS:
        opt[name] = {k: cut(v, slots[name][k])
                     for k, v in opt_state[name].items()}
    return params, state, opt


def gather_zero_state(net: Net, mesh: Mesh, params, state, opt_state):
    """The inverse of `shard_zero_state`: every sharded parameter and
    slot all-gathered to its whole tensor (a collective; every rank gets
    them), e.g. for a checkpoint in the single-device format."""
    dims = zero_param_specs(net, mesh)
    full = {t.key: tuple(t.mem_shape) for t in net.param_specs()}

    def whole(k, v):
        if tuple(v.shape) == full[k]:
            return v
        return mesh.all_gather(v.contiguous(), dims[k])

    params = {k: whole(k, v) for k, v in params.items()}
    if opt_state:
        opt_state = dict(opt_state)
        for name in OPT_BUFFERS:
            opt_state[name] = {k: whole(k, v)
                               for k, v in opt_state[name].items()}
    return params, state, opt_state


def make_zero1_train_step(net: Net, mesh: Mesh, axis: str = BATCH_AXIS):
    """ZeRO stage 1 (`mesh.py:442-461`): optimizer slots sharded over the
    ranks (`shard_zero_state`), parameters and state replicated, the
    batch this rank's stripe. The gradients are reduce-scattered, each
    rank updates its stripe, and the parameters are all-gathered: 1/D of
    the slots and of the update a rank, the same step as
    `make_dp_train_step`."""
    zero_param_specs(net, mesh, axis)
    _refuse(net, "make_zero1_train_step")
    return _make_sharded_train_step(net, mesh, "make_zero1_train_step",
                                    zero=1)


def make_fsdp_train_step(net: Net, mesh: Mesh, axis: str = BATCH_AXIS):
    """Fully sharded data parallelism (ZeRO-3, `mesh.py:464-479`):
    parameters and slots sharded over the ranks (`shard_zero_state(...,
    params_too=True)`), the state replicated. Each sharded parameter is
    all-gathered where a node uses it and freed after it (gathered again
    for the backward), its gradient reduce-scattered (SUM) to the rank's
    shard, and each rank updates its shards. Not `fully_shard`, which
    averages gradients and shards `nn.Module` trees: the executor reads
    its parameters from a dict, and the sum is kept."""
    zero_param_specs(net, mesh, axis)
    _refuse(net, "make_fsdp_train_step")
    return _make_sharded_train_step(net, mesh, "make_fsdp_train_step",
                                    zero=3)
