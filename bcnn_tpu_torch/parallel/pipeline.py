"""Pipeline (inter-op) parallelism on torch.distributed: the port of
`bcnn_tpu.parallel.pipeline` (`split_stages`, `stage_io`, `Pipeline`).

The node list is cut into contiguous stages balanced by a FLOP estimate
(`split_stages`, the JAX package's greedy cut, boundary for boundary);
`stage_io` finds what each stage imports from earlier ones (pipe_in),
what later ones import from it (pipe_out), what the host feeds it
(ext_in: the image, and the label as tensor 1 for a COST or YOLOV3
node), its parameter and state keys, and the grad-routing taps whose
producer and consumer sit in different stages. Each stage runs its
nodes through the executor's range form (`compile._Executor.run(lo, hi,
taps_in)`). The port is NCHW throughout, so the JAX package's layout
changes at a stage's boundary have no counterpart.

Training (`Pipeline.train_on_batch`) is GPipe with per-stage recompute:
a microbatch's forward runs under `torch.no_grad()` and stashes only
each stage's boundary inputs, taps, host slices, dropout seed and
pre-forward state; its backward runs the stage again from that stash,
its boundary inputs leaves that require grad, and calls autograd on
(pipe outputs, taps out, surrogate) with the cotangents later stages
sent back (zeros where none did) and 1 for the surrogate. The
recompute's running stats are dropped. Parameter gradients add up over
the microbatches, boundary cotangents by tensor index; then each stage
runs `learner.apply_updates` on its subtree. schedule="gpipe" runs
every forward, then every backward (a stash of n_microbatches x stages);
"1f1b" runs each microbatch's backward right after its forward and frees
its stash (a stash of one microbatch). Both give the same numbers.
net.remat is honoured by construction: a stage always recomputes.

Microbatch m draws from the m-th of `compile.child_generators(generator,
n_microbatches)` (with one microbatch, the step's generator itself), and
a net with dropout draws its seed from it as `make_train_step` does, so
a stage draws the masks one device would (seed + the node's position).
With no generator the seed comes from torch's default one (rank 0's,
broadcast), never None: the recompute draws the forward's masks.
So n_microbatches = k is the port's `make_train_step(accum_steps=k)`:
per-microbatch BN statistics, the same masks, summed gradients, one
update; the loss is the metric sum over the microbatches over the
metric count of one. With n_microbatches = 1 it is the plain step.

Ranks. JAX runs one controller over `stage_devices`; the port runs one
process a rank, as `mesh.py` does, every rank calling the same methods
with the same arguments. `stage_ranks` holds one list of global ranks a
stage; a rank may hold several stages, whose boundary values it passes
on locally, and a pipeline whose stages all sit on rank 0 runs in one
process with no process group at all. A stage of more than one rank is
data-parallel over their sub-group (`Mesh(group=...)`): each rank runs
its stripe of the microbatch, BN's statistics, the metrics and dropout's
masks are the stage's whole microbatch's (the executor's `mesh`), and
the gradients are summed over the sub-group before the update. A
consumer stage's rank receives every stripe of a value and joins them;
cotangents go back stripe by stripe.

Transport: every boundary value, tap and cotangent moves by `broadcast`
on the two-rank group {producer, consumer} (gloo on CUDA tensors runs
only broadcast and all_reduce, and two ranks that share a card need
gloo); every rank creates every group, in the same order, and every rank
makes its transfers in one global order (stage by stage, value by
value), so blocking collectives cannot wait on each other in a cycle.
Shapes come from the tensor specs, dtypes from the executor's rules
(`compile.value_dtypes`); tensors other than fp32 and fp64 travel as
fp32 and are cast back, which is exact. The loss and `forward`'s
outputs end on every rank, broadcast over the default group from the
stage that made them; `shard` returns lists over every stage, filled
for this rank's stages only (None elsewhere); `gather` returns the
whole tree on every rank, later stages winning on duplicates.

Settings bcnn_tpu's Pipeline drops raise here (`_refuse`; ROADMAP Queue
3): its stages build the executor bare (`bcnn_tpu/parallel/pipeline.py:
236-249`), so in TRAIN it drops net.device_augment, net.accum_steps
(n_microbatches is the pipeline's own accumulation) and net.yolo_stats;
and `shard` keeps only STATE tensors, so net.qat's ranges would start
again from the first observation on each stage, and a stage's
end-of-pass observation would see the boundary values it imported:
net.qat raises outside PREDICT (where the executor ignores it).
`forward` returns an int8-flow output as its int8 codes, as bcnn_tpu's
returns `ex.values[i]` where `make_forward` dequantizes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..compile import (_Executor, build_grad_routing, child_generators,
                       value_dtypes)
from ..graph import Net, TensorKind
from ..learner import apply_updates
from ..types import LayerType, Mode
from .mesh import Mesh, _as_tensor, _rank_device, all_reduce_flat
from .model_axis import _layout, _wire

# ---------------------------------------------------------------------- #
# Stage splitting (`bcnn_tpu/parallel/pipeline.py:69-113`)
# ---------------------------------------------------------------------- #


def _node_flops(net: Net, node) -> float:
    """Rough per-node FLOP estimate for stage balancing (MACs x 2)."""
    if not node.dst:
        return 0.0
    out = net.tensors[node.dst[0]]
    out_sz = max(out.size(), 1)
    p = node.param
    if node.type == LayerType.CONV2D:
        cin = net.tensors[node.src[0]].c // max(p.get("num_groups", 1), 1)
        return 2.0 * out_sz * p["size"] * p["size"] * cin
    if node.type == LayerType.DEPTHWISE_CONV2D:
        return 2.0 * out_sz * p["size"] * p["size"]
    if node.type == LayerType.TRANSPOSE_CONV2D:
        cin = net.tensors[node.src[0]].c
        return 2.0 * out_sz * p["size"] * p["size"] * cin
    if node.type == LayerType.FULL_CONNECTED:
        return 2.0 * out_sz * net.tensors[node.src[0]].size3d()
    return float(out_sz)


def split_stages(net: Net, n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous [lo, hi) node ranges, greedily balanced by FLOPs: a cut
    where the running cost reaches the remaining cost over the stages
    left (re-targeted after each cut), or where only one node a
    remaining stage is left."""
    n_nodes = len(net.nodes)
    if not 1 <= n_stages <= n_nodes:
        raise ValueError(f"n_stages={n_stages} for {n_nodes} nodes")
    costs = [_node_flops(net, nd) for nd in net.nodes]
    ranges: List[Tuple[int, int]] = []
    lo, acc = 0, 0.0
    remaining = sum(costs)
    for i, c in enumerate(costs):
        acc += c
        stages_left = n_stages - len(ranges)
        nodes_left = n_nodes - i - 1
        if len(ranges) == n_stages - 1:
            break  # the last stage takes the tail
        if (
            acc >= remaining / stages_left or nodes_left == stages_left - 1
        ) and nodes_left >= stages_left - 1:
            ranges.append((lo, i + 1))
            lo, remaining, acc = i + 1, remaining - acc, 0.0
    ranges.append((lo, n_nodes))
    return ranges


# ---------------------------------------------------------------------- #
# Stage IO analysis (`pipeline.py:121-222`)
# ---------------------------------------------------------------------- #


class _StageIO:
    """Static boundary sets for one stage."""

    def __init__(self):
        self.pipe_in: List[int] = []    # tensor idx from earlier stages
        self.pipe_out: List[int] = []   # tensor idx read by later stages
        self.ext_in: List[int] = []     # host-fed tensors (input/label/...)
        self.taps_in: List[Tuple[int, int]] = []   # grad-routing taps
        self.taps_out: List[Tuple[int, int]] = []
        self.param_keys: List[str] = []
        self.state_keys: List[str] = []


def _stage_of_node(ranges) -> Dict[int, int]:
    return {i: k for k, (lo, hi) in enumerate(ranges) for i in range(lo, hi)}


def _routes(net: Net, mode: Mode):
    """The grad-routing taps that cross a stage boundary come from these
    (TRAIN under net.ref_grad_routing only)."""
    if mode == Mode.TRAIN and getattr(net, "ref_grad_routing", True):
        return build_grad_routing(net)
    return {}


def stage_io(net: Net, ranges, mode: Mode) -> List[_StageIO]:
    stage_of_node = _stage_of_node(ranges)
    produced_by: Dict[int, int] = {}  # tensor idx -> stage that last wrote it
    ever_produced = set()
    for lo, hi in ranges:
        for i in range(lo, hi):
            ever_produced.update(net.nodes[i].dst)

    ios = [_StageIO() for _ in ranges]
    for k, (lo, hi) in enumerate(ranges):
        io = ios[k]
        written_here = set()
        pipe, ext = set(), set()
        pkeys, skeys = [], []
        for i in range(lo, hi):
            node = net.nodes[i]
            for s in node.src:
                t = net.tensors[s]
                if t.kind == TensorKind.PARAM:
                    if t.key not in pkeys:
                        pkeys.append(t.key)
                elif t.kind == TensorKind.STATE:
                    if t.key not in skeys:
                        skeys.append(t.key)
                elif s not in written_here:
                    if s in produced_by:
                        pipe.add(s)
                    elif s not in ever_produced:
                        ext.add(s)
            # cost nodes read the label (tensor 1) implicitly
            if node.type in (LayerType.COST, LayerType.YOLOV3):
                if 1 not in ever_produced and len(net.tensors) > 1:
                    ext.add(1)
            written_here.update(node.dst)
        for d in written_here:
            produced_by[d] = k
        io.pipe_in = sorted(pipe)
        io.ext_in = sorted(ext)
        io.param_keys = pkeys
        io.state_keys = skeys

    # pipe_out: everything a later stage imports, attributed to the last
    # stage that wrote it before the importer
    last_writer: Dict[int, int] = {}
    for k, (lo, hi) in enumerate(ranges):
        for s in ios[k].pipe_in:
            ios[last_writer[s]].pipe_out.append(s)
        for i in range(lo, hi):
            for d in net.nodes[i].dst:
                last_writer[d] = k
    for io in ios:
        io.pipe_out = sorted(set(io.pipe_out))

    for (d, prod_pos), rec in _routes(net, mode).items():
        pk = stage_of_node[prod_pos]
        for cons_pos, _ov in rec:
            ck = stage_of_node[cons_pos]
            if ck != pk:
                ios[pk].taps_out.append((d, cons_pos))
                ios[ck].taps_in.append((d, cons_pos))
    for io in ios:
        io.taps_out = sorted(set(io.taps_out))
        io.taps_in = sorted(set(io.taps_in))
    return ios


def _metric_count(net: Net, lo: int, hi: int, mode: Mode) -> int:
    """How many scalars this stage appends to ex.metrics."""
    if mode == Mode.PREDICT:
        return 0
    n = 0
    for i in range(lo, hi):
        t = net.nodes[i].type
        if t == LayerType.COST:
            n += 1
        elif t == LayerType.YOLOV3 and mode == Mode.TRAIN:
            n += 1
    return n


# ---------------------------------------------------------------------- #
# The pipeline
# ---------------------------------------------------------------------- #


def _refuse(net: Net, mode: Mode) -> None:
    """Raise on each net setting bcnn_tpu's Pipeline drops (module
    docstring; ROADMAP Queue 3)."""
    train = mode == Mode.TRAIN
    dropped = [name for name, on in (
        ("device_augment",
         train and getattr(net, "device_augment", None) is not None),
        ("accum_steps",
         train and int(getattr(net, "accum_steps", 1) or 1) > 1),
        ("yolo_stats", train and bool(getattr(net, "yolo_stats", False))),
        ("qat", mode != Mode.PREDICT and bool(getattr(net, "qat", None))),
    ) if on]
    if dropped:
        raise ValueError(
            f"Pipeline does not honour net.{', net.'.join(dropped)}: "
            f"bcnn_tpu's Pipeline drops {'them' if len(dropped) > 1 else 'it'}"
            " (its stages build the executor bare, and shard keeps only the "
            "STATE tensors); unset it (n_microbatches is the pipeline's own "
            "accumulation), or train on one device")


class _Stash:
    """What a stage keeps of one microbatch's forward for its backward."""

    def __init__(self, pipe, taps, ext, seed, state, outs=None):
        self.pipe, self.taps, self.ext = pipe, taps, ext
        self.seed, self.state, self.outs = seed, state, outs


def _leaf(v: torch.Tensor) -> torch.Tensor:
    return v.detach().requires_grad_(v.is_floating_point())


class Pipeline:
    """Stage-partitioned executor over explicit ranks (module docstring).

    stage_ranks: one list of global ranks a stage (a singleton: pure
    pipeline; longer: that stage is data-parallel over its sub-group).
    device: this rank's device (None: its card, `cuda:<local rank>`;
    "cpu" for gloo ranks, or one process, on the CPU)."""

    def __init__(
        self,
        net: Net,
        stage_ranks: Sequence[Sequence[int]],
        mode: Mode = Mode.TRAIN,
        n_microbatches: int = 1,
        boundaries: Optional[List[Tuple[int, int]]] = None,
        output_names: Sequence[str] = (),
        schedule: str = "gpipe",
        device=None,
    ):
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"unknown schedule {schedule!r}")
        _refuse(net, mode)
        self.net = net
        self.mode = mode
        self.schedule = schedule
        self.n_micro = n_microbatches
        if n_microbatches < 1 or net.batch_size % n_microbatches:
            raise ValueError(
                f"batch_size {net.batch_size} not divisible by "
                f"n_microbatches {n_microbatches}"
            )
        self.mb = net.batch_size // n_microbatches
        self.stage_ranks = [[int(r) for r in rs] for rs in stage_ranks]
        self.n_stages = len(self.stage_ranks)
        for rs in self.stage_ranks:
            if not rs or len(set(rs)) != len(rs):
                raise ValueError(f"a stage needs distinct ranks, not {rs}")
            if self.mb % len(rs):
                raise ValueError(f"a microbatch of {self.mb} rows does not "
                                 f"divide by the {len(rs)} ranks {rs}")
        self.ranges = list(boundaries or split_stages(net, self.n_stages))
        if len(self.ranges) != self.n_stages:
            raise ValueError("boundaries/stage_ranks length mismatch")
        self.ios = stage_io(net, self.ranges, mode)
        self.metric_counts = [
            _metric_count(net, lo, hi, mode) for lo, hi in self.ranges
        ]
        out_idx = [net.get_tensor_index_by_name(n) for n in output_names]
        self.extract = [
            [i for i in out_idx if self._stage_of_tensor(i) == k]
            for k in range(self.n_stages)
        ]
        self.out_order = out_idx
        self.dtypes = value_dtypes(net, mode)
        self._sources()
        self._connect(device)
        # a check the tests turn on: each recompute's boundary outputs
        # compared with the first forward's, bit for bit (RuntimeError
        # where they differ)
        self._check_recompute = False

    def _stage_of_tensor(self, idx: int) -> int:
        last = None
        for k, (lo, hi) in enumerate(self.ranges):
            for i in range(lo, hi):
                if idx in self.net.nodes[i].dst:
                    last = k
        if last is None:
            raise ValueError(
                f"tensor {idx} ({self.net.tensors[idx].name!r}) is not "
                "produced by any node; pipeline outputs must be node "
                "outputs (host-fed inputs cannot be requested)"
            )
        return last

    def _sources(self) -> None:
        """The stage each boundary value and tap of a stage comes from."""
        last_writer: Dict[int, int] = {}
        self.pipe_src: List[Dict[int, int]] = []
        for k, (lo, hi) in enumerate(self.ranges):
            self.pipe_src.append({i: last_writer[i]
                                  for i in self.ios[k].pipe_in})
            for i in range(lo, hi):
                for d in self.net.nodes[i].dst:
                    last_writer[d] = k
        of = _stage_of_node(self.ranges)
        self.tap_src: List[Dict[Tuple[int, int], int]] = [
            {} for _ in self.ranges]
        for (d, prod_pos), rec in _routes(self.net, self.mode).items():
            for cons_pos, _ov in rec:
                if of[cons_pos] != of[prod_pos]:
                    self.tap_src[of[cons_pos]][(d, cons_pos)] = of[prod_pos]

    def _connect(self, device) -> None:
        """This rank, its device, the data-parallel stages' meshes and the
        two-rank groups of the transfers; every rank makes every group,
        in the same order."""
        if dist.is_available() and dist.is_initialized():
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            self.device = _rank_device(device, dist.get_backend())
        else:
            self.rank, self.world = 0, 1
            if any(rs != [0] for rs in self.stage_ranks):
                raise ValueError(
                    "without an initialized process group every stage sits "
                    f"on rank 0, not {self.stage_ranks}")
            self.device = _rank_device(device)
        if max(max(rs) for rs in self.stage_ranks) >= self.world:
            raise ValueError(f"stage ranks {self.stage_ranks} for a world "
                             f"of {self.world}")
        self.mine = [self.rank in rs for rs in self.stage_ranks]
        self.meshes: List[Optional[Mesh]] = [None] * self.n_stages
        for k, rs in enumerate(self.stage_ranks):
            if len(rs) > 1:
                group = dist.new_group(rs)
                if self.mine[k]:
                    self.meshes[k] = Mesh(group, self.device)
        pairs = set()
        for j, io in enumerate(self.ios):
            srcs = [self.pipe_src[j][i] for i in io.pipe_in] + [
                self.tap_src[j][key] for key in io.taps_in]
            for k in srcs:
                for p in self.stage_ranks[k]:
                    for c in self.stage_ranks[j]:
                        if p != c:
                            pairs.add((min(p, c), max(p, c)))
        self._pairs = {pc: dist.new_group(list(pc)) for pc in sorted(pairs)}

    # -- transport ------------------------------------------------------- #

    def _rows(self, k: int, a: int) -> Tuple[int, int]:
        """Rows [lo, hi) of the microbatch that position a of stage k's
        ranks holds."""
        n = self.mb // len(self.stage_ranks[k])
        return a * n, (a + 1) * n

    def _tail(self, idx: int) -> Tuple[int, int, int]:
        t = self.net.tensors[idx]
        return (t.c, t.h, t.w)

    def _send(self, t: torch.Tensor, src: int, dst: int) -> None:
        buf = t.detach().to(_wire(t.dtype)).contiguous()
        dist.broadcast(buf, src=src, group=self._pairs[(min(src, dst),
                                                        max(src, dst))])

    def _recv(self, shape, dtype, src: int, dst: int) -> torch.Tensor:
        buf = torch.empty(shape, dtype=_wire(dtype), device=self.device)
        dist.broadcast(buf, src=src, group=self._pairs[(min(src, dst),
                                                        max(src, dst))])
        return _layout(buf.to(dtype))

    def _check(self, idx: int, v: torch.Tensor, rows: int) -> None:
        want = (rows,) + self._tail(idx)
        if tuple(v.shape) != want or v.dtype != self.dtypes[idx]:
            raise RuntimeError(
                f"Pipeline: boundary tensor {self.net.tensors[idx].name!r} "
                f"is {tuple(v.shape)} {v.dtype}, where the specs and the "
                f"executor's rules give {want} {self.dtypes[idx]}")

    def _forward_value(self, k: int, j: int, idx: int,
                       held: Optional[torch.Tensor]):
        """This rank's stripe, for stage j, of the value idx that stage k
        produced (held: this rank's stripe of it, on stage k's ranks):
        each of stage k's stripes moved to each of stage j's ranks, which
        join them. None off stage j."""
        pk, cj, me = self.stage_ranks[k], self.stage_ranks[j], self.rank
        if me not in pk and me not in cj:
            return None
        if pk == cj == [me]:
            self._check(idx, held, self.mb)
            return held
        tail, dtype = self._tail(idx), self.dtypes[idx]
        pieces = []
        for a, p in enumerate(pk):
            lo, hi = self._rows(k, a)
            if me == p:
                self._check(idx, held, hi - lo)
            piece = held if me == p else None
            for c in cj:
                if c == p:
                    continue
                if me == p:
                    self._send(held, p, c)
                elif me == c:
                    piece = self._recv((hi - lo,) + tail, dtype, p, c)
            pieces.append(piece)
        if me not in cj:
            return None
        full = pieces[0] if len(pieces) == 1 else _layout(torch.cat(pieces))
        if len(cj) > 1:
            lo, hi = self._rows(j, cj.index(me))
            full = full[lo:hi]
        return full

    def _backward_value(self, k: int, j: int, idx: int,
                        grad: Optional[torch.Tensor]):
        """The cotangent, on a rank of stage k, of its stripe of value idx
        from stage j's ranks (grad: this rank's gradient in its stage-j
        stripe): each consumer sends the rows it shares with each
        producer's stripe, which adds them up. None off stage k."""
        pk, cj, me = self.stage_ranks[k], self.stage_ranks[j], self.rank
        if me not in pk and me not in cj:
            return None
        if pk == cj == [me]:
            return grad
        tail, dtype = self._tail(idx), self.dtypes[idx]
        mine = None
        for a, p in enumerate(pk):
            plo, phi = self._rows(k, a)
            parts = []
            for b, c in enumerate(cj):
                clo, chi = self._rows(j, b)
                lo, hi = max(plo, clo), min(phi, chi)
                if lo >= hi:
                    continue
                if me == c and c != p:
                    self._send(grad[lo - clo:hi - clo], c, p)
                elif me == p:
                    part = (grad[lo - clo:hi - clo] if c == p else
                            self._recv((hi - lo,) + tail, dtype, c, p))
                    parts.append((lo - plo, part))
            if me != p:
                continue
            if len(parts) == 1 and parts[0][1].shape[0] == phi - plo:
                mine = parts[0][1]
            else:
                mine = torch.zeros((phi - plo,) + tail, dtype=dtype,
                                   device=self.device)
                for off, part in parts:
                    mine[off:off + part.shape[0]] += part
        return mine

    def _broadcast_rows(self, k: int, idx: int, stripe):
        """Stage k's stripes of a microbatch's value idx, joined on every
        rank (broadcast over the default group from each of its ranks)."""
        if self.world == 1:
            return stripe
        tail, dtype = self._tail(idx), self.dtypes[idx]
        pieces = []
        for a, p in enumerate(self.stage_ranks[k]):
            lo, hi = self._rows(k, a)
            if self.rank == p:
                buf = stripe.detach().to(_wire(dtype)).contiguous()
            else:
                buf = torch.empty((hi - lo,) + tail, dtype=_wire(dtype),
                                  device=self.device)
            dist.broadcast(buf, src=p)
            pieces.append(buf.to(dtype))
        return _layout(torch.cat(pieces))

    # -- placement ------------------------------------------------------- #

    def shard(self, params, state, opt_state=None):
        """Split the full trees into per-stage subtrees on this rank's
        device: (params_list, state_list[, opt_list]), each a list over
        every stage, None for the stages other ranks hold."""
        def put(t):
            return _as_tensor(t).to(self.device, copy=True)

        def sub(d, keys):
            return {k: put(d[k]) for k in keys if k in d}

        ps, ss, os_ = [], [], []
        for k, io in enumerate(self.ios):
            if not self.mine[k]:
                ps.append(None)
                ss.append(None)
                os_.append(None)
                continue
            ps.append(sub(params, io.param_keys))
            ss.append(sub(state, io.state_keys))
            if opt_state is not None:
                os_.append({
                    "seen": int(opt_state["seen"]),
                    "velocity": sub(opt_state["velocity"], io.param_keys),
                    "adam_m": sub(opt_state["adam_m"], io.param_keys),
                    "adam_v": sub(opt_state["adam_v"], io.param_keys),
                })
        if opt_state is not None:
            return ps, ss, os_
        return ps, ss

    def gather(self, parts: Sequence[Optional[Dict[str, Any]]]
               ) -> Dict[str, torch.Tensor]:
        """Merge per-stage subtrees (flat dicts of tensors) into one tree
        on the host, on every rank; later stages win on duplicates. Each
        stage's subtree is broadcast from its first rank."""
        out: Dict[str, torch.Tensor] = {}
        for k, sub in enumerate(parts):
            src = self.stage_ranks[k][0]
            if self.world == 1:
                meta = [(key, None, None) for key in sub]
            else:
                box = [[(key, tuple(v.shape), v.dtype)
                        for key, v in sub.items()] if self.rank == src
                       else None]
                dist.broadcast_object_list(box, src=src)
                meta = box[0]
            for key, shape, dtype in meta:
                if self.world == 1:
                    v = sub[key].detach()
                else:
                    if self.rank == src:
                        buf = sub[key].detach().to(_wire(dtype)).contiguous()
                    else:
                        buf = torch.empty(shape, dtype=_wire(dtype),
                                          device=self.device)
                    dist.broadcast(buf, src=src)
                    v = buf.to(dtype)
                out[key] = v.cpu().clone()
        return out

    def _batch_on_device(self, batch) -> Dict[str, torch.Tensor]:
        return {name: _as_tensor(v).to(self.device) for name, v in
                batch.items()}

    def _micro_ext(self, k: int, batch: Dict[str, torch.Tensor], m: int
                   ) -> Dict[int, torch.Tensor]:
        """{tensor idx: this rank's stripe of microbatch m} of stage k's
        host-fed inputs; absent batch keys are omitted (a cost node
        without ground truth is forward-only). A training input that is
        not fp32 is cast to it, as `make_train_step` casts it."""
        lo, hi = m * self.mb, (m + 1) * self.mb
        rs = self.stage_ranks[k]
        if len(rs) > 1:
            a, b = self._rows(k, rs.index(self.rank))
            lo, hi = lo + a, lo + b
        vals = {}
        for idx in self.ios[k].ext_in:
            name = "input" if idx == 0 else (
                "label" if idx == 1 else self.net.tensors[idx].name
            )
            if name not in batch:
                continue
            v = batch[name][lo:hi]
            if (idx == 0 and self.mode == Mode.TRAIN
                    and v.dtype != torch.float32):
                v = v.to(torch.float32)
            vals[idx] = v
        return vals

    def _run_stage(self, k: int, params, state, pipe, taps, ext, seed):
        lo, hi = self.ranges[k]
        io = self.ios[k]
        ex = _Executor(self.net, params, state, self.mode, seed,
                       mesh=self.meshes[k])
        ex.values.update(zip(io.pipe_in, pipe))
        ex.values.update(ext)
        return ex.run(lo, hi, taps_in=dict(zip(io.taps_in, taps)))

    def _inputs(self, k: int, held, held_taps=None):
        """This rank's boundary inputs of stage k, and with held_taps its
        taps, moved from the stages that made them."""
        io = self.ios[k]
        pipe = [self._forward_value(self.pipe_src[k][i], k, i,
                                    held.get((self.pipe_src[k][i], i)))
                for i in io.pipe_in]
        if held_taps is None:
            return pipe, []
        taps = [self._forward_value(self.tap_src[k][key], k, key[0],
                                    held_taps.get(key))
                for key in io.taps_in]
        return pipe, taps

    # -- forward --------------------------------------------------------- #

    def forward(self, params_list, state_list, batch):
        """Microbatched pipelined forward: the requested output tensors
        (NCHW), concatenated over microbatches, on every rank; an int8-flow
        output as its int8 codes (module docstring)."""
        collected: Dict[int, List[torch.Tensor]] = {i: [] for i in
                                                    self.out_order}
        with torch.no_grad():
            dev = self._batch_on_device(batch)
            for m in range(self.n_micro):
                held: Dict[Tuple[int, int], torch.Tensor] = {}
                for k in range(self.n_stages):
                    pipe, _ = self._inputs(k, held)
                    if not self.mine[k]:
                        continue
                    ex = self._run_stage(k, params_list[k], state_list[k],
                                         pipe, [], self._micro_ext(k, dev, m),
                                         None)
                    for i in self.ios[k].pipe_out:
                        held[(k, i)] = ex.values[i]
                    for i in self.extract[k]:
                        collected[i].append(ex.values[i])
                    del ex
            outs = []
            for i in self.out_order:
                k = self._stage_of_tensor(i)
                parts = [self._broadcast_rows(
                    k, i, collected[i][m] if self.mine[k] else None)
                    for m in range(self.n_micro)]
                # NCHW (int8 channels-last) also where a stage's executor
                # held its bf16 values channels-last
                outs.append(_layout(torch.cat(parts) if len(parts) > 1
                                    else parts[0]))
        return tuple(outs)

    # -- training -------------------------------------------------------- #

    def _forward_micro(self, params_list, states, batch, m, seed):
        """Forward one microbatch through every stage, without autograd.
        Updates `states` in place (BN's running stats go through the
        microbatches in order). Returns (this rank's stash a stage, its
        metrics a stage)."""
        stash: List[Optional[_Stash]] = [None] * self.n_stages
        metrics: List[list] = [[] for _ in range(self.n_stages)]
        held: Dict[Tuple[int, int], torch.Tensor] = {}
        held_taps: Dict[Tuple[int, int], torch.Tensor] = {}
        for k in range(self.n_stages):
            pipe, taps = self._inputs(k, held, held_taps)
            if not self.mine[k]:
                continue
            io = self.ios[k]
            ext = self._micro_ext(k, batch, m)
            with torch.no_grad():
                ex = self._run_stage(k, params_list[k], states[k], pipe, taps,
                                     ext, seed)
            outs = ([ex.values[i] for i in io.pipe_out]
                    + [ex.taps[key] for key in io.taps_out])
            stash[k] = _Stash(pipe, taps, ext, seed, states[k],
                              outs if self._check_recompute else None)
            states[k] = ex.state
            for i in io.pipe_out:
                held[(k, i)] = ex.values[i]
            for key in io.taps_out:
                held_taps[key] = ex.taps[key]
            if len(ex.metrics) != self.metric_counts[k]:
                raise ValueError(
                    f"stage {k} reported {len(ex.metrics)} metrics where its "
                    f"cost layers make {self.metric_counts[k]}: pass the "
                    "batch's label")
            metrics[k] = [v.detach() for v in ex.metrics]
            # the stage's other values die here, not during the next stage
            del ex, outs
        return stash, metrics

    def _backward_micro(self, leaves_list, stash) -> None:
        """Backward one microbatch: each stage in reverse order runs again
        from its stash, and autograd takes the cotangents of its outputs
        into its parameters' .grad and its boundary inputs, whose
        cotangents go back to the stages that made them."""
        cot_vals: Dict[Tuple[int, int], torch.Tensor] = {}
        cot_taps: Dict[Tuple[int, int], torch.Tensor] = {}
        for k in reversed(range(self.n_stages)):
            io = self.ios[k]
            g_pipe: List[Optional[torch.Tensor]] = [None] * len(io.pipe_in)
            g_taps: List[Optional[torch.Tensor]] = [None] * len(io.taps_in)
            if self.mine[k]:
                s = stash[k]
                pipe = [_leaf(v) for v in s.pipe]
                taps = [_leaf(v) for v in s.taps]
                ex = self._run_stage(k, leaves_list[k], s.state, pipe, taps,
                                     s.ext, s.seed)
                outs = ([ex.values[i] for i in io.pipe_out]
                        + [ex.taps[key] for key in io.taps_out])
                sur = ex.surrogate
                # what autograd does not keep dies before the backward
                del ex
                if s.outs is not None and not all(
                        torch.equal(o.detach(), first)
                        for o, first in zip(outs, s.outs)):
                    raise RuntimeError(
                        f"stage {k}'s recompute differs from its first "
                        "forward")
                cots = [cot_vals.pop((k, i), None) for i in io.pipe_out] + [
                    cot_taps.pop(key, None) for key in io.taps_out]
                pairs = [(o, c if c is not None else torch.zeros_like(o))
                         for o, c in zip(outs, cots) if o.requires_grad]
                if sur is not None and sur.requires_grad:
                    pairs.append((sur, torch.ones_like(sur)))
                if pairs:
                    torch.autograd.backward([o for o, _ in pairs],
                                            [c for _, c in pairs])
                g_pipe = [v.grad if v.grad is not None
                          else torch.zeros_like(v) for v in pipe]
                g_taps = [v.grad if v.grad is not None
                          else torch.zeros_like(v) for v in taps]
                # free the stage's values and stash before the next stage
                del outs, cots, pairs, sur, pipe, taps, s
                stash[k] = None
            for i, g in zip(io.pipe_in, g_pipe):
                src = self.pipe_src[k][i]
                g = self._backward_value(src, k, i, g)
                if g is not None:
                    key = (src, i)
                    cot_vals[key] = cot_vals[key] + g if key in cot_vals else g
            for key, g in zip(io.taps_in, g_taps):
                g = self._backward_value(self.tap_src[k][key], k, key[0], g)
                if g is not None:
                    cot_taps[key] = (cot_taps[key] + g if key in cot_taps
                                     else g)

    def _loss(self, metrics_m) -> torch.Tensor:
        """metric_sum / n_metrics over every stage's metrics, in the JAX
        package's order (microbatch by microbatch, stage by stage), on
        every rank (each stage's broadcast from its first rank)."""
        n_metrics = sum(self.metric_counts)
        if not n_metrics:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        table: List[Optional[torch.Tensor]] = [None] * self.n_stages
        for k in range(self.n_stages):
            n = self.n_micro * self.metric_counts[k]
            if not n:
                continue
            src = self.stage_ranks[k][0]
            if self.rank == src:
                flat = torch.stack([v.to(torch.float32).reshape(())
                                    for mt in metrics_m for v in mt[k]])
            else:
                flat = torch.empty(n, dtype=torch.float32,
                                   device=self.device)
            if self.world > 1:
                dist.broadcast(flat, src=src)
            table[k] = flat.reshape(self.n_micro, self.metric_counts[k])
        metric_sum = None
        for m in range(self.n_micro):
            for k in range(self.n_stages):
                if table[k] is None:
                    continue
                for s in table[k][m]:
                    metric_sum = s if metric_sum is None else metric_sum + s
        return metric_sum / n_metrics

    def _seeds(self, generator) -> List[int]:
        """Each microbatch's dropout seed: a draw from its generator (the
        m-th of child_generators(generator, n_microbatches); with one
        microbatch, generator itself), as `make_train_step` draws it.
        With no generator the draws come from torch's default one, so
        that the recompute still draws the forward's masks; across ranks
        rank 0's draws are broadcast, since each rank's default generator
        has moved its own way."""
        gens = ([generator] if self.n_micro == 1
                else child_generators(generator, self.n_micro))
        seeds = [int(torch.randint(2**62, (), generator=g)) for g in gens]
        if generator is None and self.world > 1:
            box = torch.tensor(seeds, dtype=torch.int64, device=self.device)
            dist.broadcast(box, src=0)
            seeds = [int(v) for v in box.tolist()]
        return seeds

    def train_on_batch(self, params_list, state_list, opt_list, batch,
                       generator: Optional[torch.Generator] = None):
        """One full-batch training step (module docstring): returns
        (params_list, state_list, opt_list, loss), the loss on every rank;
        params and optimizer state are updated in place."""
        if self.mode != Mode.TRAIN:
            raise ValueError("train_on_batch needs a Pipeline in TRAIN mode")
        specs = {t.key: t for t in self.net.param_specs()}
        has_dropout = any(n.type == LayerType.DROPOUT for n in self.net.nodes)
        seeds = [None] * self.n_micro
        if has_dropout:
            seeds = self._seeds(generator)
        dev = self._batch_on_device(batch)
        states = list(state_list)
        leaves = [
            {key: v.detach().requires_grad_(specs[key].trainable)
             for key, v in params_list[k].items()} if self.mine[k] else None
            for k in range(self.n_stages)]
        metrics_m = []
        if self.schedule == "1f1b":
            for m in range(self.n_micro):
                stash, mt = self._forward_micro(params_list, states, dev, m,
                                                seeds[m])
                metrics_m.append(mt)
                self._backward_micro(leaves, stash)
                del stash
        else:  # gpipe
            stashes = []
            for m in range(self.n_micro):
                stash, mt = self._forward_micro(params_list, states, dev, m,
                                                seeds[m])
                stashes.append(stash)
                metrics_m.append(mt)
            for stash in stashes:
                self._backward_micro(leaves, stash)
            del stashes

        # ---- per-stage optimizer update on batch-summed grads
        new_params, new_opt = [], []
        for k in range(self.n_stages):
            if not self.mine[k]:
                new_params.append(None)
                new_opt.append(None)
                continue
            grads = {key: v.grad if v.grad is not None else torch.zeros_like(v)
                     for key, v in leaves[k].items() if specs[key].trainable}
            if self.meshes[k] is not None:
                all_reduce_flat(self.meshes[k], list(grads.values()))
            p2, o2 = apply_updates(self.net, params_list[k], grads,
                                   opt_list[k])
            new_params.append(p2)
            new_opt.append(o2)
        return new_params, states, new_opt, self._loss(metrics_m).detach()
