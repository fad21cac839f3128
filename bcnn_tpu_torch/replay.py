"""A training step's discrete choices, recorded on one run and imposed
on another, and the SGD update that a run's gradients make.

Two runs of one TRAIN step (on another device, in another precision)
part where a choice flips: a RELU or LRELU unit whose input lies within
rounding of 0 takes the other slope, a max-pool window whose largest
inputs tie within rounding sends its gradient to another input, and
under net.qat a fake-quant input within rounding of a code's boundary
rounds to the next code (or, at the range's end, falls outside it and
passes no gradient). The
gradient then moves by the whole slope, or the whole input, there, and a
BN layer's backward spreads that over the unit's channel and every layer
below it: the two updates part by percents with neither run at fault.

`record(choices)` keeps every kink's side (x > 0) and every window's pick
of the forward run inside its `with` block; `impose(choices)` makes the
forward inside its block take them, so that the two runs differ by
rounding only. Both patch the executor's ops (`ops.apply_activation`,
`ops.maxpool` and `ops.quant.fake_quant_ste`) for the block and keep the
choices in the order the forward makes them, which is the net's node
order: `kinked_nodes` and `pooling_nodes` name the node of each entry;
the fake quant's come in pairs, a node's input, then its weight.

`sgd_update` runs one step's forward and backward on a device in a
dtype (float64 for a reference), under `record` or `impose` if given,
and returns the update that one SGD step makes from those gradients:
fp32, on the CPU, from a fresh optimizer state (`learner.apply_updates`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F

from . import ops
from .compile import execute
from .ops import quant
from .graph import Net
from .learner import apply_updates, init_opt_state
from .types import Activation, LayerType, Mode

# the activations with a kink at 0, and their slope below it
KINKED = {Activation.RELU: 0.0, Activation.LRELU: 0.1}
# how far, in codes, a run's x / s may lie from the rounding interval of
# a code it imposes: that code was taken by a forward of the same
# choices in another precision or on another device, which differs from
# this run's by rounding only
CODE_EPS = 1e-2


@dataclass
class Choices:
    """kinks: one bool tensor (x > 0) per RELU/LRELU call; picks: one
    int64 tensor (N, C, out_h, out_w) per max-pool call, the index of the
    input each window takes within its size x size window (row-major);
    codes and inside: per fake-quant call, the int8 code of each value
    and whether it lies inside the range (its gradient 1, else 0); all
    on the CPU, in call order. boundary and off: set by the last
    `impose` of these choices."""
    kinks: List[torch.Tensor] = field(default_factory=list)
    picks: List[torch.Tensor] = field(default_factory=list)
    codes: List[torch.Tensor] = field(default_factory=list)
    inside: List[torch.Tensor] = field(default_factory=list)
    boundary: List[int] = field(default_factory=list)
    off: List[float] = field(default_factory=list)


def kinked_nodes(net: Net) -> List[int]:
    """The node of each entry of `Choices.kinks`."""
    return [i for i, n in enumerate(net.nodes)
            if n.param.get("activation") in KINKED]


def pooling_nodes(net: Net) -> List[int]:
    """The node of each entry of `Choices.picks`."""
    return [i for i, n in enumerate(net.nodes)
            if n.type == LayerType.MAXPOOL]


def windows(x: torch.Tensor, size: int, stride: int, out_h: int,
            out_w: int, offset: int = 0) -> torch.Tensor:
    """x: NCHW -> (N, C, out_h, out_w, size * size), each max-pool
    window's inputs, padded with -inf as `ops.maxpool` pads (by `offset`
    on the low side, and on the high side as the output needs)."""
    pad_h = max(0, (out_h - 1) * stride + size - x.shape[2] - offset)
    pad_w = max(0, (out_w - 1) * stride + size - x.shape[3] - offset)
    x = F.pad(x, (offset, pad_w, offset, pad_h), value=float("-inf"))
    return x.unfold(2, size, stride).unfold(3, size, stride).flatten(-2)


def fake_quant_choice(x: torch.Tensor, scale: torch.Tensor):
    """(int8 codes, inside) of `quant.fake_quant_ste(x, scale)`: the
    codes its forward takes and where its gradient is 1."""
    s = scale.detach()
    x = x.detach().to(torch.promote_types(x.dtype, s.dtype))
    codes = torch.clamp(torch.round(x / s), -127.0, 127.0)
    return codes.to(torch.int8), x.abs() <= 127.0 * s


@contextlib.contextmanager
def _patched(activation, maxpool, fake_quant):
    saved = ops.apply_activation, ops.maxpool, quant.fake_quant_ste
    ops.apply_activation, ops.maxpool = activation, maxpool
    quant.fake_quant_ste = fake_quant
    try:
        yield
    finally:
        ops.apply_activation, ops.maxpool, quant.fake_quant_ste = saved


def record(choices: Choices, when: Optional[Callable[[], bool]] = None):
    """A context in which the executor's forward appends its choices to
    `choices` and computes as it always does. when: a call's choices are
    kept only where when() is true (None: every call's), e.g. a
    pipeline's forwards, which run without autograd, and not their
    recomputes."""
    act0, pool0, fq0 = ops.apply_activation, ops.maxpool, \
        quant.fake_quant_ste

    def keep():
        return when is None or when()

    def activation(x, act, slopes=None):
        if act in KINKED and keep():
            choices.kinks.append((x > 0).detach().cpu())
        return act0(x, act, slopes)

    def maxpool(x, size, stride, out_h, out_w, offset=0):
        if keep():
            choices.picks.append(windows(x.detach(), size, stride, out_h,
                                         out_w, offset).argmax(-1).cpu())
        return pool0(x, size, stride, out_h, out_w, offset)

    def fake_quant(x, scale):
        if keep():
            codes, inside = fake_quant_choice(x, scale)
            choices.codes.append(codes.cpu())
            choices.inside.append(inside.cpu())
        return fq0(x, scale)

    return _patched(activation, maxpool, fake_quant)


@contextlib.contextmanager
def impose(choices: Choices):
    """A context in which the executor's forward takes `choices` in
    order: a kinked unit is x or slope * x as its recorded side says (its
    gradient 1 or slope), a max-pool window outputs (and sends its
    gradient to) its recorded pick, a fake quant outputs its recorded
    code times the scale, with a gradient of 1 where it was inside the
    range and 0 elsewhere. Each imposed code is held to this run's own
    x / s: it must lie within 0.5 + CODE_EPS of it (clipped to the
    range), and its inside mask must agree except within CODE_EPS of
    127; per fake-quant call, `choices.boundary` gets how many imposed
    codes (or masks) this run would have taken otherwise, and
    `choices.off` how far, in codes, the farthest imposed code lies
    outside the interval that rounds to it (negative: inside). Raises
    ValueError on a code or mask outside that, or if the forward's calls
    do not match the record in number or shape."""
    act0, pool0 = ops.apply_activation, ops.maxpool
    kinks, picks = iter(choices.kinks), iter(choices.picks)
    codes, insides = iter(choices.codes), iter(choices.inside)
    choices.boundary, choices.off = [], []

    def take(it, what, shape):
        got = next(it, None)
        if got is None or tuple(got.shape) != tuple(shape):
            raise ValueError(f"the forward's {what} call of shape "
                             f"{tuple(shape)} has no recorded choice")
        return got

    def activation(x, act, slopes=None):
        if act not in KINKED:
            return act0(x, act, slopes)
        side = take(kinks, act.name, x.shape).to(x.device)
        return torch.where(side, x, KINKED[act] * x)

    def maxpool(x, size, stride, out_h, out_w, offset=0):
        win = windows(x, size, stride, out_h, out_w, offset)
        pick = take(picks, "MAXPOOL", win.shape[:-1]).to(x.device)
        return win.gather(-1, pick.unsqueeze(-1)).squeeze(-1)

    def fake_quant(x, scale):
        s = scale.detach()
        x = x.to(torch.promote_types(x.dtype, s.dtype))
        code = take(codes, "fake quant", x.shape).to(x.device, x.dtype)
        inside = take(insides, "fake quant", x.shape).to(x.device)
        v = x.detach() / s
        off = float(((v.clamp(-127.0, 127.0) - code).abs() - 0.5).max())
        own, own_inside = fake_quant_choice(x, scale)
        stray = (inside != own_inside) & ((v.abs() - 127.0).abs() > CODE_EPS)
        if off > CODE_EPS or bool(stray.any()):
            raise ValueError(
                f"fake quant {len(choices.boundary)}: an imposed code lies "
                f"{off + 0.5:.4g} codes from this run's x / s, or "
                f"{int(stray.sum())} inside masks differ away from 127")
        choices.boundary.append(int(((own.to(code.dtype) != code)
                                     | (own_inside != inside)).sum()))
        choices.off.append(off)
        q = (code * s).detach()
        return torch.where(inside, x + (q - x).detach(), q)

    with _patched(activation, maxpool, fake_quant):
        yield
    if any(next(it, None) is not None
           for it in (kinks, picks, codes, insides)):
        raise ValueError("the forward made fewer choices than were "
                         "recorded")


def sgd_update(net: Net, params: Dict[str, torch.Tensor],
               state: Dict[str, torch.Tensor], batch: Dict[str, object],
               dtype: torch.dtype = torch.float32, device="cpu",
               choices=None, retain: Iterable[int] = (),
               seed: Optional[int] = None,
               dropout_masks: Optional[Dict[int, torch.Tensor]] = None,
               accum_steps: int = 1):
    """One TRAIN forward and backward of `net` on `device`, its params,
    state and input cast to `dtype` (the label kept as it is), inside
    the context `choices` (`record(...)` or `impose(...)`) if given; then
    one SGD step from those gradients in fp32 on the CPU, from a fresh
    optimizer state. batch: {"input", "label"}, tensors or arrays.
    retain: tensor indices whose gradient to keep (their `.grad` in the
    executor's values); seed and dropout_masks go to `execute`.
    accum_steps: the batch runs as that many microbatches in turn, the
    running stats carried and the gradients summed, as
    `make_train_step(accum_steps=...)` runs it (no seed or masks then;
    the executor returned is the last microbatch's).

    Returns (update: trainable key -> fp32 CPU tensor, the executor)."""
    if accum_steps > 1 and (seed is not None or dropout_masks):
        raise ValueError("sgd_update: accum_steps takes no seed or masks")
    specs = {t.key: t for t in net.param_specs()}
    leaves = {k: v.detach().to(device, dtype, copy=True).requires_grad_(
        specs[k].trainable) for k, v in params.items()}
    st = {k: v.to(device, dtype) for k, v in state.items()}
    inputs = {"input": torch.as_tensor(batch["input"]).to(device, dtype),
              "label": torch.as_tensor(batch["label"]).to(device)}
    n = inputs["input"].shape[0] // accum_steps
    with choices if choices is not None else contextlib.nullcontext():
        for m in range(accum_steps):
            ex = execute(net, leaves, st,
                         {k: v[m * n:(m + 1) * n] for k, v in inputs.items()},
                         Mode.TRAIN, seed=seed, dropout_masks=dropout_masks)
            st = ex.state
            if m < accum_steps - 1:
                ex.surrogate.backward()
    for i in retain:
        if ex.values[i].requires_grad:
            ex.values[i].retain_grad()
    ex.surrogate.backward()
    p = {k: v.detach().to("cpu", torch.float32, copy=True)
         for k, v in params.items()}
    p0 = {k: v.clone() for k, v in p.items()}
    apply_updates(net, p, {k: v.grad.to("cpu", torch.float32)
                           for k, v in leaves.items() if specs[k].trainable},
                  init_opt_state(net, p))
    return {k: p[k] - p0[k] for k in p if specs[k].trainable}, ex
