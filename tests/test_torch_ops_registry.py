"""The six kernels as `torch.library` ops (`bcnn_tpu_torch.ops.library`):
`torch.library.opcheck` on each through its CPU implementation, at small
shapes. opcheck runs the op against its schema (no input mutated or
aliased), the fake implementation against the real one (shape, dtype
and strides: int8 channels-last for K4 and K5), the FakeTensor path and
the op under AOT dispatch. Also: the wrappers reach the op on the CPU,
the flop formulas of K3-K5, and the registration needs no card."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bcnn_tpu_torch.ops import bn_act as k6
from bcnn_tpu_torch.ops import conv_int8 as k4
from bcnn_tpu_torch.ops import depthwise as k3
from bcnn_tpu_torch.ops import grouped_int8 as k5
from bcnn_tpu_torch.ops import row_shift as k2
from bcnn_tpu_torch.ops import yolo_decode as k1
from bcnn_tpu_torch.types import Activation

torch.set_num_threads(1)

ops = torch.ops.bcnn_tpu_torch
CL = torch.channels_last
ANCHORS = [10.0, 14.0, 23.0, 27.0, 37.0, 58.0]


def gen(seed):
    return torch.Generator().manual_seed(seed)


def int8(shape, g, cl=False):
    t = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    return t.contiguous(memory_format=CL) if cl else t


def vecs(o, g):
    return [torch.rand(o, generator=g) + 0.5 for _ in range(5)]


def k4_args(bn, s_out, g):
    x = int8((2, 16, 7, 7), g, cl=True)
    w = k4.channels_last_weight(int8((24, 16, 3, 3), g))
    d, bias, scale, mean, inv = vecs(24, g)
    d = d * 1e-3
    bnargs = {"none": (None, None, None), "folded": (scale, None, None),
              "unfolded": (scale, mean, inv)}[bn]
    return (x, w, d, bias, 1, 1, int(Activation.LRELU), *bnargs, s_out)


def k5_args(groups, s_out, g):
    c = o = 16
    x = int8((2, c, 9, 9), g, cl=True)
    w = k5.grouped_weight(int8((o, c // groups, 3, 3), g))
    d, bias, scale, mean, inv = vecs(o, g)
    return (x, w, d * 1e-3, bias, 2, 1, groups, int(Activation.RELU), scale,
            mean, inv, s_out)


CASES = {
    "yolo_decode": lambda g: (ops.yolo_decode.default, (
        4 * torch.randn(2, 3 * 9, 5, 6, generator=g), ANCHORS, 4, 96.0,
        96.0)),
    "row_shift_rows": lambda g: (ops.row_shift.default, (
        255 * torch.rand(2, 5, 12, 3, generator=g),
        torch.rand(2, 5, generator=g) * 2 - 1, 3, -2, 14, 0, 128.0, False)),
    "row_shift_columns": lambda g: (ops.row_shift.default, (
        255 * torch.rand(2, 12, 5, 3, generator=g),
        torch.rand(2, 5, generator=g) * 2 - 1, 3, 0, 10, -1, 0.0, True)),
    "depthwise": lambda g: (ops.depthwise.default, (
        torch.randn(2, 6, 9, 9, generator=g),
        torch.randn(6, 1, 3, 3, generator=g), torch.randn(6, generator=g),
        2, 1, int(Activation.LRELU))),
    "conv_int8_int8_out": lambda g: (ops.conv_int8.default,
                                     k4_args("unfolded", 0.05, g)),
    "conv_int8_fp32_out": lambda g: (ops.conv_int8.default,
                                     k4_args("folded", None, g)),
    "conv_int8_no_bn": lambda g: (ops.conv_int8.default,
                                  k4_args("none", 0.1, g)),
    "grouped_int8_dw": lambda g: (ops.grouped_int8.default,
                                  k5_args(16, 0.05, g)),
    "grouped_int8_groups4_fp32": lambda g: (ops.grouped_int8.default,
                                            k5_args(4, None, g)),
    "bn_act_bf16": lambda g: (ops.bn_act.default, (
        torch.randn(2, 5, 13, 13, generator=g).to(torch.bfloat16),
        *vecs(5, g)[:4], False, int(Activation.LRELU))),
    "bn_act_fp32_folded": lambda g: (ops.bn_act.default, (
        torch.randn(2, 5, 3, 1, generator=g), *vecs(5, g)[:4], True,
        int(Activation.RELU))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck(case):
    op, args = CASES[case](gen(len(case)))
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("case", ["conv_int8_int8_out", "grouped_int8_dw"])
def test_fake_keeps_the_kernels_layout(case):
    """The fake output of K4 and K5 with s_out is int8 channels-last, as
    the real one (a fake in NCHW would mislead the next op's layout)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args = CASES[case](gen(1))
    real = op(*args)
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
        fake = op(*fargs)
    assert fake.dtype == real.dtype == torch.int8
    assert fake.shape == real.shape and fake.stride() == real.stride()
    assert fake.is_contiguous(memory_format=CL)


def test_wrappers_reach_the_ops_on_the_cpu():
    """Each public wrapper is one call of its op on the CPU: a dispatch
    mode sees exactly that op and nothing of the plain version."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.name())
            return func(*args, **(kwargs or {}))

    g = gen(3)
    p = dict(num=3, classes=4, mask=[0, 1, 2], anchors=ANCHORS)
    head = torch.randn(1, 27, 3, 3, generator=g)
    img, d = torch.rand(1, 4, 8, 3, generator=g), torch.zeros(1, 4)
    img_c = img.transpose(1, 2).contiguous()  # (N, win, R, C)
    x = torch.randn(1, 4, 6, 6, generator=g)
    w, b = torch.randn(4, 1, 3, 3, generator=g), torch.zeros(4)
    bn = vecs(4, g)[:4]
    (xq, wq, dq, bq, *_), (x5, w5, d5, b5, *_) = (k4_args("none", 0.1, g),
                                                  k5_args(16, 0.1, g))
    calls = [
        (lambda: k1.decode_fused(head, p, 96, 96), "yolo_decode"),
        (lambda: k2.row_shift(img, d, 2, 0, 8, 0, 0.0), "row_shift"),
        (lambda: k2.col_shift(img_c, d, 2, 0, 8, 0, 0.0), "row_shift"),
        (lambda: k3.depthwise_fused(x, w, b, 1, 1, Activation.RELU),
         "depthwise"),
        (lambda: k4.conv_int8_fused(xq, wq, dq, bq, 1, 1, s_out=0.1),
         "conv_int8"),
        (lambda: k5.grouped_int8_fused(x5, w5, d5, b5, 2, 1, 16,
                                       Activation.RELU, s_out=0.1),
         "grouped_int8"),
        (lambda: k6.bn_act(x, *bn, False, Activation.LRELU), "bn_act"),
    ]
    for fn, name in calls:
        with Seen() as seen:
            fn()
        assert seen.names == [f"bcnn_tpu_torch::{name}"], seen.names


def test_a_depthwise_activation_the_kernel_does_not_fuse_runs_after_it():
    g = gen(4)
    x, w, b = (torch.randn(1, 4, 6, 6, generator=g),
               torch.randn(4, 1, 3, 3, generator=g), torch.randn(4,
                                                                 generator=g))
    got = k3.depthwise_fused(x, w, b, 1, 1, Activation.TANH)
    assert torch.equal(got, k3.depthwise_fused_ref(x, w, b, 1, 1,
                                                   Activation.TANH))


def test_flop_formulas():
    """K3-K5 count a multiply and an add a tap of each output (the
    weight's (C/G) k k taps), as FlopCounterMode counts a convolution."""
    for case in ("depthwise", "conv_int8_fp32_out",
                 "grouped_int8_groups4_fp32", "grouped_int8_dw"):
        op, args = CASES[case](gen(5))
        with FlopCounterMode(display=False) as fc:
            out = op(*args)
        w = args[1]
        assert fc.get_total_flops() == 2 * out.numel() * w[0].numel(), case


def test_the_ops_refuse_another_device():
    g = gen(6)
    x = torch.empty(1, 4, 6, 6, device="meta")
    with pytest.raises(ValueError, match="devices"):
        k3.depthwise_fused(x, torch.randn(4, 1, 3, 3, generator=g),
                           torch.zeros(4), 1, 1)
    xq, wq, dq, bq = k4_args("none", 0.1, g)[:4]
    with pytest.raises(ValueError, match="devices"):
        k4.conv_int8_fused(xq.to("meta"), wq, dq, bq, 1, 1)


def test_depthwise_op_gradient_on_the_cpu_is_the_plain_versions():
    """On the CPU the op's autograd is the plain version's, bit for bit."""
    rng = np.random.RandomState(7)
    x, w, b = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((2, 4, 7, 7), (4, 1, 3, 3), (4,)))
    gy = torch.from_numpy(rng.randn(2, 4, 4, 4).astype(np.float32))
    grads = []
    for fn in (k3.depthwise_fused, k3.depthwise_fused_ref):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        fn(*leaves, 2, 1, Activation.LRELU).backward(gy)
        grads.append([t.grad for t in leaves])
    for a, r in zip(*grads):
        assert torch.equal(a, r)
