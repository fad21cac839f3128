"""K6's op, `bcnn_tpu_torch::bn_act` (`ops/bn_act.py`), on the CPU: its
CPU implementation against the plain ops the executor ran before it
(`ops.norm.batch_norm`, then `ops.activations.apply_activation`), bit
for bit; its fake implementation against the real one; the op in an
exported program; and where the executor's conv epilogue hands a conv's
output to it. The kernel itself runs in tests/test_torch_cuda.py.
Imports no JAX."""

import io

import numpy as np
import pytest
import torch

from bcnn_tpu_torch import Net, Session, bridge, deploy
from bcnn_tpu_torch.compile import _Executor, execute
from bcnn_tpu_torch.ops import bn_act as k6
from bcnn_tpu_torch.ops.activations import apply_activation
from bcnn_tpu_torch.ops.norm import batch_norm
from bcnn_tpu_torch.types import Activation, FillerType, Mode

torch.set_num_threads(1)

op = torch.ops.bcnn_tpu_torch.bn_act.default
DTYPES = [torch.float32, torch.bfloat16]
ACTS = [Activation.NONE, Activation.RELU, Activation.LRELU]
# planes of 169 (13 x 13, odd) and 676 (26 x 26, 4 mod 8) values, C of 3,
# 255 and 1,024
SHAPES = [(2, 3, 13, 13), (1, 255, 13, 13), (1, 1024, 13, 13),
          (2, 3, 26, 26), (1, 255, 26, 26), (1, 1024, 26, 26)]


def inputs(shape, dtype, seed=0, special=True):
    """x (with a NaN, signed zeros and infinities where `special`) and
    fp32 (scales, biases, run_mean, run_var)."""
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = 3 * torch.randn(shape, generator=g)
    if special:
        x.view(-1)[:5] = torch.tensor([float("nan"), 0.0, -0.0,
                                       float("inf"), -float("inf")])
    vecs = (torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g),
            torch.randn(c, generator=g), torch.rand(c, generator=g) * 2)
    return x.to(dtype), vecs


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_impl_equals_batch_norm_then_activation(dtype, folded, act,
                                                    shape):
    x, (s, b, m, v) = inputs(shape, dtype, seed=shape[1])
    got = op(x, s, b, m, v, folded, int(act))
    want = apply_activation(batch_norm(x, s, b, m, v, folded=folded), act)
    assert got.dtype == want.dtype == dtype
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("shape", [(2, 3, 13, 13), (1, 1024, 26, 26),
                                   (1, 5, 1, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fake_gives_the_real_shape_dtype_and_strides(dtype, shape):
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, vecs = inputs(shape, dtype)
    real = op(x, *vecs, False, int(Activation.LRELU))
    with FakeTensorMode() as mode:
        fake = op(mode.from_tensor(x), *map(mode.from_tensor, vecs), False,
                  int(Activation.LRELU))
    assert (fake.shape, fake.dtype, fake.stride()) == (
        real.shape, real.dtype, real.stride())


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_opcheck(dtype, folded):
    x, vecs = inputs((2, 6, 5, 7), dtype, special=False)  # NaN != NaN
    torch.library.opcheck(op, (x, *vecs, folded, int(Activation.LRELU)))


CL = torch.channels_last


@pytest.mark.parametrize("shape", [(2, 16, 13, 13), (1, 3, 26, 26),
                                   (2, 1024, 13, 13)])
@pytest.mark.parametrize("act", ACTS + [Activation.MISH,
                                        Activation.SWISH])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_impl_keeps_a_channels_last_x_channels_last(dtype, act, shape):
    """A channels-last x: the plain ops' bits, the output channels-last
    (K6's channels-last form writes it so)."""
    x, (s, b, m, v) = inputs(shape, dtype, seed=shape[1])
    x = x.contiguous(memory_format=CL)
    got = op(x, s, b, m, v, False, int(act))
    want = apply_activation(batch_norm(x, s, b, m, v, folded=False), act)
    assert got.is_contiguous(memory_format=CL) and not got.is_contiguous()
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fake_keeps_x_channels_last(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    x, vecs = inputs((2, 16, 5, 7), dtype)
    x = x.contiguous(memory_format=CL)
    real = op(x, *vecs, True, int(Activation.MISH))
    with FakeTensorMode() as mode:
        fake = op(mode.from_tensor(x), *map(mode.from_tensor, vecs), True,
                  int(Activation.MISH))
    assert fake.stride() == real.stride() == x.stride()
    assert k6.channels_last_form(x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_opcheck_channels_last(dtype):
    x, vecs = inputs((2, 8, 5, 7), dtype, special=False)
    torch.library.opcheck(op, (x.contiguous(memory_format=CL), *vecs,
                               False, int(Activation.LRELU)))


def test_launcher_takes_two_layouts_and_refuses_other_strides():
    """The launcher's pick of a form from x's strides: contiguous NCHW,
    channels-last (NCHW where the two orders are one: H = W = 1 or C =
    1); a slice, a permutation or a 3-d x is refused before anything is
    allocated or launched, on any device."""
    x = torch.rand(2, 8, 5, 7)
    assert not k6.channels_last_form(x)
    assert k6.channels_last_form(x.contiguous(memory_format=CL))
    assert not k6.channels_last_form(
        torch.rand(2, 8, 1, 1).contiguous(memory_format=CL))
    assert not k6.channels_last_form(
        torch.rand(2, 1, 5, 7).contiguous(memory_format=CL))
    for bad in (x[:, :, 1:], x[:, :4], x.transpose(2, 3),
                x.permute(0, 2, 3, 1), x.contiguous(memory_format=CL)[
                    :, :, :, ::2], x[0]):
        with pytest.raises(ValueError, match="contiguous NCHW or "
                                             "channels-last"):
            k6.channels_last_form(bad)


def test_takes_only_what_the_kernel_runs(monkeypatch):
    """On the CPU only inside a trace; then what K6 computes (bf16 or
    fp32, a fused activation) with no autograd, whatever x's layout: the
    executor makes x contiguous."""
    x = torch.rand(1, 4, 3, 3)
    assert not k6.takes(x, Activation.LRELU)  # eager CPU
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert k6.takes(x, Activation.LRELU)
    assert k6.takes(x.to(torch.bfloat16), Activation.RELU)
    assert k6.takes(x.transpose(2, 3), Activation.NONE)
    assert k6.takes(x.contiguous(memory_format=torch.channels_last),
                    Activation.LRELU)
    assert not k6.takes(x.double(), Activation.LRELU)
    assert not k6.takes(x.half(), Activation.LRELU)
    for act in (Activation.PRELU, Activation.TANH, Activation.LOGISTIC):
        assert not k6.takes(x, act)
        assert not k6.computes(x, act)
    xg = x.clone().requires_grad_()
    assert not k6.takes(xg, Activation.LRELU)
    with torch.no_grad():
        assert k6.takes(xg, Activation.LRELU)


def bn_net(act=Activation.LRELU, batch=2, mode=Mode.PREDICT):
    """conv -> BN -> act, conv -> BN -> LRELU, conv + bias (a head)."""
    net = Net(mode)
    net.set_input_shape(16, 16, 3, batch)
    net.add_convolutional_layer(8, 3, 1, 1, 1, 1, FillerType.XAVIER, act, 0,
                                "input", "c1")
    net.add_convolutional_layer(6, 3, 2, 1, 1, 1, FillerType.XAVIER,
                                Activation.LRELU, 0, "c1", "c2")
    net.add_convolutional_layer(5, 1, 1, 0, 1, 0, FillerType.XAVIER,
                                Activation.NONE, 0, "c2", "c3")
    return net


def seeded(net, seed=0):
    p, s = bridge.params_from_numpy(net, *bridge.he_numpy_weights(net, seed))
    g = torch.Generator().manual_seed(seed + 1)
    for k in s:  # running stats away from 0 and 1
        s[k] = (torch.rand(s[k].shape, generator=g) + 0.5
                if "var" in k else torch.randn(s[k].shape, generator=g))
    return p, s


@pytest.mark.parametrize("dtype", DTYPES)
def test_export_holds_bn_act_per_bn_conv(dtype):
    """A conv -> BN -> leaky net exported on the CPU: one bcnn_tpu_torch::
    bn_act node a BN conv, none for the head; the loaded program equals
    the live forward bit for bit."""
    net = bn_net()
    if dtype == torch.bfloat16:
        net.compute_dtype = net.act_dtype = dtype
    sess = Session(net, 0, device="cpu")
    sess.params, sess.state = seeded(net)
    sess.compile_net()
    blob = sess.export_serving(None, outputs=["c3"])
    ep = torch.export.load(io.BytesIO(blob))
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count(op) == 2
    x = np.random.RandomState(3).rand(2, 3, 16, 16).astype(np.float32)
    (got,) = deploy.load_exported(blob)(x)
    (live,), _ = sess.predict_on_batch(x, outputs=["c3"])
    assert got.dtype == live.dtype and torch.equal(bits(got), bits(live))


class _Rows(_Executor):
    """An executor whose conv outputs come as non-contiguous views (a
    band of rows as the spatial model axis might hold it)."""

    def _out_rows(self, y):
        return y.transpose(2, 3).contiguous().transpose(2, 3)


def _calls(monkeypatch):
    """The op's calls from here on: (activation, x contiguous, the
    vectors' dtypes) each."""
    seen = []
    real = k6.bn_act

    def counted(x, *args):
        seen.append((args[-1], x.is_contiguous(),
                     {v.dtype for v in args[:4]}))
        return real(x, *args)

    monkeypatch.setattr(k6, "bn_act", counted)
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    return seen


@pytest.mark.parametrize("case", ["predict", "valid", "train", "prelu",
                                  "band", "bf16_state"])
def test_executor_hands_the_op_only_what_it_takes(monkeypatch, case):
    """With the device test passed (as on the card), PREDICT and VALID
    run each BN conv with a fused activation through the op, with the
    plain ops' values, x contiguous and the vectors fp32: also a
    non-contiguous band of rows and running stats held in bf16. TRAIN and
    a PReLU conv run the plain ops."""
    act = Activation.PRELU if case == "prelu" else Activation.LRELU
    mode = {"valid": Mode.VALID, "train": Mode.TRAIN}.get(case, Mode.PREDICT)
    net = bn_net(act, mode=mode)
    p, s = seeded(net)
    if case == "bf16_state":
        s = {k: v.to(torch.bfloat16) for k, v in s.items()}
    x = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = execute(net, p, dict(s), {"input": x}, mode).values
        seen = _calls(monkeypatch)
        if case == "band":
            ex = _Rows(net, p, dict(s), mode, seed=0)
            ex.values[0] = x
            got = ex.run().values
        else:
            got = execute(net, p, dict(s), {"input": x}, mode).values
    expect = {"train": 0, "prelu": 1}.get(case, 2)
    assert len(seen) == expect
    assert all(c == (Activation.LRELU, True, {torch.float32}) for c in seen)
    for i, v in want.items():
        assert torch.equal(got[i], v), net.tensors[i].name
