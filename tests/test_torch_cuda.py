"""The port's CUDA kernels and its training step on the card. Each test
is marked `cuda` and skips where there is no CUDA device, as on a
CPU-only machine. This file imports no JAX, so on a machine with a GPU
and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from bcnn_tpu_torch import Session, bridge, ops, upload
from bcnn_tpu_torch.ops import depthwise as dw
from bcnn_tpu_torch.ops import library
from bcnn_tpu_torch.models import mobilenet_v1, yolov3_tiny
from bcnn_tpu_torch.ops.depthwise import depthwise_fused, depthwise_fused_ref
from bcnn_tpu_torch.ops.row_shift import (col_shift, col_shift_ref,
                                          row_shift, row_shift_ref)
from bcnn_tpu_torch.ops.yolo_decode import decode_fused, decode_grid_ref
from bcnn_tpu_torch.types import Activation, Mode

pytestmark = pytest.mark.cuda

ANCHORS = [10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "n,classes,h,w,mask",
    [(8, 80, 13, 13, [3, 4, 5]), (2, 80, 26, 26, [0, 1, 2]),
     (3, 7, 7, 11, [1, 3, 5]), (1, 1, 1, 1, [0, 1, 2]),
     (2, 80, 7, 11, [4]),              # 1 anchor, odd grid, partial chunk
     (1, 7, 5, 9, list(range(16))),    # 16 anchors
     (8, 3, 26, 26, [0, 1, 2]),        # 16 locations a block, partial last
     (5, 90, 9, 7, list(range(16))),   # 16 anchors: 4 locations fit 48 KB
     (1, 1000, 3, 5, list(range(16))),  # classes staged 379 at a time
     (300, 2, 4, 4, [0, 1, 2]),         # 16 locations, one block an image
     (8, 80, 52, 52, [0, 1, 2])],       # full YOLOv3's stride-8 head
)
def test_k1_matches_plain_version(cuda, n, classes, h, w, mask):
    anchors = ANCHORS + [float(v) for v in range(20, 40)]  # 16 anchors
    p = dict(num=len(mask), classes=classes, mask=mask, anchors=anchors)
    gen = torch.Generator().manual_seed(h * w)
    x = 4 * torch.randn(n, len(mask) * (5 + classes), h, w, generator=gen)
    x[0, 4, 0, 0] = float("inf")
    x[0, 2, 0, 0] = 200.0  # exp overflow -> inf, as in the plain version
    x = x.to(cuda)
    before = library.launches("yolo_decode")
    got = decode_fused(x, p, 416, 416)
    torch.cuda.synchronize()
    assert library.launches("yolo_decode") == before + 1
    for g, r in zip(got, decode_grid_ref(x, p, 416, 416)):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


def test_k1_refuses_what_it_does_not_take(cuda):
    p = dict(num=3, classes=4, mask=[0, 1, 2], anchors=ANCHORS)
    x = torch.randn(1, 27, 4, 4, device=cuda)
    with pytest.raises(TypeError):
        decode_fused(x.double(), p, 64, 64)
    with pytest.raises(ValueError):
        decode_fused(x.transpose(2, 3), p, 64, 64)
    with pytest.raises(ValueError):
        decode_fused(x[:, :26], p, 64, 64)
    many = dict(num=17, classes=0, mask=list(range(17)),
                anchors=[1.0] * 34)
    with pytest.raises(ValueError):
        decode_fused(torch.randn(1, 85, 2, 2, device=cuda), many, 64, 64)


def test_detect_on_batch_launches_k1_per_head(cuda):
    sess = Session(yolov3_tiny(2, 96, 96, 4), 0, device=cuda).compile_net()
    x = np.random.RandomState(0).rand(2, 3, 96, 96).astype(np.float32)
    before = library.launches("yolo_decode")
    full = sess.detect_on_batch(x, 0.3, 20, topk_first=False)
    assert library.launches("yolo_decode") == before + 2
    plain = sess.detect_on_batch(x, 0.3, 20, topk_first=False,
                                 use_pallas=False)
    assert library.launches("yolo_decode") == before + 2
    for a, b in zip(full, plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


K2_CASES = [
    (3, 37, 53, 3, 9, -9, 71, -1), (1, 5, 8, 1, 4, 0, 8, 0),
    (2, 21, 40, 3, 6, 3, 30, 0), (1, 3, 12, 2, 5, -20, 8, 0),
    (2, 9, 30, 3, 6, -6, 42, -1),     # fill read at both ends of a row
    (1, 4, 700, 3, 5, -2, 1500, 0),   # rows of 4,500 outputs: two pieces
    (2, 6, 11, 7, 4, 1, 9, 2),        # 7 channels
]


def k2_inputs(n, r, win, c, kmax, gen):
    """img (n, r, win, c) in [0, 255) and d (n, r) on the CPU, shifts
    within kmax - 1, two of them integers."""
    img = 255 * torch.rand(n, r, win, c, generator=gen)
    d = (2 * torch.rand(n, r, generator=gen) - 1) * (kmax - 1)
    d[0, 0], d[-1, -1] = 2.0, -3.0  # integer shifts, one of them negative
    return img, d


@pytest.mark.parametrize("n,r,win,c,kmax,out_x0,out_w,in_x0", K2_CASES)
def test_k2_matches_plain_version(cuda, n, r, win, c, kmax, out_x0, out_w,
                                  in_x0):
    img, d = k2_inputs(n, r, win, c, kmax,
                       torch.Generator().manual_seed(r * win))
    img, d = img.to(cuda), d.to(cuda)
    before = library.launches("row_shift")
    got = row_shift(img, d, kmax, out_x0, out_w, in_x0, 128.0)
    torch.cuda.synchronize()
    assert library.launches("row_shift") == before + 1
    want = row_shift_ref(img, d, kmax, out_x0, out_w, in_x0, 128.0)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("off", [1, 2, 3])
def test_k2_rows_off_a_16_byte_boundary(cuda, off):
    """Input off a 16-byte boundary: the staged range's head, and the
    float4 stores' scalar head and tail, bit-equal; column mode on the
    same tensor (off 8 bytes too at off 1 and 3: float by float)."""
    gen = torch.Generator().manual_seed(off)
    for n, r, win, c, kmax, out_x0, out_w, in_x0 in K2_CASES[:5] + [
            (2, 6, 11, 2, 4, 1, 9, 2)]:
        img, d = k2_inputs(n, r, win, c, kmax, gen)
        flat = torch.empty(off + img.numel(), device=cuda)
        flat[off:] = img.reshape(-1).to(cuda)
        img = flat[off:].view(img.shape)
        assert img.data_ptr() % 16 == 4 * off
        d = d.to(cuda)
        want = row_shift_ref(img, d, kmax, out_x0, out_w, in_x0, 128.0)
        got = row_shift(img, d, kmax, out_x0, out_w, in_x0, 128.0)
        assert torch.equal(got, want)
        dc = k2_inputs(n, win, 1, 1, kmax, gen)[1].to(cuda)  # a column's
        want = col_shift_ref(img, dc, kmax, out_x0, out_w, in_x0, 128.0)
        got = col_shift(img, dc, kmax, out_x0, out_w, in_x0, 128.0)
        assert torch.equal(got, want)


@pytest.mark.parametrize("n,r,win,c,kmax,out_x0,out_w,in_x0", K2_CASES)
def test_k2_column_mode_matches_plain_version(cuda, n, r, win, c, kmax,
                                              out_x0, out_w, in_x0):
    """col_shift on img (N, win, R, C): the row mode's cases down the
    columns, bit-equal to col_shift_ref and to the transposing form."""
    img, d = k2_inputs(n, r, win, c, kmax,
                       torch.Generator().manual_seed(r + win))
    img = img.transpose(1, 2).contiguous().to(cuda)  # (n, win, r, c)
    d = d.to(cuda)
    before = library.launches("row_shift")
    got = col_shift(img, d, kmax, out_x0, out_w, in_x0, 128.0)
    torch.cuda.synchronize()
    assert library.launches("row_shift") == before + 1
    assert got.shape == (n, out_w, r, c) and got.is_contiguous()
    assert torch.equal(got, col_shift_ref(img, d, kmax, out_x0, out_w,
                                          in_x0, 128.0))
    assert torch.equal(got, row_shift_ref(
        img.transpose(1, 2).contiguous(), d, kmax, out_x0, out_w, in_x0,
        128.0).transpose(1, 2))


def test_k2_refuses_what_it_does_not_take(cuda):
    img = torch.rand(2, 4, 6, 3, device=cuda)
    d = torch.zeros(2, 4, device=cuda)
    with pytest.raises(TypeError):
        row_shift(img.double(), d, 2, 0, 6, 0, 0.0)
    with pytest.raises(ValueError):
        row_shift(img.transpose(1, 2), d, 2, 0, 6, 0, 0.0)
    with pytest.raises(ValueError):
        row_shift(img, d[:, :3], 2, 0, 6, 0, 0.0)
    with pytest.raises(ValueError):
        row_shift(img, d.cpu(), 2, 0, 6, 0, 0.0)
    dc = torch.zeros(2, 6, device=cuda)  # column mode: a shift a column
    with pytest.raises(TypeError):
        col_shift(img.double(), dc, 2, 0, 4, 0, 0.0)
    with pytest.raises(ValueError):
        col_shift(img.transpose(1, 2), d, 2, 0, 4, 0, 0.0)
    with pytest.raises(ValueError):
        col_shift(img, d, 2, 0, 4, 0, 0.0)  # (N, R) of the rows
    with pytest.raises(ValueError):
        col_shift(img, dc.cpu(), 2, 0, 4, 0, 0.0)
    with pytest.raises(ValueError):
        col_shift(img, dc, -1, 0, 4, 0, 0.0)
    before = library.launches("row_shift")
    assert col_shift(img, dc, 2, 0, 0, 0, 0.0).shape == (2, 0, 6, 3)
    assert library.launches("row_shift") == before  # nothing to launch


def test_train_step_launches_k2_three_times(cuda):
    net = yolov3_tiny(2, 96, 96, 4, mode=Mode.TRAIN)
    net.device_augment = dict(rotation_range=10.0, random_fliph=1)
    sess = Session(net, 0, device=cuda).compile_net()
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (2, 3, 96, 96)).astype(np.uint8)
    lab = np.zeros((2, 250), np.float32)
    lab[:, :5] = [0.4, 0.6, 0.3, 0.2, 1]
    before = library.launches("row_shift")
    w0 = sess.params["input_w"].clone()
    loss = sess.train_on_batch(x, lab)
    torch.cuda.synchronize()
    assert library.launches("row_shift") == before + 3
    assert loss.device.type == "cuda" and bool(torch.isfinite(loss))
    assert not torch.equal(w0, sess.params["input_w"])


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_gradients_on_the_card_are_fp32(cuda, stride):
    """The conv's input and weight gradients on the card against the
    CPU's at rtol 1e-4: TF32 anywhere in the backward (about 1e-3
    relative) fails it, while cuDNN's default for fp32 is TF32."""
    assert torch.backends.cudnn.allow_tf32  # the default the port overrides
    gen = torch.Generator().manual_seed(stride)
    x = torch.randn(4, 128, 24, 24, generator=gen)
    w = torch.randn(96, 128, 3, 3, generator=gen) * 0.05
    g = torch.randn(4, 96, 24 // stride, 24 // stride, generator=gen)
    grads = []
    for dev in ("cpu", cuda):
        xd = x.to(dev).detach().requires_grad_()
        wd = w.to(dev).detach().requires_grad_()
        ops.conv2d(xd, wd, stride, 1).backward(g.to(dev))
        grads.append((xd.grad.cpu(), wd.grad.cpu()))
    for ref, got in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-4,
                                   atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("stride", [1, 2])
def test_mixed_conv_backward_on_the_card(cuda, stride):
    """The bf16 conv of TRAIN (compute_dtype) on the card against the
    CPU's: the fp32 forward within 1e-5 of its largest value (products
    of bf16 values are exact in TF32 and fp32), dx (bf16, as x) and dw
    (fp32) within 2^-7 of their largest |value| (the transposed convs'
    bf16 outputs, summed in another order)."""
    gen = torch.Generator().manual_seed(10 + stride)
    x = torch.randn(4, 64, 24, 24, generator=gen).to(torch.bfloat16)
    w = torch.randn(48, 64, 3, 3, generator=gen) * 0.05
    g = torch.randn(4, 48, 24 // stride, 24 // stride, generator=gen)
    outs = []
    for dev in ("cpu", cuda):
        xd = x.to(dev).detach().requires_grad_()
        wd = w.to(dev).detach().requires_grad_()
        y = ops.conv2d(xd, wd, stride, 1, 1, torch.bfloat16)
        y.backward(g.to(dev))
        assert y.dtype == torch.float32
        assert xd.grad.dtype == torch.bfloat16
        assert wd.grad.dtype == torch.float32
        outs.append((y.detach().cpu(), xd.grad.cpu().float(),
                     wd.grad.cpu()))
    for (ref, got), tol in zip(zip(*outs), (1e-5, 2.0**-7, 2.0**-7)):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=tol * float(ref.abs().max()))


@pytest.mark.parametrize("form", ["plain", "remat", "accum_steps",
                                  "scan"])
def test_bf16_training_forms_on_the_card(cuda, form):
    """A bf16 + act16 YOLOv3-tiny step on the card in each form, with
    rotation (K2, three launches a step, and a microbatch under
    accum_steps): finite loss, every param, running stat and velocity
    fp32, the weights moved."""
    from bcnn_tpu_torch.compile import make_train_scan, make_train_step

    net = yolov3_tiny(4, 96, 96, 4, mode=Mode.TRAIN)
    net.compute_dtype = net.train_act_dtype = torch.bfloat16
    net.device_augment = dict(rotation_range=10.0, random_fliph=1)
    net.yolo_stats = True
    sess = Session(net, 0, device=cuda).compile_net()
    rng = np.random.RandomState(1)
    steps = 2 if form == "scan" else 1
    x = torch.from_numpy(rng.randint(0, 256, (steps, 4, 3, 96, 96)).astype(
        np.uint8)).to(cuda)
    lab = np.zeros((steps, 4, 250), np.float32)
    lab[..., :5] = [0.4, 0.6, 0.3, 0.2, 1]
    lab = torch.from_numpy(lab).to(cuda)
    w0 = sess.params["input_w"].clone()
    before = library.launches("row_shift")
    gen = torch.Generator().manual_seed(0)
    if form == "scan":
        out = make_train_scan(net)(sess.params, sess.state, sess.opt_state,
                                   {"input": x, "label": lab}, gen)
        assert out[3].shape == (2,)
        assert all(v.shape == (2,) for st in out[4] for v in st.values())
    else:
        kw = {"remat": {"remat": True},
              "accum_steps": {"accum_steps": 2}}.get(form, {})
        out = make_train_step(net, **kw)(
            sess.params, sess.state, sess.opt_state,
            {"input": x[0], "label": lab[0]}, gen)
        assert len(out[4]) == 2  # one stats dict a head
    torch.cuda.synchronize()
    augments = 2 if form == "accum_steps" else steps
    assert library.launches("row_shift") == before + 3 * augments
    assert bool(torch.isfinite(out[3]).all())
    for table in (out[0], out[1], out[2]["velocity"]):
        assert all(v.dtype == torch.float32 and v.device.type == "cuda"
                   for v in table.values())
    assert not torch.equal(w0, out[0]["input_w"])


@pytest.mark.parametrize(
    "n,c,h,w,k,stride,pad,act",
    [(2, 32, 16, 16, 3, 1, 1, Activation.RELU),
     (3, 64, 15, 13, 3, 2, 1, Activation.LRELU),
     (2, 7, 15, 13, 5, 3, 0, Activation.CLAMP),
     (1, 5, 9, 11, 7, 1, 3, Activation.NONE),
     (70, 16, 7, 7, 3, 1, 1, Activation.RELU),   # planes grouped per block
     (1, 3, 40, 300, 3, 2, 1, Activation.TANH),   # bands; unfused act
     (3, 5, 15, 7, 3, 1, 1, Activation.LRELU),    # 7 wide, planes of 105
     (64, 1024, 7, 7, 3, 1, 1, Activation.RELU),  # tiles > persistent blocks
     (64, 32, 112, 112, 3, 1, 1, Activation.RELU),  # > 48 KB shared memory
     (1, 2, 200, 40, 3, 1, 1, Activation.NONE),   # last band's halo at the end
     (1, 1, 9, 5, 3, 1, 4, Activation.LRELU),     # bands of padding only
     (1, 1, 5, 8000, 3, 1, 1, Activation.CLAMP)],  # ring of 2 wide stages
)
def test_k3_matches_plain_version(cuda, n, c, h, w, k, stride, pad, act):
    gen = torch.Generator().manual_seed(c * h + k)
    x = torch.randn(n, c, h, w, generator=gen).to(cuda)
    wt = (torch.randn(c, 1, k, k, generator=gen) * (2 / k**2) ** 0.5).to(cuda)
    b = (torch.rand(c, generator=gen) - 0.5).to(cuda)
    want = depthwise_fused_ref(x, wt, b, stride, pad, act)
    got = depthwise_fused(x, wt, b, stride, pad, act)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_k3_takes_x_off_a_16_byte_boundary(cuda):
    gen = torch.Generator().manual_seed(7)
    for off in (1, 2, 3):
        flat = torch.randn(off + 2 * 6 * 9 * 7, generator=gen).to(cuda)
        x = flat[off:].view(2, 6, 9, 7)
        assert x.data_ptr() % 16 == 4 * off
        wt = torch.randn(6, 1, 3, 3, generator=gen).to(cuda)
        b = torch.randn(6, generator=gen).to(cuda)
        for stride in (1, 2):
            want = depthwise_fused_ref(x, wt, b, stride, 1)
            got = depthwise_fused(x, wt, b, stride, 1)
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-4 * float(want.abs().max()))


def test_k3_raises_on_a_plan_the_kernel_refuses(cuda, monkeypatch):
    x = torch.randn(2, 8, 10, 10, device=cuda)
    wt = torch.randn(8, 1, 3, 3, device=cuda)
    b = torch.zeros(8, device=cuda)
    good = dw.plan_tiles(2, 8, 10, 10, 3, 1, 1)
    for bad in (good._replace(stage_floats=good.stage_floats - 4),
                good._replace(tiles=good.tiles + 1),
                good._replace(stages=5), good._replace(rows=2)):
        monkeypatch.setattr(dw, "plan_tiles", lambda *a, bad=bad: bad)
        before = library.launches("depthwise")
        with pytest.raises(RuntimeError, match="CUDA error"):
            depthwise_fused(x, wt, b, 1, 1)
        assert library.launches("depthwise") == before


def test_k3_counts_its_launches(cuda):
    x = torch.randn(2, 8, 10, 10, device=cuda)
    wt = torch.randn(8, 1, 3, 3, device=cuda)
    b = torch.zeros(8, device=cuda)
    before = library.launches("depthwise")
    depthwise_fused(x, wt, b, 1, 1, Activation.RELU)
    depthwise_fused(x, wt, b, 2, 1, Activation.SOFTPLUS)  # K3, then softplus
    assert library.launches("depthwise") == before + 2
    depthwise_fused_ref(x, wt, b, 1, 1, Activation.RELU)
    assert library.launches("depthwise") == before + 2
    net = mobilenet_v1(2, 10, width_mult=0.25)
    sess = Session(net, 0, device=cuda)
    sess.params, sess.state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0), device=cuda)
    sess.compile_net()
    xs = np.random.RandomState(0).rand(2, 3, 224, 224).astype(np.float32)
    before = library.launches("depthwise")
    (y,), _ = sess.predict_on_batch(xs)
    torch.cuda.synchronize()
    assert library.launches("depthwise") == before + 13
    assert y.shape == (2, 10, 1, 1) and bool(torch.isfinite(y).all())


def test_k3_refuses_what_it_does_not_take(cuda):
    x = torch.randn(2, 4, 6, 6, device=cuda)
    wt = torch.randn(4, 1, 3, 3, device=cuda)
    b = torch.zeros(4, device=cuda)
    with pytest.raises(TypeError):
        depthwise_fused(x.double(), wt.double(), b.double(), 1, 1)
    with pytest.raises(TypeError):
        depthwise_fused(x.half(), wt, b, 1, 1)
    with pytest.raises(ValueError):
        depthwise_fused(x.transpose(2, 3), wt, b, 1, 1)
    with pytest.raises(ValueError):
        depthwise_fused(x, wt.cpu(), b, 1, 1)
    with pytest.raises(ValueError):
        depthwise_fused(x, wt[:3], b, 1, 1)
    with pytest.raises(NotImplementedError):
        depthwise_fused(x, wt.requires_grad_(), b, 1, 1)


def test_fc_on_the_card_is_fp32(cuda):
    """The FC against a float64 product at rtol 1e-5: TF32 (about 1e-3
    relative) fails it."""
    assert not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 1024, 1, 1, generator=gen)
    w = torch.randn(1024, 1000, generator=gen) * 0.05
    b = torch.randn(1000, generator=gen)
    ref = (x.double().reshape(64, -1) @ w.double() + b.double()).float()
    got = ops.full_connected(x.to(cuda), w.to(cuda), b.to(cuda)).cpu()
    torch.testing.assert_close(got.reshape(64, -1), ref, rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------ K4, bf16 and int8 paths

from bcnn_tpu_torch.ops import conv as conv_ops  # noqa: E402
from bcnn_tpu_torch.ops import pool as pool_ops  # noqa: E402
from bcnn_tpu_torch.ops.conv_int8 import (  # noqa: E402
    channels_last_weight, conv_int8_fused, conv_int8_fused_ref)
from bcnn_tpu_torch.ops.quant import ptq_synthetic  # noqa: E402


@pytest.mark.parametrize(
    "n,c,h,w,o,k,stride,pad,bn,act,int8_out",
    [(1, 3, 9, 9, 16, 3, 1, 1, 2, Activation.LRELU, True),  # K = 27
     (1, 16, 13, 13, 255, 1, 1, 0, 0, Activation.NONE, False),  # a head
     (2, 8, 13, 11, 70, 3, 2, 1, 1, Activation.RELU, True),  # stride 2
     (3, 7, 6, 5, 12, 3, 1, 1, 2, Activation.NONE, True),  # K = 63
     (1, 64, 13, 13, 130, 3, 1, 1, 2, Activation.LRELU, False),  # ragged
     (2, 20, 7, 7, 9, 5, 2, 0, 0, Activation.LRELU, True),
     (8, 256, 13, 13, 128, 1, 1, 0, 2, Activation.LRELU, True),  # 64 x 64
     (8, 512, 13, 13, 255, 1, 1, 0, 0, Activation.NONE, False),  # a head
     (8, 256, 13, 13, 512, 3, 1, 1, 2, Activation.LRELU, True),  # split 2
     (1, 512, 13, 13, 255, 3, 1, 1, 0, Activation.NONE, False),  # split 18
     (2, 256, 13, 13, 64, 3, 1, 1, 1, Activation.RELU, True),  # split 36
     (8, 32, 52, 52, 128, 3, 1, 1, 2, Activation.LRELU, True),  # 128 x 64
     (2, 48, 9, 9, 40, 3, 2, 1, 1, Activation.RELU, True),  # K % 32 = 16
     (3, 16, 30, 17, 32, 3, 1, 1, 2, Activation.LRELU, True),  # two taps
     (1, 32, 20, 20, 16, 3, 1, 1, 0, Activation.NONE, False),  # 128 x 16
     # Darknet-53 (full YOLOv3 416, batch 8, BN folded): its five
     # stride-2 convs, K = 288, a 52x52 head, and a split of K = 9216
     (8, 32, 416, 416, 64, 3, 2, 1, 1, Activation.LRELU, True),
     (8, 64, 208, 208, 128, 3, 2, 1, 1, Activation.LRELU, True),
     (8, 128, 104, 104, 256, 3, 2, 1, 1, Activation.LRELU, True),
     (8, 256, 52, 52, 512, 3, 2, 1, 1, Activation.LRELU, True),
     (8, 512, 26, 26, 1024, 3, 2, 1, 1, Activation.LRELU, True),
     (8, 32, 208, 208, 64, 3, 1, 1, 1, Activation.LRELU, True),  # K = 288
     (8, 256, 52, 52, 255, 1, 1, 0, 0, Activation.NONE, False),  # a head
     (1, 1024, 13, 13, 512, 3, 1, 1, 1, Activation.LRELU, True)],  # split
)
def test_k4_matches_plain_version(cuda, n, c, h, w, o, k, stride, pad, bn,
                                  act, int8_out):
    """K4 on channels-last x and the (O, k, k, C) weight, every tile
    shape of the plan and split-K among them, bit-equal to the plain
    version on the NCHW tensors."""
    gen = torch.Generator().manual_seed(c * o)
    x = torch.randint(-127, 128, (n, c, h, w), generator=gen,
                      dtype=torch.int8)
    wt = torch.randint(-127, 128, (o, c, k, k), generator=gen,
                       dtype=torch.int8)
    vec = lambda lo, hi: (lo + (hi - lo) * torch.rand(o, generator=gen)  # noqa
                          ).to(cuda)
    kw = dict(act=act, s_out=0.1 if int8_out else None)
    if bn >= 1:
        kw["scale"] = vec(0.5, 1.5)
    if bn == 2:
        kw["mean"], kw["inv"] = vec(-0.1, 0.1), vec(0.8, 1.2)
    x, wt = x.to(cuda), wt.to(cuda)
    d = vec(1e-5, 1e-4) * (64 / (c * k * k)) ** 0.5
    b = vec(-1, 1)
    before = library.launches("conv_int8")
    got = conv_int8_fused(x.contiguous(memory_format=torch.channels_last),
                          channels_last_weight(wt), d, b, stride, pad, **kw)
    want = conv_int8_fused_ref(x, wt, d, b, stride, pad, **kw)
    torch.cuda.synchronize()
    assert library.launches("conv_int8") == before + 1
    assert got.dtype == (torch.int8 if int8_out else torch.float32)
    assert got.is_contiguous(memory_format=torch.channels_last if int8_out
                             else torch.contiguous_format)
    assert torch.equal(got, want)


def test_k4_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 4, 5, 5, dtype=torch.int8, device=cuda)
    w = torch.zeros(3, 4, 3, 3, dtype=torch.int8, device=cuda)
    d = b = torch.ones(3, device=cuda)
    with pytest.raises(TypeError):
        conv_int8_fused(x.float(), w, d, b, 1, 1)
    with pytest.raises(ValueError):
        conv_int8_fused(x, w[:, :2], d, b, 1, 1)  # groups
    with pytest.raises(ValueError):
        conv_int8_fused(x, w, d, b, 1, 1, act=Activation.TANH)
    with pytest.raises(ValueError):
        conv_int8_fused(x.transpose(2, 3), w, d, b, 1, 1)
    with pytest.raises(ValueError):
        conv_int8_fused(x, w, d.cpu(), b, 1, 1)


def test_k4_raises_on_an_nchw_int8_x_or_w(cuda):
    """The card takes the int8 flow's channels-last layout only: an NCHW
    x or w raises, and nothing is copied behind the caller's back."""
    x = torch.ones(2, 16, 5, 5, dtype=torch.int8, device=cuda)
    w = torch.ones(8, 16, 3, 3, dtype=torch.int8, device=cuda)
    d = b = torch.ones(8, device=cuda)
    xc = x.contiguous(memory_format=torch.channels_last)
    before = library.launches("conv_int8")
    with pytest.raises(ValueError, match="channels-last"):
        conv_int8_fused(x, channels_last_weight(w), d, b, 1, 1)
    with pytest.raises(ValueError, match="channels-last"):
        conv_int8_fused(xc, w, d, b, 1, 1)
    assert library.launches("conv_int8") == before
    y = conv_int8_fused(xc, channels_last_weight(w), d, b, 1, 1)
    assert torch.equal(y, conv_int8_fused_ref(x, w, d, b, 1, 1))


def test_k4_takes_an_output_past_2_31_values(cuda):
    """An unsplit launch whose int8 output holds more than 2^31 values
    (YOLOv3-tiny's first conv at 416 px and batch 1024 has one): it
    launches, and its last rows equal the plain version's on the input
    rows they read."""
    h = w = 11600  # M * O = 11600^2 * 16 > 2^31
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randint(-127, 128, (1, 3, h, w), generator=gen,
                      dtype=torch.int8, device=cuda).contiguous(
                          memory_format=torch.channels_last)
    wt = torch.randint(-127, 128, (16, 3, 3, 3), generator=gen,
                       dtype=torch.int8, device=cuda)
    d = torch.full((16,), 2e-5, device=cuda)
    b = torch.zeros(16, device=cuda)
    kw = dict(act=Activation.LRELU, s_out=0.05)
    y = conv_int8_fused(x, channels_last_weight(wt), d, b, 1, 1, **kw)
    assert y.numel() > 2**31
    # output rows h-5.. read input rows h-6.. (and the bottom pad)
    want = conv_int8_fused_ref(x[:, :, h - 6:], wt, d, b, 1, 1, **kw)
    assert torch.equal(y[:, :, h - 5:], want[:, :, 1:])
    del x, y


def test_int8_pass_through_ops_keep_channels_last_on_the_card(cuda):
    """maxpool, upsample and concat on channels-last int8, as the int8
    flow runs them on the card: still channels-last, values as on the
    CPU."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(-127, 128, (2, 16, 13, 13), generator=gen,
                      dtype=torch.int8).contiguous(
                          memory_format=torch.channels_last)
    xg = x.to(cuda)
    outs = [
        (pool_ops.maxpool(xg, 2, 1, 13, 13), pool_ops.maxpool(x, 2, 1, 13, 13)),
        (pool_ops.maxpool(xg, 2, 2, 7, 7), pool_ops.maxpool(x, 2, 2, 7, 7)),
        (ops.upsample_nn(xg, 2), ops.upsample_nn(x, 2)),
        (ops.concat_channels([xg, xg]), ops.concat_channels([x, x])),
        (ops.concat_channels([xg]), ops.concat_channels([x])),
    ]
    for got, want in outs:
        assert got.dtype == torch.int8
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got.cpu(), want)


def test_bf16_conv_with_fp32_out_is_the_fp32_conv_of_rounded_inputs(cuda):
    """conv2d(compute_dtype=bf16) without out_dtype runs the fp32 conv of
    the bf16-rounded inputs with TF32 allowed: every product is exact in
    TF32, so it equals the TF32-off fp32 conv of those inputs up to the
    order of the sum."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 26, 26, generator=gen).to(cuda)
    w = torch.randn(128, 64, 3, 3, generator=gen).to(cuda)
    got = conv_ops.conv2d(x, w, 1, 1, 1, torch.bfloat16)
    xr, wr = x.bfloat16().float(), w.bfloat16().float()
    want = conv_ops.conv2d(xr, wr, 1, 1)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    bf = conv_ops.conv2d(x, w, 1, 1, 1, torch.bfloat16, torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf.float(), want, rtol=2**-7, atol=1e-2)


def test_maxpool_on_int8(cuda):
    x = torch.randint(-127, 128, (2, 5, 13, 13), dtype=torch.int8)
    for size, stride, oh in ((2, 2, 7), (2, 1, 13)):
        got = pool_ops.maxpool(x.to(cuda), size, stride, oh, oh)
        assert got.dtype == torch.int8
        assert torch.equal(got.cpu(), pool_ops.maxpool(x, size, stride, oh,
                                                       oh))


def test_int8_detect_on_the_card_equals_the_cpu(cuda):
    """One quant dict, made on the CPU, for both sessions: every int8
    flow tensor and both raw heads equal, 13 K4 launches a request."""
    from bcnn_tpu_torch.compile import execute

    net = yolov3_tiny(2, 96, 96, 4)
    net.compute_dtype = net.act_dtype = torch.bfloat16
    cpu = Session(net, 0, device="cpu").compile_net()
    ptq_synthetic(net, cpu)
    gpu = Session(net, 0, device=cuda)
    gpu.params = {k: v.to(cuda) for k, v in cpu.params.items()}
    gpu.state = {k: v.to(cuda) for k, v in cpu.state.items()}
    gpu.compile_net()
    quant_cpu = net.quant
    quant_gpu = dict(quant_cpu, weights={
        k: {kk: vv.to(cuda) for kk, vv in e.items()}
        for k, e in quant_cpu["weights"].items()})
    x = torch.rand(2, 3, 96, 96, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = execute(net, cpu.params, cpu.state, {"input": x},
                       Mode.PREDICT)
        net.quant = quant_gpu
        before = library.launches("conv_int8")
        got = execute(net, gpu.params, gpu.state, {"input": x.to(cuda)},
                      Mode.PREDICT)
        torch.cuda.synchronize()
        assert library.launches("conv_int8") == before + 13
    net.quant = quant_cpu
    n_int8 = 0
    for i, v in want.values.items():
        if v.dtype in (torch.int8, torch.bfloat16) and v.dim() == 4:
            n_int8 += v.dtype == torch.int8
            assert torch.equal(got.values[i].cpu(), v), net.tensors[i].name
            if v.dtype == torch.int8:  # the int8 flow is channels-last
                assert got.values[i].is_contiguous(
                    memory_format=torch.channels_last), net.tensors[i].name
    assert n_int8 >= 10


def test_detect_on_full_yolov3_launches_k1_per_head(cuda):
    """Full YOLOv3 (96 px, 4 classes): three K1 launches a
    decode-everything request, equal to the plain decode."""
    from bcnn_tpu_torch.models import yolov3

    net = yolov3(2, 96, 96, 4)
    sess = Session(net, 0, device=cuda)
    sess.params, sess.state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0, residual_scale=0.1),
        device=cuda)
    sess.compile_net()
    x = np.random.RandomState(0).rand(2, 3, 96, 96).astype(np.float32)
    before = library.launches("yolo_decode")
    full = sess.detect_on_batch(x, 0.5, 30, topk_first=False)
    assert library.launches("yolo_decode") == before + 3
    plain = sess.detect_on_batch(x, 0.5, 30, topk_first=False,
                                 use_pallas=False)
    for a, b in zip(full, plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_full_yolov3_int8_on_the_card_equals_the_cpu(cuda):
    """Full YOLOv3 (96 px, batch 2, bf16 + int8), one quant dict made on
    the CPU: 75 K4 launches a forward, every int8 and bf16 tensor equal
    to the CPU's, the shortcut adds int8 and channels-last."""
    from bcnn_tpu_torch.compile import execute
    from bcnn_tpu_torch.models import yolov3

    net = yolov3(2, 96, 96, 4)
    net.compute_dtype = net.act_dtype = torch.bfloat16
    cpu = Session(net, 0, device="cpu")
    cpu.params, cpu.state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0, residual_scale=0.1))
    cpu.compile_net()
    quant_cpu = ptq_synthetic(net, cpu)
    quant_gpu = dict(quant_cpu, weights={
        k: {kk: vv.to(cuda) for kk, vv in e.items()}
        for k, e in quant_cpu["weights"].items()})
    x = torch.rand(2, 3, 96, 96, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = execute(net, cpu.params, cpu.state, {"input": x},
                       Mode.PREDICT)
        net.quant = quant_gpu
        before = library.launches("conv_int8")
        got = execute(net, {k: v.to(cuda) for k, v in cpu.params.items()},
                      {k: v.to(cuda) for k, v in cpu.state.items()},
                      {"input": x.to(cuda)}, Mode.PREDICT)
        torch.cuda.synchronize()
        assert library.launches("conv_int8") == before + 75
    net.quant = quant_cpu
    for i, v in want.values.items():
        if v.dtype in (torch.int8, torch.bfloat16) and v.dim() == 4:
            assert torch.equal(got.values[i].cpu(), v), net.tensors[i].name
    adds = [n.dst[0] for n in net.nodes if n.type.name == "ELTWISE"]
    assert len(adds) == 23
    for i in adds:
        assert got.values[i].dtype == torch.int8, net.tensors[i].name
        assert got.values[i].is_contiguous(
            memory_format=torch.channels_last), net.tensors[i].name


def test_int8_shortcut_makes_no_layout_copy_on_the_card(cuda, tmp_path):
    """The shortcut net's int8 program on the card: no 4-d tensor copied
    into its own dtype outside K4 (the int32 add and the requantize keep
    channels-last), every int8 tensor equal to the CPU's."""
    from bcnn_tpu_torch.compile import execute
    from test_torch_int8_layout import LayoutCopies, shortcut_net

    net = shortcut_net(tmp_path / "shortcut.cfg")
    cpu = Session(net, 0, device="cpu")
    cpu.params, cpu.state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 3, residual_scale=0.5))
    cpu.compile_net()
    quant_cpu = ptq_synthetic(net, cpu)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        want = execute(net, cpu.params, cpu.state, {"input": x},
                       Mode.PREDICT)
        net.quant = dict(quant_cpu, weights={
            k: {kk: vv.to(cuda) for kk, vv in e.items()}
            for k, e in quant_cpu["weights"].items()})
        params = {k: v.to(cuda) for k, v in cpu.params.items()}
        state = {k: v.to(cuda) for k, v in cpu.state.items()}
        mode = LayoutCopies()
        with mode:
            got = execute(net, params, state, {"input": x.to(cuda)},
                          Mode.PREDICT)
        torch.cuda.synchronize()
    net.quant = quant_cpu
    assert mode.copies == []
    n_int8 = 0
    for i, v in want.values.items():
        if v.dtype == torch.int8:
            n_int8 += 1
            assert torch.equal(got.values[i].cpu(), v), net.tensors[i].name
            assert got.values[i].is_contiguous(
                memory_format=torch.channels_last), net.tensors[i].name
    assert n_int8 >= 10


# ---------------------------------------------------------- the data feed #


def _clf_list(tmp_path, n=7, size=16):
    from bcnn_tpu_torch import bip

    rng = np.random.RandomState(0)
    lines = []
    for i in range(n):
        p = str(tmp_path / f"im{i}.png")
        bip.write_image(p, (rng.rand(size, size, 3) * 255).astype(np.uint8))
        lines.append(f"{p} {i % 4}")
    lst = tmp_path / "clf.txt"
    lst.write_text("\n".join(lines) + "\n")
    return str(lst)


def _clf_net(raw=False, batch=2):
    from bcnn_tpu_torch.graph import Net

    net = Net(Mode.TRAIN)
    net.set_input_shape(16, 16, 3, batch)
    t1 = net.tensors[1]
    t1.n, t1.c, t1.h, t1.w = batch, 4, 1, 1
    if raw:
        net.device_augment = {}
    return net


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("workers", [0, 3])
def test_pipeline_device_batches_equal_host_arrays(cuda, tmp_path, raw,
                                                   workers):
    """The pipelines' batches on the card (pinned copies on the worker's
    stream, handed over with an event) equal the sequential loader's host
    arrays, while the consumer's stream is kept busy."""
    from bcnn_tpu_torch.data import loaders
    from bcnn_tpu_torch.data.pipeline import (BatchPipeline,
                                              ShardedBatchPipeline)

    lst = _clf_list(tmp_path)
    ref = loaders.ClassificationListLoader(_clf_net(raw), lst)
    want = [ref.next_batch() for _ in range(8)]
    if workers:
        pipe = ShardedBatchPipeline(
            lambda: loaders.ClassificationListLoader(_clf_net(raw), lst),
            workers=workers, device=cuda)
    else:
        pipe = BatchPipeline(loaders.ClassificationListLoader(
            _clf_net(raw), lst), depth=2, device=cuda)
    got = []
    try:
        for x, y in pipe:
            torch.cuda._sleep(1_000_000)  # the consumer's stream is busy
            got.append((x.clone(), y.clone()))
            if len(got) == len(want):
                break
    finally:
        pipe.stop()
    torch.cuda.synchronize()
    for (x, y), (rx, ry) in zip(got, want):
        assert x.device.type == "cuda"
        assert x.dtype == (torch.uint8 if raw else torch.float32)
        np.testing.assert_array_equal(x.cpu().numpy(),
                                      rx.astype(x.cpu().numpy().dtype))
        np.testing.assert_array_equal(y.cpu().numpy(), ry)


@pytest.mark.parametrize("cfg", [
    dict(rotation_range=150.0, min_scale=0.9, max_scale=1.1,
         random_fliph=1, min_contrast=0.8, max_contrast=1.2),
    dict(max_distortion=0.3), dict(max_random_spots=4),
    dict(rotation_range=20.0, max_distortion=0.2, max_random_spots=2)],
    ids=["full", "perlin", "spotlights", "shear_perlin_spots"])
def test_device_augment_full_perlin_spots_card_vs_cpu(cuda, cfg):
    """One params dict on both devices; atol 1e-3 on [0, 255] values, the
    tolerance tests/test_torch_device_augment.py holds bcnn_tpu to, and
    4e-3 with Perlin distortion: its sample coordinates come from cos on
    each device (CUDA's cosf within 2 ulp, the host's within 1), and an
    ulp of a coordinate near 56 px (3.8e-6 px) times an image slope of up
    to 255 levels a px is 1e-3 (1.9e-3 measured on an H100)."""
    from bcnn_tpu_torch.data import device_augment as da

    gen = torch.Generator().manual_seed(3)
    x = torch.randint(0, 256, (4, 48, 56, 3), generator=gen).float()
    params = da.sample_params(gen, 4, cfg, (48, 56))
    kw = da._geo_kwargs(cfg)
    cpu = da._augment(x, params, **kw)
    got = da._augment(x.to(cuda), da._on(params, cuda), **kw).cpu()
    atol = 4e-3 if "max_distortion" in cfg else 1e-3
    torch.testing.assert_close(got, cpu, rtol=0, atol=atol)


def test_resident_scan_gathers_the_staged_batches_on_the_card(cuda,
                                                              tmp_path):
    """Session.train_scan_resident_on_batches (the record file uploaded
    once, batches gathered on the card) against train_scan_on_batches on
    the same records, from the same start: the same batches and draws,
    within the trajectory tolerances (losses rtol 1e-4, updates 1e-3 of
    their largest entry)."""
    from bcnn_tpu_torch.data import records

    rng = np.random.RandomState(4)
    xs = rng.randint(0, 256, (6, 3, 64, 64)).astype(np.uint8)
    ys = np.zeros((6, 250), np.float32)
    ys[:, :5] = [0.5, 0.5, 0.3, 0.4, 1.0]
    path = str(tmp_path / "r.bcrd")
    records.write_records(path, zip(xs, ys), 3, 64, 64, 250)
    out = []
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the two runs, bit for bit
    for resident in (True, False):
        net = yolov3_tiny(2, 64, 64, 2, mode=Mode.TRAIN)
        net.device_augment = dict(rotation_range=10.0, random_fliph=1)
        sess = Session(net, 0, device=cuda).compile_net()
        p0 = {k: v.clone() for k, v in sess.params.items()}
        sess.loader = records.RawRecordLoader(net, path)
        before = library.launches("row_shift")
        fn = (sess.train_scan_resident_on_batches if resident
              else sess.train_scan_on_batches)
        losses = [fn(2) for _ in range(2)]
        assert library.launches("row_shift") - before == 3 * 4
        out.append((losses, p0, sess.params))
    torch.backends.cudnn.deterministic = det
    (la, p0, pa), (lb, _, pb) = out
    np.testing.assert_allclose(la, lb, rtol=1e-4)
    for k in p0:
        du_a, du_b = pa[k] - p0[k], pb[k] - p0[k]
        scale = float(du_b.abs().max())
        assert float((du_a - du_b).abs().max()) <= 1e-3 * scale, k


# ------------- the shortcut's backward, deconv, LRN, dropout, PReLU #


def _card_vs_cpu(cuda, fn, *args, rtol=1e-4):
    """fn(*args) and its gradients on the card against the CPU's: each
    output and each gradient within rtol of its largest |value| (sums in
    another order; TF32 stays off in the fp32 ops)."""
    outs = []
    for dev in ("cpu", cuda):
        leaves = [a.to(dev).detach().requires_grad_(a.is_floating_point())
                  for a in args]
        y = fn(*leaves)
        g = torch.ones_like(y) + torch.arange(
            y.numel(), device=y.device, dtype=y.dtype).reshape(y.shape) % 3
        y.backward(g)
        outs.append([y.detach().cpu()] + [
            a.grad.cpu() for a in leaves if a.grad is not None])
    for ref, got in zip(*outs):
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=rtol * float(ref.abs().max()))


def test_eltwise_backward_on_the_card(cuda):
    """The strided add's gradients: x0 all of it, x1 its strided subset."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(2, 6, 16, 16, generator=gen)
    b = torch.randn(2, 4, 8, 8, generator=gen)
    _card_vs_cpu(cuda, lambda u, v: ops.eltwise_add(u, v, (2, 1),
                                                    (4, 8, 8)) ** 2, a, b)


@pytest.mark.parametrize("form", ["fp32", "bf16", "quirk"])
def test_deconv_on_the_card(cuda, form):
    """The deconv on the card against the CPU, forward and gradients:
    fp32 (TF32 off both ways), bf16 (gradients within 2^-7) and the
    reference's padded quirk."""
    from bcnn_tpu_torch.ops.conv import conv2d_transpose_ref_quirk

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, 13, 13, generator=gen)
    w = torch.randn(32, 16, 4, 4, generator=gen) * 0.1
    if form == "quirk":
        fn = lambda u, v: conv2d_transpose_ref_quirk(u, v, 2, 1)  # noqa
    else:
        cd = torch.bfloat16 if form == "bf16" else None
        fn = lambda u, v: ops.conv2d_transpose(u, v, 2, 1, cd)  # noqa
    _card_vs_cpu(cuda, fn, x, w,
                 rtol=2.0**-7 if form == "bf16" else 1e-4)


def test_lrn_on_the_card(cuda):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 24, 9, 9, generator=gen) + 0.5
    _card_vs_cpu(cuda, lambda u: ops.lrn(u, 5, 1e-2, 0.75, 2.0), x)


def test_dropout_generator_on_the_card(cuda):
    """A mask drawn on the card repeats under one seed (the executor's
    per-node seed), differs under another, keeps about 1 - rate, and the
    CPU given that mask computes the same layer and gradient."""
    x = torch.randn(4, 8, 32, 32, device=cuda)
    masks = [ops.dropout_mask(x.shape, 0.3, cuda, torch.Generator(
        device=cuda).manual_seed(s + 3)) for s in (5, 5, 6)]
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])
    assert abs(float(masks[0].float().mean()) - 0.7) < 0.02
    _card_vs_cpu(cuda, lambda u: ops.dropout(u, 1 / 0.7, masks[0].to(
        u.device)) * u, x.cpu(), rtol=0)


def test_prelu_on_the_card(cuda):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 10, 10, generator=gen)
    s = torch.rand(8, generator=gen) * 0.3
    _card_vs_cpu(cuda, lambda u, v: ops.apply_activation(
        u, Activation.PRELU, v), x, s)


def test_bf16_fc_and_depthwise_step_on_the_card(cuda):
    """A MobileNet-v1 (width 0.25, 96 px) bf16 + act16 training step on
    the card against the CPU: FC and depthwise in bf16 both ways, the
    loss within 2^-5, every parameter fp32 and finite, and the FC's and
    the first depthwise layer's updates within 2^-5 of their largest
    (bf16 roundings taken in another order)."""
    net = mobilenet_v1(2, 10, Mode.TRAIN, width_mult=0.25).resize(96, 96)
    net.compute_dtype = net.train_act_dtype = torch.bfloat16
    p_np, s_np = bridge.he_numpy_weights(net, 0)
    rng = np.random.RandomState(1)
    x = rng.rand(2, 3, 96, 96).astype(np.float32)
    lab = np.zeros((2, 10), np.float32)
    lab[[0, 1], [3, 7]] = 1.0
    runs = []
    for dev in ("cpu", cuda):
        sess = Session(net, 0, device=dev)
        sess.params, sess.state = bridge.params_from_numpy(net, p_np, s_np,
                                                           dev)
        sess.compile_net()
        loss = float(sess.train_on_batch(x, lab))
        assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
                   for v in sess.params.values())
        runs.append((loss, {k: v.cpu() for k, v in sess.params.items()}))
    (lc, pc), (lg, pg) = runs
    assert abs(lg - lc) <= 2.0**-5 * abs(lc)
    p0 = bridge.params_from_numpy(net, p_np, s_np)[0]
    for k in ("avgpool_w", "conv1_w"):
        du_c, du_g = pc[k] - p0[k], pg[k] - p0[k]
        assert float((du_g - du_c).abs().max()) <= 2.0**-5 * float(
            du_c.abs().max()), k


# ------------------------------------------- K5, the int8 FC and deconv #

from bcnn_tpu_torch import graph as tgraph  # noqa: E402
from bcnn_tpu_torch import replay  # noqa: E402
from bcnn_tpu_torch.compile import execute, make_train_step  # noqa: E402
from bcnn_tpu_torch.learner import init_opt_state  # noqa: E402
from bcnn_tpu_torch.ops import quant as tq  # noqa: E402
from bcnn_tpu_torch.ops.grouped_int8 import (  # noqa: E402
    grouped_int8_fused, grouped_int8_fused_ref, grouped_weight)

# (n, c, h, w, o, k, stride, pad, groups, bn, act): MobileNet-v1's nine
# depthwise shapes at batch 2, then ragged and grouped ones
K5_CASES = [
    (2, c, hw, hw, c, 3, s, 1, c, 0, Activation.RELU)
    for c, hw, s in [(32, 112, 1), (64, 112, 2), (128, 56, 1), (128, 56, 2),
                     (256, 28, 1), (256, 28, 2), (512, 14, 1), (512, 14, 2),
                     (1024, 7, 1)]
] + [
    (3, 6, 15, 13, 6, 3, 1, 1, 6, 0, Activation.LRELU),    # C % 4 != 0
    (2, 5, 9, 11, 5, 5, 2, 0, 5, 0, Activation.NONE),      # k 5
    (2, 64, 13, 13, 128, 3, 1, 1, 2, 2, Activation.LRELU),  # 2 groups, BN
    (1, 48, 9, 9, 24, 1, 1, 0, 4, 1, Activation.RELU),     # 1x1, folded BN
    (2, 9, 7, 7, 6, 3, 2, 1, 3, 0, Activation.NONE),       # O % 4 != 0
    (1, 16, 5, 5, 32, 3, 1, 1, 16, 0, Activation.LRELU),   # multiplier 2
    (1, 1400, 3, 3, 4, 3, 1, 1, 1, 0, Activation.RELU),    # unstaged
    (70, 16, 7, 7, 16, 3, 1, 1, 16, 0, Activation.RELU),   # many images
    (2, 32, 14, 14, 32, 3, 1, 1, 32, 0, Activation.RELU),  # ragged strips
    (2, 48, 13, 11, 48, 3, 2, 1, 48, 0, Activation.LRELU),  # stride 2, odd
    (2, 24, 8, 8, 24, 3, 1, 1, 24, 0, Activation.NONE),    # C = 16 j + 8
    (2, 16, 9, 9, 16, 3, 1, 1, 4, 2, Activation.RELU),     # cg = 4
    (2, 128, 10, 10, 64, 3, 1, 1, 2, 1, Activation.LRELU),  # cg = 64
    (1, 1024, 7, 7, 1024, 3, 1, 1, 1024, 0, Activation.RELU),  # batch 1
]


def _k5_args(n, c, h, w, o, k, groups, bn, gen):
    x = torch.randint(-127, 128, (n, c, h, w), generator=gen,
                      dtype=torch.int8)
    wt = torch.randint(-127, 128, (o, c // groups, k, k), generator=gen,
                       dtype=torch.int8)
    vec = lambda lo, hi: lo + (hi - lo) * torch.rand(o, generator=gen)  # noqa: E731,E501
    d, b = vec(1e-4, 3e-4), vec(-0.2, 0.2)
    kw = {}
    if bn:
        kw["scale"] = vec(0.8, 1.2)
    if bn == 2:
        var = vec(0.5, 1.5)
        kw["mean"] = vec(-0.1, 0.1)
        kw["inv"] = torch.ones_like(var) / torch.sqrt(var + 1e-5)
    return x, wt, d, b, kw


@pytest.mark.parametrize("n,c,h,w,o,k,stride,pad,groups,bn,act", K5_CASES)
def test_k5_matches_plain_version(cuda, n, c, h, w, o, k, stride, pad,
                                  groups, bn, act):
    """K5 on channels-last x and the (k, k, O, C/G) weight, bit-equal to
    its plain version, fp32 and requantized, one launch a call."""
    gen = torch.Generator().manual_seed(c * 7 + o + k)
    x, wt, d, b, kw = _k5_args(n, c, h, w, o, k, groups, bn, gen)
    wg = grouped_weight(wt)
    xc = x.contiguous(memory_format=torch.channels_last)
    for s_out in (None, 0.05):
        want = grouped_int8_fused_ref(x, wt, d, b, stride, pad, groups, act,
                                      s_out=s_out, **kw)
        before = library.launches("grouped_int8")
        got = grouped_int8_fused(
            xc.to(cuda), wg.to(cuda), d.to(cuda), b.to(cuda), stride, pad,
            groups, act, s_out=s_out, **{k_: v.to(cuda)
                                         for k_, v in kw.items()})
        torch.cuda.synchronize()
        assert library.launches("grouped_int8") == before + 1
        assert torch.equal(got.cpu(), want)


def test_k5_requantizes_ties_as_the_true_division(cuda):
    """A depthwise layer whose outputs are the bias alone (x = 0), the
    bias (q + 0.5) s_out and the floats next to it, q across the codes:
    the requantize's shortcut must take the true division there
    (bit-equal to the plain version), on the depthwise branch."""
    s_out = 2.0 / 127
    q = torch.arange(-130, 130, dtype=torch.float32)
    ties = (q + 0.5) * torch.tensor(s_out, dtype=torch.float32)
    y = torch.cat([ties, torch.nextafter(ties, ties + 1),
                   torch.nextafter(ties, ties - 1)])
    c = -(-y.numel() // 16) * 16
    b = torch.cat([y, torch.zeros(c - y.numel())])
    x = torch.zeros(1, c, 1, 1, dtype=torch.int8).contiguous(
        memory_format=torch.channels_last)
    w = torch.ones(c, 1, 3, 3, dtype=torch.int8)
    d = torch.ones(c)
    want = grouped_int8_fused_ref(x, w, d, b, 1, 1, c, s_out=s_out)
    got = grouped_int8_fused(x.to(cuda), grouped_weight(w).to(cuda),
                             d.to(cuda), b.to(cuda), 1, 1, c, s_out=s_out)
    assert torch.equal(got.cpu(), want)


def test_k5_requantizes_where_the_shortcut_is_off(cuda):
    """s_out whose inverse is no normal float32: the byte branch divides,
    bit-equal to the plain version, and so does a large normal one."""
    gen = torch.Generator().manual_seed(9)
    x, wt, d, b, _ = _k5_args(2, 32, 9, 9, 32, 3, 32, 0, gen)
    xc = x.contiguous(memory_format=torch.channels_last)
    for s_out, scale in ((2.0**127, 2.0**127), (1e-39, 1e-39), (1e30, 1e30)):
        d_s = d * scale
        want = grouped_int8_fused_ref(x, wt, d_s, b, 1, 1, 32, s_out=s_out)
        got = grouped_int8_fused(xc.to(cuda), grouped_weight(wt).to(cuda),
                                 d_s.to(cuda), b.to(cuda), 1, 1, 32,
                                 s_out=s_out)
        assert torch.equal(got.cpu(), want), s_out


def test_k5_raises_on_an_nchw_x_or_a_conv_layout_w(cuda):
    gen = torch.Generator().manual_seed(5)
    x, wt, d, b, _ = _k5_args(2, 8, 6, 6, 8, 3, 8, 0, gen)
    x, wt, d, b = x.to(cuda), wt.to(cuda), d.to(cuda), b.to(cuda)
    xc = x.contiguous(memory_format=torch.channels_last)
    before = library.launches("grouped_int8")
    with pytest.raises(ValueError, match="channels-last"):
        grouped_int8_fused(x, grouped_weight(wt), d, b, 1, 1, 8)
    with pytest.raises(ValueError, match="grouped_weight"):
        grouped_int8_fused(xc, wt, d, b, 1, 1, 8)
    with pytest.raises(ValueError, match="not fused"):
        grouped_int8_fused(xc, grouped_weight(wt), d, b, 1, 1, 8,
                           Activation.TANH)
    assert library.launches("grouped_int8") == before


def _int8_layers_net():
    """Depthwise (stride 1, 2), a grouped conv with BN, a deconv (stride
    2, pad 1) and FCs on a 4-d and on a pooled input."""
    A, F = Activation, tgraph.FillerType
    net = tgraph.Net(Mode.PREDICT)
    net.set_input_shape(16, 16, 8, 2)
    net.add_convolutional_layer(16, 3, 1, 1, 1, 1, F.XAVIER, A.LRELU, 0,
                                "input", "c0")
    net.add_depthwise_conv_layer(3, 1, 1, 0, F.XAVIER, A.RELU, "c0", "dw1")
    net.add_depthwise_conv_layer(3, 2, 1, 0, F.XAVIER, A.LRELU, "dw1", "dw2")
    net.add_convolutional_layer(16, 3, 1, 1, 4, 1, F.XAVIER, A.RELU, 0,
                                "dw2", "g4")
    net.add_deconvolutional_layer(8, 4, 2, 1, F.XAVIER, A.LRELU, "g4", "up")
    net.add_convolutional_layer(8, 3, 2, 1, 1, 0, F.XAVIER, A.RELU, 0, "up",
                                "c1")
    net.add_fullc_layer(12, F.XAVIER, A.RELU, 0, "c1", "fc1")
    net.add_fullc_layer(5, F.XAVIER, A.NONE, 0, "fc1", "fc2")
    return net


def test_int8_depthwise_grouped_deconv_and_fc_card_vs_cpu(cuda):
    """Every quantized layer kind on the card (K5 on the depthwise and
    grouped layers, K4 on the convs, the deconv and the FCs) against the
    CPU with one quant dict: every int8 tensor equal, the output within
    fp32 rounding; the launches counted."""
    from bcnn_tpu_torch.ops.conv_int8 import conv_int8_fused

    net = _int8_layers_net()
    p_np, s_np = bridge.he_numpy_weights(net, 3)
    x = np.random.RandomState(4).rand(2, 8, 16, 16).astype(np.float32)
    outs = {}
    for dev in ("cpu", cuda):
        sess = Session(net, 0, device=dev)
        sess.params, sess.state = bridge.params_from_numpy(net, p_np, s_np,
                                                           dev)
        sess.compile_net()
        if dev == "cpu":
            tq.ptq_synthetic(net, sess)  # resets run_var to 1
            quant, state = net.quant, sess.state
        else:
            sess.state = {k: v.to(cuda) for k, v in state.items()}
            net.quant = {**quant, "weights": {
                k: {p: t.to(cuda) for p, t in e.items()}
                for k, e in quant["weights"].items()}}
        k4 = library.launches("conv_int8")
        k5 = library.launches("grouped_int8")
        with torch.inference_mode():
            ex = execute(net, sess.params, sess.state,
                         {"input": torch.from_numpy(x).to(dev)},
                         Mode.PREDICT)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert library.launches("grouped_int8") - k5 == 3
            assert library.launches("conv_int8") - k4 == 5
        outs[str(dev)] = {i: v.cpu() for i, v in ex.values.items()}
    net.quant = None
    cpu, card = outs["cpu"], outs[str(cuda)]
    n_int8 = 0
    for i, v in cpu.items():
        if v.dtype == torch.int8:
            n_int8 += 1
            assert torch.equal(card[i], v), net.tensors[i].name
    assert n_int8 >= 6
    last = net.nodes[-1].dst[0]
    torch.testing.assert_close(card[last], cpu[last], rtol=1e-5, atol=1e-6)


def _qat_net():
    A, F = Activation, tgraph.FillerType
    net = tgraph.Net(Mode.TRAIN)
    net.set_input_shape(12, 12, 3, 4)
    net.set_sgd_optimizer(0.02, 0.9)
    net.add_convolutional_layer(16, 3, 1, 1, 1, 1, F.XAVIER, A.RELU, 1,
                                "input", "c1")
    net.add_maxpool_layer(2, 2, tgraph.Padding.SAME, "c1", "p1")
    net.add_depthwise_conv_layer(3, 1, 1, 0, F.XAVIER, A.LRELU, "p1", "dw")
    net.add_convolutional_layer(32, 3, 1, 1, 1, 1, F.XAVIER, A.RELU, 1,
                                "dw", "c2")
    net.add_fullc_layer(4, F.XAVIER, A.NONE, 1, "c2", "fc")
    net.add_softmax_layer("fc", "sm")
    net.add_cost_layer(tgraph.Loss.EUCLIDEAN, tgraph.Metric.ERROR_RATE, 1.0,
                       "sm", "label", "cost")
    net.qat = True
    return net


def test_qat_step_on_the_card(cuda):
    """One QAT training step on the card against the CPU's: the loss
    (rtol 1e-4) and the ranges (rtol 1e-5) and each update held to a
    float64 step that takes the card's own kink sides, max-pool picks and
    fake-quant codes (within 1e-3 of its largest entry), each code within
    `replay.CODE_EPS` of float64's x / s and at most 1 in 1,000 on a
    boundary there; the number of codes that differ from the CPU's run
    is printed."""
    net = _qat_net()
    p_np, s_np = bridge.he_numpy_weights(net, 2)
    rng = np.random.RandomState(3)
    x = rng.randn(4, 3, 12, 12).astype(np.float32)
    y = np.zeros((4, 4, 1, 1), np.float32)
    y[np.arange(4), rng.randint(0, 4, 4)] = 1.0
    batch = {"input": x, "label": y}
    runs = {}
    for dev in ("cpu", cuda):
        params, state = bridge.params_from_numpy(net, p_np, s_np, dev)
        state.update({k: torch.zeros((), device=dev)
                      for k in tq.qat_state_keys(net)})
        ch = replay.Choices()
        with replay.record(ch):
            params, state, _, loss = make_train_step(net)(
                params, state, init_opt_state(net, params),
                {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        runs[str(dev)] = (float(loss), {k: v.cpu() for k, v in
                                        params.items()},
                          {k: v.cpu() for k, v in state.items()}, ch)
    (lc, pc, sc, chc), (lg, pg, sg, chg) = runs["cpu"], runs[str(cuda)]
    apart = sum(int((a != b).sum()) for a, b in zip(chc.codes, chg.codes))
    print(f"{apart} fake-quant codes differ card vs CPU")
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for k in tq.qat_state_keys(net):
        torch.testing.assert_close(sg[k], sc[k], rtol=1e-5, atol=0)
    p0, s0 = bridge.params_from_numpy(net, p_np, s_np)
    s0.update({k: torch.zeros(()) for k in tq.qat_state_keys(net)})
    update, _ = replay.sgd_update(net, p0, s0, batch, torch.float64,
                                  choices=replay.impose(chg))
    total = sum(c.numel() for c in chg.codes)
    print(f"{sum(chg.boundary)} of {total} of the card's codes round the "
          "other way in float64")
    assert sum(chg.boundary) <= max(2, total // 1000)
    for k, du64 in update.items():
        du = pg[k] - p0[k]
        tol = max(1e-3 * float(du64.abs().max()),
                  float(np.spacing(np.float32(p0[k].abs().max()))))
        assert float((du - du64).abs().max()) <= tol, k


# ------------------------------------------- the kernels as torch.library ops #


def _op_cases(gen):
    """(name, op, launcher, args on the CPU, plain-version tolerance)
    for each of the six ops at a small shape (K6 folded, whose plain
    version rounds alike on both devices): None is bit for bit, else
    (rtol, atol, atol relative to the largest output?), those of the
    tests of K1 and K3 above."""
    from bcnn_tpu_torch.ops import bn_act as k6
    from bcnn_tpu_torch.ops import conv_int8 as k4
    from bcnn_tpu_torch.ops import depthwise as k3
    from bcnn_tpu_torch.ops import grouped_int8 as k5
    from bcnn_tpu_torch.ops import row_shift as k2
    from bcnn_tpu_torch.ops import yolo_decode as k1

    ops_ = torch.ops.bcnn_tpu_torch
    i8 = lambda *s: torch.randint(-127, 128, s, generator=gen,  # noqa: E731
                                  dtype=torch.int8)
    vec = lambda o: torch.rand(o, generator=gen) + 0.5  # noqa: E731
    cl = torch.channels_last
    x4 = i8(2, 32, 13, 13).contiguous(memory_format=cl)
    w4 = k4.channels_last_weight(i8(48, 32, 3, 3))
    x5 = i8(2, 32, 14, 14).contiguous(memory_format=cl)
    w5 = k5.grouped_weight(i8(32, 1, 3, 3))
    anchors = [float(a) for a in ANCHORS[:6]]
    return [
        ("yolo_decode", ops_.yolo_decode.default, k1.decode_cuda,
         (4 * torch.randn(2, 3 * 85, 13, 13, generator=gen), anchors, 80,
          416.0, 416.0), (1e-5, 1e-6, False)),
        ("row_shift", ops_.row_shift.default, k2.shift_cuda,
         (255 * torch.rand(2, 21, 40, 3, generator=gen),
          torch.rand(2, 21, generator=gen) * 8 - 4, 6, 3, 30, 0, 128.0,
          False), None),
        ("col_shift", ops_.row_shift.default, k2.shift_cuda,
         (255 * torch.rand(2, 40, 21, 3, generator=gen),
          torch.rand(2, 21, generator=gen) * 8 - 4, 6, 3, 30, 0, 128.0,
          True), None),
        ("depthwise", ops_.depthwise.default, k3.depthwise_cuda,
         (torch.randn(2, 32, 16, 16, generator=gen),
          torch.randn(32, 1, 3, 3, generator=gen) * 0.4, torch.rand(
              32, generator=gen) - 0.5, 2, 1, int(Activation.LRELU)),
         (0, 1e-4, True)),
        ("conv_int8", ops_.conv_int8.default, k4.conv_int8_cuda,
         (x4, w4, vec(48) * 1e-4, vec(48), 1, 1, int(Activation.LRELU),
          vec(48), None, None, 0.05), None),
        ("grouped_int8", ops_.grouped_int8.default, k5.grouped_int8_cuda,
         (x5, w5, vec(32) * 1e-3, vec(32), 2, 1, 32, int(Activation.RELU),
          None, None, None, 0.05), None),
        ("bn_act", ops_.bn_act.default, k6.bn_act_cuda,
         (torch.randn(2, 48, 13, 13, generator=gen).to(torch.bfloat16),
          vec(48), vec(48) - 1, vec(48), vec(48), True,
          int(Activation.LRELU)), None),
    ]


def test_ops_on_the_card_equal_their_plain_versions_and_launchers(cuda):
    """Each op through torch.ops launches its kernel (its counter moves
    by one), equals its plain version (the op's CPU implementation) on
    the same values, and equals its launcher called directly, bit for
    bit."""
    counters = {"yolo_decode": "yolo_decode", "row_shift": "row_shift",
                "col_shift": "row_shift", "depthwise": "depthwise",
                "conv_int8": "conv_int8", "grouped_int8": "grouped_int8",
                "bn_act": "bn_act"}
    for name, op, launcher, args, tol in _op_cases(
            torch.Generator().manual_seed(11)):
        dev = [a.to(cuda) if isinstance(a, torch.Tensor) else a
               for a in args]
        plain = op(*args)
        before = library.launches(counters[name])
        got = op(*dev)
        torch.cuda.synchronize()
        assert library.launches(counters[name]) == before + 1, name
        direct = launcher(*dev)
        outs = (got, direct, plain)
        if isinstance(got, torch.Tensor):
            outs = ((got,), (direct,), (plain,))
        for g, d, p in zip(*outs):
            assert g.stride() == p.stride(), name
            assert torch.equal(g, d), name
            if tol is None:
                assert torch.equal(g.cpu(), p), name
            else:
                rtol, atol, rel = tol
                torch.testing.assert_close(
                    g.cpu(), p, rtol=rtol,
                    atol=atol * (float(p.abs().max()) if rel else 1.0))


def test_exported_int8_detect_launches_k4_per_conv(cuda, tmp_path):
    """YOLOv3-tiny int8 (96 px, batch 2), exported on the card: a call
    of the loaded program launches K4 13 times and equals the live
    detect_on_batch bit for bit."""
    from bcnn_tpu_torch import deploy
    from bcnn_tpu_torch.ops.conv_int8 import conv_int8_fused

    net = yolov3_tiny(2, 96, 96, 4)
    sess = Session(net, 0, device=cuda)
    sess.params, sess.state = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0), device=cuda)
    sess.compile_net()
    ptq_synthetic(net, sess)
    path = str(tmp_path / "tiny_int8.pt2")
    sess.export_serving(path, detect=True, thresh=0.3, max_dets=20)
    served = deploy.load_exported(path)
    assert served.platforms == ("cuda",)
    x = torch.rand(2, 3, 96, 96, generator=torch.Generator().manual_seed(2))
    live = sess.detect_on_batch(x, 0.3, 20)
    before = library.launches("conv_int8")
    got = served(x.to(cuda))
    torch.cuda.synchronize()
    assert library.launches("conv_int8") == before + 13
    for g, w in zip(got, live):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="cpu"):
        served(x)  # a CPU tensor is not copied over


def _pipeline_step(net, p, s, batch, n_micro, schedule, device,
                   check=False):
    """One Pipeline step of `net` over split_stages' 2 stages, both on
    `device` (no process group), recording the kink sides and
    max-pool picks of its forwards (not of its recomputes)."""
    from bcnn_tpu_torch import replay
    from bcnn_tpu_torch.learner import init_opt_state
    from bcnn_tpu_torch.parallel import Pipeline

    pipe = Pipeline(net, [[0], [0]], Mode.TRAIN, n_microbatches=n_micro,
                    schedule=schedule, device=device)
    pipe._check_recompute = check
    ps, ss, os_ = pipe.shard(p, s, init_opt_state(net, p))
    choices = replay.Choices()
    with replay.record(choices, when=lambda: not torch.is_grad_enabled()):
        ps, ss, os_, loss = pipe.train_on_batch(ps, ss, os_, batch)
    return pipe.gather(ps), float(loss), choices


def _tiny_train():
    net = yolov3_tiny(4, 96, 96, 4, mode=Mode.TRAIN)
    p, s = bridge.params_from_numpy(net, *bridge.he_numpy_weights(net, 3))
    rng = np.random.RandomState(4)
    lab = np.zeros((4, 50, 5), np.float32)
    lab[:, 0] = [0.5, 0.5, 0.3, 0.4, 1]
    lab[:, 1] = [0.25, 0.7, 0.2, 0.2, 3]
    batch = {"input": torch.from_numpy((rng.rand(4, 3, 96, 96) * 2 - 1)
                                       .astype(np.float32)),
             "label": torch.from_numpy(lab.reshape(4, 250))}
    return net, p, s, batch


def test_pipeline_step_on_the_card_within_the_replay_rule(cuda):
    """A 2-stage YOLOv3-tiny pipeline step at 96 px, batch 4, 2
    microbatches, on the card: each update within 1e-3 of its largest
    entry from a float64 replay (on the card) of the pipeline's own kink
    sides and max-pool picks, twice the one-device
    make_train_step(accum_steps=2)'s own distance to the replay of its
    choices, or one float32 spacing; the loss within 1e-4 of the one
    device step's."""
    from bcnn_tpu_torch import replay
    from bcnn_tpu_torch.compile import make_train_step
    from bcnn_tpu_torch.learner import init_opt_state

    net, p, s, batch = _tiny_train()
    dev = {k: v.to(cuda) for k, v in batch.items()}
    params, loss, choices = _pipeline_step(
        net, {k: v.to(cuda) for k, v in p.items()},
        {k: v.to(cuda) for k, v in s.items()}, dev, 2, "gpipe", cuda)
    one = replay.Choices()
    q = {k: v.to(cuda) for k, v in p.items()}
    with replay.record(one):
        q, _, _, l1 = make_train_step(net, accum_steps=2)(
            q, {k: v.to(cuda) for k, v in s.items()},
            init_opt_state(net, q), dev)
    np.testing.assert_allclose(loss, float(l1), rtol=1e-4)

    def exact(ch):
        return replay.sgd_update(net, p, s, batch, torch.float64, cuda,
                                 replay.impose(ch), accum_steps=2)[0]

    ref, ref_one = exact(choices), exact(one)
    for k, r in ref.items():
        scale = float(r.abs().max())
        e_one = float((q[k].cpu() - p[k] - ref_one[k]).abs().max()) / scale
        lim = max(1e-3, 2 * e_one,
                  float(np.spacing(np.float32(p[k].abs().max()))) / scale)
        err = float((params[k] - p[k] - r).abs().max()) / scale
        assert err <= lim, (k, err, lim)


def test_pipeline_recompute_is_bit_equal_on_the_card(cuda):
    """Under cuDNN's deterministic algorithms every stage's recompute
    gives its first forward's boundary outputs bit for bit (the
    pipeline's check raises otherwise), and 1F1B's step is GPipe's."""
    net, p, s, batch = _tiny_train()
    dev = {k: v.to(cuda) for k, v in batch.items()}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = [_pipeline_step(net, {k: v.to(cuda) for k, v in p.items()},
                               {k: v.to(cuda) for k, v in s.items()}, dev, 2,
                               schedule, cuda, check=True)
                for schedule in ("gpipe", "1f1b")]
    finally:
        torch.backends.cudnn.deterministic = det
    for k, v in runs[0][0].items():
        assert torch.equal(v, runs[1][0][k]), k


# ------------------------------------- K6: a conv's BN and activation --- #

from bcnn_tpu_torch.ops import bn_act as k6  # noqa: E402

K6_ACTS = [Activation.NONE, Activation.RELU, Activation.LRELU,
           Activation.MISH, Activation.SWISH]
# planes of 169 and 676 values with C of 3, 255 and 1,024; planes of 1
# and 3 values, C = 1, planes under a vector
K6_EDGES = [(2, 3, 13, 13), (1, 255, 13, 13), (1, 1024, 13, 13),
            (2, 3, 26, 26), (1, 255, 26, 26), (1, 1024, 26, 26),
            (3, 1, 1, 1), (2, 5, 3, 1), (1, 1, 7, 9), (2, 7, 2, 2)]


def _k6_bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _k6_vectors(c, gen, device):
    """(scales, biases, run_mean, run_var), fp32."""
    return tuple(t.to(device) for t in (
        torch.rand(c, generator=gen) + 0.5, torch.randn(c, generator=gen),
        torch.randn(c, generator=gen), torch.rand(c, generator=gen) * 2))


def _k6_same(x, vecs, folded, act):
    """K6 through its op equals the plain ops on the card, bits and
    strides; one launch counted."""
    before = library.launches("bn_act")
    got = k6.bn_act(x, *vecs, folded, act)
    want = k6.bn_act_ref(x, *vecs, folded, act)
    torch.cuda.synchronize()
    assert library.launches("bn_act") == before + 1
    assert got.dtype == want.dtype and got.stride() == want.stride()
    assert torch.equal(_k6_bits(got), _k6_bits(want)), (
        tuple(x.shape), x.dtype, folded, act)


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_matches_plain_ops_at_every_yolov3_bn_conv(cuda, dtype, folded):
    """Each of full YOLOv3 416's 72 BN conv outputs at batch 2, with
    NONE, RELU and LRELU: bit for bit."""
    from bcnn_tpu_torch.models import yolov3

    net = yolov3(2, 416, 416, 80)
    gen = torch.Generator().manual_seed(22)
    convs = 0
    for node in net.nodes:
        if node.type.name != "CONV2D" or not node.param.get("batch_norm"):
            continue
        d = net.tensors[node.dst[0]]
        x = (3 * torch.randn(2, d.c, d.h, d.w, generator=gen)).to(
            dtype).to(cuda)
        vecs = _k6_vectors(d.c, gen, cuda)
        for act in K6_ACTS:
            _k6_same(x, vecs, folded, act)
        convs += 1
    assert convs == 72


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_mish_matches_plain_ops_at_every_yolov4_bn_shape(cuda, dtype,
                                                           folded):
    """Each shape of YOLOv4 608's 107 BN conv outputs at batch 2, with
    MISH and LRELU, x spread so that BN gives |y| past Darknet's softplus
    cut of 20, and NaN, +-inf, +-20, +-25 and +-100 among the values:
    bit for bit."""
    from bcnn_tpu_torch.models import yolov4

    net = yolov4(2, 608, 608, 80)
    shapes = {tuple(net.tensors[n.dst[0]].shape[1:]) for n in net.nodes
              if n.type.name == "CONV2D" and n.param.get("batch_norm")}
    assert len(shapes) == 13
    gen = torch.Generator().manual_seed(24)
    for c, h, w in sorted(shapes):
        x = 12 * torch.randn(2, c, h, w, generator=gen)
        x.view(-1)[:10] = torch.tensor([
            float("nan"), float("inf"), -float("inf"), 20.0, -20.0, 25.0,
            -25.0, 100.0, -100.0, -0.0])
        vecs = _k6_vectors(c, gen, cuda)
        xd = x.to(dtype).to(cuda)
        for act in (Activation.MISH, Activation.LRELU):
            _k6_same(xd, vecs, folded, act)
        before = library.launches("bn_act", "MISH")
        k6.bn_act(xd, *vecs, folded, Activation.MISH)
        assert library.launches("bn_act", "MISH") == before + 1


@pytest.mark.parametrize("shape", K6_EDGES)
def test_k6_matches_plain_ops_at_the_edges(cuda, shape):
    """NaN, signed zeros, infinities and an fp32 subnormal; x on a
    16-byte boundary and one value off it (all scalars); both dtypes,
    folded and unfolded, each fused activation: bit for bit."""
    gen = torch.Generator().manual_seed(shape[1])
    x = 3 * torch.randn(shape, generator=gen)
    x.view(-1)[:6] = torch.tensor([float("nan"), 0.0, -0.0, float("inf"),
                                   -float("inf"), 1e-40])[:x.numel()]
    vecs = _k6_vectors(shape[1], gen, cuda)
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype).to(cuda)
        off = torch.empty(xd.numel() + 1, dtype=dtype,
                          device=cuda)[1:].view(shape)
        off.copy_(xd)
        assert off.data_ptr() % 16
        for xs in (xd, off):
            for folded in (False, True):
                for act in K6_ACTS:
                    _k6_same(xs, vecs, folded, act)


def test_k6_refuses_what_it_does_not_take(cuda):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 5, 5, generator=gen).to(cuda)
    vecs = _k6_vectors(4, gen, cuda)
    before = library.launches("bn_act")
    with pytest.raises(TypeError):
        k6.bn_act(x.double(), *vecs, False, Activation.LRELU)
    with pytest.raises(ValueError):
        k6.bn_act(x.transpose(2, 3), *vecs, False, Activation.LRELU)
    with pytest.raises(TypeError):
        k6.bn_act(x, *vecs, False, Activation.PRELU)
    with pytest.raises(ValueError):
        k6.bn_act(x, vecs[0][:3], *vecs[1:], False, Activation.LRELU)
    with pytest.raises(ValueError):
        k6.bn_act(x, vecs[0].double(), *vecs[1:], False, Activation.LRELU)
    with pytest.raises(ValueError):
        k6.bn_act(x, vecs[0].cpu(), *vecs[1:], False, Activation.LRELU)
    assert library.launches("bn_act") == before
    empty = k6.bn_act(x[:0], *vecs, False, Activation.LRELU)
    assert empty.shape == (0, 4, 5, 5)
    assert library.launches("bn_act") == before  # nothing to launch


def test_k6_runs_each_bn_conv_of_a_bf16_detect_and_none_of_an_int8_one(
        cuda, monkeypatch):
    """Full YOLOv3 (96 px, batch 2): a bf16 detect launches K6 72 times,
    with the detections of the plain ops on the card bit for bit; an
    int8 one (K4 on every conv) none."""
    from bcnn_tpu_torch.models import yolov3

    net = yolov3(2, 96, 96, 4)
    net.compute_dtype = net.act_dtype = torch.bfloat16
    p, s = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0, residual_scale=0.1))
    cpu = Session(net, 0, device="cpu")
    cpu.params, cpu.state = p, s
    cpu.compile_net()
    sess = Session(net, 0, device=cuda)
    sess.params = {k: v.to(cuda) for k, v in p.items()}
    sess.state = {k: v.to(cuda) for k, v in s.items()}
    sess.compile_net()
    x = np.random.RandomState(0).rand(2, 3, 96, 96).astype(np.float32)
    before = library.launches("bn_act")
    got = sess.detect_on_batch(x, 0.3, 30)
    torch.cuda.synchronize()
    assert library.launches("bn_act") == before + 72
    with monkeypatch.context() as m:
        m.setattr(k6, "takes", lambda *a: False)
        plain = sess.detect_on_batch(x, 0.3, 30)
    assert library.launches("bn_act") == before + 72
    for g, w in zip(got, plain):
        assert torch.equal(g, w)
    quant = ptq_synthetic(net, cpu)
    net.quant = dict(quant, weights={
        k: {kk: vv.to(cuda) for kk, vv in e.items()}
        for k, e in quant["weights"].items()})
    sess.state = {k: v.to(cuda) for k, v in cpu.state.items()}
    try:
        before, k4 = library.launches("bn_act"), library.launches("conv_int8")
        sess.detect_on_batch(x, 0.3, 30)
        torch.cuda.synchronize()
        assert library.launches("bn_act") == before
        assert library.launches("conv_int8") == k4 + 75
    finally:
        net.quant = None


def _yolov4_sessions(cuda, size=96):
    """YOLOv4 at `size`, batch 2, bf16, with seeded weights: (net, CPU
    session, card session)."""
    from bcnn_tpu_torch.models import yolov4

    net = yolov4(2, size, size, 80)
    net.compute_dtype = net.act_dtype = torch.bfloat16
    p, s = bridge.params_from_numpy(
        net, *bridge.he_numpy_weights(net, 0, residual_scale=0.1))
    cpu = Session(net, 0, device="cpu")
    cpu.params, cpu.state = p, s
    cpu.compile_net()
    sess = Session(net, 0, device=cuda)
    sess.params = {k: v.to(cuda) for k, v in p.items()}
    sess.state = {k: v.to(cuda) for k, v in s.items()}
    sess.compile_net()
    return net, cpu, sess


def test_yolov4_bf16_detect_runs_k6_on_each_bn_conv(cuda, monkeypatch):
    """YOLOv4 (96 px, batch 2): a bf16 detect launches K6 107 times, 72
    of them MISH and 35 LRELU, with the detections of the plain ops on
    the card bit for bit."""
    _, _, sess = _yolov4_sessions(cuda)
    x = np.random.RandomState(1).rand(2, 3, 96, 96).astype(np.float32)
    library.reset_launches()
    got = sess.detect_on_batch(x, 0.3, 30)
    torch.cuda.synchronize()
    assert library.launches("bn_act") == 107
    assert library.launches("bn_act", "MISH") == 72
    assert library.launches("bn_act", "LRELU") == 35
    with monkeypatch.context() as m:
        m.setattr(k6, "takes", lambda *a: False)
        plain = sess.detect_on_batch(x, 0.3, 30)
    assert library.launches("bn_act") == 107
    for g, w in zip(got, plain):
        assert torch.equal(g, w)


def test_yolov4_int8_on_the_card_raises_naming_mish(cuda):
    """K4 does not fuse Mish: int8 serving of YOLOv4 on the card raises
    before it detects (the CPU runs Mish after its int8 conv)."""
    net, cpu, sess = _yolov4_sessions(cuda)
    quant = ptq_synthetic(net, cpu)
    net.quant = dict(quant, weights={
        k: {kk: vv.to(cuda) for kk, vv in e.items()}
        for k, e in quant["weights"].items()})
    sess.state = {k: v.to(cuda) for k, v in cpu.state.items()}
    x = np.random.RandomState(2).rand(2, 3, 96, 96).astype(np.float32)
    try:
        with pytest.raises(ValueError, match="MISH"):
            sess.detect_on_batch(x, 0.3, 30)
    finally:
        net.quant = None


# -- K6's channels-last form and the executor's channels-last layout --- #

from bcnn_tpu_torch import compile as tcompile  # noqa: E402

CL = torch.channels_last
# C a multiple of 8 (16-byte vectors) and not (one value a thread: C 3,
# 5, 12 in bf16); planes of 1 (where NCHW and channels-last are one
# order), 169 and 5,776 values; a 32 KB bf16 table (64 KB in fp32: past
# the table's limit, one value a thread)
K6_CL_SHAPES = [(2, 16, 1, 1), (2, 16, 13, 13), (2, 3, 13, 13),
                (1, 1024, 13, 13), (2, 12, 13, 13), (1, 32, 76, 76),
                (1, 5, 76, 76), (1, 4096, 2, 2)]


def _k6_misaligned_cl(x):
    """A copy of channels-last x that starts one value past a 16-byte
    boundary, still channels-last-contiguous."""
    n, c, h, w = x.shape
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    off = buf[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    off.copy_(x)
    assert off.data_ptr() % 16 and off.is_contiguous(memory_format=CL)
    return off


@pytest.mark.parametrize("shape", K6_CL_SHAPES)
def test_k6_channels_last_form_matches_plain_ops(cuda, shape):
    """x channels-last, in bf16 and fp32, folded and unfolded, with NONE,
    RELU, LRELU and MISH, NaN, signed zeros, infinities and values past
    Mish's cut: K6 bit-equal to the plain ops, y channels-last, one
    launch each, counted under "channels_last" (at H = W = 1 the two
    orders are one and the NCHW form runs); on a 16-byte boundary and
    one value off it."""
    gen = torch.Generator().manual_seed(shape[1] * 7 + shape[2])
    x = 12 * torch.randn(shape, generator=gen)
    x.view(-1)[:8] = torch.tensor([float("nan"), 0.0, -0.0, float("inf"),
                                   -float("inf"), 1e-40, 25.0,
                                   -100.0])[:x.numel()]
    vecs = _k6_vectors(shape[1], gen, cuda)
    cl_form = shape[2] * shape[3] > 1
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype).to(cuda).contiguous(memory_format=CL)
        for xs in (xd, _k6_misaligned_cl(xd)):
            for folded in (False, True):
                for act in K6_ACTS:
                    before = library.launches("bn_act", "channels_last")
                    _k6_same_cl(xs, vecs, folded, act)
                    assert library.launches(
                        "bn_act", "channels_last") == before + cl_form


def _k6_same_cl(x, vecs, folded, act):
    """`_k6_same` for a channels-last x: y keeps x's strides (the plain
    ops' own may differ on unit dimensions, where they mean nothing, so
    those are compared where a dimension has more than one value)."""
    before = library.launches("bn_act")
    got = k6.bn_act(x, *vecs, folded, act)
    want = k6.bn_act_ref(x, *vecs, folded, act)
    torch.cuda.synchronize()
    assert library.launches("bn_act") == before + 1
    assert got.stride() == x.stride() and got.dtype == want.dtype
    assert [st for st, n in zip(got.stride(), got.shape) if n > 1] == [
        st for st, n in zip(want.stride(), want.shape) if n > 1]
    assert torch.equal(_k6_bits(got), _k6_bits(want)), (
        tuple(x.shape), x.dtype, folded, act)


def test_k6_channels_last_form_past_2_31_values(cuda):
    """(2, 8, 16384, 8193) bf16 channels-last, 2.15e9 values: the launcher
    cuts it into two runs of one image, each on a 16-byte boundary; MISH
    and LRELU, BN unfolded: bit for bit, one call counted."""
    shape = (2, 8, 16384, 8193)
    assert shape[0] * shape[1] * shape[2] * shape[3] > 2**31
    gen = torch.Generator(device=cuda).manual_seed(31)
    x = torch.empty(shape, dtype=torch.bfloat16, device=cuda,
                    memory_format=CL).normal_(0, 4, generator=gen)
    vecs = _k6_vectors(8, torch.Generator().manual_seed(31), cuda)
    for act in (Activation.MISH, Activation.LRELU):
        before = library.launches("bn_act", "channels_last")
        _k6_same_cl(x, vecs, False, act)
        assert library.launches("bn_act", "channels_last") == before + 1


def _layout_net(batch=2, size=32):
    """A small bf16 detector with every node that has a channels-last
    form: BN convs with MISH and LRELU (C 16, 32, 24, and 12, not a
    multiple of 8), a shortcut, Darknet's SPP pools (5 and 9, centred), a
    route of three, an upsample and a route across it, two heads."""
    from bcnn_tpu_torch import Net
    from bcnn_tpu_torch.types import FillerType, Padding

    mish, leaky, lin = Activation.MISH, Activation.LRELU, Activation.NONE
    xav = FillerType.XAVIER
    net = Net(Mode.PREDICT)
    net.set_input_shape(size, size, 3, batch)
    conv = net.add_convolutional_layer
    conv(16, 3, 1, 1, 1, 1, xav, mish, 0, "input", "c1")
    conv(32, 3, 2, 1, 1, 1, xav, leaky, 0, "c1", "c2")
    conv(32, 1, 1, 0, 1, 1, xav, mish, 0, "c2", "c3")
    net.add_eltwise_layer(lin, "c2", "c3", "s1")
    net.add_maxpool_layer(5, 1, Padding.SAME, "s1", "p5", darknet_padding=4)
    net.add_maxpool_layer(9, 1, Padding.SAME, "s1", "p9", darknet_padding=8)
    net.add_concat_layer(["p9", "p5", "s1"], "spp")
    conv(24, 1, 1, 0, 1, 1, xav, leaky, 0, "spp", "c4")
    conv(21, 1, 1, 0, 1, 0, xav, lin, 0, "c4", "h1")
    anchors = [10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319]
    net.add_yolo_layer(3, 2, 4, 6, [3, 4, 5], anchors, "h1", "y1")
    conv(16, 1, 1, 0, 1, 1, xav, leaky, 0, "c4", "c6")
    net.add_upsample_layer(2, "c6", "up")
    net.add_concat_layer(["up", "c1"], "r2")
    conv(12, 3, 1, 1, 1, 1, xav, leaky, 0, "r2", "c7")
    conv(21, 1, 1, 0, 1, 0, xav, lin, 0, "c7", "h2")
    net.add_yolo_layer(3, 2, 4, 6, [0, 1, 2], anchors, "h2", "y2")
    net.compute_dtype = net.act_dtype = torch.bfloat16
    return net


def test_bf16_predict_runs_channels_last_on_the_card(cuda, monkeypatch):
    """The small detector at bf16 on the card: the executor picks
    channels-last; every activation but the input, the heads' inputs
    and the YOLO outputs is channels-last; `layout_counts` shows one
    executor, every node, the input converted once and each head once;
    each BN conv's K6 launch is its channels-last form; the heads are
    NCHW and within 2^-5 of their largest value of the same net forced
    NCHW through `compile.channels_last_layout`."""
    net = _layout_net()
    assert tcompile.channels_last_layout(net, Mode.PREDICT, "cuda")
    p, s = bridge.params_from_numpy(net, *bridge.he_numpy_weights(net, 0))
    sess = Session(net, 0, device=cuda)
    sess.params = {k: v.to(cuda) for k, v in p.items()}
    sess.state = {k: v.to(cuda) for k, v in s.items()}
    sess.compile_net()
    x = np.random.RandomState(3).rand(2, 3, 32, 32).astype(np.float32)
    bn = sum(1 for n in net.nodes if n.param.get("batch_norm"))
    tcompile.reset_layout_counts()
    library.reset_launches()
    got, _ = sess.predict_on_batch(x, outputs=["h1", "h2"])
    torch.cuda.synchronize()
    assert tcompile.layout_counts() == {
        "executors": 1, "nodes": len(net.nodes), "to_channels_last": 1,
        "to_nchw": 2}
    assert library.launches("bn_act") == bn == 6
    assert library.launches("bn_act", "channels_last") == bn
    heads = {net.get_tensor_index_by_name(k) for k in ("h1", "h2")}
    yolo = {net.get_tensor_index_by_name(k) for k in ("y1", "y2")}
    with torch.inference_mode():
        ex = tcompile.execute(net, sess.params, sess.state,
                              {"input": torch.as_tensor(x).to(cuda)},
                              Mode.PREDICT)
    for i, v in ex.values.items():
        if i == 0 or i in heads or i in yolo:
            assert v.is_contiguous(), net.tensors[i].name
        else:
            assert v.is_contiguous(memory_format=CL) and not \
                v.is_contiguous(), net.tensors[i].name
    with monkeypatch.context() as m:
        m.setattr(tcompile, "channels_last_layout", lambda *a, **k: False)
        tcompile.reset_layout_counts()
        want, _ = sess.predict_on_batch(x, outputs=["h1", "h2"])
        assert tcompile.layout_counts()["executors"] == 0
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == w.dtype == torch.bfloat16
        ref = w.float()
        torch.testing.assert_close(
            g.float(), ref, rtol=0, atol=2.0**-5 * float(ref.abs().max()))


def test_fp32_keeps_nchw_on_the_card(cuda):
    """The same detector in fp32 runs NCHW on the card: no executor
    counted channels-last, no K6 launch of that form."""
    net = _layout_net()
    net.compute_dtype = net.act_dtype = None
    p, s = bridge.params_from_numpy(net, *bridge.he_numpy_weights(net, 0))
    sess = Session(net, 0, device=cuda)
    sess.params = {k: v.to(cuda) for k, v in p.items()}
    sess.state = {k: v.to(cuda) for k, v in s.items()}
    sess.compile_net()
    tcompile.reset_layout_counts()
    library.reset_launches()
    sess.predict_on_batch(
        np.random.RandomState(4).rand(2, 3, 32, 32).astype(np.float32),
        outputs=["h1", "h2"])
    torch.cuda.synchronize()
    assert library.launches("bn_act") == 6
    assert library.launches("bn_act", "channels_last") == 0
    assert tcompile.layout_counts()["executors"] == 0


# -- YOLOv7: K6's SWISH form, the channels-last executor, int8 ---------- #


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_swish_matches_silu_at_every_yolov7_bn_shape(cuda, dtype,
                                                       folded):
    """Each shape of YOLOv7 640's 89 BN conv outputs at batch 64, NCHW and
    channels-last, x spread so that BN gives |y| past silu's tails (exp
    of -y under- and overflowing in fp32), and NaN, +-inf, +-88, +-89,
    +-100 and -0 among the values: K6's SWISH form bit-equal to
    F.silu on the plain BN, each launch counted under SWISH (and under
    "channels_last" in that layout)."""
    import torch.nn.functional as F

    from bcnn_tpu_torch.models import yolov7

    net = yolov7(64, 640, 640, 80)
    shapes = {tuple(net.tensors[n.dst[0]].shape) for n in net.nodes
              if n.type.name == "CONV2D" and n.param.get("batch_norm")}
    assert len(shapes) == 16
    gen = torch.Generator(device=cuda).manual_seed(28)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"),
                            88.0, -88.0, 89.0, -89.0, 100.0, -100.0, -0.0],
                           device=cuda)
    for shape in sorted(shapes):
        x = torch.empty(shape, device=cuda).normal_(0, 40, generator=gen)
        x.view(-1)[:10] = special
        xd = x.to(dtype)
        del x
        vecs = _k6_vectors(shape[1], torch.Generator().manual_seed(
            shape[1]), cuda)
        for xs in (xd, xd.contiguous(memory_format=CL)):
            cl = int(not xs.is_contiguous())
            kinds = ("SWISH", "channels_last")
            before = [library.launches("bn_act", k) for k in kinds]
            got = k6.bn_act(xs, *vecs, folded, Activation.SWISH)
            want = F.silu(ops.batch_norm(xs, *vecs, folded=folded))
            torch.cuda.synchronize()
            assert [library.launches("bn_act", k) for k in kinds] == [
                before[0] + 1, before[1] + cl]
            assert got.stride() == xs.stride()
            assert torch.equal(_k6_bits(got), _k6_bits(want)), (
                shape, dtype, folded, cl)
            del got, want, xs
        del xd


def _yolov7_sessions(cuda, size=96):
    """YOLOv7 at `size`, batch 2, bf16, with seeded weights: (net, CPU
    session, card session)."""
    from bcnn_tpu_torch.models import yolov7

    net = yolov7(2, size, size, 80)
    net.compute_dtype = net.act_dtype = torch.bfloat16
    p, s = bridge.params_from_numpy(net, *bridge.he_numpy_weights(net, 0))
    cpu = Session(net, 0, device="cpu")
    cpu.params, cpu.state = p, s
    cpu.compile_net()
    sess = Session(net, 0, device=cuda)
    sess.params = {k: v.to(cuda) for k, v in p.items()}
    sess.state = {k: v.to(cuda) for k, v in s.items()}
    sess.compile_net()
    return net, cpu, sess


def test_yolov7_bf16_detect_runs_k6_swish_channels_last(cuda, monkeypatch):
    """YOLOv7 (96 px, batch 2): a bf16 detect runs one executor
    channels-last (`compile.layout_counts`: the input converted once,
    each head back once) and launches K6 89 times, every one SWISH and
    channels-last, with the detections of the plain ops on the card bit
    for bit."""
    _, _, sess = _yolov7_sessions(cuda)
    x = np.random.RandomState(7).rand(2, 3, 96, 96).astype(np.float32)
    library.reset_launches()
    tcompile.reset_layout_counts()
    got = sess.detect_on_batch(x, 0.3, 30)
    torch.cuda.synchronize()
    counts = tcompile.layout_counts()
    assert (counts["executors"], counts["to_channels_last"],
            counts["to_nchw"]) == (1, 1, 3)
    assert library.launches("bn_act") == 89
    assert library.launches("bn_act", "SWISH") == 89
    assert library.launches("bn_act", "channels_last") == 89
    with monkeypatch.context() as m:
        m.setattr(k6, "takes", lambda *a: False)
        plain = sess.detect_on_batch(x, 0.3, 30)
    assert library.launches("bn_act") == 89
    for g, w in zip(got, plain):
        assert torch.equal(g, w)


def test_yolov7_int8_on_the_card_raises_naming_swish(cuda):
    """K4 does not fuse Swish: int8 serving of YOLOv7 on the card raises
    before it detects."""
    net, cpu, sess = _yolov7_sessions(cuda)
    quant = ptq_synthetic(net, cpu)
    net.quant = dict(quant, weights={
        k: {kk: vv.to(cuda) for kk, vv in e.items()}
        for k, e in quant["weights"].items()})
    sess.state = {k: v.to(cuda) for k, v in cpu.state.items()}
    x = np.random.RandomState(2).rand(2, 3, 96, 96).astype(np.float32)
    try:
        with pytest.raises(ValueError, match="SWISH"):
            sess.detect_on_batch(x, 0.3, 30)
    finally:
        net.quant = None



# -- the staged upload (upload.py): a host batch through the pinned ring --


def _frames(shape, dtype, seed):
    rs = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rs.randint(0, 256, shape).astype(np.uint8)
    return (rs.randn(*shape) * 100).astype(dtype)


def _upload_session(cuda):
    """A session whose `_input` is tested (the net plays no part)."""
    return Session(yolov3_tiny(2, 64, 64, 4), 0, device=cuda)


def _chunks(x):
    return -(-4 * x.size // upload.CHUNK_BYTES)


@pytest.mark.parametrize("size", [416, 608])  # YOLOv3's, YOLOv4's
@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.float64])
def test_staged_upload_is_as_tensor_bit_for_bit(cuda, size, dtype):
    sess = _upload_session(cuda)
    x = _frames((32, 3, size, size), dtype, size)
    upload.reset_counts()
    got = sess._input(x)
    assert upload.counts() == {"staged": 1, "direct": 0,
                               "chunks": _chunks(x), "pin_failed": 0}
    assert _chunks(x) >= 3
    want = torch.as_tensor(x, dtype=torch.float32, device=cuda)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_staged_upload_survives_the_caller_overwriting_its_batch(cuda):
    """Every read of the batch is done when `_input` returns, though its
    copies to the card wait behind a slow kernel."""
    sess = _upload_session(cuda)
    x = _frames((32, 3, 416, 416), np.float32, 1)
    keep = torch.from_numpy(x.copy())
    torch.cuda._sleep(200_000_000)
    got = sess._input(x)
    x[...] = -1.0
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), keep)


def test_staged_upload_of_the_same_array_mutated_sends_the_new_values(cuda):
    sess = _upload_session(cuda)
    x = _frames((32, 3, 416, 416), np.float32, 2)
    old = torch.from_numpy(x.copy())
    first = sess._input(x)
    x *= 2.0
    second = sess._input(x)
    torch.cuda.synchronize()
    assert torch.equal(first.cpu(), old)
    assert torch.equal(second.cpu(), torch.from_numpy(x))


def test_staged_uploads_back_to_back_behind_a_slow_stream(cuda):
    """Two staged uploads queued behind a long kernel reuse the ring's
    slots only after the copies that read them ran."""
    sess = _upload_session(cuda)
    a = _frames((32, 3, 608, 608), np.float32, 3)
    b = _frames((32, 3, 608, 608), np.uint8, 4)
    upload.reset_counts()
    torch.cuda._sleep(200_000_000)
    ga, gb = sess._input(a), sess._input(b)
    torch.cuda.synchronize()
    assert torch.equal(ga.cpu(), torch.from_numpy(a))
    assert torch.equal(gb.cpu(), torch.from_numpy(b).float())
    assert upload.counts()["staged"] == 2


def test_detect_on_a_staged_host_batch_equals_detect_on_the_card(cuda):
    sess = Session(yolov3_tiny(32, 416, 416, 4), 0,
                   device=cuda).compile_net()
    x = np.random.RandomState(5).rand(32, 3, 416, 416).astype(np.float32)
    upload.reset_counts()
    got = sess.detect_on_batch(x, 0.3, 30)  # the ring is made here
    assert upload.counts() == {"staged": 1, "direct": 0,
                               "chunks": _chunks(x), "pin_failed": 0}
    want = sess.detect_on_batch(torch.from_numpy(x).to(cuda), 0.3, 30)
    assert upload.counts()["direct"] == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the ring made under inference_mode serves an upload outside it
    (heads,), _ = sess.predict_on_batch(x)
    (on_card,), _ = sess.predict_on_batch(torch.from_numpy(x).to(cuda))
    assert upload.counts()["staged"] == 2
    assert torch.equal(heads, on_card)
