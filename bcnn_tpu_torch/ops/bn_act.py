"""A conv's batch norm and activation outside TRAIN in one pass: the CUDA
kernel K6 (`csrc/bn_act.cu`) and its plain PyTorch version.

`bn_act_ref` is the plain version: `ops.norm.batch_norm` (folded or
not, in x's dtype) and then `ops.activations.apply_activation`, the ops
the executor's conv epilogue ran on every device before K6. K6 computes
the same values bit for bit (the kernel's note says how) in one read and
one write of x, where those ops take about 15 launches a conv; it derives
the per-channel constants inside the launch from the fp32 vectors, so
nothing is cached from one call to the next.

`bn_act` calls the op `bcnn_tpu_torch::bn_act` (`ops.library`): its CPU
implementation is the plain version; its CUDA implementation,
`bn_act_cuda`, launches the kernel or raises; nothing falls back. The
kernel has no backward. `library.launches("bn_act")` counts its
launches, and `library.launches("bn_act", act.name)` those of one
activation.

`computes` is the one test of the function K6 computes (x's dtype and
the activation); the launcher raises where it fails. `takes` is the
executor's test of whether a conv's output goes to the op
(`compile._Executor._apply_conv_epilogue`, outside TRAIN): `computes`,
no autograd recording x, and x on the card. A CPU tensor goes to the op
only inside a `torch.export` trace, so that an exported program holds it
and launches K6 where it runs on the card; eager CPU runs keep the plain
ops. The executor hands the op x in one of the two layouts K6 takes
(contiguous NCHW, or channels-last where the executor holds its
activations so) and the vectors fp32, so that no layout or storage dtype
of its own sends a conv to the plain ops.

K6 has two forms, picked by the launcher from x's strides
(`channels_last_form`): NCHW, and channels-last (NHWC in memory), each
with the same arithmetic; y takes x's strides.
`library.launches("bn_act", "channels_last")` counts the channels-last
form's launches.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..types import Activation
from . import library
from .activations import LRELU_SLOPE, apply_activation, weak
from .norm import EPS, batch_norm

FUSED_ACT = (Activation.NONE, Activation.RELU, Activation.LRELU,
             Activation.MISH, Activation.SWISH)
DTYPES = (torch.bfloat16, torch.float32)


def computes(x: torch.Tensor, act: Activation) -> bool:
    """Whether K6 computes BN and then `act` on x: x bf16 or fp32, the
    activation NONE, RELU, LRELU, MISH or SWISH."""
    return x.dtype in DTYPES and act in FUSED_ACT


def takes(x: torch.Tensor, act: Activation) -> bool:
    """Whether the executor runs this epilogue as K6: a function it
    computes, recorded by no autograd (K6 has no backward), x on the
    card (or traced by `torch.export`)."""
    return (computes(x, act)
            and not (torch.is_grad_enabled() and x.requires_grad)
            and (x.is_cuda or torch.compiler.is_compiling()))


def channels_last_form(x: torch.Tensor) -> bool:
    """The launcher's pick of K6's form from x's strides: False for a
    contiguous NCHW x (also one that is channels-last too: at H = W = 1
    or C = 1 the two orders are one), True for a channels-last one; a
    ValueError for any other strides (a slice, a permutation)."""
    if x.dim() == 4:
        if x.is_contiguous():
            return False
        if x.is_contiguous(memory_format=torch.channels_last):
            return True
    raise ValueError("bn_act: x must be a contiguous NCHW or "
                     "channels-last tensor")


def bn_act_ref(
    x: torch.Tensor, scales: torch.Tensor, biases: torch.Tensor,
    run_mean: torch.Tensor, run_var: torch.Tensor, folded: bool,
    act: Activation,
) -> torch.Tensor:
    """The plain version: batch_norm (x (N, C, H, W) in any layout, the
    vectors (C,)), then the activation."""
    return apply_activation(
        batch_norm(x, scales, biases, run_mean, run_var, folded=folded),
        Activation(act))


def bn_act(
    x: torch.Tensor, scales: torch.Tensor, biases: torch.Tensor,
    run_mean: torch.Tensor, run_var: torch.Tensor, folded: bool,
    act: Activation,
) -> torch.Tensor:
    """K6: `bn_act_ref` as one CUDA kernel for a CUDA x (bf16 or fp32,
    contiguous NCHW or channels-last; the vectors fp32 (C,); act NONE,
    RELU, LRELU, MISH or SWISH), y in x's layout, through the op
    `bcnn_tpu_torch::bn_act` on either device. run_mean and run_var are
    unread when folded."""
    library.check_devices("bn_act", x, scales, biases, run_mean, run_var)
    return _K6(x, scales, biases, run_mean, run_var, bool(folded),
               int(act))


def _bn_act_cpu(x, scales, biases, run_mean, run_var, folded, act):
    y = _bn_act_fake(x, scales, biases, run_mean, run_var, folded, act)
    return y.copy_(bn_act_ref(x, scales, biases, run_mean, run_var, folded,
                              act))


def bn_act_cuda(x, scales, biases, run_mean, run_var, folded, act):
    """The op's CUDA implementation, K6's launcher: checks what the
    kernel takes (raises otherwise), allocates the output, launches and
    checks the launch."""
    vecs = (scales, biases, run_mean, run_var)
    if x.device.type != "cuda" or any(v.device != x.device for v in vecs):
        raise ValueError("bn_act: unsupported devices " + ", ".join(
            str(t.device) for t in (x, *vecs)))
    act = Activation(act)
    if not computes(x, act):
        raise TypeError(f"bn_act: computes BN and NONE, RELU, LRELU, "
                        f"MISH or SWISH on bfloat16 or float32, not "
                        f"{act.name} on {x.dtype}")
    nhwc = channels_last_form(x)
    n, c, h, w = x.shape
    if any(v.dtype != torch.float32 or v.shape != (c,)
           or not v.is_contiguous() for v in vecs):
        raise ValueError(f"bn_act: the vectors must be float32 ({c},)")
    if c * h * w >= 2**31:
        raise ValueError("bn_act: an image of 2^31 values or more")
    y = torch.empty_like(x)  # x's strides: one of K6's two layouts
    if y.numel() == 0:
        return y
    # as the plain version meets x with them: in x's dtype (ctypes
    # rounds an fp32 x's to fp32)
    eps, slope = (float(weak(v, x)) for v in (EPS, LRELU_SLOPE))
    lib = kernels.library()
    with torch.cuda.device(x.device):
        rc = lib.bcnn_bn_act(
            x.data_ptr(), y.data_ptr(), run_mean.data_ptr(),
            run_var.data_ptr(), scales.data_ptr(), biases.data_ptr(), n, c,
            h * w, int(x.dtype == torch.bfloat16), int(folded), int(act),
            int(nhwc), eps, slope,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    kernels.check(rc, "bn_act")
    library.count_kind("bn_act", act.name)
    if nhwc:
        library.count_kind("bn_act", "channels_last")
    return y


def _bn_act_fake(x, scales, biases, run_mean, run_var, folded, act):
    """The output, empty: x's shape, dtype and strides where x is in one
    of K6's layouts (NCHW or channels-last; the strides of its unit
    dimensions too), else contiguous NCHW."""
    if x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last):
        return torch.empty_like(x)
    return x.new_empty(x.shape)


_K6 = library.register(
    "bn_act",
    "(Tensor x, Tensor scales, Tensor biases, Tensor run_mean, "
    "Tensor run_var, bool folded, int act) -> Tensor",
    cpu=_bn_act_cpu,
    cuda=bn_act_cuda,
    fake=_bn_act_fake,
)
