"""The port's CUDA kernels on the card. Each test skips where there is no
CUDA device, as on a CPU-only machine. This file imports no JAX, so on a
machine with a GPU and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from bcnn_tpu_torch import Session
from bcnn_tpu_torch.models import yolov3_tiny
from bcnn_tpu_torch.ops.yolo_decode import decode_fused, decode_grid_ref

ANCHORS = [10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "n,classes,h,w,mask",
    [(8, 80, 13, 13, [3, 4, 5]), (2, 80, 26, 26, [0, 1, 2]),
     (3, 7, 7, 11, [1, 3, 5]), (1, 1, 1, 1, [0, 1, 2])],
)
def test_k1_matches_plain_version(cuda, n, classes, h, w, mask):
    p = dict(num=3, classes=classes, mask=mask, anchors=ANCHORS)
    gen = torch.Generator().manual_seed(h * w)
    x = 4 * torch.randn(n, 3 * (5 + classes), h, w, generator=gen)
    x[0, 4, 0, 0] = float("inf")
    x[0, 2, 0, 0] = 200.0  # exp overflow -> inf, as in the plain version
    x = x.to(cuda)
    before = decode_fused.launches
    got = decode_fused(x, p, 416, 416)
    torch.cuda.synchronize()
    assert decode_fused.launches == before + 1
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


def test_detect_on_batch_launches_k1_per_head(cuda):
    sess = Session(yolov3_tiny(2, 96, 96, 4), 0, device=cuda).compile_net()
    x = np.random.RandomState(0).rand(2, 3, 96, 96).astype(np.float32)
    before = decode_fused.launches
    full = sess.detect_on_batch(x, 0.3, 20, topk_first=False)
    assert decode_fused.launches == before + 2
    plain = sess.detect_on_batch(x, 0.3, 20, topk_first=False,
                                 use_pallas=False)
    assert decode_fused.launches == before + 2
    for a, b in zip(full, plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
