"""Ops of the detection slice on NCHW torch tensors.

Plain PyTorch wherever the JAX package leaves the op to XLA (conv, BN,
pooling, concat, upsample, the detection tail); a hand-written CUDA
kernel where it wrote a Pallas kernel (`yolo_decode.decode_fused`, K1).
"""

from .activations import apply_activation
from .conv import conv2d
from .misc import concat_channels, upsample_nn
from .norm import batch_norm
from .pool import maxpool
