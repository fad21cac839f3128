"""Ops of the ported slices on NCHW torch tensors.

Plain PyTorch wherever the JAX package leaves the op to XLA (conv,
deconv, BN, pooling, FC, softmax, concat, the eltwise add, upsample,
dropout, LRN, the activations, the losses, the detection tail and
training deltas); a hand-written CUDA kernel where it wrote a Pallas kernel
(`yolo_decode.decode_fused`, K1; `row_shift.row_shift` and
`row_shift.col_shift`, K2;
`depthwise.depthwise_fused`, K3), and for the int8 convs that PyTorch
lacks on CUDA (`conv_int8.conv_int8_fused`, K4, which also runs the int8
FC and deconv; `grouped_int8.grouped_int8_fused`, K5, the grouped and
depthwise ones), and for a float conv's batch norm and activation outside
TRAIN (`bn_act.bn_act`, K6, one pass where the plain ops take about 15
launches). `quant` holds the int8 post-training quantization and
the quantization-aware training's fake quant.

Importing this package registers the six kernels as `torch.library`
ops (`library`: `bcnn_tpu_torch::yolo_decode`, `row_shift`,
`depthwise`, `conv_int8`, `grouped_int8`, `bn_act`), so that a program
exported with them (`deploy.py`) loads; nothing is built then.
"""

from . import (bn_act, conv_int8, depthwise, grouped_int8, library,
               row_shift, yolo_decode)
from .activations import apply_activation
from .conv import conv2d, conv2d_transpose, depthwise_conv2d
from .depthwise import depthwise_fused
from .linear import full_connected
from .misc import (concat_channels, dropout, dropout_mask, eltwise_add, lrn,
                   upsample_nn)
from .norm import batch_norm, batch_norm_train
from .pool import global_avgpool, maxpool
from .softmax import softmax_passthrough_grad
