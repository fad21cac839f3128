"""Core enums, with the same names and values as `bcnn_tpu.types`.

They mirror the public enums of the bcnn C header (bcnn.h:90-236), so
config files, serialized models and user code keep one meaning in both
packages. `tests/test_torch_graph.py` holds every member to its
`bcnn_tpu` counterpart; `Activation.MISH` and `Activation.SWISH` alone
have none.
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    """bcnn_status (bcnn.h:90-99)."""

    SUCCESS = 0
    INVALID_PARAMETER = 1
    INVALID_DATA = 2
    INVALID_MODEL = 3
    FAILED_ALLOC = 4
    INTERNAL_ERROR = 5
    CUDA_FAILED_ALLOC = 6
    UNKNOWN_ERROR = 7


class Mode(enum.IntEnum):
    """bcnn_mode (bcnn.h:105-112)."""

    PREDICT = 0
    TRAIN = 1
    VALID = 2


class LoaderType(enum.IntEnum):
    """bcnn_loader_type (bcnn.h:117-124)."""

    MNIST = 0
    CIFAR10 = 1
    CLASSIFICATION_LIST = 2
    REGRESSION_LIST = 3
    DETECTION_LIST = 4


class LrDecay(enum.IntEnum):
    """bcnn_lr_decay (bcnn.h:129-136)."""

    CONSTANT = 0
    STEP = 1
    INV = 2
    EXP = 3
    POLY = 4
    SIGMOID = 5


class LayerType(enum.IntEnum):
    """bcnn_layer_type (bcnn.h:141-159)."""

    CONV2D = 0
    TRANSPOSE_CONV2D = 1
    DEPTHWISE_CONV2D = 2
    ACTIVATION = 3
    FULL_CONNECTED = 4
    MAXPOOL = 5
    AVGPOOL = 6
    SOFTMAX = 7
    DROPOUT = 8
    BATCHNORM = 9
    LRN = 10
    CONCAT = 11
    ELTWISE = 12
    UPSAMPLE = 13
    YOLOV3 = 14
    RESHAPE = 15
    COST = 16


class Activation(enum.IntEnum):
    """bcnn_activation (bcnn.h:164-175). LRELU has slope 0.1, the value
    the C implementation uses, not the header's documented 0.01. MISH
    and SWISH are the port's own (bcnn has neither): Darknet's x *
    tanh(softplus(x)), which YOLOv4's backbone uses, and Darknet's
    x * logistic(x) (PyTorch's SiLU), which YOLOv7's convs use."""

    NONE = 0
    TANH = 1
    RELU = 2
    RAMP = 3
    SOFTPLUS = 4
    LRELU = 5
    ABS = 6
    CLAMP = 7
    PRELU = 8
    LOGISTIC = 9
    MISH = 10
    SWISH = 11


class Loss(enum.IntEnum):
    """bcnn_loss (bcnn.h:180)."""

    EUCLIDEAN = 0
    LIFTED_STRUCT = 1


class Metric(enum.IntEnum):
    """bcnn_loss_metric (bcnn.h:185-192)."""

    ERROR_RATE = 0
    LOGLOSS = 1
    SSE = 2
    MSE = 3
    CRPS = 4
    DICE = 5


class Padding(enum.IntEnum):
    """bcnn_padding (bcnn.h:200-204). Output sizes: SAME
    (h + stride - 1) / stride, VALID (h - size + stride) / stride, CAFFE
    ceil((h - size) / stride) + 1."""

    SAME = 0
    VALID = 1
    CAFFE = 2


class Optimizer(enum.IntEnum):
    """bcnn_optimizer (bcnn.h:209)."""

    SGD = 0
    ADAM = 1


class LogLevel(enum.IntEnum):
    """bcnn_log_level (bcnn.h:214-219)."""

    INFO = 0
    WARNING = 1
    ERROR = 2
    SILENT = 3


class FillerType(enum.IntEnum):
    """bcnn_filler_type (bcnn.h:228-232)."""

    FIXED = 0
    XAVIER = 1
    MSRA = 2


# Max number of bounding boxes for detection (bcnn.h:235)
DETECTION_MAX_BOXES = 50
