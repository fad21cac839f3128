"""Data feeds of the port: the host loaders and augmentation
(`loaders`, `augment`, `native_loader`), raw records (`records`), the
prefetch pipelines (`pipeline`) and on-device augmentation
(`device_augment`)."""

from .augment import Augmenter, convert_img_to_float
from .loaders import (
    Cifar10Loader,
    ClassificationListLoader,
    DataLoader,
    DetectionListLoader,
    MnistLoader,
    RegressionListLoader,
    make_loader,
)
from .pipeline import BatchPipeline, ShardedBatchPipeline
from .records import (
    EpochIndexStream,
    RawRecordLoader,
    ShardedEpochIndexStream,
    records_from_loader,
    write_records,
)
