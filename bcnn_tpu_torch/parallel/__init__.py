"""Data parallelism on torch.distributed: the batch-axis half of
`bcnn_tpu.parallel` (`mesh`, `multihost`). The model axis (the 2-D
mesh, tensor and spatial parallelism, pipeline stages) is not ported
yet (ROADMAP Queue 1)."""

from . import multihost
from .mesh import (
    BATCH_AXIS,
    Mesh,
    gather_zero_state,
    make_dp_forward,
    make_dp_train_scan,
    make_dp_train_scan_resident,
    make_dp_train_scan_resident_sharded,
    make_dp_train_step,
    make_fsdp_train_step,
    make_mesh,
    make_zero1_train_step,
    replicate,
    shard_batch,
    shard_resident_dataset,
    shard_zero_state,
    zero_param_specs,
)
