"""Parallelism on torch.distributed, the port of `bcnn_tpu.parallel`:
the batch axis (`mesh`: the DP step and scans, the resident feeds, the
DP forward, ZeRO-1, FSDP), `multihost`, the model axis
(`model_axis`: the 2-D batch x model mesh, tensor- and
spatial-parallel training, the spatial forward), and the pipeline
stages (`pipeline`: `split_stages`, `stage_io`, `Pipeline` with GPipe
and 1F1B over microbatches, data-parallel stages and cross-stage routing
taps). Every module of `bcnn_tpu.parallel` has its counterpart."""

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
from .model_axis import (
    MODEL_AXIS,
    Mesh2D,
    gather_train_state,
    make_dp_sp_train_step,
    make_dp_tp_train_step,
    make_mesh_2d,
    make_spatial_forward,
    plan_bands,
    shard_spatial,
    shard_train_state,
    spatial_band,
    tp_param_specs,
)
from .pipeline import Pipeline, split_stages, stage_io
