"""Multi-process bring-up on torch.distributed, the port of
`bcnn_tpu.parallel.multihost`.

JAX initializes `jax.distributed` and builds one mesh over every host's
devices; the port runs one process a card (or, with gloo, a process on
the CPU), joined in one process group, and the same DP programs run
unchanged on the mesh over it:

    from bcnn_tpu_torch.parallel import make_dp_train_step, multihost
    multihost.initialize()                  # torchrun's environment
    mesh = multihost.global_mesh()          # every rank, cuda:<local rank>
    step = make_dp_train_step(net, mesh)    # as on one process

Launched by `torchrun --nproc_per_node=N script.py` (NCCL, one card a
rank), `initialize` reads the rendezvous from the environment
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); pass the address, the
process count and this process's index to join another way.

Per-process data loading: `shard_loader(loader)` stripes the sequential
stream over the processes (DataLoader.set_shard), so each reads only its
rows of every global batch; `host_local_batch` places them on the rank's
device, where they are the stripe that the DP step takes.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import BATCH_AXIS, Mesh, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
    timeout: Optional[datetime.timedelta] = None,
) -> None:
    """`torch.distributed.init_process_group`, from the environment as
    torchrun sets it where the arguments are None; else at
    coordinator_address ("host:port", or a "tcp://" or "file://" URL)
    with num_processes ranks, this one process_id. NCCL (one card a
    rank) unless backend="gloo" is asked for; timeout: of each
    collective (None: torch's default)."""
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("initialize: NCCL needs CUDA, which is not "
                           "available; pass backend='gloo' for ranks on "
                           "the CPU")
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError("initialize: give the coordinator_address with "
                             "num_processes and process_id")
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator_address needs "
                         "num_processes and process_id")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


def global_mesh(axis: str = BATCH_AXIS, device=None) -> Mesh:
    """The 1-D mesh over every rank of the default process group; device
    as `make_mesh` (None: cuda:<local rank>)."""
    return make_mesh(None, axis, device)


def host_local_batch(mesh: Mesh, x, y):
    """This process's rows of the global batch, on its device: under the
    port's one process a rank they are the rank's stripe, which the DP
    step takes as it is."""
    def put(a):
        t = a if torch.is_tensor(a) else torch.as_tensor(a)
        return t.to(mesh.device)

    return {"input": put(x), "label": put(y)}


def process_batch_slice(total_batch: int):
    """(start, size) of this process's share of the global batch."""
    n, i = dist.get_world_size(), dist.get_rank()
    if total_batch % n:
        raise ValueError(f"batch {total_batch} does not divide by {n} "
                         "processes")
    per = total_batch // n
    return i * per, per


def shard_loader(loader):
    """Stripe a streaming loader over the processes: each reads its rows
    of every global batch and skips the others' (DataLoader.set_shard),
    so the processes together consume the stream in one process's order.
    The loader's net.batch_size must be the per-process batch. Returns
    the loader."""
    loader.set_shard(dist.get_rank(), dist.get_world_size())
    return loader
