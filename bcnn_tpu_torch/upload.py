"""A host batch to the device, the upload of `Session._input`.

`torch.as_tensor(x, dtype=torch.float32, device="cuda")` on a pageable
host array goes through CUDA's own pageable staging buffer, which one host
thread fills with memcpy: the copy runs at that one thread's rate, well
under the host link's. A large host batch is instead staged through a
ring of pinned host buffers that its session owns (`Uploader`):

  - the batch is cut into contiguous flat chunks, in order (`chunks`);
  - each chunk is copied on the host into the next slot of the ring,
    `slot[:n].copy_(src[a:b])`: torch's intra-op threads run the copy,
    and it converts the caller's dtype to fp32 in the same pass, as
    `as_tensor` does (the span `bcnn.upload.stage`, inside the caller's
    `bcnn.upload`);
  - the slot goes to its place in one fp32 tensor on the device with
    `copy_(..., non_blocking=True)` on the current stream, so that the
    card's copy of a chunk runs while the host fills the next slot, and
    the kernels the caller queues next run after every copy;
  - each slot's event is recorded after its copy is queued and waited
    on before the host writes the slot again.

The call returns once the last copy is queued: by then every read of
the caller's array is done, so the caller may overwrite or free it at
once. The device tensor is bit for bit `as_tensor`'s.

The staged path runs where the input shows it pays (`host_flat`): a
CUDA device, a C-contiguous host numpy array or CPU tensor, at least
two chunks of fp32. Everything else (device tensors,
small or non-contiguous inputs, CPU sessions) takes `as_tensor`, as
does every upload of a session whose pinned allocation failed.

The ring (`SLOTS` slots of `CHUNK_BYTES`) is allocated at a session's
first staged upload and freed with the session. `counts()` reads the
uploads each path took, the chunks staged and the failed pinned
allocations since the last `reset_counts()`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .profiling import span

# chosen from tools/upload_compare.py and the serving loop on an H100's
# host (PERF.md, "Upload")
SLOTS = 2
CHUNK_BYTES = 16 << 20

_COUNTS: Dict[str, int] = {"staged": 0, "direct": 0, "chunks": 0,
                           "pin_failed": 0}


def counts() -> Dict[str, int]:
    """Uploads that were staged or direct, chunks staged and pinned
    allocations that failed, since the last `reset_counts`."""
    return dict(_COUNTS)


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def chunks(numel: int, chunk: int) -> List[Tuple[int, int]]:
    """The flat ranges [a, b) of `numel` values, `chunk` at most each,
    in order."""
    return [(a, min(a + chunk, numel)) for a in range(0, numel, chunk)]


def host_flat(x) -> Optional[torch.Tensor]:
    """x as a flat CPU tensor on x's own memory where the staged path
    takes it (a C-contiguous numpy array or CPU tensor with no autograd,
    of at least two chunks of fp32), else None."""
    if isinstance(x, np.ndarray):
        try:
            t = torch.from_numpy(x)
        except (TypeError, ValueError):  # a dtype, byte order or negative
            return None                  # stride that torch lacks
    elif isinstance(x, torch.Tensor):
        if x.device.type != "cpu" or x.requires_grad:
            return None
        t = x
    else:
        return None
    if not t.is_contiguous() or 4 * t.numel() < 2 * CHUNK_BYTES:
        return None
    return t.view(-1)


class Ring:
    """`SLOTS` pinned fp32 host buffers of `CHUNK_BYTES`, each with the
    event of the last copy that read it."""

    def __init__(self):
        self.chunk = CHUNK_BYTES // 4
        # ordinary tensors even under inference_mode, so that later
        # uploads outside it may write them
        with torch.inference_mode(False):
            self.slots = [torch.empty(self.chunk, dtype=torch.float32,
                                      pin_memory=True)
                          for _ in range(SLOTS)]
        self.events = [torch.cuda.Event() for _ in range(SLOTS)]


def stage(src: torch.Tensor, dst: torch.Tensor, ring, stream) -> None:
    """Copy the flat host tensor `src` into the flat device tensor `dst`
    through the ring, the copies to the device on `stream`."""
    n = len(ring.slots)
    for i, (a, b) in enumerate(chunks(src.numel(), ring.chunk)):
        slot, done = ring.slots[i % n][:b - a], ring.events[i % n]
        done.synchronize()
        with span("bcnn.upload.stage"):
            slot.copy_(src[a:b])
        dst[a:b].copy_(slot, non_blocking=True)
        done.record(stream)
        _COUNTS["chunks"] += 1


class Uploader:
    """One session's uploads to `device`, and its ring."""

    def __init__(self, device: torch.device):
        self.device = device
        self._ring = None  # a Ring; False once its allocation failed

    def __call__(self, x) -> torch.Tensor:
        src = host_flat(x) if self.device.type == "cuda" else None
        if src is not None and self._ring is None:
            try:
                self._ring = Ring()
            except RuntimeError:  # pinned memory refused
                self._ring = False
                _COUNTS["pin_failed"] += 1
        if src is None or self._ring is False:
            _COUNTS["direct"] += 1
            return torch.as_tensor(x, dtype=torch.float32,
                                   device=self.device)
        out = torch.empty(tuple(x.shape), dtype=torch.float32,
                          device=self.device)
        stage(src, out.view(-1), self._ring,
              torch.cuda.current_stream(self.device))
        _COUNTS["staged"] += 1
        return out
