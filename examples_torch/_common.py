"""Shared helpers of the port's example drivers: the --device option,
the synchronisation a timer needs, the default data directories, and
handing in weights made elsewhere."""

from __future__ import annotations

import os
import tempfile

import torch


def add_device(ap):
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where CUDA is missing) or "
                    "cpu")


def device(name: str) -> torch.device:
    """The device asked for; `cuda` without CUDA raises, as `Session`
    does."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    return dev


def sync(dev: torch.device):
    """Wait for the device's queued work (a timer's end)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def data_dir(name: str) -> str:
    """A directory for an example's synthetic data, under the
    temporary directory (TMPDIR)."""
    path = os.path.join(tempfile.gettempdir(), name)
    os.makedirs(path, exist_ok=True)
    return path


def seed_weights(sess, weights):
    """Stage `weights`, (params, state) numpy dicts in bcnn_tpu's layout
    (conv weights HWIO, keyed by TensorSpec.key), as the session's
    before compile_net; None keeps the session's own seeded init."""
    if weights is None:
        return sess
    from bcnn_tpu_torch import bridge

    sess.params, sess.state = bridge.params_from_numpy(
        sess.net, weights[0], weights[1], sess.device)
    return sess
