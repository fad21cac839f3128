"""Logging: callback + level filtering, mirroring the reference
(bcnn_set_log_context bcnn_net.c:159-163, bcnn_log_context
src/bcnn_utils.h:57-60, default stderr writer src/bcnn_utils.c:30-47).
The port's copy of `bcnn_tpu.log`: the same lines for the same net.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

from .types import LogLevel

_PREFIX = {
    LogLevel.INFO: "[INFO]",
    LogLevel.WARNING: "\x1b[33m[WARNING]\x1b[0m",
    LogLevel.ERROR: "\x1b[31m[ERROR]\x1b[0m",
}


class LogContext:
    def __init__(
        self,
        callback: Optional[Callable[[str], None]] = None,
        level: LogLevel = LogLevel.INFO,
    ):
        self.callback = callback
        self.level = LogLevel(level)

    def log(self, level: LogLevel, msg: str):
        if level < self.level or self.level == LogLevel.SILENT:
            return
        line = f"{_PREFIX.get(level, '')} {msg}"
        if self.callback is not None:
            self.callback(line)
        else:
            print(line, file=sys.stderr)

    def info(self, msg: str):
        self.log(LogLevel.INFO, msg)

    def warning(self, msg: str):
        self.log(LogLevel.WARNING, msg)

    def error(self, msg: str):
        self.log(LogLevel.ERROR, msg)


_GLOBAL = LogContext()


def set_log_context(
    callback: Optional[Callable[[str], None]] = None,
    level: LogLevel = LogLevel.INFO,
):
    """bcnn_set_log_context equivalent."""
    global _GLOBAL
    _GLOBAL = LogContext(callback, level)
    return _GLOBAL


def get_log_context() -> LogContext:
    return _GLOBAL


def print_net_summary(net, ctx: Optional[LogContext] = None):
    """The colorized per-layer shape table printed during graph build
    (bcnn_conv_layer.c:344-362, header bcnn_net.c:1136-1140)."""
    ctx = ctx or _GLOBAL
    ctx.info(
        f"{'[Op]':<24} {'src':<10} {'(w x h x c)':<18} "
        f"{'dst':<10} {'(w x h x c)':<18}"
    )
    for node in net.nodes:
        s = net.tensors[node.src[0]]
        d = net.tensors[node.dst[0]] if node.dst else s
        op = f"[{node.type.name}]"
        ctx.info(
            f"{op:<24} {s.name:<10} ({s.w:4d} x{s.h:4d} x{s.c:4d})   "
            f"{d.name:<10} ({d.w:4d} x{d.h:4d} x{d.c:4d})"
        )
