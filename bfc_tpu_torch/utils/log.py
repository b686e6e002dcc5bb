"""stderr logging in the reference's [M::fn @wall*cpu%] cadence (utils.c, count.c:110)."""

from __future__ import annotations

import inspect
import os
import resource
import sys
import time

_t0 = time.time()
verbosity = 3


def reset_clock() -> None:
    global _t0
    _t0 = time.time()


def realtime() -> float:
    return time.time() - _t0


def cputime() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def log(msg: str, level: int = 3, func: str | None = None) -> None:
    if verbosity < level:
        return
    if func is None:
        func = inspect.stack()[1].function
    rt = realtime()
    eff = 100.0 * cputime() / (rt + 1e-6)
    sys.stderr.write(f"[M::{func} @{rt:.1f}*{eff:.1f}%] {msg}\n")
    sys.stderr.flush()
