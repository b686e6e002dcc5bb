"""What the per-layer metrics read: the window's jobs, the trace, the
card's peaks and what the metrics' own hooks tallied.

A metric module (metrics/<name>.py) defines

    read(w: Window, tally: dict) -> float | None

and, where it counts work at the program's calls, hooks(tally) returning
{"module:function" or "module:Class.method": on_call(args, kwargs,
result)}.  The harness wraps those functions for the traced window only
and restores them after it.  A reader that finds nothing to read returns
None, and the metric is left out of the result line.
"""

from __future__ import annotations

import functools
import importlib
from typing import Callable, Dict, List, Optional

from . import devtrace

# Bytes of one random access of device memory, and of one 512-bit Bloom
# block, which a k-mer's probes share.
SECTOR = 32
BLOCK = 2 * SECTOR
# 32-bit integer operations a unit of work takes, counted from the
# kernels' sources (a u64 add, shift or logic op counts two): a
# canonical hash and shard split ~60 u64 ops, a table probe ~20 more,
# one Bloom addressing ~20 plus ~4 a probed bit.
OPS_KMER = 2 * 60
OPS_PROBE = 2 * 80
OPS_BLOOM = 2 * (20 + 4 * 4)


def number(x) -> float:
    """A tally's value: a Python number, or a device scalar read once."""
    return float(x.item()) if hasattr(x, "item") else float(x)


def add(tally: dict, key: str, x) -> None:
    """tally[key] += x, where x may be a device scalar (no wait)."""
    tally[key] = tally[key] + x if key in tally else x


def valid_kmers(lens, k: int):
    """The k-mers a padded batch of these read lengths holds at most, as
    a device scalar: the sum of max(len - k + 1, 0)."""
    return (lens.long() - (k - 1)).clamp(min=0).sum()


class Window:
    """A measured window, as the readers see it."""

    def __init__(self, jobs: List[dict], trace: Optional[devtrace.Trace],
                 peaks: Optional[dict], kernel_names: Callable[[str], List[str]]):
        self.jobs = jobs
        self.trace = trace
        self.peaks = peaks
        self._names = kernel_names

    @property
    def reads(self) -> int:
        return sum(j["reads"] for j in self.jobs)

    def mean(self, key: str) -> Optional[float]:
        """The mean over the jobs of a number in the program's report."""
        vals = [j["report"].get(key) for j in self.jobs]
        if not vals or any(v is None for v in vals):
            return None
        return sum(vals) / len(vals)

    def total(self, key: str) -> Optional[float]:
        vals = [j["report"].get(key) for j in self.jobs]
        if not vals or any(v is None for v in vals):
            return None
        return float(sum(vals))

    def kernel_s(self, kernel: str) -> Optional[float]:
        """Seconds the kernel ran in the window, by its name table
        (kernels/<kernel>.json); None where it did not run or untraced."""
        return devtrace.kernel_seconds(self.trace, self._names(kernel))

    def roofline_pct(self, kernel: str, bytes_moved: float,
                     int_ops: float) -> Optional[float]:
        """The least time the card could take for this work (bytes over
        the peak bandwidth or integer operations over the peak rate,
        whichever is larger), as a share of the kernel's time."""
        t = self.kernel_s(kernel)
        if t is None or self.peaks is None or bytes_moved <= 0:
            return None
        least = max(bytes_moved / self.peaks["hbm_bytes_per_s"],
                    int_ops / self.peaks["int32_ops_per_s"])
        return 100.0 * least / t


class Hooks:
    """Program functions wrapped for a window, restored by restore()."""

    def __init__(self):
        self._saved: List[tuple] = []

    @staticmethod
    def _owner(target: str):
        mod_name, attr = target.split(":")
        owner = importlib.import_module(mod_name)
        parts = attr.split(".")
        for p in parts[:-1]:
            owner = getattr(owner, p)
        return owner, parts[-1]

    def after(self, target: str, on_call: Callable) -> None:
        """Call on_call(args, kwargs, result) after each call of target."""
        owner, name = self._owner(target)
        orig = getattr(owner, name)

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            on_call(args, kwargs, out)
            return out

        setattr(owner, name, wrapper)
        self._saved.append((owner, name, orig))

    def around(self, target: str, context: Callable) -> None:
        """Run each call of target inside context() (a context manager)."""
        owner, name = self._owner(target)
        orig = getattr(owner, name)

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            with context():
                return orig(*args, **kwargs)

        setattr(owner, name, wrapper)
        self._saved.append((owner, name, orig))

    def restore(self) -> None:
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []


def install(hooks: Hooks, modules: Dict[str, object]) -> Dict[str, dict]:
    """Each metric module's hooks, wrapped; returns its tally by name."""
    tallies: Dict[str, dict] = {}
    for name, mod in modules.items():
        tallies[name] = {}
        make = getattr(mod, "hooks", None)
        if make is not None:
            for target, fn in make(tallies[name]).items():
                hooks.after(target, fn)
    return tallies
