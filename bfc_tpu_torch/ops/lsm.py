"""The counting tree: a binary counter of device merges with a host spill.

Copy of bfc_tpu/ops/lsm.py.  The single-card AggBuilder folds read-batch
runs through a log-depth binary counter of DEVICE merges and spills
COMPLETE contiguous stream spans to a HOST binary counter whenever a
device merge would not fit the card (the merge callback signals that by
returning None).  Span order is load-bearing: the reference's
first-occurrence semantics resolve ties by stream position, so host
pushes must arrive oldest-span-first - draining the device counter
completely on spill guarantees every host push is the next contiguous
span.

Two tail optimizations (both order-preserving):

  * the async spill runs as a TWO-stage pipeline - a pull worker
    (to_host: the copy to the host) feeding a merge worker (host_merge:
    numpy) through a bounded queue - so a level's copy overlaps the
    previous level's merge instead of serializing with it.  The card's
    own part of a spill (stage: the pack, which allocates its output)
    runs on the pushing thread before the run is queued, so no worker
    allocates on the card and a merge's check of the card's free memory
    is not raced by a spill in flight;
  * levels too big to ever device-merge again (> eager_min rows: any
    merge would spill anyway) are spilled EAGERLY while the stream is
    still running, so their pulls overlap the card's counting instead of
    landing in the finish tail.  Eager spill drains oldest-first from the
    top level down to the triggering one, which keeps the span order
    intact.

The reference sizes everything for tables that fit one node's RAM
(htab.c:28-33); this tree is the answer to the card's memory being an
order of magnitude smaller than that.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..utils.log import log


def _nice_thread() -> None:
    # deprioritize: the main thread's host work (decoding the next batch,
    # enqueueing its kernels, waiting on KB's group count) is what keeps
    # the card busy, so host CPU taken by the spill merges idles the card.
    # A niced worker only uses cycles the stream leaves idle; the final
    # drain runs with the card idle anyway.
    try:
        import os
        import threading

        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 15)
    except Exception:
        pass


class LsmTree:
    """merge(older, newer) -> run | None (None = would not fit the card:
    the tree spills); to_host(run) -> HostAgg; host_merge(older, newer)
    -> HostAgg.  async_spill runs to_host and host_merge on two ordered
    worker threads (numpy releases the GIL) - only safe when to_host
    contains no collectives.  The port's trees meet that condition on the
    mesh too: each rank spills only its own prefix range to a tree of its
    own, its workers copy and merge numpy, and the ranks meet on the main
    thread once their trees are drained (parallel/mesh.py).  bfc_tpu's
    mesh, whose pull all-gathers, spills synchronously instead.
    stage(run), where given, runs on the
    pushing thread as a run is spilled, and to_host takes what it
    returns.  size(run) + eager_min enable the eager mid-stream spill of
    merge-dead levels."""

    def __init__(self, merge: Callable, to_host: Callable,
                 host_merge: Callable, async_spill: bool = False,
                 name: str = "LsmTree", size: Callable = None,
                 eager_min: int = 0, prep: Callable = None,
                 eager_min_after: int = 0, stage: Callable = None):
        import time

        def timed(f, key):
            def g(*a):
                t0 = time.time()
                out = f(*a)
                self.timings[key] = round(
                    self.timings.get(key, 0.0) + (time.time() - t0), 2)
                return out
            return g

        self.timings: dict = {}   # cumulative pull/merge seconds (anatomy)
        self.merge = merge
        self.stage = timed(stage, "stage") if stage is not None else None
        self.to_host = timed(to_host, "pull")
        self.host_merge = timed(host_merge, "host_merge")
        # per-span host hook: runs on the MERGE worker, so it overlaps the
        # pull worker's next copy instead of serializing with it
        self.prep = timed(prep, "prep") if prep is not None else None
        self.async_spill = async_spill
        self.name = name
        self.size = size
        self.eager_min = eager_min
        # once a forced drain happens, the stream is provably larger
        # than the device tree: drop the eager threshold so every later
        # big span spills asynchronously behind the stream instead of
        # the next stop-the-world _spill_all.  Streams that never drain
        # (they fit on the card) are unaffected.
        self.eager_min_after = eager_min_after
        self.levels: List = []       # device binary counter
        self.host_levels: List = []  # host binary counter (HostAggs)
        self._q = None               # runs -> pull worker
        self._q2 = None              # HostAggs -> merge worker
        self._threads: List = []
        self._err: Optional[BaseException] = None

    # -- host counter -----------------------------------------------------

    def _host_push(self, ha) -> None:
        i = 0
        while i < len(self.host_levels) and self.host_levels[i] is not None:
            ha = self.host_merge(self.host_levels[i], ha)  # older first
            self.host_levels[i] = None
            i += 1
        if i == len(self.host_levels):
            self.host_levels.append(None)
        self.host_levels[i] = ha

    # -- async spill pipeline ----------------------------------------------

    def _worker_pull(self) -> None:
        _nice_thread()
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                self._q2.put(None)
                return
            try:
                self._q2.put(self.to_host(item))
            except BaseException as e:  # surfaced by push()/finish()
                self._err = e
            finally:
                self._q.task_done()

    def _worker_merge(self) -> None:
        _nice_thread()
        while True:
            ha = self._q2.get()
            if ha is None:
                self._q2.task_done()
                return
            try:
                if self.prep is not None:
                    self.prep(ha)
                self._host_push(ha)
            except BaseException as e:
                self._err = e
            finally:
                self._q2.task_done()

    def _spill_item(self, run) -> None:
        if self.stage is not None:
            run = self.stage(run)
        if not self.async_spill:
            ha = self.to_host(run)
            if self.prep is not None:
                self.prep(ha)
            self._host_push(ha)
            return
        import queue
        import threading

        if self._q is None:
            self._q = queue.Queue(maxsize=2)
            self._q2 = queue.Queue(maxsize=2)
            self._threads = [
                threading.Thread(target=self._worker_pull, daemon=True,
                                 name="bfc-lsm-pull"),
                threading.Thread(target=self._worker_merge, daemon=True,
                                 name="bfc-lsm-merge"),
            ]
            for t in self._threads:
                t.start()
        self._q.put(run)

    def _drain(self) -> None:
        if self._q is not None:
            self._q.join()
            self._q.put(None)  # shuts both workers down in order
            for t in self._threads:
                t.join()
            self._q2.join()
            self._q = None
            self._q2 = None
            self._threads = []
        if self._err is not None:
            raise self._err

    def _spill_all(self, run) -> None:
        import time

        t0 = time.time()
        for j in range(len(self.levels) - 1, -1, -1):  # oldest span first
            if self.levels[j] is not None:
                self._spill_item(self.levels[j])
                self.levels[j] = None
        if run is not None:
            self._spill_item(run)
        if self.eager_min_after and self.eager_min > self.eager_min_after:
            self.eager_min = self.eager_min_after
            log(f"eager-spill threshold -> {self.eager_min} rows "
                "(stream exceeds the device tree)", func=self.name)
        log(f"spilled device counter to host in {time.time()-t0:.1f}s",
            func=self.name)

    def _spill_eager(self) -> None:
        """Spill every level from the top down to the lowest level whose
        run can never device-merge again (> eager_min rows).  Everything
        above that level is older, so draining top-down preserves the
        oldest-first host push order; younger levels stay on the card."""
        low = None
        for j, lvl in enumerate(self.levels):
            if lvl is not None and self.size(lvl) > self.eager_min:
                low = j
        if low is None:
            return
        for j in range(len(self.levels) - 1, low - 1, -1):
            if self.levels[j] is not None:
                self._spill_item(self.levels[j])
                self.levels[j] = None

    # -- public ------------------------------------------------------------

    def push(self, run) -> None:
        """Fold the newest run into the counter (stream order)."""
        if self._err is not None:  # fail fast, not hours later at finish
            raise self._err
        i = 0
        while i < len(self.levels) and self.levels[i] is not None:
            merged = self.merge(self.levels[i], run)  # older first
            if merged is None:
                # levels[i] not yet cleared: _spill_all drains it (and
                # everything older) before the newer run
                self._spill_all(run)
                return
            self.levels[i] = None
            run = merged
            i += 1
        if i == len(self.levels):
            self.levels.append(None)
        self.levels[i] = run
        if self.eager_min and self.size is not None:
            self._spill_eager()

    def finish(self):
        """Drain everything -> (device_run | None, host_agg | None);
        at most one is non-None."""
        import time

        t0 = time.time()
        acc = None
        for lvl in reversed(self.levels):  # oldest (highest level) first
            if lvl is None:
                continue
            if acc is None:
                acc = lvl
                continue
            merged = self.merge(acc, lvl)
            if merged is None:
                self._spill_item(acc)  # acc = older span
                acc = lvl
            else:
                acc = merged
        self.levels = []
        has_host = (
            any(x is not None for x in self.host_levels) or self._q is not None
        )
        if has_host and acc is not None:
            self._spill_item(acc)
            acc = None
        self._drain()
        t1 = time.time()
        hacc = None
        for ha in reversed(self.host_levels):  # oldest first
            if ha is None:
                continue
            hacc = ha if hacc is None else self.host_merge(hacc, ha)
        self.host_levels = []
        if has_host:
            log(f"finish: device spill {t1 - t0:.1f}s, host chain "
                f"{time.time() - t1:.1f}s, cumulative {self.timings}",
                func=self.name)
        return acc, hacc
