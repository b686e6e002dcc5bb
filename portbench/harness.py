"""One run of one cell: set-up, the measured window of whole jobs, the
check against the reference, and the result line.

A job is one call of bfc_tpu_torch.models.device_pipeline.run_device,
the entry the CLI drives once it has parsed its flags, over the run's
generated FASTQ file, with an in-memory sink (sink.JobSink).  Set-up
(from the process's start) makes the input, builds and loads what the
program builds at first use, and runs one whole job as the warm-up.  The
window then runs jobs back to back and closes at the end of the first
job that ends after --seconds; its time is the sum of the jobs' walls,
each ending in torch.cuda.synchronize() and the sink's flush.  Between
jobs, outside the window, the harness digests the job's output and takes
its table or filter for the check.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from . import check, devtrace, gen, measure, options
from .catalog import Catalog

JAX_NAMES = {"jax", "jaxlib", "flax", "bfc_tpu"}
# report numbers the readers may take (run_device's report)
REPORT_KEYS = ("count_s", "correct_s", "trim_s", "n_reads", "n_aggregated",
               "n_kept", "c_bits", "verdict", "n_fallback", "finalize",
               "count_peak_bytes", "correct_peak_bytes")
GIB = float(1 << 30)


def cache_env(root: Path) -> dict:
    """Build and kernel caches at fixed paths inside the checkout (the
    program builds its own kernels under build/ there already)."""
    base = root / "build" / "portbench"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton"),
            "CUDA_CACHE_PATH": str(base / "cuda_cache")}


@contextlib.contextmanager
def environ(values: dict):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Runner:
    """Runs jobs of one cell and keeps what the check needs of each."""

    def __init__(self, cfg: dict, path: str, sample, n_reads: int, device,
                 traced: bool):
        import torch

        self.torch = torch
        self.flags = cfg["flags"]
        self.path = path
        self.sample = sample
        self.n_reads = n_reads
        self.device = device
        self.cuda = device == "cuda"
        self.traced = traced
        self.taken = {}
        self.digests = {}  # digest -> answer kept on the host
        self.hooks = measure.Hooks()
        self.hooks.after("bfc_tpu_torch.models.device_pipeline:count_file_device",
                         lambda a, k, out: self.taken.update(answer=out))
        self.hooks.after(
            "bfc_tpu_torch.models.device_pipeline:count_file_filter_device",
            lambda a, k, out: self.taken.update(answer=out))

    def job(self) -> dict:
        """One whole job, then its output digested outside its wall."""
        from bfc_tpu_torch import kernels
        from bfc_tpu_torch.models import device_pipeline as DP

        from .sink import JobSink

        torch = self.torch
        opt = options.program_opts(self.flags)
        sink = JobSink(self.sample)
        report = {} if self.traced else None
        kernels.reset_launches()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        span = (torch.profiler.record_function(devtrace.JOB) if self.traced
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with span:
            DP.run_device(opt, self.path, sink=sink, report=report,
                          device=self.device)
            if self.cuda:
                torch.cuda.synchronize()
            sink.flush()
        wall = time.perf_counter() - t0
        peak = 0
        if self.cuda:
            peak = max(torch.cuda.max_memory_allocated(),
                       (report or {}).get("count_peak_bytes", 0))
        rec = {"wall_s": wall, "reads": self.n_reads, "peak_bytes": peak,
               "launches": sum(k.launches for k in kernels.KERNELS.values()),
               "report": {k: (report or {}).get(k) for k in REPORT_KEYS}}
        rec.update(sink.digest())
        rec.update(self._answer(opt))
        del report
        return rec

    def _answer(self, opt) -> dict:
        """The job's table (correction) or filter (trim): its digest, and
        the answer itself on the host where the digest is new."""
        from .reference import spectrum as R

        ans = self.taken.pop("answer")
        if opt.filter_mode:
            words = ans.words
            digest = R.words_digest(words)
            host = (lambda: words.cpu().numpy())
        else:
            t = ans.table
            table = check.table_entries(t.table, t.kb_bits, t.l_pre, t.c_bits)
            digest = check.entries_digest(*table)
            host = (lambda: tuple(np.asarray(x).copy() for x in table))
        if digest not in self.digests:
            self.digests[digest] = host()
        del ans
        return {"digest": digest, "answer": self.digests[digest]}

    def warm_up(self) -> set:
        """The warm-up job, which builds, loads and sizes what jobs use.
        It also notes the reads that correction sent to the program's
        scalar fallback (batches come in input order), returned as read
        ids; every job of the file falls back on the same reads."""
        hooks, ids, at = measure.Hooks(), set(), [0]

        def note(args, kwargs, out):
            ids.update(at[0] + i for i in out.exceptional)
            at[0] += out.n

        try:
            hooks.after("bfc_tpu_torch.models.corrector:"
                        "Corrector.correct_arrays", note)
            self.job()
        finally:
            hooks.restore()
        return ids

    def close(self) -> None:
        self.hooks.restore()


# the program's phases that the traced window marks as spans
SPANS = {"bfc_tpu_torch.models.device_pipeline:count_file_device": "count",
         "bfc_tpu_torch.models.device_pipeline:count_file_filter_device":
             "count",
         "bfc_tpu_torch.models.device_pipeline:correct_file_device":
             "correct",
         "bfc_tpu_torch.models.trimmer:Trimmer.trim_file": "trim"}


def run_cell(cat: Catalog, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None) -> dict:
    """One run of the cell: its result (the result line's keys, the
    check's numbers under "check"); device "cpu" runs the kernels' plain
    versions (tests)."""
    t0 = time.time() if t0 is None else t0
    cell = cat.cell(name)
    cfg = cat.config(cell["config"])
    mix = cat.traffic(cell["traffic"])
    with environ({**cache_env(cat.root), **cfg.get("env", {})}):
        reads = gen.make_reads(cfg["genome"], mix, seed)
        sample = gen.sample_ids(reads.lens, int(mix["check_reads"]), seed)
        path = gen.scratch_path("reads.fq")
        try:
            gen.write_fastq(path, reads)
            return _run(cat, cell, cfg, reads, sample, path, seconds, trace,
                        device, t0)
        finally:
            shutil.rmtree(os.path.dirname(path), ignore_errors=True)


def _run(cat, cell, cfg, reads, sample, path, seconds, trace, device, t0):
    import torch

    runner = Runner(cfg, path, sample, len(reads.lens), device, trace)
    spans = measure.Hooks()
    try:
        fallback = runner.warm_up()
        modules, tallies = {}, {}
        if trace:
            for m in cat.metrics(cell["name"], "per_layer"):
                modules[m["name"]] = cat.metric_module(m["name"])
            tallies = measure.install(spans, modules)
            for target, label in SPANS.items():
                spans.around(target, lambda label=label:
                             torch.profiler.record_function(
                                 devtrace.SPAN_PREFIX + label))
        setup_s = time.time() - t0
        jobs, tr = _window(runner, seconds, trace, device)
    finally:
        spans.restore()
        runner.close()
    result = _result(cat, cell, jobs, tr, setup_s, device, modules, tallies)
    del runner, spans, modules, tallies
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ropt = options.reference_opts(cfg["flags"])
    want = check.expected(reads, ropt, sample, device)
    by_job = [check.judge([j], want) for j in jobs]
    nums = check.combine(by_job)
    result["correct"] = check.passed(nums)
    result["failed"] = sum(not check.passed(n) for n in by_job)
    result["check"] = {k: {"value": v, "limit": check.LIMITS[k]}
                       for k, v in nums.items()}
    result["check_info"] = {**want.info, "sampled_fallback": len(
        fallback.intersection(int(i) for i in sample))}
    return result


def _window(runner: Runner, seconds: float, trace: bool, device: str):
    """Jobs back to back until their walls pass `seconds`; with trace, under
    torch.profiler.  Returns (jobs, devtrace.Trace or None)."""
    import tempfile

    import torch

    jobs: List[dict] = []
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        while not jobs or sum(j["wall_s"] for j in jobs) < seconds:
            jobs.append(runner.job())
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    tr = None
    if prof is not None:
        d = tempfile.mkdtemp(prefix="portbench-trace-")
        try:
            f = os.path.join(d, "trace.json")
            prof.export_chrome_trace(f)
            tr = devtrace.read_file(f)
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return jobs, tr


def _result(cat, cell, jobs, tr, setup_s, device, modules, tallies) -> dict:
    import torch

    wall = sum(j["wall_s"] for j in jobs)
    reads = sum(j["reads"] for j in jobs)
    peak = max(j["peak_bytes"] for j in jobs)
    cuda = device == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": False, "attempted": len(jobs), "failed": 0}
    if modules:
        w = measure.Window(jobs, tr, cat.peaks(dev["kind"]), cat.kernel_names)
        metrics = {}
        units = {m["name"]: m["unit"] for m in cat.bench["per_layer"]}
        for name, mod in modules.items():
            v = mod.read(w, tallies[name])
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
        out["metrics"] = metrics
        if tr is not None:
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
            out["breakdown"] = devtrace.breakdown(tr)
    else:
        e2e = {"reads_per_s": reads / wall, "peak_dev_gib": peak / GIB,
               "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in cat.bench["end_to_end"]}
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                      "unit": units[m["name"]]}
                          for m in cat.metrics(cell["name"], "end_to_end")}
    out["device"] = dev
    return out


def result_lines(res: dict, workload: str, seed: int):
    """(standard error's last lines, the result line) of a run: the
    check's readings, then each number compared beside its limit; the
    result with the check last."""
    res = dict(res)
    info = res.pop("check_info", {})
    err = f"portbench: {workload} seed {seed}: {json.dumps(info)}\n" + "".join(
        f"check {k} {v['value']} limit {v['limit']}\n"
        for k, v in res["check"].items())
    res["check"] = res.pop("check")
    return err, json.dumps(res) + "\n"


def loaded_jax() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & JAX_NAMES)


def main(argv=None, t0: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cat = Catalog()
    cell = cat.cell(args.workload)
    with environ(cache_env(cat.root)):
        import torch

        if not torch.cuda.is_available():
            sys.stderr.write("portbench: no CUDA device\n")
            return 2
        if torch.cuda.device_count() < int(cell["chips"]):
            sys.stderr.write(f"portbench: {cell['name']} needs {cell['chips']} "
                             f"cards, {torch.cuda.device_count()} found\n")
            return 2
        res = run_cell(cat, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", t0)
    bad = loaded_jax()
    if bad:
        sys.stderr.write(f"portbench: loaded {', '.join(bad)}\n")
        return 3
    err, line = result_lines(res, args.workload, args.seed)
    sys.stderr.write(err)
    sys.stdout.write(line)
    sys.stdout.flush()
    return 0
