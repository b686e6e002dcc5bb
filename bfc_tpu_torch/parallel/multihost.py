"""Launching the mesh path: one process per rank over torch.distributed.

Counterpart of bfc_tpu/parallel/multihost.py.  Each rank is a process
that runs the CLI; the process group gives the mesh.  Rank r runs on
cuda:LOCAL_RANK (or, with --cpu, on the CPU); every rank reads the input,
counts and corrects its share, and rank 0 alone writes the output and the
logs.

  worker    torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK,
            LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), across hosts too:
              torchrun --nproc-per-node 8 -m bfc_tpu_torch.parallel.multihost reads.fq
  launcher  N local ranks, rank 0's stdout passed through:
              python -m bfc_tpu_torch.parallel.multihost --launch N \\
                  [--backend gloo|nccl] -- <bfc args>
            (`python -m bfc_tpu_torch --mesh N` does the same).
  module    launch(N, argv, module=...) starts N ranks of another module
            the same way (tools/human_scale.py --mesh N does); each joins
            the group itself through join, as worker_main does.

The backend is NCCL on cards and gloo on the CPU unless --backend names
one.  NCCL takes one card a rank: with more ranks on a host than cards it
raises before init_process_group.  With --backend gloo, ranks beyond the
card count share cards as cuda:(LOCAL_RANK % device_count), and the
exchanges go through host memory.

Stdin belongs to the launcher: it reads stdin once into a file and hands
that file to the first `-` operand, and an empty file to every later one
(the correction pass of a lone `-` included), since a second pass over
stdin finds it consumed; the ranks start with stdin closed.  A torchrun
worker has no launcher to do this, so in a world larger than one it
refuses `-`.
"""

from __future__ import annotations

import datetime
import getopt
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import BinaryIO, List, Optional, Tuple

TIMEOUT = datetime.timedelta(minutes=30)  # any one collective
GRACE_S = 30.0  # how long the launcher waits for peers of a failed rank


def device_for(backend: str, local_rank: int, local_world: int,
               cpu: bool) -> str:
    """The device of a rank: the CPU with --cpu, else a card.  NCCL needs
    a card a rank; gloo lets ranks share them."""
    if cpu:
        return "cpu"
    import torch

    n = torch.cuda.device_count()
    if backend == "nccl" and local_world > n:
        raise RuntimeError(
            f"{local_world} NCCL ranks on a host with {n} CUDA devices: NCCL "
            "takes one device a rank; pass --backend gloo to share devices")
    if n == 0:
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
    return f"cuda:{local_rank % n}"


def split_operands(argv: List[str]) -> Tuple[List[str], List[str]]:
    """(options, operands) of a CLI argv, as the CLI's getopt splits it;
    an argv it rejects is all options (the CLI reports it)."""
    from ..cli import LONG_OPTS, SHORT_OPTS

    try:
        _, args = getopt.getopt(argv, SHORT_OPTS, LONG_OPTS)
    except getopt.GetoptError:
        return list(argv), []
    n = len(argv) - len(args)
    return list(argv[:n]), list(args)


def spool_stdin(argv: List[str], tmp: str,
                stdin: Optional[BinaryIO] = None) -> List[str]:
    """argv with its `-` operands replaced by files in tmp: the first by
    one holding all of stdin (or `stdin`), every later one by an empty
    file.  A lone `-` also gets the empty file as its correction input,
    which the single-device run reads from the consumed stream."""
    opts, args = split_operands(argv)
    if "-" not in args:
        return list(argv)
    spooled, empty = os.path.join(tmp, "stdin"), os.path.join(tmp, "empty")
    with open(spooled, "wb") as f:
        shutil.copyfileobj(stdin or sys.stdin.buffer, f, 1 << 24)
    open(empty, "wb").close()
    first = args.index("-")
    args = [a if a != "-" else spooled if i == first else empty
            for i, a in enumerate(args)]
    if len(args) == 1:
        args.append(empty)
    return opts + args


def in_world() -> bool:
    """Whether torchrun's variables (or the launcher's) make this process
    a rank: RANK and WORLD_SIZE are set."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join(cpu: bool, backend: Optional[str] = None) -> str:
    """Join the process group as the rank that torchrun's variables (or
    the launcher's, which sets the same ones) name; returns the rank's
    device (device_for), made current where it is a card.  The backend
    is gloo with cpu, else NCCL, unless named."""
    import torch
    import torch.distributed as dist

    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend = backend or ("gloo" if cpu else "nccl")
    dev = device_for(backend, local, local_world, cpu)
    if dev != "cpu":
        torch.cuda.set_device(torch.device(dev))
    dist.init_process_group(
        backend, init_method=os.environ.get("BFC_TPU_INIT_METHOD", "env://"),
        rank=rank, world_size=world, timeout=TIMEOUT)
    return dev


def worker_main(argv: List[str], backend: Optional[str] = None,
                report_path: Optional[str] = None) -> int:
    """Run the CLI as one rank of the mesh (join)."""
    import torch.distributed as dist

    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and "-" in split_operands(argv)[1]:
        raise RuntimeError(
            f"stdin (`-`) in a world of {world} ranks: every rank would read "
            "its own part of the stream; pass a file, or run through the "
            "launcher (--mesh N or --launch N), which reads stdin once")
    join("--cpu" in argv, backend)

    from .. import cli
    from ..utils import log as ulog

    real_err = None
    if rank != 0:
        # every rank would log the same lines; only rank 0 keeps them
        sys.stdout = open(os.devnull, "w")
        real_err = sys.stderr
        sys.stderr = open(os.devnull, "w")
        ulog.verbosity = 0
    report = {}
    try:
        rc = cli.main(argv, report=report)
    except BaseException:
        if real_err is not None:
            sys.stderr = real_err
        raise
    if rank == 0 and report_path:
        keep = {k: v for k, v in report.items()
                if isinstance(v, (int, float, str, list, dict))}
        with open(report_path, "w") as f:
            json.dump(keep, f)
    dist.destroy_process_group()
    return rc


def wait_all(procs: List[subprocess.Popen], grace_s: float = GRACE_S) -> int:
    """Wait for every process; returns the largest exit code.  Polls rather
    than waiting in turn: a rank that dies leaves its peers blocked inside
    a collective, so once one fails the rest get grace_s seconds, and any
    still running are killed (bfc_tpu's multihost.py:122-146)."""
    rcs: List[Optional[int]] = [None] * len(procs)
    deadline = None
    try:
        while True:
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    rcs[i] = p.poll()
            if all(rc is not None for rc in rcs):
                return max(rcs)
            if any(rc not in (None, 0) for rc in rcs):
                if deadline is None:
                    deadline = time.time() + grace_s
                elif time.time() > deadline:
                    return max(rc for rc in rcs if rc is not None)
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def launch(nproc: int, argv: List[str], backend: Optional[str] = None,
           stdout=None, report_path: Optional[str] = None,
           stdin: Optional[BinaryIO] = None,
           module: Optional[str] = None) -> int:
    """Spawn nproc local ranks running the CLI with argv; rank 0's stdout
    passes through (or into `stdout`).  The ranks meet through a file in
    a fresh temporary directory, which also holds stdin (or `stdin`) read
    once where an operand is `-` (spool_stdin).  With `module`, each rank
    runs `python -m module argv` instead, which joins the group itself
    (join) and takes no stdin; backend and report_path are then the
    module's to parse from argv.  Returns the largest exit code."""
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if module is not None and (backend or report_path or stdin):
        raise ValueError("a launched module takes its options in argv")
    with tempfile.TemporaryDirectory(prefix="bfc_mesh_") as tmp:
        if module is None:
            argv = spool_stdin(argv, tmp, stdin)
        procs = []
        for r in range(nproc):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(nproc),
                       LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(nproc),
                       BFC_TPU_INIT_METHOD=f"file://{tmp}/rendezvous")
            env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH",
                                                                "")
            # -P: the ranks import this package, not one that a working
            # directory holding another checkout would put first
            cmd = [sys.executable, "-P", "-m",
                   module or "bfc_tpu_torch.parallel.multihost"]
            if module is None:
                if backend:
                    cmd += ["--backend", backend]
                if report_path and r == 0:
                    cmd += ["--report", report_path]
                cmd.append("--")
            procs.append(subprocess.Popen(
                cmd + list(argv), env=env, stdin=subprocess.DEVNULL,
                stdout=(stdout if r == 0 else subprocess.DEVNULL)))
        return wait_all(procs)


def _main(argv: List[str]) -> int:
    nproc = backend = report = None
    while argv and argv[0] in ("--launch", "--backend", "--report"):
        flag, val, argv = argv[0], argv[1], argv[2:]
        if flag == "--launch":
            nproc = int(val)
        elif flag == "--backend":
            backend = val
        else:
            report = val
    if argv[:1] == ["--"]:
        argv = argv[1:]
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"--backend {backend}: gloo or nccl")
    if nproc is not None:
        return launch(nproc, argv, backend=backend, report_path=report)
    return worker_main(argv, backend=backend, report_path=report)


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
