"""Build and bind the hand-written CUDA kernels in csrc/.

Each csrc/<name>.cu is compiled by nvcc for sm_90a into its own shared
library with a plain C interface, under build/bfc_tpu_torch_kernels/ at
first use, and loaded with ctypes.  Every source compiles in its own nvcc
process, all started together.  A stamp beside each library holds the
hash of its sources, so a changed source rebuilds and nothing else does.
Each C launcher enqueues on the stream it is given and returns
cudaGetLastError(); Kernel.launch passes PyTorch's current stream, counts
the kernels the launcher enqueues (one, or KL's and KN's five) and raises
on a non-zero code.

Importing this module builds nothing: the first launch builds, since
building needs nvcc, which only the machine with the card has.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parents[1] / "build" / "bfc_tpu_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


class Kernel:
    """One csrc/<name>.cu library: its C entry points and a launch count."""

    def __init__(self, name: str, signatures: Dict[str, List]):
        self.name = name
        self.signatures = signatures
        self.launches = 0
        self._lib = None

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    @property
    def library(self) -> Path:
        return BUILD / f"lib{self.name}.so"

    def lib(self):
        if self._lib is None:
            build_all()
            lib = ctypes.CDLL(str(self.library))
            for fn, argtypes in self.signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, fn: str, *args, kernels: int = 1) -> None:
        """Enqueue fn's launches on PyTorch's current stream: one kernel,
        or `kernels` where the entry point enqueues several."""
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(self.lib(), fn)(*args, stream)
        self.launches += kernels
        if rc != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc}")

    def call(self, fn: str, *args) -> int:
        """A host-side entry point that launches nothing (sizes, limits)."""
        return getattr(self.lib(), fn)(*args)


KA = Kernel("kmer_stream", {
    "ka_launch": [_P, _P, _P, _I, _I, _I, _I, _LL, _P, _P, _P, _P, _P],
})
KB = Kernel("run_combine", {
    "kb_launch": [_LL] + [_P] * 17,
    "kb_tile_rows": [_P],
})
KC = Kernel("kcov_island", {
    "kc_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P,
                  _P, _P, _P],
})
KD = Kernel("ec1_search", {
    "kd_launch": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _I] + [_P] * 14
                 + [_I, _I, _LL, _I, _LL, _I, _P],
    "kd_plan": [_I, _I, _P],
})
KE = Kernel("pack_pull", {
    "ke_launch": [_LL] + [_P] * 7,
})
KF = Kernel("bloom_adjudicate", {
    "kf_launch": [_LL, _P, _P, _P, _I, _I, _I] + [_P] * 8,
})
KG = Kernel("bloom_build", {
    "kg_launch": [_LL, _P, _P, _I, _I, _P, _P],
})
KH = Kernel("max_streak", {
    "kh_launch": [_P, _P, _I, _I, _I, _P, _I, _I, _P, _P],
})
KI = Kernel("first_occurrence", {
    "ki_launch": [_LL, _P, _P, _I, _I, _I] + [_P] * 7,
})
KJ = Kernel("derive_ret", {
    "kj_launch": [_LL, _P, _P, _I, _I, _P, _P],
})
KK = Kernel("finalize_counts", {
    "kk_launch": [_LL] + [_P] * 9,
})
KL = Kernel("cuckoo_build", {
    "kl_launch": [_LL, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
})
KM = Kernel("route_rows", {
    "km_count_launch": [_LL, _I, _P, _P, _I, _I, _LL, _P, _P, _P],
    "km_scan_launch": [_I, _LL, _P, _P, _P, _P],
    "km_scatter_launch": [_LL, _I, _P, _P, _I, _I, _LL] + [_P] * 11,
})
KN = Kernel("cuckoo_build_local", {
    "kn_launch": [_LL, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "kn_handle_bytes": [_P],
    "kn_alloc": [_I, _LL, _P],
    "kn_free": [_I, _P],
    "kn_export": [_I, _P, _P],
    "kn_open": [_I, _P, _P],
    "kn_close": [_I, _P],
})
# The probe kernels (ops/probe.py): the access patterns of the TPU probe
# scripts' Pallas kernels, on the probe path (chip_probe.py).
KO = Kernel("probe_flat_gather", {
    "ko_launch": [_LL, _P, _LL, _P, _I, _P, _P, _P],
})
KP = Kernel("probe_tile_gather", {
    "kp_row_launch": [_LL, _P, _LL, _P, _I, _P, _P, _P],
    "kp_column_launch": [_LL, _P, _LL, _P, _I, _I, _P, _P, _P],
    "kp_lane_launch": [_LL, _P, _P, _I, _P, _P, _P],
})
KQ = Kernel("probe_onehot_passes", {
    "kq_registers_launch": [_LL, _P, _P, _I, _P, _P],
    "kq_shared_launch": [_LL, _P, _P, _I, _P, _P],
})
KR = Kernel("probe_two_plane", {
    "kr_launch": [_LL, _P, _P, _LL, _P, _I, _I, _P, _P, _P],
})
KERNELS = {k.name: k for k in (KA, KB, KC, KD, KE, KF, KG, KH, KI, KJ, KK,
                               KL, KM, KN, KO, KP, KQ, KR)}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


_lock = threading.Lock()


def _src_hash(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def build_all() -> float:
    """Compile every stale kernel library in parallel; returns seconds.

    The compiler's register and spill report for each library is kept
    beside it as <name>.ptxas.txt.  A file lock serialises builds across
    processes (the ranks of a mesh run), so one builds and the rest find
    the stamps fresh."""
    import fcntl

    BUILD.mkdir(parents=True, exist_ok=True)
    with _lock, open(BUILD / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        t0 = time.time()
        jobs = []
        for k in KERNELS.values():
            h = _src_hash(k.source)
            stamp = BUILD / f"{k.name}.srchash"
            if (k.library.exists() and stamp.exists()
                    and stamp.read_text().strip() == h):
                continue
            tmp = BUILD / f"lib{k.name}.so.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(k.source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((k, h, stamp, tmp, proc))
        failed = []
        for k, h, stamp, tmp, proc in jobs:
            out, _ = proc.communicate()
            (BUILD / f"{k.name}.ptxas.txt").write_text(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {k.source}:\n{out}")
                continue
            tmp.replace(k.library)
            stamp.write_text(h)
        if failed:
            raise RuntimeError("\n".join(failed))
        return time.time() - t0


def device_free_bytes(dev) -> int:
    """Device bytes a new allocation can take: the free memory that
    cudaMemGetInfo reports plus what PyTorch's caching allocator holds in
    segments it does not use at all.  The free blocks split off segments
    still in use (inactive_split_bytes) are not counted: they are
    fragments that a large allocation may not fit, and counting them let
    a merge pass the spill rule and then run out of memory."""
    import torch

    free, _ = torch.cuda.mem_get_info(dev)
    stats = torch.cuda.memory_stats(dev)
    return (free + stats.get("reserved_bytes.all.current", 0)
            - stats.get("allocated_bytes.all.current", 0)
            - stats.get("inactive_split_bytes.all.current", 0))


def check(t, name: str, dtype, shape, device) -> None:
    """Raise unless t is a contiguous tensor of this dtype, shape, device."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
