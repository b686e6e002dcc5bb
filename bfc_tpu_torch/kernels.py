"""Build and bind the hand-written CUDA kernels in csrc/.

Each csrc/<name>.cu is compiled by nvcc for sm_90a into its own shared
library with a plain C interface, under build/bfc_tpu_torch_kernels/ at
first use, and loaded with ctypes.  Every source compiles in its own nvcc
process, all started together.  A stamp beside each library holds the
hash of its sources, so a changed source rebuilds and nothing else does.
Each C launcher enqueues on the stream it is given and returns
cudaGetLastError(); Kernel.launch passes PyTorch's current stream, counts
the launch and raises on a non-zero code.

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

    def launch(self, fn: str, *args) -> None:
        """Enqueue one kernel launch on PyTorch's current stream."""
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(self.lib(), fn)(*args, stream)
        self.launches += 1
        if rc != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc}")

    def call(self, fn: str, *args) -> int:
        """A host-side entry point that launches nothing (sizes, limits)."""
        return getattr(self.lib(), fn)(*args)


KA = Kernel("kmer_stream", {
    "ka_launch": [_P, _P, _P, _I, _I, _I, _I, _LL, _P, _P, _P, _P, _P],
})
KB = Kernel("run_combine", {
    "kb_head_launch": [_P, _P, _LL, _P, _P],
    "kb_combine_launch": [_LL] + [_P] * 17,
})
KC = Kernel("kcov_island", {
    "kc_launch": [_P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P],
})
KD = Kernel("ec1_search", {
    "kd_launch": [_P, _I, _I, _I, _I, _P, _I, _I] + [_P] * 13,
    "kd_sizes": [_P, _P, _P],
})
KE = Kernel("pack_pull", {
    "ke_launch": [_LL] + [_P] * 7,
})
KF = Kernel("bloom_adjudicate", {
    "kf_launch": [_LL, _P, _P, _P, _I, _I, _P, _P, _P, _P],
})
KG = Kernel("bloom_build", {
    "kg_launch": [_LL, _P, _P, _I, _I, _P, _P],
})
KH = Kernel("max_streak", {
    "kh_launch": [_P, _P, _I, _I, _I, _P, _I, _I, _P, _P],
})
KI = Kernel("first_occurrence", {
    "ki_launch": [_LL, _P, _P, _P, _P, _I, _I, _P, _P],
})
KJ = Kernel("derive_ret", {
    "kj_launch": [_LL, _P, _P, _I, _I, _P, _P],
})
KK = Kernel("finalize_counts", {
    "kk_launch": [_LL] + [_P] * 9,
})
KL = Kernel("cuckoo_build", {
    "kl_launch": [_LL, _P, _P, _P, _I, _I, _I, _P, _P, _P],
})
KERNELS = {k.name: k for k in (KA, KB, KC, KD, KE, KF, KG, KH, KI, KJ, KK,
                               KL)}


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
    beside it as <name>.ptxas.txt."""
    with _lock:
        t0 = time.time()
        BUILD.mkdir(parents=True, exist_ok=True)
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
    cudaMemGetInfo reports plus what PyTorch's caching allocator holds
    unused."""
    import torch

    free, _ = torch.cuda.mem_get_info(dev)
    return (free + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))


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
