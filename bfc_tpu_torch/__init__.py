"""bfc-tpu ported to PyTorch and CUDA on one NVIDIA H100.

The counterpart of the JAX package bfc_tpu: the same two-pass k-mer
spectrum error correction of lh3/bfc (count, then correct or trim) with
output byte-identical to it, where every device program of the ported
paths is a kernel written by hand for Hopper (csrc/).  The package imports torch,
numpy and the standard library only.
"""

# glibc malloc tuning, applied on import, before numpy or torch allocate
# anything big (bfc_tpu/__init__.py:17-34).  The host finalize, the pull
# of the counting aggregate and the spill's host merges make multi-MB
# numpy temporaries; glibc's default mmap threshold gives each a fresh
# mmap returned to the OS on free, so every pass pays its page faults
# again, and on a virtual machine whose first touch of a page is dear
# that dominates those passes (bfc_tpu records 3-10x, a 5M-row
# adjudicate 25 s -> 4 s).  Large blocks kept on the heap's free list
# (an mmap threshold of 1 GiB, no trimming) pay the faults once a
# process; the price is a resident set that stays at its peak.
try:
    import ctypes as _ctypes

    _libc = _ctypes.CDLL("libc.so.6", use_errno=True)
    _libc.mallopt(-3, 1 << 30)       # M_MMAP_THRESHOLD: 1 GiB
    _libc.mallopt(-1, 0x7FFFFFFF)    # M_TRIM_THRESHOLD: never trim
except Exception:  # not glibc: nothing to tune
    pass

__version__ = "0.1.0"
