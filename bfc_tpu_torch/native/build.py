"""On-demand build + ctypes binding for the native I/O library."""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "fastxio.c"
_SO = _DIR / "libfastxio.so"
_STAMP = _DIR / ".fastxio.srchash"

_lib = None


def _src_hash() -> str:
    import hashlib

    return hashlib.sha256(_SRC.read_bytes()).hexdigest()


def get_lib():
    """Compile (if stale) and load the native library; None if unavailable.

    Staleness is gated on a stored source hash (never on mtimes, which
    are equal after a fresh checkout) so the binary is always rebuilt
    for the local platform; the .so itself is not committed."""
    global _lib
    if _lib is not None:
        return _lib
    try:
        h = _src_hash()
        if (not _SO.exists() or not _STAMP.exists()
                or _STAMP.read_text().strip() != h):
            subprocess.run(
                ["cc", "-O3", "-fPIC", "-shared", "-o", str(_SO), str(_SRC)],
                check=True, capture_output=True,
            )
            _STAMP.write_text(h)
        lib = ctypes.CDLL(str(_SO))
        _parse_args = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
            ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fastx_parse.restype = ctypes.c_long
        lib.fastx_parse.argtypes = _parse_args
        lib.fastx_parse_range.restype = ctypes.c_long
        lib.fastx_parse_range.argtypes = _parse_args + [
            ctypes.c_long, ctypes.c_long,
        ]
        lib.fastx_format_trim.restype = ctypes.c_long
        lib.fastx_format_trim.argtypes = [
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_char_p, ctypes.c_long,
        ]
        lib.bloom_scatter_min_u32.restype = None
        lib.bloom_scatter_min_u32.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_long, ctypes.c_int,
        ]
        lib.bloom_gather_verdict_u32.restype = None
        lib.bloom_gather_verdict_u32.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.bloom_scatter_imin_u32.restype = None
        lib.bloom_scatter_imin_u32.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_long, ctypes.c_int,
        ]
        lib.bloom_replay_verdict_u64.restype = None
        lib.bloom_replay_verdict_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.bloom_gather_verdict_inv_u32.restype = None
        lib.bloom_gather_verdict_inv_u32.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.fastx_format.restype = ctypes.c_long
        lib.fastx_format.argtypes = [
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_char_p, ctypes.c_long,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib
