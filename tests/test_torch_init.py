"""Importing bfc_tpu_torch tunes glibc's malloc as bfc_tpu's import does
(bfc_tpu/__init__.py:17-34): M_MMAP_THRESHOLD (-3) to 1 GiB and
M_TRIM_THRESHOLD (-1) to never, through ctypes.  Each case imports the
package in a fresh interpreter with ctypes.CDLL stubbed to record its
calls; a CDLL that fails (no glibc) must leave the import working."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import ctypes, json, sys
calls = []

class Libc:
    def mallopt(self, param, value):
        calls.append([param, value])
        return 1

def cdll(name, *args, **kwargs):
    calls.append([name])
    if sys.argv[1] == "fail":
        raise OSError("no such library")
    return Libc()

ctypes.CDLL = cdll
import bfc_tpu_torch
print(json.dumps({"calls": calls, "version": bfc_tpu_torch.__version__}))
"""


@pytest.mark.parametrize("mode,want", [
    ("glibc", [["libc.so.6"], [-3, 1 << 30], [-1, 0x7FFFFFFF]]),
    ("fail", [["libc.so.6"]]),
])
def test_import_sets_the_allocator(mode, want):
    r = subprocess.run([sys.executable, "-c", PROBE, mode], cwd=ROOT,
                       capture_output=True, check=True, timeout=120,
                       env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    got = json.loads(r.stdout.decode().strip().splitlines()[-1])
    assert got["calls"] == want
    assert got["version"]
