"""The output sink of a job: it keeps what the program writes in memory
while the job runs, and once the job has ended hashes it, counts its
records and picks out the records of the sampled reads.

Nothing is written to disk.  During the job write() only keeps a
reference to each chunk, so the sink adds no work to the job's wall;
digest() does the reading afterwards, outside the window.  Records are
the program's output records, `lines` lines each, named r%08d as the
generator names the reads (gen.write_fastq), in input order.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np


def newlines(b: bytes) -> int:
    return int(np.count_nonzero(np.frombuffer(b, np.uint8) == 10))


class JobSink:
    """A binary file-like object for run_device's `sink`."""

    def __init__(self, sample: np.ndarray, lines: int = 4):
        self.sample = [int(i) for i in sample]
        self.lines = lines
        self.parts: List[bytes] = []

    def write(self, b) -> int:
        self.parts.append(b if isinstance(b, bytes) else bytes(b))
        return len(b)

    def flush(self) -> None:
        pass

    def digest(self) -> dict:
        """Hash, record count and sampled records of what was written:
        {"sha256", "bytes", "records", "sampled": {read id: record bytes
        or None where the output holds no record of it}, "malformed":
        text of the first fault found, else None}."""
        h = hashlib.sha256()
        found: Dict[int, Optional[bytes]] = {}
        state = {"records": 0, "bytes": 0, "next": 0, "malformed": None}
        carry = b""
        for part in self.parts:
            data = carry + part if carry else part
            n_lines = newlines(data)
            if data.endswith(b"\n") and n_lines % self.lines == 0:
                chunk, carry = data, b""
            else:
                cut = self._whole_records(data, n_lines)
                chunk, carry = data[:cut], data[cut:]
                n_lines = newlines(chunk)
            if chunk:
                h.update(chunk)
                state["bytes"] += len(chunk)
                state["records"] += n_lines // self.lines
                self._scan(chunk, found, state)
        self.parts = []
        if carry:
            state["malformed"] = state["malformed"] or (
                f"{len(carry)} bytes after the last whole record")
        while state["next"] < len(self.sample):
            found[self.sample[state["next"]]] = None
            state["next"] += 1
        return {"sha256": h.hexdigest(), "bytes": state["bytes"],
                "records": state["records"], "sampled": found,
                "malformed": state["malformed"]}

    def _whole_records(self, data: bytes, n_lines: int) -> int:
        """The length of data's leading whole records; data holds n_lines
        newlines."""
        end = data.rfind(b"\n") + 1
        r = n_lines % self.lines
        for _ in range(r):
            end = data.rfind(b"\n", 0, end - 1) + 1
        return end

    def _record_id(self, chunk: bytes, at: int) -> Optional[int]:
        name = chunk[at + 1:at + 10]
        if name[:1] != b"r" or not name[1:].isdigit():
            return None
        return int(name[1:])

    @staticmethod
    def _find(chunk: bytes, name: bytes, start: int) -> int:
        """Where the record named name begins in chunk (its '@' or '>'),
        or -1."""
        pos = chunk.find(name, start)
        while pos > 0:
            head = pos - 1
            if ((head == 0 or chunk[head - 1] == 10)
                    and chunk[head] in b"@>"
                    and chunk[pos + len(name):pos + len(name) + 1] in
                    (b"\t", b"\n", b" ")):
                return head
            pos = chunk.find(name, pos + 1)
        return -1

    def _scan(self, chunk: bytes, found: dict, state: dict) -> None:
        first = self._record_id(chunk, 0)
        p = len(chunk) - 1
        for _ in range(self.lines):
            p = chunk.rfind(b"\n", 0, p)
        last = self._record_id(chunk, p + 1)
        if first is None or last is None:
            state["malformed"] = state["malformed"] or (
                f"a record not named r%08d: {chunk[:40]!r}")
            return
        ids, i = self.sample, state["next"]
        cursor = 0
        while i < len(ids) and ids[i] <= last:
            rid = ids[i]
            if rid >= first:
                pos = self._find(chunk, b"r%08d" % rid, cursor)
                if pos >= 0:
                    end = pos
                    for _ in range(self.lines):
                        end = chunk.find(b"\n", end) + 1
                    found[rid] = chunk[pos:end]
                    cursor = end
                else:
                    found[rid] = None
            else:
                found[rid] = None
            i += 1
        state["next"] = i
