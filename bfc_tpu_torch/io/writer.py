"""Streaming output writer: list-of-lines compatible, O(batch) memory.

The reference streams records to stdout as each pipeline step finishes
(correct.c:596-618); the original port accumulated the
whole output as a Python list joined at the end — O(file) memory and a
per-read string path.  OutputWriter keeps the `out.append(line)` API
(every line is a str WITHOUT its trailing newline, exactly as the list
consumers produce them) and adds `write_bytes` for preformatted chunks
from the native formatter (native/fastxio.c:fastx_format).  With a
binary sink it streams; without one it accumulates and `getvalue()`
returns the text (the legacy contract: lines joined with '\n' plus a
trailing newline when non-empty).
"""

from __future__ import annotations

from typing import List, Optional


class OutputWriter:
    def __init__(self, sink=None):
        self.sink = sink  # binary file-like, or None to accumulate
        self._parts: List[bytes] = []
        self._any = False

    def append(self, line: str) -> None:
        b = line.encode("ascii") + b"\n"
        self._any = True
        if self.sink is not None:
            self.sink.write(b)
        else:
            self._parts.append(b)

    def extend(self, lines) -> None:
        for ln in lines:
            self.append(ln)

    def write_bytes(self, b: bytes) -> None:
        if not b:
            return
        self._any = True
        if self.sink is not None:
            self.sink.write(b)
        else:
            self._parts.append(b)

    def getvalue(self) -> str:
        assert self.sink is None, "streaming writer has no accumulated value"
        return b"".join(self._parts).decode("ascii")

    def getbytes(self) -> bytes:
        assert self.sink is None, "streaming writer has no accumulated value"
        return b"".join(self._parts)

    def flush(self) -> None:
        if self.sink is not None and hasattr(self.sink, "flush"):
            self.sink.flush()
