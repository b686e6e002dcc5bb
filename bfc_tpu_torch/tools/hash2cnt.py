"""Decode a spectrum dump back to k-mer strings + counts.

Counterpart of bfc_tpu/tools/hash2cnt.py and of the reference hash2cnt
tool (hash2cnt.c): inverts the canonical hash so the actual k-mer
sequences can be printed without ever having been stored.  Reads the -d
dump format, which both packages write byte for byte.

Usage: python -m bfc_tpu_torch.tools.hash2cnt [-s|-h] [-m min_cnt] [-d min_high] dump.hash
"""

from __future__ import annotations

import getopt
import struct
import sys

from ..models.refmodel import kmer_2str, kmer_hash_inv


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, args = getopt.getopt(argv, "shm:d:")
    sizes_only = hist_only = False
    min_cnt = min_high = 0
    for f, v in opts:
        if f == "-s":
            sizes_only = True
        elif f == "-h":
            hist_only = True
        elif f == "-m":
            min_cnt = int(v)
        elif f == "-d":
            min_high = int(v)
    if not args:
        sys.stderr.write("Usage: hash2cnt [-s|-h] [-m min] [-d minHigh] <dump>\n")
        return 1
    with open(args[0], "rb") as fp:
        k, l_pre = struct.unpack("<II", fp.read(8))
        if k > 37:
            sys.stderr.write("ERROR: k-mer length over 37 cannot be decoded\n")
            return 1
        hist = [0] * 256
        t = 2 * k - l_pre if k <= 32 else None
        for shard in range(1 << l_pre):
            nb, size = struct.unpack("<II", fp.read(8))
            if sizes_only:
                print(shard, nb, size)
                if size:
                    fp.seek(8 * size, 1)
                continue
            for _ in range(size):
                (key,) = struct.unpack("<Q", fp.read(8))
                cnt = key & 0xFF
                high = (key >> 8) & 0x3F
                hist[cnt] += 1
                if hist_only or cnt < min_cnt or high < min_high:
                    continue
                ident = key >> 14
                if k <= 32:
                    z = (shard << t) | ident
                    h0, h1 = z >> k, z & ((1 << k) - 1)
                else:
                    tt = k - l_pre
                    h1 = ident & ((1 << k) - 1)
                    h0 = (shard << tt) | (ident >> k)
                y0, y1 = kmer_hash_inv(k, h0, h1)
                print(f"{kmer_2str(k, y0, y1)}\t{cnt}\t{high}")
        if hist_only:
            for i, v in enumerate(hist):
                if v:
                    print(i, v)
    return 0


if __name__ == "__main__":
    sys.exit(main())
