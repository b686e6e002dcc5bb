"""How `correct` is decided: the window's answers against the plain
reference (reference/), worked out again from the same generated reads
once the window has closed.

Numbers compared, each with its limit (all exact, so every limit is 0):

    table_entries_wrong   entries (k-mer key, count and high-quality
                          count) of the cuckoo table that correction
                          probes, decoded slot by slot (table_entries),
                          that differ from the reference's kept table, in
                          the job that differs most (correction)
    bloom_bits_wrong      bits of the -1 mode's second Bloom filter that
                          differ, in the job that differs most (trim)
    record_count_wrong    output records too many or too few, summed over
                          the jobs, against one a read (correction) or the
                          reference's trim decision for every read (trim);
                          output that is not whole records counts one
    records_wrong         sampled reads whose output record differs from
                          the scalar model's (corrected, or trimmed and
                          dropped), summed over the jobs
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from . import gen
from .reference import scalar as S
from .reference import spectrum as R

LIMITS = {"table_entries_wrong": 0, "bloom_bits_wrong": 0,
          "record_count_wrong": 0, "records_wrong": 0}
# the numbers the window takes at its worst job; the others add up
WORST = {"table_entries_wrong", "bloom_bits_wrong"}


def entries_digest(shard, ident, payload) -> str:
    """sha256 of a kept table given sorted by (shard, ident)."""
    h = hashlib.sha256()
    for a, dt in ((shard, "<u4"), (ident, "<u8"), (payload, "<u4")):
        h.update(np.ascontiguousarray(np.asarray(a).astype(dt)).tobytes())
    return h.hexdigest()


# the table's alternate-slot hash (the layout correction probes: an
# entry qlow << 15 | nest << 14 | payload at its key's first slot, nest
# 0, or at the first slot xor alt(qlow), nest 1)
_GOLD = 0x9E3779B97F4A7C15 - (1 << 64)
_ALT_C1, _ALT_C2 = 0x9E3779B9, 0x85EBCA6B


def _srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> n) & ((1 << (64 - n)) - 1) if n else x


def _alt(qlow: torch.Tensor, c_bits: int) -> torch.Tensor:
    if c_bits > 32:
        return _srl(qlow * _GOLD, 64 - c_bits)
    h = (((qlow & 0xFFFFFFFF) * _ALT_C1) ^ ((qlow >> 32) * _ALT_C2)) \
        & 0xFFFFFFFF
    return h >> (32 - c_bits)


def table_entries(table: torch.Tensor, kb_bits: int, l_pre: int,
                  c_bits: int) -> tuple:
    """The entries of a cuckoo table of 2^c_bits int64 slots, decoded
    from the slots themselves, as (shard u32, ident u64, payload u32)
    numpy arrays sorted by key.  A key is l_pre + kb_bits bits: its top
    c_bits pick its first slot, the rest (qlow) are stored; a key that
    correction's probe could not find decodes to another key."""
    width = l_pre + kb_bits
    if not 0 < width - c_bits <= 49 or width > 63:
        raise ValueError(f"no table of {width}-bit keys in 2^{c_bits} slots")
    used = torch.nonzero(table & 0x3FFF).flatten()
    e = table[used]
    qlow = _srl(e, 15)
    slot = torch.where(((e >> 14) & 1) == 1, used ^ _alt(qlow, c_bits), used)
    key = (slot << (width - c_bits)) | qlow
    key, order = torch.sort(key)
    pay = (e & 0x3FFF)[order]
    return (_srl(key, kb_bits).cpu().numpy().astype(np.uint32),
            (key & ((1 << kb_bits) - 1)).cpu().numpy().view(np.uint64),
            pay.cpu().numpy().astype(np.uint32))


def entries_differing(a, b) -> int:
    """Entries (shard, ident, payload) in one table and not in the other."""
    def rows(t):
        s, i, p = (np.asarray(x) for x in t)
        out = np.zeros((len(s), 16), np.uint8)
        out[:, 0:4] = s.astype(">u4").view(np.uint8).reshape(-1, 4)
        out[:, 4:12] = i.astype(">u8").view(np.uint8).reshape(-1, 8)
        out[:, 12:16] = p.astype(">u4").view(np.uint8).reshape(-1, 4)
        return out.view("V16").ravel()

    ra, rb = rows(a), rows(b)
    both = len(np.intersect1d(ra, rb))
    return len(ra) + len(rb) - 2 * both


def bits_differing(a: torch.Tensor, b: torch.Tensor, chunk: int = 1 << 24) -> int:
    """Set bits that differ between two int32 word arrays."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel()) * 32
    n = 0
    for s in range(0, a.numel(), chunk):
        x = (a[s:s + chunk] ^ b[s:s + chunk]).to(torch.int64) & 0xFFFFFFFF
        for sh, mk in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F)):
            x = (x & mk) + ((x >> sh) & mk)
        n += int(((x * 0x01010101) >> 24 & 0xFF).sum())
    return n


class Expected(NamedTuple):
    """The reference's answers: the count table (correction) or the
    filter's words and digest (trim), the record count, and the record
    of each sampled read (None where it is dropped)."""

    digest: str
    table: Optional[tuple]
    words: Optional[torch.Tensor]
    records: int
    sampled: Dict[int, Optional[bytes]]
    info: dict


def expected(reads: R.Reads, opt: S.Opts, sample, device,
             drop_bloom: bool = False) -> Expected:
    """What the program must produce, from the reference alone.  With
    drop_bloom, the control's answers: the reference computed without
    the Bloom filter's false positives (every k-mer's first occurrence a
    miss), a counter that breaks the exact-count guarantee."""
    out: Dict[int, Optional[bytes]] = {}
    if opt.filter_mode:
        words = R.bloom_high(reads, opt, device, drop_bloom=drop_bloom)
        kept, _, _ = R.trim_all(reads, opt, words, device)
        probe = R.WordsBloom(words, opt.bf_shift, opt.n_hashes)
        n_kept = 0
        for i in sample:
            seq, qual = gen.read_text(reads, int(i))
            keep, s2, q2 = S.trim_read(opt, probe, seq, qual)
            n_kept += keep
            out[int(i)] = (S.trimmed_record(opt, gen.read_name(int(i)), s2, q2)
                           if keep else None)
        return Expected(R.words_digest(words), None, words, int(kept.sum()),
                        out, {"reads_kept": int(kept.sum()),
                              "sampled_kept": n_kept})
    spec = R.count_spectrum(reads, opt, device, drop_bloom=drop_bloom)
    probe = R.TableProbe(spec, opt.k, opt.l_pre)
    changed = 0
    for i in sample:
        seq, qual = gen.read_text(reads, int(i))
        st, s2, q2 = S.ec1(opt, probe, spec.mode, seq, qual)
        changed += st.n_ec > 0
        out[int(i)] = S.corrected_record(opt, gen.read_name(int(i)), st, s2, q2)
    table = (spec.shard, spec.ident, spec.payload)
    return Expected(entries_digest(*table), table, None, len(reads.lens), out,
                    {"entries": len(spec.shard), "mode": spec.mode,
                     "sampled_corrected": changed})


def judge(jobs: List[dict], want: Expected) -> Dict[str, int]:
    """The numbers compared, over every job of the window.  A job holds
    `digest` (its table's or filter's), `answer` (its table, or its words
    on the host, kept where its digest is new), `records`, `sampled` and
    `malformed` (the sink's digest)."""
    nums = {"record_count_wrong": 0, "records_wrong": 0}
    worst = 0
    for j in jobs:
        if j["digest"] != want.digest:
            if j.get("answer") is None:
                worst = max(worst, 1)
            elif want.table is not None:
                worst = max(worst, entries_differing(j["answer"], want.table))
            else:
                got = torch.from_numpy(j["answer"]).to(want.words.device)
                worst = max(worst, bits_differing(got, want.words))
        nums["record_count_wrong"] += abs(j["records"] - want.records) + (
            j["malformed"] is not None)
        nums["records_wrong"] += sum(
            j["sampled"].get(i) != rec for i, rec in want.sampled.items())
    key = "table_entries_wrong" if want.table is not None else "bloom_bits_wrong"
    return {key: worst, **nums}


def combine(by_job: List[Dict[str, int]]) -> Dict[str, int]:
    """The window's numbers from each job's: the worst table or filter,
    the summed records."""
    out: Dict[str, int] = {}
    for nums in by_job:
        for k, v in nums.items():
            out[k] = max(out.get(k, 0), v) if k in WORST else out.get(k, 0) + v
    return out


def passed(nums: Dict[str, int]) -> bool:
    return all(v <= LIMITS[k] for k, v in nums.items())
