"""The vectorized reference against the frozen scalar model of bfc
(count_reads, trim_read) on small sets where the Bloom filter's false
positives matter, and against k-mers counted by hand."""

from collections import Counter

import numpy as np
import pytest
import torch

from portbench import gen
from portbench.reference import scalar as S
from portbench.reference import spectrum as R

GENOME = {"length": 3000, "repeat_fraction": 0.2, "repeat_segment": 300}


def small_reads(seed, n=300, length=(60, 120), with_n=True):
    mix = {"reads": n, "length": list(length), "revcomp": 0.5,
           "error_rate": 0.02, "qual_error": [2, 14], "qual_ok": [15, 39]}
    r = gen.make_reads(GENOME, mix, seed)
    if with_n:
        rng = np.random.default_rng(seed)
        r.codes[rng.choice(len(r.codes), len(r.codes) // 150, replace=False)] = 4
    return r


def texts(r):
    return [gen.read_text(r, i) for i in range(len(r.lens))]


@pytest.mark.parametrize("k,bf_shift", [(11, 12), (21, 13), (35, 12)])
def test_count_matches_scalar(k, bf_shift):
    r = small_reads(k)
    opt = S.Opts(k=k, bf_shift=bf_shift)
    _, ch = S.count_reads(texts(r), opt)
    want = sorted(ch.items())
    spec = R.count_spectrum(r, opt, "cpu", block_slots=4096)
    got = list(zip(spec.shard.tolist(), spec.ident.tolist(),
                   spec.payload.tolist()))
    assert got == want
    cnt, _, mode = ch.hist()
    assert spec.mode == mode and spec.hist[1:].tolist() == cnt[1:]
    # the false positives made a difference here
    assert got != sorted(zip(*R.count_spectrum(
        r, opt, "cpu", drop_bloom=True)[:3]))


@pytest.mark.parametrize("k,bf_shift", [(51, 12), (31, 14)])
def test_trim_matches_scalar(k, bf_shift):
    r = small_reads(k + 1, n=400)
    opt = S.Opts(k=k, bf_shift=bf_shift, filter_mode=True)
    _, bf_high = S.count_reads(texts(r), opt)
    words = R.bloom_high(r, opt, "cpu", block_slots=4096)
    want = np.zeros(words.numel(), np.uint32)
    for block, bits in bf_high.blocks.items():
        for z in range(512):
            if (bits >> z) & 1:
                want[(block * 512 + z) >> 5] |= np.uint32(1 << (z & 31))
    assert np.array_equal(words.numpy().view(np.uint32), want)
    kept, start, end = R.trim_all(r, opt, words, "cpu", block_slots=4096)
    for i, (seq, qual) in enumerate(texts(r)):
        keep, s2, _ = S.trim_read(opt, bf_high, seq, qual)
        assert bool(kept[i]) == keep
        if keep:
            assert seq[start[i]:end[i]] == s2
    assert 0 < kept.sum() < len(kept)


def as_reads(seqs, qual=30):
    lut = np.full(256, 4, np.uint8)
    lut[list(b"ACGT")] = np.arange(4)
    codes = lut[np.frombuffer("".join(seqs).encode(), np.uint8)]
    lens = np.array([len(x) for x in seqs], np.int64)
    return R.Reads(codes, np.full(len(codes), 33 + qual, np.uint8), lens,
                   np.r_[0, np.cumsum(lens)[:-1]].astype(np.int64))


U64 = (1 << 64) - 1


def hash64_inv(key: int, mask: int) -> int:
    """Exact inverse of the scalar model's hash64 (bfc's kmer.h:42-77)."""
    tmp = (key - (key << 31)) & U64
    key = (key - ((tmp << 31) & U64)) & mask
    tmp = key ^ (key >> 28)
    key = key ^ (tmp >> 28)
    key = (key * 14933078535860113213) & mask
    tmp = key ^ (key >> 14)
    tmp = key ^ (tmp >> 14)
    tmp = key ^ (tmp >> 14)
    key = key ^ (tmp >> 14)
    key = (key * 15244667743933553977) & mask
    tmp = key ^ (key >> 24)
    key = key ^ (tmp >> 24)
    tmp = ~key & U64
    tmp = ~(key - ((tmp << 21) & U64)) & U64
    tmp = ~(key - ((tmp << 21) & U64)) & U64
    key = ~(key - ((tmp << 21) & U64)) & mask
    return key


def kmer_str(k: int, h0: int, h1: int) -> str:
    """The k-mer whose canonical hash is (h0, h1), as ACGT (kmer.h:90-104)."""
    mask = (1 << k) - 1
    t = (h0 - h1) & mask
    y1 = hash64_inv(h1, mask) ^ t
    y0 = (hash64_inv(t, mask) - y1) & mask
    return "".join("ACGT"[(((y1 >> l) & 1) << 1) | ((y0 >> l) & 1)]
                   for l in range(k - 1, -1, -1))


def decoded(spec, k, l_pre):
    """{canonical k-mer string: (count, high count)} of a Spectrum."""
    comp = str.maketrans("ACGT", "TGCA")
    out = {}
    for s, i, p in zip(spec.shard.tolist(), spec.ident.tolist(),
                       spec.payload.tolist()):
        z = (s << (2 * k - l_pre)) | i
        w = kmer_str(k, z >> k, z & ((1 << k) - 1))
        out[min(w, w.translate(comp)[::-1])] = (p & 0xFF, p >> 8)
    return out


def test_hand_counted_kmers():
    # X has the 11-mers ACGGTCATTGC, CGGTCATTGCA, GGTCATTGCAG, GTCATTGCAGT,
    # none its own reverse complement; X twice and its reverse complement
    # once make three occurrences of each, the first of which (no false
    # positive in 2^20 bits) stays out: count 2, all bases high.  The N
    # read and the 10-base read hold no 11-mer.
    x = "ACGGTCATTGCAGT"
    rc = x.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    r = as_reads([x, x, rc, "ACGGTNATTGCAGT", "ACGGTCATTG"])
    spec = R.count_spectrum(r, S.Opts(k=11, bf_shift=20), "cpu")
    comp = str.maketrans("ACGT", "TGCA")
    want = {min(w, w.translate(comp)[::-1]): (2, 2) for w in
            ("ACGGTCATTGC", "CGGTCATTGCA", "GGTCATTGCAG", "GTCATTGCAGT")}
    assert decoded(spec, 11, 20) == want
    # low qualities: the k-mers are still counted, no longer high
    spec = R.count_spectrum(as_reads([x, x, rc], qual=5), S.Opts(k=11, bf_shift=20),
                            "cpu")
    assert set(decoded(spec, 11, 20).values()) == {(2, 0)}


def test_counted_kmers_match_a_counter():
    r = small_reads(8, n=60, with_n=True)
    comp = str.maketrans("ACGT", "TGCA")
    occ = Counter()
    for seq, _ in texts(r):
        for i in range(len(seq) - 23 + 1):
            w = seq[i:i + 23]
            if "N" not in w:
                occ[min(w, w.translate(comp)[::-1])] += 1
    # k = 23 and 2^30 bits, as -s 5m sets them: ret's 46 bits address
    # the filter's 39, and 6,000 k-mers leave no false positive
    spec = R.count_spectrum(r, S.Opts(k=23, bf_shift=30), "cpu")
    got = {w: c for w, (c, _) in decoded(spec, 23, 20).items()}
    assert got == {w: min(c - 1, 255) for w, c in occ.items() if c >= 2}


def test_table_probe_matches_count_hash():
    r = small_reads(3)
    opt = S.Opts(k=17, bf_shift=14)
    _, ch = S.count_reads(texts(r), opt)
    probe = R.TableProbe(R.count_spectrum(r, opt, "cpu"), opt.k, opt.l_pre)
    rng = np.random.default_rng(0)
    for s, (seq, _) in enumerate(texts(r)[:40]):
        x = S.kmer_null()
        for c in seq:
            code = S.BASE_CODE[ord(c)]
            if code < 4:
                S.kmer_append(opt.k, x, code)
                assert probe.kmer_occ(x) == ch.kmer_occ(x)
        x = [int(v) for v in rng.integers(0, 1 << opt.k, 4)]
        assert probe.kmer_occ(x) == ch.kmer_occ(x)


def test_words_digest():
    w = torch.arange(1 << 12, dtype=torch.int32) * 7919
    d = R.words_digest(w, chunk=1000)
    assert d == R.words_digest(w.clone())
    w[77] ^= 1 << 5
    assert d != R.words_digest(w)
