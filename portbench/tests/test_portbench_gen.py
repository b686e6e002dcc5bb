"""The generator: deterministic by seed, the same read lengths for every
seed, and a FASTQ file that holds the reads as drawn."""

import numpy as np

from portbench import gen

GENOME = {"length": 20000, "repeat_fraction": 0.1, "repeat_segment": 500}
MIX = {"reads": 400, "length": [90, 140], "revcomp": 0.5, "error_rate": 0.01,
       "qual_error": [2, 14], "qual_ok": [30, 39]}


def test_same_seed_same_reads():
    a = gen.make_reads(GENOME, MIX, 2 ** 40 + 3)
    b = gen.make_reads(GENOME, MIX, 2 ** 40 + 3)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_seeds_differ_in_reads_not_in_lengths():
    a = gen.make_reads(GENOME, MIX, 5)
    b = gen.make_reads(GENOME, MIX, -5)
    assert not np.array_equal(a.codes[:1000], b.codes[:1000])
    assert not np.array_equal(a.lens, b.lens)
    assert np.array_equal(np.sort(a.lens), np.sort(b.lens))


def test_errors_carry_low_qualities():
    r = gen.make_reads(GENOME, dict(MIX, error_rate=0.0), 9)
    assert (r.quals >= 33 + 30).all() and (r.codes < 4).all()
    r = gen.make_reads(GENOME, dict(MIX, error_rate=1.0), 9)
    assert (r.quals <= 33 + 14).all()


def test_fastq_holds_the_reads(tmp_path):
    r = gen.make_reads(GENOME, MIX, 11)
    path = tmp_path / "r.fq"
    size = gen.write_fastq(str(path), r)
    lines = path.read_bytes().split(b"\n")
    assert size == path.stat().st_size and lines[-1] == b""
    assert len(lines) - 1 == 4 * len(r.lens)
    for i in (0, 1, 137, len(r.lens) - 1):
        seq, qual = gen.read_text(r, i)
        assert lines[4 * i:4 * i + 4] == [b"@" + gen.read_name(i).encode(),
                                          seq.encode(), b"+", qual.encode()]


def test_sample_holds_the_longest_read():
    r = gen.make_reads(GENOME, MIX, 12)
    s = gen.sample_ids(r.lens, 50, 12)
    assert len(s) == 50 == len(set(s.tolist()))
    assert int(np.argmax(r.lens)) in s
    assert np.array_equal(s, gen.sample_ids(r.lens, 50, 12))


def test_reads_come_from_the_genome():
    g = gen.make_genome(GENOME, 13)
    gs = "".join("ACGT"[c] for c in g)
    rc = gs.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    for length in ([100, 100], [60, 140]):   # rows, and the flat path
        r = gen.make_reads(GENOME, dict(MIX, length=length, error_rate=0.0), 13)
        strands = set()
        for i in range(len(r.lens)):
            seq, _ = gen.read_text(r, i)
            assert seq in gs or seq in rc
            strands.add(seq in gs)
        assert strands == {True, False}
