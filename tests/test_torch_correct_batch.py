"""The correction batch: KD's default batch of CORRECT_BATCH reads.

correct_file_device over more reads than one default batch must give the
bytes of the 8,192-read batching, records in input order; run_device hands
the correction its default and the trim (KH) its own 8,192.  The input
mixes reads of a tests/datagen.py dataset (a 12 kb genome, 50 bp reads, 1%
errors), placed across both batchings' edges, with short all-N reads that
the many-N gate passes through at once, so the file (one 4 MB block of the
reader) spans two default batches on the CPU.  Tolerance: byte equality."""

import inspect

import pytest
import torch

from bfc_tpu_torch.io import fast_reader as FR
from bfc_tpu_torch.io.writer import OutputWriter
from bfc_tpu_torch.models import counter as TC
from bfc_tpu_torch.models import device_pipeline as TDP
from bfc_tpu_torch.models import trimmer as TT
from bfc_tpu_torch.ops import search as tsrch
from bfc_tpu_torch.opts import Opts

from . import datagen

N_READS = tsrch.CORRECT_BATCH + 700
# real reads around the 8,192-read edges of batch 1 and the default edge
REAL = [(8000, 8400), (tsrch.CORRECT_BATCH - 300, tsrch.CORRECT_BATCH + 300)]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    d = tmp_path_factory.mktemp("correct_batch")
    genome = datagen.make_genome(12000, seed=41)
    reads = datagen.simulate_reads(genome, 1500, read_len=50, err_rate=0.01,
                                   seed=42)
    real_fq = f"{d}/real.fq"
    datagen.write_fastq(real_fq, reads)
    filler = ("N" * 20, "#" * 20)
    seq = [filler] * N_READS
    it = iter(reads)
    for a, b in REAL:
        for i in range(a, b):
            seq[i] = next(it)
    fq = f"{d}/mixed.fq"
    datagen.write_fastq(fq, seq)
    opt = Opts()
    opt.k = 21
    opt.bf_shift = 24
    torch.set_num_threads(1)
    ds = TC.count_file_device(real_fq, opt, "cpu", batch_reads=512)
    return fq, opt, ds


def test_correct_batch_default():
    sig = inspect.signature(TDP.correct_file_device)
    assert sig.parameters["batch_reads"].default == tsrch.CORRECT_BATCH
    assert tsrch.CORRECT_BATCH == 65536


def test_correct_file_device_past_one_batch(mixed):
    fq, opt, ds = mixed
    outs = {}
    for batch in (None, 8192):
        w = OutputWriter()
        kw = {} if batch is None else {"batch_reads": batch}
        corr = TDP.correct_file_device(fq, opt, ds, w, **kw)
        outs[batch] = w.getbytes()
        assert corr.n_fallback == 0
    assert outs[None] == outs[8192]
    lines = outs[None].split(b"\n")
    assert len(lines) - 1 == 4 * N_READS
    names = [int(lines[j].split(b"\t")[0][2:])
             for j in range(0, 4 * N_READS, 4)]
    assert names == list(range(N_READS))
    # the real reads were corrected: lower-case bases mark the edits
    seqs = [lines[4 * i + 1] for a, b in REAL for i in range(a, b)]
    assert sum(s != s.upper() for s in seqs) > 20


def test_run_device_batch_defaults(monkeypatch, tmp_path):
    """run_device asks the reader for CORRECT_BATCH reads a correction
    batch and 8,192 a trim batch, unless batch_reads says otherwise."""
    torch.set_num_threads(1)
    small = tmp_path / "small.fq"
    genome = datagen.make_genome(8000, seed=43)
    datagen.write_fastq(str(small), datagen.simulate_reads(
        genome, 400, read_len=50, err_rate=0.01, seed=44))
    asked = []
    real = FR.iter_batches_prefetch

    def spy(fn, batch_reads, *a, **kw):
        asked.append(batch_reads)
        return real(fn, batch_reads, *a, **kw)

    monkeypatch.setattr(FR, "iter_batches_prefetch", spy)
    got = {}
    for trim in (False, True):
        for batch in (None, 300):
            o = Opts()
            o.k = 21
            o.bf_shift = 24
            o.filter_mode = trim
            asked.clear()
            TDP.run_device(o, str(small), device="cpu", batch_reads=batch)
            got[trim, batch] = asked[-1]  # after the counting's
    assert got[False, None] == tsrch.CORRECT_BATCH
    assert got[False, 300] == 300
    default_trim = inspect.signature(TT.Trimmer.trim_file).parameters
    assert got[True, None] == default_trim["batch_reads"].default == 8192
    assert got[True, 300] == 300

