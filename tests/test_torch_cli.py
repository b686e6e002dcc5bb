"""The port's CLI surface: host formatting flags and FASTA input against
bfc_tpu's scalar spec (models/pipeline.run), byte for byte; the card-or-
--cpu rule of the entry points; trim mode (-1) with -Q, -D and a second
file; and the modes not ported yet (-d/-r are tests/test_torch_sharded.py's).

The input is a tests/datagen.py dataset with 1% N bases, so -D drops
reads (a 12 kb genome, 1,500 reads of 100 bp, 1% errors), as FASTQ and as
FASTA.  Tolerance: byte equality."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bfc_tpu.models import pipeline as JP
from bfc_tpu.opts import Opts as JOpts
from bfc_tpu_torch import cli
from bfc_tpu_torch.models import device_pipeline as TDP

from . import datagen

ROOT = Path(__file__).resolve().parents[1]


def _port_cli(*args) -> bytes:
    # one intra-op thread: the plain versions' small ops lose to thread
    # start-up beside the suite's other workers, and the bytes do not change
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "bfc_tpu_torch", "--cpu", *args],
                       cwd=ROOT, env=env, capture_output=True, check=True)
    return r.stdout


@pytest.fixture(scope="module")
def noisy(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    genome = datagen.make_genome(12000, seed=41)
    reads = datagen.simulate_reads(genome, 1500, read_len=100,
                                   err_rate=0.01, n_rate=0.01, seed=42)
    fq, fa = f"{d}/reads.fq", f"{d}/reads.fa"
    datagen.write_fastq(fq, reads)
    datagen.write_fastq(fa, [(s, None) for s, _ in reads])
    return {"fq": fq, "fa": fa}


@pytest.mark.parametrize("fmt,flags", [("fq", ["-Q", "-D", "-c4", "-w5"]),
                                       ("fa", ["-q30"])])
def test_cli_host_flags_match_scalar_spec(noisy, fmt, flags):
    mine = _port_cli("-k21", "-b24", *flags, noisy[fmt])
    o = JOpts()
    o.k = 21
    o.bf_shift = 24
    o.no_qual = "-Q" in flags
    o.discard = "-D" in flags
    o.min_cov = 4 if "-c4" in flags else o.min_cov
    o.win_multi_ec = 5 if "-w5" in flags else o.win_multi_ec
    o.q = 30 if "-q30" in flags else o.q
    assert mine == JP.run(o, noisy[fmt]).encode()
    if o.discard:  # some of the 1,500 FASTA records (-Q) were dropped
        assert mine.count(b"\n") < 2 * 1500


def test_entry_points_need_a_card_or_cpu(monkeypatch, noisy):
    fastq = noisy["fq"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDP.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-k21", fastq])
    assert TDP.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("flags,files", [
    (["-Q"], ["fq"]), (["-D"], ["fq"]), ([], ["fq", "fa"])],
    ids=["fasta-out", "discard", "two-files"])
def test_trim_flags_match_scalar_spec(noisy, flags, files):
    """-1 at k = 21, -b24: -Q writes FASTA, -D changes nothing in trim mode,
    and the two-file form counts the first file and trims the second."""
    mine = _port_cli("-1", "-k21", "-b24", *flags, *(noisy[f] for f in files))
    o = JOpts()
    o.k = 21
    o.bf_shift = 24
    o.filter_mode = True
    o.no_qual = "-Q" in flags
    o.discard = "-D" in flags
    want = JP.run(o, *(noisy[f] for f in files)).encode()
    assert mine == want
    assert 0 < mine.count(b"\n")
    assert (mine[:1] == b">") == (o.no_qual or files[-1] == "fa")


@pytest.mark.parametrize("flag", [["-R"], ["-V4"]])
def test_modes_outside_the_slice_name_their_roadmap_item(flag, noisy):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        cli.main([*flag, "--cpu", noisy["fq"]])
