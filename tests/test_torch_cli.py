"""The port's CLI surface: host formatting flags and FASTA input against
bfc_tpu's scalar spec (models/pipeline.run), byte for byte; the card-or-
--cpu rule of the entry points; trim mode (-1) with -Q, -D and a second
file (-d/-r are tests/test_torch_sharded.py's, -R
tests/test_torch_refine.py's).  Then the host routes: -V4 (stdout and the
search trace against `python -m bfc_tpu -V4`), --scalar in correct, -1,
-d and -r modes against bfc_tpu's scalar pipeline (the same function
`bfc_tpu --scalar` runs), --profile on the CPU, and gzip and stdin input.

The input is a tests/datagen.py dataset with 1% N bases, so -D drops
reads (a 12 kb genome, 1,500 reads of 100 bp, 1% errors), as FASTQ and as
FASTA; the host routes and the inputs take a smaller one (a 2 kb genome,
500 reads, k = 17, -b20).  Tolerance: byte equality."""

import gzip
import json
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


def _port_cli(*args, stdin=None, stderr=False, cpu=True):
    # one intra-op thread: the plain versions' small ops lose to thread
    # start-up beside the suite's other workers, and the bytes do not change
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "bfc_tpu_torch",
                        *(["--cpu"] if cpu else []), *args], cwd=ROOT,
                       env=env, capture_output=True, check=True, stdin=stdin)
    return (r.stdout, r.stderr) if stderr else r.stdout


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


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_small")
    fq = datagen.standard_dataset(str(d), genome_len=2000, n_reads=500,
                                  name="small.fq")
    return {"fq": fq, "dir": d}


def _jopts(**kw):
    o = JOpts()
    o.k, o.bf_shift = 17, 20
    for key, v in kw.items():
        setattr(o, key, v)
    return o


def _trace_lines(stderr: bytes):
    """The -V4 search trace: the lines that start with a space or '*'
    (tests/test_cli.py:_trace_lines)."""
    return [ln for ln in stderr.splitlines()
            if ln.startswith(b" ") or ln.startswith(b"*")]


def test_v4_trace_matches_bfc_tpu(small):
    """-V4 takes the scalar pipeline in both packages, saying so."""
    mine, err = _port_cli("-k17", "-b20", "-V4", small["fq"], stderr=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "bfc_tpu", "-k17", "-b20",
                        "-V4", small["fq"]], cwd=ROOT, env=env,
                       capture_output=True, check=True)
    assert mine == r.stdout and mine.count(b"\n") == 4 * 500
    line = b"[M::main] -V4 search trace: using the scalar engine"
    assert line in err.splitlines() and line in r.stderr.splitlines()
    trace = _trace_lines(err)
    assert trace == _trace_lines(r.stderr) and len(trace) > 1000


@pytest.mark.parametrize("mode", ["correct", "mesh", "trim", "dump",
                                  "restore"])
def test_scalar_matches_bfc_tpu_scalar(small, tmp_path, mode):
    """--scalar needs no device and starts no ranks under --mesh; -d
    writes bfc_tpu's scalar dump, and -r restores a dump written by
    bfc_tpu's scalar pipeline."""
    fq = small["fq"]
    if mode in ("correct", "mesh"):
        mesh = ["--mesh", "2"] if mode == "mesh" else []
        assert _port_cli("--scalar", *mesh, "-k17", "-b20", fq,
                         cpu=False) == JP.run(_jopts(), fq).encode()
    elif mode == "trim":
        assert _port_cli("--scalar", "-1", "-k17", "-b20", fq) == JP.run(
            _jopts(filter_mode=True), fq).encode()
    elif mode == "dump":
        mine, want = tmp_path / "mine.dump", tmp_path / "want.dump"
        out = _port_cli("--scalar", "-k17", "-b20", "-E", "-d", str(mine), fq)
        JP.run(_jopts(), fq, out_hash=str(want), no_ec=True)
        assert out == b"" and mine.read_bytes() == want.read_bytes()
    else:
        dump = tmp_path / "j.dump"
        JP.run(_jopts(), fq, out_hash=str(dump), no_ec=True)
        assert _port_cli("--scalar", "-r", str(dump), fq) == JP.run(
            JOpts(), fq, in_hash=str(dump)).encode()


def test_profile_on_cpu_writes_a_trace(small, tmp_path):
    """--profile DIR: a Chrome trace of the run in DIR, stdout unchanged."""
    d = tmp_path / "prof"
    mine, err = _port_cli("-k17", "-b20", "--profile", str(d), small["fq"],
                          stderr=True)
    assert mine == _port_cli("-k17", "-b20", small["fq"])
    trace = json.loads((d / "trace.rank0.json").read_text())
    assert len(trace["traceEvents"]) > 100
    assert f"[M::main] profiler trace written to {d}".encode() in err


def test_profile_under_mesh_writes_a_trace_a_rank(small, tmp_path):
    d = tmp_path / "prof"
    mine = _port_cli("--mesh", "2", "-k17", "-b20", "--profile", str(d),
                     small["fq"])
    assert mine == _port_cli("-k17", "-b20", small["fq"])
    assert sorted(p.name for p in d.iterdir()) == ["trace.rank0.json",
                                                   "trace.rank1.json"]


@pytest.mark.parametrize("trim", [False, True], ids=["correct", "trim"])
@pytest.mark.parametrize("form", ["gz", "stdin_file", "stdin"])
def test_gzip_and_stdin_match_bfc_tpu(small, trim, form):
    """A .gz input reads as the plain file; `- reads.fq < reads.fq` counts
    stdin and corrects (trims) the file; a lone `-` counts stdin and finds
    it consumed for the second pass, so nothing is written, as
    bfc_tpu's run_device does (its scalar pipeline raises on the closed
    stream)."""
    fq = small["fq"]
    flags = ["-1"] if trim else []
    want = JP.run(_jopts(filter_mode=trim), fq).encode()
    if form == "gz":
        gz = Path(small["dir"]) / "small.fq.gz"
        if not gz.exists():
            gz.write_bytes(gzip.compress(Path(fq).read_bytes()))
        assert _port_cli(*flags, "-k17", "-b20", str(gz)) == want
        return
    args = ["-", fq] if form == "stdin_file" else ["-"]
    with open(fq, "rb") as f:
        mine = _port_cli(*flags, "-k17", "-b20", *args, stdin=f)
    assert mine == (want if form == "stdin_file" else b"")
    assert want.count(b"\n") > 4 * 100
