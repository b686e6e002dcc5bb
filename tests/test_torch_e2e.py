"""The whole port: `python -m bfc_tpu_torch --cpu` against bfc_tpu.

stdout must be byte-identical to bfc_tpu's device pipeline (run_device on
JAX-CPU) at k = 21, -b24, the configuration of
tests/test_device_vs_reference.py, and to bfc_tpu's scalar spec
(models/pipeline.run) at k = 21, at the default k = 33 and at k = 63.
Trim mode (-1) is held against both at k = 21 and 51, with the host Bloom
sketch and without it (BFC_TPU_INC_ADJ=0, the device adjudicate in both
packages), and against the spec at k = 63.  With the device finalize
(BFC_TPU_DEVICE_FINALIZE=1 in both packages) correction at k = 21 and
trim at k = 21 and 51 are held against bfc_tpu's run_device.
The input is a tests/datagen.py dataset: a 12 kb genome, 1,500 reads of
100 bp, 1% errors.  Tolerance: byte equality."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from bfc_tpu.models import device_pipeline as JDP
from bfc_tpu.models import pipeline as JP
from bfc_tpu.opts import Opts as JOpts

from . import datagen

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_e2e")
    genome = datagen.make_genome(12000, seed=31)
    reads = datagen.simulate_reads(genome, 1500, read_len=100,
                                   err_rate=0.01, seed=32)
    fq = f"{d}/reads.fq"
    datagen.write_fastq(fq, reads)
    return fq


def _port_cli(*args) -> bytes:
    # one intra-op thread: the plain versions' small ops lose to thread
    # start-up beside the suite's other workers, and the bytes do not change
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "bfc_tpu_torch", "--cpu", *args],
                       cwd=ROOT, env=env, capture_output=True, check=True)
    return r.stdout


def _jopts(k):
    o = JOpts()
    o.k = k
    o.bf_shift = 24
    return o


def test_cli_matches_run_device_k21(fastq):
    mine = _port_cli("-k21", "-b24", fastq)
    want = JDP.run_device(_jopts(21), fastq).encode()
    assert mine.count(b"\n") == 4 * 1500
    assert mine == want
    assert mine == JP.run(_jopts(21), fastq).encode()


def test_cli_device_finalize_matches_run_device(fastq, monkeypatch):
    """BFC_TPU_DEVICE_FINALIZE=1 in both packages: KJ, KF, KK and KL in
    the port, bfc_tpu's device finalize."""
    monkeypatch.setenv("BFC_TPU_DEVICE_FINALIZE", "1")
    mine = _port_cli("-k21", "-b24", fastq)
    assert mine.count(b"\n") == 4 * 1500
    assert mine == JDP.run_device(_jopts(21), fastq).encode()


@pytest.mark.parametrize("k", [33, 63])
def test_cli_matches_scalar_spec(fastq, k):
    """k = 33 is the default; at k = 63 bfc_tpu's run_device differs from
    its scalar spec (ROADMAP Queue 3), so only the spec is compared."""
    mine = _port_cli("-b24", *(["-k63"] if k == 63 else []), fastq)
    assert mine.count(b"\n") == 4 * 1500
    assert mine == JP.run(_jopts(k), fastq).encode()


@pytest.mark.parametrize("env", [("BFC_TPU_INC_ADJ", "1"),
                                 ("BFC_TPU_INC_ADJ", "0"),
                                 ("BFC_TPU_DEVICE_FINALIZE", "1")],
                         ids=["host-sketch", "kf", "device-finalize"])
@pytest.mark.parametrize("k", [21, 51])
def test_trim_matches_run_device(fastq, k, env, monkeypatch):
    monkeypatch.setenv(*env)
    mine = _port_cli("-1", f"-k{k}", "-b24", fastq)
    o = _jopts(k)
    o.filter_mode = True
    assert 0 < mine.count(b"\n") < 4 * 1500  # some reads are dropped
    assert mine == JDP.run_device(o, fastq).encode()
    assert mine == JP.run(o, fastq).encode()


def test_trim_k63_matches_scalar_spec(fastq):
    mine = _port_cli("-1", "-k63", "-b24", fastq)
    o = _jopts(63)
    o.filter_mode = True
    assert mine.count(b"\n") > 0
    assert mine == JP.run(o, fastq).encode()
