"""-R (refine) in the port against bfc_tpu, byte for byte.

`python -m bfc_tpu_torch --cpu -R reads.fq in.fq` counts reads.fq and
refines in.fq: KC and KD (their plain versions on the CPU) over the bases
that qualities of '!' to '&' carry, and the host bookkeeping of
models/refine.py around them.  It is held to bfc_tpu's scalar spec
(models/pipeline.run with refine_ec) over a first correction's output,
over mangled tags (every third dropped, a foreign one every seventh, as
tests/test_device_vs_reference.py builds them), over qualities of '!'
(base code 7, where bfc_tpu's run_device fails: ROADMAP Queue 3), over
odd tags, with KD overflowing into the scalar fallback and under
--mesh 2; and once to bfc_tpu's run_device.  parse_stats and the native
tag parser are held to bfc_tpu's parse_stats on odd tags.

The input is a tests/datagen.py dataset with 1% N bases: a 12 kb genome,
1,500 reads of 100 bp, 1% errors, k = 21, -b24.  Tolerance: byte
equality."""

import dataclasses
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bfc_tpu.models import device_pipeline as JDP
from bfc_tpu.models import pipeline as JP
from bfc_tpu.opts import Opts as JOpts
from bfc_tpu_torch.io import fast_reader as FR
from bfc_tpu_torch.models import corrector as TC
from bfc_tpu_torch.models import device_pipeline as TDP
from bfc_tpu_torch.models import pipeline as TP
from bfc_tpu_torch.models import refine as RF
from bfc_tpu_torch.opts import Opts

from . import datagen

ROOT = Path(__file__).resolve().parents[1]
K, BF = 21, 24


def _port_cli(*args) -> bytes:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "bfc_tpu_torch", "--cpu",
                        f"-k{K}", f"-b{BF}", "-R", *args],
                       cwd=ROOT, env=env, capture_output=True, check=True)
    return r.stdout


def _spec(fq: str, inp: str) -> bytes:
    o = JOpts()
    o.k, o.bf_shift, o.refine_ec = K, BF, True
    return JP.run(o, fq, inp).encode()


def _records(path: str):
    lines = Path(path).read_text().splitlines()
    return [lines[i:i + 4] for i in range(0, len(lines), 4)]


def _write(path, recs) -> str:
    Path(path).write_text("".join("\n".join(r) + "\n" for r in recs))
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_refine")
    genome = datagen.make_genome(12000, seed=41)
    reads = datagen.simulate_reads(genome, 1500, read_len=100,
                                   err_rate=0.01, n_rate=0.01, seed=42)
    fq = f"{d}/reads.fq"
    datagen.write_fastq(fq, reads)
    o = JOpts()
    o.k, o.bf_shift = K, BF
    corrected = f"{d}/corrected.fq"
    Path(corrected).write_text(JP.run(o, fq))
    recs = _records(corrected)
    mangled = []
    for i, (hdr, *rest) in enumerate(recs):
        name = hdr.split("\t")[0].split(" ")[0]
        if i % 3 == 0:
            hdr = name  # the ec:Z comment dropped
        elif i % 7 == 0:
            hdr = name + "\txx:Z:foo"
        mangled.append([hdr, *rest])
    rng = random.Random(5)
    bang = []
    for hdr, seq, plus, qual in _records(corrected):
        q = list(qual)
        if rng.random() < 0.3:  # '!' qualities under a foreign comment,
            for j in rng.sample(range(len(q)), rng.randint(1, 3)):
                q[j] = "!"   # so that the read is refined, not skipped
            hdr = hdr.split("\t")[0] + "\txx:Z:foo"
        bang.append([hdr, seq, plus, "".join(q)])
    return {"fq": fq, "corrected": corrected,
            "mangled": _write(f"{d}/mangled.fq", mangled),
            "bang": _write(f"{d}/bang.fq", bang), "dir": d}


def test_refine_matches_run_device_and_spec(data):
    """Over a first correction's output: skipped, refined, reverted and
    failed reads, against bfc_tpu's run_device (JAX on the CPU) and its
    scalar spec."""
    mine = _port_cli(data["fq"], data["corrected"])
    assert mine.count(b"\n") == 4 * 1500
    assert mine == _spec(data["fq"], data["corrected"])
    o = JOpts()
    o.k, o.bf_shift, o.refine_ec = K, BF, True
    assert mine == JDP.run_device(o, data["fq"],
                                  correct_fn=data["corrected"]).encode()
    tags = [ln.split(b"\t")[1] for ln in mine.split(b"\n")[::4] if ln]
    assert sum(t.endswith(b"_3") for t in tags) > 0  # refined


def test_refine_mangled_tags_across_batches(data):
    """Tagless records inherit the last comment and the carried stats,
    also across batches of 256 reads."""
    want = _spec(data["fq"], data["mangled"])
    assert _port_cli(data["fq"], data["mangled"]) == want
    assert _port_cli("--batch", "256", data["fq"], data["mangled"]) == want
    tags = [ln.split(b"\t")[1] for ln in want.split(b"\n")[::4] if ln]
    assert sum(t.endswith(b"_3") for t in tags) > 10  # refined
    assert sum(t.endswith(b"_2") for t in tags) > 10  # reverted


def test_refine_bang_quality_matches_spec(data):
    """A '!' quality substitutes base code 7, which the scalar model
    takes as an N (refmodel.seq_revcomp folds codes above 3 to 4): where
    the search puts a base there, its quality is '&' (34 + 4)."""
    mine = _port_cli(data["fq"], data["bang"])
    assert mine == _spec(data["fq"], data["bang"])
    out = mine.decode().splitlines()
    n_fixed = sum(1 for i, r in enumerate(_records(data["bang"]))
                  for j, q in enumerate(r[3])
                  if q == "!" and out[4 * i + 3][j] == "&")
    assert n_fixed > 50


def test_refine_scalar_fallback_matches_spec(data, monkeypatch):
    """KD with tiny caps overflows on many reads; the scalar model refines
    them (refmodel.ec1 with refine_ec) and the bookkeeping gives them the
    bytes of the others."""
    monkeypatch.setattr(TDP, "Corrector",
                        lambda opt, ds: TC.Corrector(opt, ds, 24, 120))
    opt = Opts()
    opt.k, opt.bf_shift, opt.refine_ec = K, BF, True
    report = {}
    mine = TDP.run_device(opt, data["fq"], correct_fn=data["mangled"],
                          device="cpu", report=report)
    assert mine.encode() == _spec(data["fq"], data["mangled"])
    assert report["n_fallback"] >= 5
    c = report["refine"]
    assert c["skipped"] + c["refined"] + c["reverted"] + c["failed"] == 1500
    assert c["skipped"] > 0 and c["refined"] > 0


def test_refine_mesh_matches_single_device(data):
    """--mesh 2 -R: each rank parses every tag of a batch and refines its
    half; rank 0 writes both halves."""
    want = _port_cli("--batch", "256", data["fq"], data["mangled"])
    assert _port_cli("--mesh", "2", "--batch", "256", data["fq"],
                     data["mangled"]) == want


ODD_TAGS = ["0_3:12_0_1:0_3", "0", "", "3", "0_1:2", "0_-5:60_1_2:1_0",
            "-0_1:2_3_4:5_6", "0_1:2_3_4:5_6:7_8_9", "0__:_:_", "x0_1",
            "0_99999999999999999999:70_0_0:0_1",
            "0_1:99999999999999999999999_1_70000:2_1",
            "0_000000000000000000000001:60_0_0:0_1", "7_1:2_3_4:5",
            "0_1:2_3_4:5_-", "0_1:2_3_4:-_5", "--1", "0_1-2:3_4_5_6"]


@pytest.mark.parametrize("tag", ODD_TAGS)
def test_parse_stats_matches_bfc_tpu(tag):
    """The port's parse_stats against bfc_tpu's (a lone '-' raises in
    both), and the native tag parser against both (refine.tag_cols)."""
    try:
        want = dataclasses.asdict(JP.parse_stats(tag))
    except ValueError:
        with pytest.raises(ValueError):
            TP.parse_stats(tag)
        return
    assert dataclasses.asdict(TP.parse_stats(tag)) == want


def test_native_tag_parser_matches_parse_stats(tmp_path):
    """fastx_parse_tags on every odd tag, as ec:Z comments and after other
    text, against refine.tag_cols (parse_stats); the rows it leaves to
    Python are those with a lone '-' or a number over 18 characters."""
    comments = [f"ec:Z:{t}" for t in ODD_TAGS] + ["xx:Z:foo", "ec:Z", ""]
    fq = tmp_path / "tags.fq"
    fq.write_text("".join(f"@r{i}\t{c}\nACGT\n+\nIIII\n"
                          for i, c in enumerate(comments)) + "@t\nA\n+\nI\n")
    rb = next(FR.iter_batches(str(fq), 64))
    assert rb._strings is None
    import ctypes

    from bfc_tpu_torch.native.build import get_lib

    cols = np.zeros((rb.n, RF.TAG_COLS), np.int64)
    p = ctypes.POINTER
    lib = get_lib()
    lib.fastx_parse_tags(
        rb.n, rb.buf,
        np.ascontiguousarray(rb.comm_off).ctypes.data_as(p(ctypes.c_int64)),
        np.ascontiguousarray(rb.comm_len).ctypes.data_as(p(ctypes.c_int32)),
        cols.ctypes.data_as(p(ctypes.c_int64)))
    n_odd = 0
    for i, c in enumerate(comments):
        if cols[i, RF.ODD]:
            n_odd += 1
            continue
        want = RF.tag_cols(c)
        got = cols[i].copy()
        for col, mask in ((RF.BRUTE, 1), (RF.N_EC, 0x3FFF),
                          (RF.N_EC_HIGH, 0x3FFF)):
            got[col] &= mask
        assert got.tolist() == want.tolist(), c
    assert n_odd == 6
    assert cols[-1].tolist() == [0] * RF.TAG_COLS  # no comment


def test_refine_odd_tags_match_spec(data):
    """Odd tags end to end: a negative n_absent (a revert fastx_format
    cannot print: that batch goes through format_corrected), numbers of
    20 digits, a header with an empty comment, tags without their
    numbers."""
    recs = _records(data["corrected"])
    odd = [t for t in ODD_TAGS if "-" not in t.replace("_-5", "")] + [None]
    out = []
    for i, (hdr, *rest) in enumerate(recs):
        name = hdr.split("\t")[0]
        if i % 5 == 0:
            t = odd[(i // 5) % len(odd)]
            hdr = name + ("\t" if t is None else f"\tec:Z:{t}")
        out.append([hdr, *rest])
    inp = _write(Path(data["dir"]) / "odd.fq", out)
    mine = _port_cli("--batch", "300", data["fq"], inp)
    assert mine == _spec(data["fq"], inp)
    assert b"ec:Z:0_-5:60_1_2:1_2" in mine  # the revert's original stats
