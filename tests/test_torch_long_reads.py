"""Reads longer than 504 bp end to end: the port against bfc_tpu.

bfc_tpu sends a batch whose reads pass 504 bp to its scalar path
(bfc_tpu/models/corrector.py:917-922); the port sends every read to KC
and KD (their plain versions here), whose only limit is KD's stack.
Two sets: the first 150 reads of the 600 bp set of
tests/test_fallback_paths.py (an 8 kb genome, seed 91; reads of seed 92;
a half for the file's time, ~11x coverage) and a mixed set of 100-1,300
bp reads (a 6 kb genome, seed 93), whose lengths cross the reader's
max_len of 512 and 1,024 in mid-file and end mid-chunk (505, 513,
1,025, ...), with a few Ns.

The native reader must give every read of the mixed set, as the text
parser does: a record longer than max_len that follows others in the
last block of the text ended the stream there (bfc_tpu's reader, of
which the port's is a copy, still does so, so bfc_tpu's run_device
corrects the mixed set's first two reads only).  Then on each set
`python -m bfc_tpu_torch --cpu -k21 -b24` must be byte-identical to
bfc_tpu and to the port's scalar spec (models/pipeline.run, as --scalar runs it), with the
host finalize and with the device finalize; so must `-1 -k51 -b24`,
`-R` over the port's own output with every fifth tag foreign (so
that those reads are refined), and `--mesh 2` (two gloo ranks).  bfc_tpu is
its run_device on JAX-CPU for the 600 bp set and its scalar pipeline
(bfc_tpu/models/pipeline.py, the text parser) for the mixed set.  Both
run_devices count in 256-read batches here (--mesh 2 at the CLI's
default), as their defaults of 8,192 and 16,384 reads pad a batch of
these sets to millions of slots of the plain versions on the CPU; the
arrivals keep stream order, so no output byte depends on it.  The port's
runs are started together, beside bfc_tpu's.  Tolerance: byte equality."""

import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from bfc_tpu.models import counter as JC
from bfc_tpu.models import device_pipeline as JDP
from bfc_tpu.models import pipeline as JP
from bfc_tpu.opts import Opts as JOpts
from bfc_tpu_torch.io import fast_reader as FR
from bfc_tpu_torch.io import fastq as TQ

from . import datagen

ROOT = Path(__file__).resolve().parents[1]
K, BF, TRIM_K = 21, 24, 51
MIXED_LENS = (505, 511, 512, 513, 600, 1023, 1024, 1025, 1300, 100)
CORRECT = (f"-k{K}", f"-b{BF}")
COUNT_BATCH = 256
# `python -m bfc_tpu_torch` with run_device counting in COUNT_BATCH reads
SMALL_BATCH = (
    "import functools, runpy\n"
    "from bfc_tpu_torch.models import device_pipeline as DP\n"
    "DP.run_device = functools.partial(DP.run_device, "
    f"count_batch_reads={COUNT_BATCH})\n"
    "runpy.run_module('bfc_tpu_torch', run_name='__main__', alter_sys=True)")


def _start(*args, env=()) -> subprocess.Popen:
    """`python -m bfc_tpu_torch --cpu *args` (counting in COUNT_BATCH
    reads unless it is a --mesh run), started; _out waits."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               **dict(env))
    run = ["-m", "bfc_tpu_torch"] if "--mesh" in args else ["-c", SMALL_BATCH]
    return subprocess.Popen([sys.executable, *run, "--cpu", *args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def _out(p: subprocess.Popen) -> bytes:
    out, err = p.communicate()
    assert p.returncode == 0, err.decode()[-2000:]
    return out


def _opts(O, k=K, trim=False, refine=False):
    o = O()
    o.k, o.bf_shift, o.filter_mode, o.refine_ec = k, BF, trim, refine
    return o


def _mixed_reads():
    """100-1,300 bp reads, the lengths of MIXED_LENS among them, shuffled,
    with Ns at 0.2% of the bases."""
    genome = datagen.make_genome(6000, seed=93)
    rng = random.Random(94)
    lens = list(MIXED_LENS) + [rng.randint(100, 1300) for _ in range(70)]
    rng.shuffle(lens)
    return [datagen.simulate_reads(genome, 1, read_len=n, err_rate=0.01,
                                   n_rate=0.002, seed=1000 + i)[0]
            for i, n in enumerate(lens)]


def _foreign_tags(src: bytes, dst: Path) -> str:
    """src with every fifth record's comment replaced by a foreign tag, so
    that -R refines those reads instead of skipping them (a record with
    no comment would inherit the one before it)."""
    lines = src.decode().splitlines()
    for i in range(0, len(lines), 20):
        lines[i] = lines[i].split("\t")[0] + "\txx:Z:foo"
    dst.write_text("".join(ln + "\n" for ln in lines))
    return str(dst)


def _bfc_tpu(name: str, fq: str, refine_in: str):
    """bfc_tpu's correction, -1 and -R outputs: run_device on JAX-CPU
    counting in COUNT_BATCH reads (600bp), its scalar pipeline (mixed)."""
    if name == "mixed":
        return {"correct": JP.run(_opts(JOpts), fq),
                "trim": JP.run(_opts(JOpts, TRIM_K, trim=True), fq),
                "refine": JP.run(_opts(JOpts, refine=True), fq, refine_in)}
    count = JC.count_batches_aggregate
    mp = pytest.MonkeyPatch()
    mp.setattr(JC, "count_batches_aggregate",
               lambda fn, opt, **kw: count(fn, opt, batch_reads=COUNT_BATCH))
    try:
        return {"correct": JDP.run_device(_opts(JOpts), fq),
                "trim": JDP.run_device(_opts(JOpts, TRIM_K, trim=True), fq),
                "refine": JDP.run_device(_opts(JOpts, refine=True), fq,
                                         correct_fn=refine_in)}
    finally:
        mp.undo()


@pytest.fixture(scope="module", params=["600bp", "mixed"])
def data(request, tmp_path_factory):
    """A set; the port's CLI outputs (correction with each finalize, -1,
    -R over its own correction, --mesh 2) and its scalar spec's
    (--scalar: models/pipeline.run), run together; bfc_tpu's."""
    d = tmp_path_factory.mktemp(f"long_{request.param}")
    if request.param == "600bp":
        genome = datagen.make_genome(8000, seed=91)
        reads = datagen.simulate_reads(genome, 150, read_len=600,
                                       err_rate=0.01, seed=92)
    else:
        reads = _mixed_reads()
    fq = str(d / "reads.fq")
    datagen.write_fastq(fq, reads)
    runs = {"correct": _start(*CORRECT, fq),
            "device": _start(*CORRECT, fq,
                             env={"BFC_TPU_DEVICE_FINALIZE": "1"}),
            "trim": _start("-1", f"-k{TRIM_K}", f"-b{BF}", fq),
            "mesh": _start("--mesh", "2", *CORRECT, fq),
            "spec_correct": _start("--scalar", *CORRECT, fq),
            "spec_trim": _start("--scalar", "-1", f"-k{TRIM_K}", f"-b{BF}",
                                fq)}
    port = {"correct": _out(runs.pop("correct"))}
    refine_in = _foreign_tags(port["correct"], d / "refine_in.fq")
    runs["refine"] = _start(*CORRECT, "-R", fq, refine_in)
    runs["spec_refine"] = _start("--scalar", *CORRECT, "-R", fq, refine_in)
    want = {m: out.encode() for m, out in
            _bfc_tpu(request.param, fq, refine_in).items()}
    port.update((m, _out(p)) for m, p in runs.items())
    return {"name": request.param, "fq": fq, "n": len(reads),
            "refine_in": refine_in,
            "port": port, "bfc_tpu": want}


def test_reader_gives_every_read_of_the_mixed_set(tmp_path, monkeypatch):
    """The native reader's batches hold the text parser's reads, in
    order, whether the over-long records fall in the text's last block
    (4 MiB blocks) or in earlier ones (blocks of 5,000 bytes); the
    batches widen from 512 to 1,024 and 2,048 slots."""
    fq = str(tmp_path / "mixed.fq")
    datagen.write_fastq(fq, _mixed_reads())
    want = [r.seq.upper() for r in TQ.read_fastx(fq)]
    assert len(want) == 80 and {505, 513, 1025} <= {len(s) for s in want}
    for block in (FR._BLOCK, 5000):
        monkeypatch.setattr(FR, "_BLOCK", block)
        got, widths = [], set()
        for rb in FR.iter_batches(fq, 16):
            widths.add(rb.bases.shape[1])
            got += [bytes(b"ACGTN"[c] for c in rb.bases[i, :rb.lens[i]])
                    .decode() for i in range(rb.n)]
        assert got == want, block
        assert widths == {1024, 2048}, block


def test_correction_matches_bfc_tpu_and_spec(data):
    got = data["port"]["correct"]
    assert got.count(b"\n") == 4 * data["n"]
    assert got == data["bfc_tpu"]["correct"]
    assert got == data["port"]["spec_correct"]
    tags = [ln.split(b"\t")[1] for ln in got.split(b"\n")[::4] if ln]
    assert sum(t.startswith(b"ec:Z:0_") and not t.endswith(b":0_0")
               for t in tags) > 10  # reads that were corrected


def test_device_finalize_matches_bfc_tpu(data):
    assert data["port"]["device"] == data["bfc_tpu"]["correct"]


def test_trim_matches_bfc_tpu_and_spec(data):
    """Every read of the 600 bp set holds an error within 90% of its
    length, so -1 drops them all."""
    got = data["port"]["trim"]
    assert got.count(b"\n") < 4 * data["n"]
    assert (got != b"") == (data["name"] == "mixed")
    assert got == data["bfc_tpu"]["trim"]
    assert got == data["port"]["spec_trim"]


def test_refine_matches_bfc_tpu_and_spec(data):
    got = data["port"]["refine"]
    assert got.count(b"\n") == 4 * data["n"]
    assert got == data["bfc_tpu"]["refine"]
    assert got == data["port"]["spec_refine"]
    tags = [ln.split(b"\t")[1] for ln in got.split(b"\n")[::4] if ln]
    # refined: most of the reads with a foreign tag
    assert sum(t.endswith(b"_3") for t in tags) > data["n"] // 10


def test_mesh_matches_bfc_tpu(data):
    assert data["port"]["mesh"] == data["bfc_tpu"]["correct"]
