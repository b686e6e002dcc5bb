"""The port's tools against bfc_tpu's: hash2cnt on a dump the port wrote
(python -m bfc_tpu_torch --cpu -E -d, k = 17) with -s, -h, -m 2 and -d 1,
and its refusal of k = 41; errstat on SAM files written here, one file
and two.  Tolerance: byte equality of stdout, and the same exit code
and message."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from bfc_tpu.tools import errstat as JE
from bfc_tpu.tools import hash2cnt as JH
from bfc_tpu_torch.tools import errstat as TE
from bfc_tpu_torch.tools import hash2cnt as TH

from . import datagen

ROOT = Path(__file__).resolve().parents[1]


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_tools")
    fq = datagen.standard_dataset(str(d), genome_len=2000, n_reads=500)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = {}
    for k in (17, 41):
        out[k] = str(d / f"k{k}.dump")
        subprocess.run([sys.executable, "-m", "bfc_tpu_torch", "--cpu",
                        f"-k{k}", "-b20", "-E", "-d", out[k], fq], cwd=ROOT,
                       env=env, capture_output=True, check=True)
    return out


@pytest.mark.parametrize("flags", [[], ["-s"], ["-h"], ["-m", "2"],
                                   ["-d", "1"]],
                         ids=["all", "sizes", "hist", "min-count",
                              "min-high"])
def test_hash2cnt_matches_bfc_tpu(dumps, flags, capsys):
    got = _run(TH.main, [*flags, dumps[17]], capsys)
    want = _run(JH.main, [*flags, dumps[17]], capsys)
    assert got == want and got[0] == 0 and got[1].count("\n") > 20


def test_hash2cnt_refuses_k41_as_bfc_tpu(dumps):
    """As `python -m` runs the tools."""
    got, want = (subprocess.run(
        [sys.executable, "-m", f"{pkg}.tools.hash2cnt", dumps[41]], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True)
        for pkg in ("bfc_tpu_torch", "bfc_tpu"))
    assert (got.returncode, got.stdout, got.stderr) == (
        want.returncode, want.stdout, want.stderr)
    assert got.returncode == 1 and b"over 37" in got.stderr


SAM1 = """@SQ\tSN:ref\tLN:10000
r1\t0\tref\t100\t60\t100M\t*\t0\t0\t*\t*\tNM:i:0
r2\t0\tref\t200\t60\t90M10S\t*\t0\t0\t*\t*\tNM:i:2
r3\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*
r4\t0\tref\t300\t60\t50M\t*\t0\t0\t*\t*\tNM:i:1
r4\t2048\tref\t900\t60\t50M\t*\t0\t0\t*\t*\tNM:i:0
r5\t64\tref\t10\t60\t5S95M\t*\t0\t0\t*\t*\tNM:i:3
r5\t128\tref\t400\t60\t100M\t*\t0\t0\t*\t*\tNM:i:0
"""

SAM2 = """@SQ\tSN:ref\tLN:10000
r1\t0\tref\t100\t60\t100M\t*\t0\t0\t*\t*\tNM:i:1
r2\t0\tref\t200\t60\t90M10S\t*\t0\t0\t*\t*\tNM:i:0
r3\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*
r4\t0\tref\t300\t60\t50M\t*\t0\t0\t*\t*\tNM:i:1
r4\t2048\tref\t900\t60\t50M\t*\t0\t0\t*\t*\tNM:i:0
r5\t64\tref\t10\t60\t100M\t*\t0\t0\t*\t*\tNM:i:0
r5\t128\tref\t400\t60\t98M2S\t*\t0\t0\t*\t*\tNM:i:1
"""
# a read the first file lacks, which skip_missing passes over
SAM2_EXTRA = SAM2.replace(
    "r3\t4", "r2b\t0\tref\t50\t60\t100M\t*\t0\t0\t*\t*\tNM:i:0\nr3\t4")


@pytest.mark.parametrize("files", [[SAM1], [SAM1, SAM2], [SAM2, SAM1],
                                   [SAM1, SAM2_EXTRA, "1"]],
                         ids=["one", "two", "two-swapped", "skip-missing"])
def test_errstat_matches_bfc_tpu(tmp_path, files, capsys):
    argv = []
    for i, text in enumerate(files):
        if text == "1":
            argv.append(text)
            continue
        p = tmp_path / f"f{i}.sam"
        p.write_text(text)
        argv.append(str(p))
    got = _run(TE.main, argv, capsys)
    want = _run(JE.main, argv, capsys)
    assert got == want and "# reads:             6" in got[1]
    if len(files) > 1:
        assert "# better reads:" in got[1] and got[1][0] in "12"
