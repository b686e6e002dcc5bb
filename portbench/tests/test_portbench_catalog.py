"""BENCHMARK.json keeps to the benchmark's contract, everything it names
is found by name under portbench/, and a new cell, configuration, mix or
metric is added as files alone, in a copy."""

import json
import re

from portbench import harness
from portbench.catalog import Catalog

from portbench_tiny import CELL, REPO, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (REPO / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (REPO / "portbench/traffic" / f"{w['traffic']}.json").is_file()
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert (REPO / "portbench/metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_everything_named_is_found():
    cat = Catalog()
    for w in cat.bench["workloads"]:
        cfg = cat.config(w["config"])
        assert cfg["flags"] and cfg["genome"]["length"] > 0
        mix = cat.traffic(w["traffic"])
        assert mix["reads"] > 0 and mix["check_reads"] > 0
    for m in cat.bench["per_layer"]:
        mod = cat.metric_module(m["name"])
        assert callable(mod.read)
    for path in (REPO / "portbench/kernels").glob("*.json"):
        assert cat.kernel_names(path.stem)


def test_new_cell_as_files(tmp_path):
    """A later change adds a configuration, a mix, a metric and a cell by
    files and BENCHMARK.json entries; the harness finds and runs them."""
    root = tiny_root(tmp_path, ["-k", "17", "-b", "22"], reads=300)
    (root / "portbench/metrics/reads_per_job.py").write_text(
        '"""reads_per_job: input reads a job."""\n\n\n'
        "def read(w, tally):\n"
        "    return w.reads / len(w.jobs)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "reads_per_job", "unit": "reads",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "reads_per_s",
                               "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cat = Catalog(root)
    assert cat.config("tiny")["flags"] == ["-k", "17", "-b", "22"]
    assert cat.traffic("tinymix")["reads"] == 300
    assert "reads_per_job" in [m["name"] for m in cat.metrics(CELL, "per_layer")]
    res = harness.run_cell(cat, CELL, 5, 0.0, True, "cpu")
    assert res["correct"], res["check"]
    assert res["metrics"]["reads_per_job"]["value"] == 300.0
    assert set(res["metrics"]) >= {"count_s", "correct_s", "reads_per_job",
                                   "idle_pct"}
