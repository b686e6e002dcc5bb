"""The result line keeps to the contract: exactly its keys, the check's
numbers last, each beside its limit on standard error's last lines; and
a run without a card prints no result."""

import json
import os
import shutil
import subprocess
import sys

from portbench import harness

from portbench_tiny import CELL, REPO, tiny_root

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def test_lines_of_a_run(tmp_path):
    root = tiny_root(tmp_path, ["-1", "-k", "31", "-b", "22"], reads=400)
    from portbench.catalog import Catalog

    for trace in (False, True):
        res = harness.run_cell(Catalog(root), CELL, 3, 0.0, trace, "cpu")
        err, line = harness.result_lines(res, CELL, 3)
        out = json.loads(line)
        assert line.endswith("\n") and "\n" not in line[:-1]
        assert set(out) - {"breakdown", "check"} == KEYS
        assert list(out)[-1] == "check"
        assert out["correct"] is True and out["failed"] == 0
        assert out["attempted"] >= 1
        assert set(out["device"]) >= {"platform", "kind", "count",
                                      "memory_peak_bytes"}
        for m in out["metrics"].values():
            assert set(m) == {"value", "unit"}
        if trace:
            assert set(out["metrics"]) == {"count_s", "trim_s", "idle_pct",
                                           "launches_per_mread"}
            assert set(out["device"]) >= {"busy_s", "window_s"}
            assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert set(out["metrics"]) == {"reads_per_s", "peak_dev_gib",
                                           "setup_s"}
        tail = err.splitlines()[-len(out["check"]):]
        for (name, v), text in zip(out["check"].items(), tail):
            assert text == f"check {name} {v['value']} limit {v['limit']}"


def test_no_card_no_result(capsys):
    # this machine has no CUDA card
    assert harness.main(["--workload", "ecoli_s5m_dfin.hiseq100_3m",
                         "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_only_the_benchmark_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/ gives no
    result (here also for want of a card)."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "trim_k51.hiseq100_3m", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
