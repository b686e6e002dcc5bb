"""A copy of the benchmark with one tiny cell added as files, as a later
change would add one: a configuration and a traffic mix of its own, and a
BENCHMARK.json entry.  The CPU tests run it with the kernels' plain
versions."""

import json
import shutil
from pathlib import Path

import torch

# one thread a test process: pytest's workers share the machine's cores,
# and the CPU kernels' thread pools slow each other down many times over
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny.tinymix"


def tiny_root(tmp: Path, flags, reads=600, genome=20000, length=(100, 100),
              check=None, env=None) -> Path:
    """tmp holding BENCHMARK.json and portbench/, with the cell CELL:
    `reads` reads of a `genome`-base genome under `flags`; the check
    compares every read's record unless `check` says fewer."""
    root = Path(tmp)
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = {"name": "tiny", "flags": list(flags),
           "env": env if env is not None else {"BFC_TPU_DEVICE_FINALIZE": "1"},
           "genome": {"length": genome, "repeat_fraction": 0.1,
                      "repeat_segment": 500}}
    (root / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    mix = {"reads": reads, "length": list(length), "revcomp": 0.5,
           "error_rate": 0.01, "qual_error": [2, 14], "qual_ok": [30, 39],
           "check_reads": check if check is not None else reads}
    (root / "portbench/traffic/tinymix.json").write_text(json.dumps(mix))
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "tiny",
                               "traffic": "tinymix", "chips": 1,
                               "why": "a test"})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
