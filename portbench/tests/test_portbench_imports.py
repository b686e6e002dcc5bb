"""Nothing the benchmark runs imports jax, jaxlib, flax or bfc_tpu (top-level
names compared whole: bfc_tpu_torch is not bfc_tpu), bench.py or the
chip_*.py tools; the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench_tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "bfc_tpu", "bench", "chip_smoke",
             "chip_ab", "chip_probe"}


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources():
    for path in (REPO / "portbench").rglob("*.py"):
        names = set(imported(path))
        assert not names & FORBIDDEN, path
        if "reference" in path.parts:
            assert "bfc_tpu_torch" not in names, path


SCRIPT = r"""
import json, sys, tempfile
from pathlib import Path
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
from portbench_tiny import CELL, tiny_root
from portbench import harness
from portbench.catalog import Catalog
root = tiny_root(Path(tempfile.mkdtemp()), ["-1", "-k", "31", "-b", "20"], reads=200)
res = harness.run_cell(Catalog(root), CELL, 1, 0.0, True, "cpu")
assert res["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_modules_of_a_run():
    code = SCRIPT.format(repo=str(REPO), tests=str(Path(__file__).parent))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd="/")
    assert p.returncode == 0, p.stderr[-3000:]
    import json

    names = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "bfc_tpu_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "bfc_tpu"}


def test_reference_alone():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.check, portbench.control, portbench.gen; "
            "print(sorted(m for m in sys.modules if m.startswith('bfc')))"
            % str(REPO))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd="/")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
