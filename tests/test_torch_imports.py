"""The port imports torch, numpy and the standard library only.

Parses every module of bfc_tpu_torch/, chip_smoke.py, chip_probe.py and
chip_ab.py and fails on an import of jax or of the JAX package bfc_tpu (module names
matched exactly: bfc_tpu_torch shares the prefix)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "bfc_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_probe.py", ROOT / "chip_ab.py"]
FORBIDDEN = ("jax", "bfc_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_bfc_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported(tree) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_matcher_is_exact():
    assert _forbidden("jax.numpy") and _forbidden("bfc_tpu.ops.kmer")
    assert not _forbidden("bfc_tpu_torch.ops.kmer")
    assert not _forbidden("jaxlib_like_name")
