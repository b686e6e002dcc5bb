"""The control, the reference without the Bloom filter's false positives
in the program's place, comes out not correct; the reference in the
program's place comes out correct."""

import pytest

from portbench import control
from portbench.catalog import Catalog

from portbench_tiny import CELL, tiny_root


@pytest.mark.parametrize("flags,number", [
    (["-k", "17", "-b", "14"], "table_entries_wrong"),
    (["-1", "-k", "31", "-b", "14"], "bloom_bits_wrong"),
], ids=["correct", "trim"])
def test_control_fails(tmp_path, flags, number):
    cat = Catalog(tiny_root(tmp_path, flags, reads=400, check=100))
    out = control.control(cat, CELL, 77, "cpu")
    assert out["correct"] is False
    assert out["check"][number]["value"] > 0
