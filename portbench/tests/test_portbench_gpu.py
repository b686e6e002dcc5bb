"""On the card: a small cell of each path through the harness as run.py
runs it, and the control.  Skips without a card."""

import pytest

from portbench import control, harness
from portbench.catalog import Catalog

from portbench_tiny import CELL, tiny_root


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [["-s", "5m"], ["-1", "-k", "51"]],
                         ids=["correct", "trim"])
def test_small_cell_on_the_card(card, tmp_path, flags):
    cat = Catalog(tiny_root(tmp_path, flags, reads=20000, genome=200000,
                            check=300))
    for trace in (False, True):
        res = harness.run_cell(cat, CELL, 12345, 0.5, trace, "cuda")
        assert res["correct"], res["check"]
        assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    # a filter small enough for false positives at this read count: the
    # cells' own 2^30 and 2^33 bits hold 20,000 reads' k-mers without one
    small = Catalog(tiny_root(tmp_path / "control", flags + ["-b", "18"],
                              reads=20000, genome=200000, check=300))
    assert control.control(small, CELL, 12345, "cuda")["correct"] is False
