"""The check fails a run whose timed path is broken underneath: the
harness runs on the CPU (the kernels' plain versions), skipping only its
look for a card, with each fault a cell can have planted in the program
for the whole run.  One card runs no exchange between chips, so that
fault has no cell here."""

import pytest
import torch

from portbench import harness
from portbench.catalog import Catalog
from portbench.measure import Hooks

from portbench_tiny import CELL, tiny_root

CORRECT = ["-k", "17", "-b", "22"]
TRIM = ["-1", "-k", "31", "-b", "22"]


def unchanged_reads(args, kwargs, out):
    """KD hands back every read as it came: final base = input base, no
    base marked changed (packed: base | diff << 3 | q << 4 | input << 5)."""
    packed, res = out
    return (packed & 0xF0) | ((packed >> 5) & 7), res


def altered_base(args, kwargs, out):
    """One base of the first read of each batch altered where KD makes it."""
    packed, res = out
    packed = packed.clone()
    packed[0, 0] = (packed[0, 0] & 0xF8) | (((packed[0, 0] & 7) + 1) & 3)
    return packed, res


def dropped_entry(args, kwargs, out):
    """KL's table loses one entry: its first occupied slot emptied."""
    table, ok = out
    table = table.clone()
    table[torch.nonzero(table & 0x3FFF)[0]] = 0
    return table, ok


def empty_filter(args, kwargs, out):
    """KG returns the filter as it found it: empty."""
    return torch.zeros_like(out)


def shorter_streaks(args, kwargs, out):
    """KH's answer altered: every streak one k-mer shorter."""
    return torch.where(out >= (1 << 32), out - (1 << 32), out)


def half_batch(orig):
    """The counting sees only the first half of each batch's reads (the
    rows past a batch's reads are padding)."""
    def add(self, bases, qok, lens):
        lens = lens.copy()
        lens[int((lens > 0).sum()) // 2:] = 0
        return orig(self, bases, qok, lens)
    return add


def run(tmp_path, flags, patches=()):
    root = tiny_root(tmp_path, flags, reads=500)
    hooks = Hooks()
    try:
        for target, fn in patches:
            owner, name = Hooks._owner(target)
            orig = getattr(owner, name)
            if fn is half_batch:
                setattr(owner, name, half_batch(orig))
                hooks._saved.append((owner, name, orig))
            else:
                def wrapped(*a, _orig=orig, _fn=fn, **k):
                    return _fn(a, k, _orig(*a, **k))
                setattr(owner, name, wrapped)
                hooks._saved.append((owner, name, orig))
        return harness.run_cell(Catalog(root), CELL, 21, 0.0, False, "cpu")
    finally:
        hooks.restore()


KD = "bfc_tpu_torch.ops.search:ec1_search"
ADD = "bfc_tpu_torch.models.counter:AggBuilder.add"


@pytest.mark.parametrize("flags", [CORRECT, TRIM], ids=["correct", "trim"])
def test_sound_run_is_correct(tmp_path, flags):
    res = run(tmp_path, flags)
    assert res["correct"] and all(v["value"] == 0 for v in res["check"].values())


@pytest.mark.parametrize("flags,patches,number", [
    (CORRECT, [(KD, unchanged_reads)], "records_wrong"),
    (CORRECT, [(ADD, half_batch)], "table_entries_wrong"),
    (CORRECT, [(KD, altered_base)], "records_wrong"),
    (CORRECT, [("bfc_tpu_torch.ops.spectrum:cuckoo_build", dropped_entry)],
     "table_entries_wrong"),
    (TRIM, [("bfc_tpu_torch.models.trimmer:bloom_build", empty_filter)],
     "bloom_bits_wrong"),
    (TRIM, [(ADD, half_batch)], "bloom_bits_wrong"),
    (TRIM, [("bfc_tpu_torch.models.trimmer:max_streak_batch",
             shorter_streaks)], "records_wrong"),
], ids=["correct-unchanged", "correct-half-batch", "correct-altered",
        "correct-table-entry", "trim-unchanged", "trim-half-batch", "trim-altered"])
def test_fault_is_caught(tmp_path, flags, patches, number):
    res = run(tmp_path, flags, patches)
    assert not res["correct"]
    assert res["failed"] == res["attempted"]
    assert res["check"][number]["value"] > res["check"][number]["limit"]
