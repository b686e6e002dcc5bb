"""Each kernel's byte model gives the bytes worked out by hand at a
small shape, and a roofline share is the least time those bytes (or
operations) take at the card's peaks over the kernel's traced time."""

from types import SimpleNamespace

import pytest
import torch

from portbench import devtrace, measure
from portbench.catalog import Catalog

CAT = Catalog()
PEAKS = {"hbm_bytes_per_s": 1e12, "int32_ops_per_s": 1e15}
B, L = 4, 32
LENS = torch.tensor([32, 20, 10, 0], dtype=torch.int32)   # k = 17: 16 + 4 k-mers


def hook(metric):
    tally = {}
    (fn,) = CAT.metric_module(metric).hooks(tally).values()
    return fn, tally


def window(kernel_name, seconds, jobs=()):
    trace = devtrace.Trace(1.0, 0.5, [], [], {kernel_name: seconds})
    return measure.Window(list(jobs), trace, PEAKS, CAT.kernel_names)


def test_ka():
    fn, tally = hook("ka_roofline_pct")
    bases = torch.zeros((B, L), dtype=torch.uint8)
    fn((bases, bases.bool(), LENS, 17, 20, 0, False), {}, (bases, bases, bases, None))
    assert measure.number(tally["bytes"]) == 4 * 32 * 2 + 4 * 4 + 4 * 32 * 8 * 3
    assert measure.number(tally["kmers"]) == 20
    fn((bases, bases.bool(), LENS, 17, 20, 0, True), {}, (bases,) * 4)
    assert measure.number(tally["bytes"]) == 3344 + 4 * 32 * 2 + 4 * 4 + 4 * 32 * 8 * 4
    w = window("void ka_kernel<17>(long*)", 1e-6)
    share = CAT.metric_module("ka_roofline_pct").read(w, tally)
    assert share == pytest.approx(100 * (3344 + 4368) / 1e12 / 1e-6)


def test_kc():
    fn, tally = hook("kc_roofline_pct")
    bases = torch.zeros((B, L), dtype=torch.uint8)
    fn((SimpleNamespace(k=17), bases, LENS, 3), {}, None)
    assert measure.number(tally["bytes"]) == 4 * 32 * 7 + 4 * 16
    assert measure.number(tally["probes"]) == 20
    w = window("kc_kernel(int)", 2e-6)
    assert CAT.metric_module("kc_roofline_pct").read(w, tally) == \
        pytest.approx(100 * (960 + 20 * 32) / 1e12 / 2e-6)


def test_kd():
    fn, tally = hook("kd_roofline_pct")
    bases = torch.zeros((B, L), dtype=torch.uint8)
    res = torch.zeros((B, 8), dtype=torch.int32)
    res[:, 7] = torch.tensor([5, 0, 11, 4])       # the PROBES column
    fn((None, None, 0, bases), {}, (bases, res))
    assert measure.number(tally["bytes"]) == 4 * 32 * 5 + 4 * (16 + 4 * 8)
    assert measure.number(tally["probes"]) == 20
    w = window("kd_kernel(int)", 1e-6)
    assert CAT.metric_module("kd_roofline_pct").read(w, tally) == \
        pytest.approx(100 * (832 + 20 * 64) / 1e12 / 1e-6)


def test_kh():
    fn, tally = hook("kh_roofline_pct")
    bases = torch.zeros((B, L), dtype=torch.uint8)
    fn((None, bases, LENS, 17, 22, 4), {}, None)
    assert measure.number(tally["bytes"]) == 4 * (32 + 4 + 8)
    assert measure.number(tally["kmers"]) == 20
    w = window("kh_kernel(int)", 1e-6)
    assert CAT.metric_module("kh_roofline_pct").read(w, tally) == \
        pytest.approx(100 * (176 + 20 * 64) / 1e12 / 1e-6)


def test_kf_ki_kl():
    jobs = [{"reads": 10, "launches": 3,
             "report": {"verdict": "KF", "n_aggregated": 1000, "n_kept": 100,
                        "c_bits": 10}}] * 2
    w = window("void vd_scatter_kernel<unsigned int>(int)", 1e-6, jobs)
    kf = CAT.metric_module("kf_roofline_pct").read(w, {})
    assert kf == pytest.approx(100 * 2 * 1000 * 18 / 1e12 / 1e-6)
    kl = CAT.metric_module("kl_roofline_pct").read(
        window("void ck_build_kernel<1>(int)", 1e-6, jobs), {})
    assert kl == pytest.approx(100 * 2 * (100 * 20 + 8 * 1024) / 1e12 / 1e-6)
    jobs_ki = [{"reads": 10, "launches": 3,
                "report": {"verdict": "KI", "n_aggregated": 1000}}]
    ki = CAT.metric_module("kf_roofline_pct").read(
        window("vd_gather_kernel(int)", 1e-6, jobs_ki), {})
    assert ki == pytest.approx(100 * 1000 * 17 / 1e12 / 1e-6)


def test_operations_bound_where_larger():
    w = measure.Window([], devtrace.Trace(1, 1, [], [], {"kd_kernel": 1.0}),
                       {"hbm_bytes_per_s": 1e12, "int32_ops_per_s": 1e6},
                       CAT.kernel_names)
    assert w.roofline_pct("KD", 10.0, 5e5) == pytest.approx(50.0)


def test_silent_without_trace_or_peaks():
    fn, tally = hook("kc_roofline_pct")
    assert CAT.metric_module("kc_roofline_pct").read(
        measure.Window([], None, PEAKS, CAT.kernel_names), tally) is None
    w = measure.Window([], devtrace.Trace(1, 1, [], [], {"kc_kernel": 1.0}),
                       None, CAT.kernel_names)
    assert w.roofline_pct("KC", 10.0, 10.0) is None


def test_counts_and_spans():
    jobs = [{"reads": 1000, "launches": 30,
             "report": {"count_s": 1.0, "correct_s": 3.0, "n_fallback": 2}},
            {"reads": 1000, "launches": 34,
             "report": {"count_s": 2.0, "correct_s": 5.0, "n_fallback": 0}}]
    w = measure.Window(jobs, devtrace.Trace(4.0, 1.0, [], [], {}), None,
                       CAT.kernel_names)
    read = lambda m: CAT.metric_module(m).read(w, {})
    assert read("count_s") == 1.5 and read("correct_s") == 4.0
    assert read("fallback_per_mread") == 1000.0
    assert read("launches_per_mread") == 32000.0
    assert read("idle_pct") == 75.0
    assert read("trim_s") is None


def test_peaks_table():
    p = CAT.peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert p["int32_ops_per_s"] == 64 * 132 * 1.98e9
    assert CAT.peaks("a card with no table") is None
