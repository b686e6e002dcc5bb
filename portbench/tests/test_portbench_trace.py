"""The traced run's reading of a profiler trace: only the job spans
count, busy time is the union of device operations, and each idle gap
is named by the benchmark's span open in it."""

import pytest

from portbench import devtrace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev("portbench.job", "user_annotation", 100, 1000),
    ev("portbench.count", "user_annotation", 100, 400),
    ev("portbench.correct", "user_annotation", 500, 600),
    ev("void ka_kernel<23>(long*, int)", "kernel", 150, 100),
    ev("void ka_kernel<23>(long*, int)", "kernel", 200, 100),   # overlaps
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 320, 30),
    ev("kd_kernel(int*)", "kernel", 700, 200),
    ev("kd_kernel(int*)", "kernel", 1050, 200),                 # past the job
    ev("portbench.job", "user_annotation", 2000, 100),
    ev("vd_count_kernel<unsigned int>(int)", "kernel", 2010, 50),
    ev("cudaLaunchKernel", "cuda_runtime", 150, 5),
]


def test_busy_window_and_kernels():
    t = devtrace.read_events(EVENTS)
    assert t.window_s == pytest.approx(1100e-6)
    # ka 150-300, memcpy 320-350, kd 700-900 and 1050-1100, vd 2010-2060
    assert t.busy_s == pytest.approx((150 + 30 + 200 + 50 + 50) * 1e-6)
    assert devtrace.kernel_seconds(t, [r"\bka_kernel\b"]) == pytest.approx(200e-6)
    assert devtrace.kernel_seconds(t, [r"\bkd_kernel\b"]) == pytest.approx(250e-6)
    assert devtrace.kernel_seconds(t, [r"\bkc_kernel\b"]) is None
    assert devtrace.kernel_seconds(None, [r"\bka_kernel\b"]) is None
    names = dict(t.device_ops)
    assert names["ka_kernel"] == pytest.approx(200e-6)
    assert "Memcpy HtoD (Pageable -> Device)" in names


def test_idle_gaps_by_span():
    t = devtrace.read_events(EVENTS)
    gaps = sorted(t.gaps, key=lambda g: -g[1])
    # 350-700 (count then correct: its middle, 525, is in correct),
    # 900-1050 correct, 100-150 count, 300-320 count, 2060-2100, 2000-2010
    assert gaps[0] == ("correct", pytest.approx(350e-6))
    assert gaps[1] == ("correct", pytest.approx(150e-6))
    assert ("count", pytest.approx(50e-6)) in gaps
    assert ("job", pytest.approx(40e-6)) in gaps
    assert sum(g for _, g in t.gaps) == pytest.approx(t.window_s - t.busy_s)
    b = devtrace.breakdown(t, top=2)
    assert [k for k, _ in b["idle_gaps"]] == ["correct", "correct"]
    assert len(b["device_ops"]) == 2


def test_short_names():
    assert devtrace.short_name("void ka_kernel<23, (bool)1>(long*, int)") == "ka_kernel"
    assert devtrace.short_name("at::native::vectorized_elementwise_kernel<4>(int)") == \
        "at::native::vectorized_elementwise_kernel"
