"""The traced slice's arithmetic on a synthetic trace: the union of the
device's intervals, the idle share, the gaps by the harness's span, the
top operations."""
import pytest

from kbench import trace


def ev(name, cat, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


EVENTS = [
    ev("kbench.slice", "user_annotation", 0, 100),
    ev("kbench.open", "user_annotation", 0, 20),
    ev("kbench.dispatch", "user_annotation", 20, 10),
    ev("kbench.to_host", "user_annotation", 30, 70),
    ev("kernel_a", "kernel", 10, 30),          # 10..40
    ev("kernel_b", "kernel", 20, 30),          # 20..50, overlaps a
    ev("Memcpy DtoH", "gpu_memcpy", 60, 20),   # 60..80
    ev("kernel_a", "kernel", 90, 20),          # 90..110, cut at 100
    ev("kernel_c", "kernel", 200, 5),          # outside the slice
    ev("aten::add", "cpu_op", 0, 100),         # host work: not device
    {"ph": "i", "name": "marker", "ts": 5},
]


def test_parse_keeps_the_slice_and_the_spans():
    sl = trace.parse(EVENTS)
    assert (sl.start, sl.end) == (0.0, pytest.approx(100e-6))
    assert sorted({e.name for e in sl.device}) == ["Memcpy DtoH", "kernel_a",
                                                   "kernel_b"]
    assert {s.name for s in sl.spans} == {"slice", "open", "dispatch",
                                          "to_host"}
    assert len(sl.kernels("kernel_a")) == 2 and len(sl.kernels()) == 3


def test_busy_is_the_union_clipped_to_the_slice():
    sl = trace.parse(EVENTS)
    # 10..50 (two overlapping kernels once), 60..80, 90..100
    assert trace.busy_seconds(sl) == pytest.approx(70e-6)
    assert trace.idle_pct(sl) == pytest.approx(30.0)
    assert trace.gaps(sl) == [pytest.approx((0.0, 10e-6)),
                              pytest.approx((50e-6, 60e-6)),
                              pytest.approx((80e-6, 90e-6))]


def test_idle_gaps_by_the_innermost_open_span():
    sl = trace.parse(EVENTS)
    got = dict(trace.idle_by_span(sl))
    assert got == {"open": pytest.approx(10e-6),
                   "to_host": pytest.approx(20e-6)}


def test_top_ops_sum_by_name():
    sl = trace.parse(EVENTS)
    top = trace.top_ops(sl, top=2)
    assert top[0][0] == "kernel_a" and top[0][1] == pytest.approx(50e-6)
    assert len(top) == 2


def test_no_device_activity_reads_nothing():
    sl = trace.parse(EVENTS[:4])
    assert trace.idle_pct(sl) is None
    with pytest.raises(RuntimeError):
        trace.parse(EVENTS[1:])
