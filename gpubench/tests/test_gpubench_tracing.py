"""The trace reduction: device busy time as the union of device intervals
inside the window, kernel time split by the hand-written names, and idle
gaps named by what the host was doing."""

import pytest

from gpubench import tracing


def ev(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


EVENTS = [
    ev("gpubench.window", 100, 100, "user_annotation"),
    ev("gpubench.q1/execute", 100, 60, "user_annotation"),
    ev("gpubench.q1/emit", 160, 40, "user_annotation"),
    ev("aten::mul", 110, 20, "cpu_op"),
    ev("cudaStreamSynchronize", 170, 20, "cuda_runtime"),
    ev("void agg_kernel<3>(AggParams)", 90, 20, "kernel"),       # half outside the window
    ev("void at::native::elementwise_kernel<128>(int)", 115, 10, "kernel"),
    ev("void at::native::elementwise_kernel<128>(int)", 120, 10, "kernel"),  # overlaps
    ev("Memcpy DtoH (Device -> Pageable)", 150, 5, "gpu_memcpy"),
    ev("void agg_kernel<3>(AggParams)", 250, 5, "kernel"),       # after the window
]


def test_busy_union_and_window():
    t = tracing.Trace(EVENTS)
    assert t.window_s == pytest.approx(100e-6)
    # [100, 110] + [115, 130] + [150, 155]
    assert t.busy_s == pytest.approx(30e-6)


def test_kernel_seconds_by_name():
    t = tracing.Trace(EVENTS)
    assert t.kernel_seconds(["agg_kernel"], listed=True) == pytest.approx(10e-6)
    assert t.kernel_seconds(["agg_kernel"], listed=False) == pytest.approx(20e-6)
    assert t.kernel_seconds(["agg"], listed=True) == 0.0


def test_idle_gaps_named_by_the_host():
    gaps = dict(tracing.Trace(EVENTS).idle_gaps())
    assert gaps["q1/execute: aten::mul"] == pytest.approx(5e-6)
    assert gaps["q1/execute"] == pytest.approx(20e-6)
    assert gaps["q1/emit: cudaStreamSynchronize"] == pytest.approx(45e-6)
    assert sum(gaps.values()) == pytest.approx(70e-6)


def test_device_ops_sum_by_name():
    ops = tracing.Trace(EVENTS).device_ops()
    assert ops[0] == ["void at::native::elementwise_kernel<128>(int)", pytest.approx(20e-6)]


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        tracing.Trace(EVENTS[1:])
