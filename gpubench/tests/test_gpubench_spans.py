"""gpubench/spans.py: the port's spans laid on a traced window. The idle
split by the innermost program span, the idle gaps named with it, the
device time by the span that launched each kernel, the launches inside
``kernel.*`` spans; the existing readers untouched by all of it."""

import os
import types

import pytest

from eventql_tpu_torch.utils.trace import Span
from gpubench import harness, spans, tracing
from gpubench.tests.test_gpubench_tracing import EVENTS, ev
from gpubench.tests.tiny import sizes

BASE_NS = 1_700_000_000_000_000_000


def span(name, start_us, end_us, sid, parent=None, role=None):
    s = Span(name, 7, role)
    s.id, s.parent = sid, parent
    s.start_ns, s.end_ns = BASE_NS + int(start_us * 1e3), BASE_NS + int(end_us * 1e3)
    return s


# the window [100, 200]; busy [100, 110] + [115, 130] + [150, 155]; idle
# [110, 115], [130, 150], [155, 200]
SPANS = [
    span("query.execute", 100, 160, 1),
    span("op.GroupByNode", 101, 159, 2, 1),
    span("route.general", 102, 158, 3, 2),
    span("expr", 105, 112, 4, 3, role="where"),
    span("kernel.hash_groupby", 112, 140, 5, 3),
    span("readback", 140, 152, 6, 3),
    span("query.emit", 165, 190, 7),
]
LAUNCH_EVENTS = EVENTS + [
    ev("cudaLaunchKernel", 105, 1, "cuda_runtime") | {"args": {"correlation": 1}},
    ev("cudaLaunchKernel", 113, 1, "cuda_runtime") | {"args": {"correlation": 2}},
    ev("cudaLaunchKernel", 141, 1, "cuda_runtime") | {"args": {"correlation": 3}},
    ev("void at::native::elementwise_kernel<128>(int)", 116, 10, "kernel") | {"args": {"correlation": 1}},
    ev("void agg_kernel<3>(AggParams)", 120, 5, "kernel") | {"args": {"correlation": 2}},
    ev("void agg_kernel<3>(AggParams)", 150, 5, "kernel") | {"args": {"correlation": 3}},
]


def test_idle_split_charges_each_instant_to_the_innermost_span():
    t = tracing.Trace(EVENTS)
    split, crossing, by_stage = spans.idle_split(t, spans.on_trace_time(SPANS, BASE_NS))
    us = {k: round(v * 1e6, 6) for k, v in split.items()}
    # [110, 112] expr; [112, 115] and [130, 140] kernel; [140, 150]
    # readback; [155, 158] route; [158, 159] op and [165, 190] emit;
    # [159, 160] query.execute; [160, 165] and [190, 200] no span
    assert us == {"expr_idle_ms": 2.0, "kernel_idle_ms": 13.0, "route_idle_ms": 3.0,
                  "readback_idle_ms": 10.0, "emit_idle_ms": 26.0, "plan_idle_ms": 1.0,
                  "unnamed_idle_ms": 15.0}
    assert sum(split.values()) == pytest.approx(t.window_s - t.busy_s)
    # each of the three gaps crosses a span's edge
    assert crossing == pytest.approx(70e-6)
    # the unnamed [160, 165] and [190, 200] lie in the benchmark's emit
    assert by_stage == {"q1/emit": pytest.approx(15e-6), "between queries": 0.0}


def test_idle_split_without_spans_is_all_unnamed():
    t = tracing.Trace(EVENTS)
    split, crossing, by_stage = spans.idle_split(t, [])
    assert split[spans.UNNAMED] == pytest.approx(t.window_s - t.busy_s)
    assert sum(split.values()) == pytest.approx(t.window_s - t.busy_s) and crossing == 0
    assert sum(by_stage.values()) == pytest.approx(t.window_s - t.busy_s)


def test_named_gaps_put_the_program_span_between_stage_and_host_op():
    t = tracing.Trace(EVENTS)
    assert spans.named_idle_gaps(t, []) == t.idle_gaps()
    gaps = dict(spans.named_idle_gaps(t, spans.on_trace_time(SPANS, BASE_NS)))
    # the midpoint rule: 112.5 in the hash aggregate, 140 in the readback,
    # 177.5 in the emit
    assert gaps == {"q1/execute > kernel.hash_groupby: aten::mul": pytest.approx(5e-6),
                    "q1/execute > readback": pytest.approx(20e-6),
                    "q1/emit > query.emit: cudaStreamSynchronize": pytest.approx(45e-6)}


def test_device_time_by_the_span_that_launched_it_and_launch_coverage():
    t = tracing.Trace(LAUNCH_EVENTS)
    items = spans.on_trace_time(SPANS, BASE_NS)
    by, by_kernel = spans.device_by_launching_span(t, LAUNCH_EVENTS, items)
    assert dict(by) == {"expr[where]": pytest.approx(10e-6),
                        "kernel.hash_groupby": pytest.approx(5e-6),
                        "readback": pytest.approx(5e-6)}
    assert dict(by_kernel) == {"expr[where] | elementwise_kernel<128>(int)": pytest.approx(10e-6),
                               "kernel.hash_groupby | agg_kernel<3>(AggParams)": pytest.approx(5e-6),
                               "readback | agg_kernel<3>(AggParams)": pytest.approx(5e-6)}
    # the two agg_kernel launches: one inside kernel.hash_groupby, one not
    assert spans.kernel_launch_coverage(t, LAUNCH_EVENTS, items, ["agg_kernel"]) == (2, 1)


def test_the_existing_readers_read_the_same_with_the_spans():
    t = tracing.Trace(LAUNCH_EVENTS)
    layers = harness._json(os.path.join(harness.HERE, "layers.json"))
    run = types.SimpleNamespace(trace=t, queries=[{"bytes": 100}] * 4, layers=layers,
                                peak_bandwidth=3.35e12)
    names = ("device_idle_share", "host_ms_per_query", "expr_device_ms", "kernel_device_ms",
             "hbm_roofline_share")

    def read_all():
        return {n: harness._load(os.path.join(harness.HERE, "metrics", n + ".py")).read(run)
                for n in names}

    before = read_all()
    out = spans.readings(t, LAUNCH_EVENTS, BASE_NS, SPANS, 4, layers["kernels"]["kernels"])
    assert read_all() == before and t.idle_gaps() == tracing.Trace(LAUNCH_EVENTS).idle_gaps()
    idle = sum(out[k] for k, _names in spans.IDLE_OF) + out[spans.UNNAMED]
    assert idle == pytest.approx(out["host_ms_per_query"]) == pytest.approx(before["host_ms_per_query"])


def test_a_cpu_run_of_a_cell_with_the_tracer_on():
    cell = "tpch_q6"
    result, out = spans.run(cell, 2**31 + 11, 0.3, True, device="cpu", sizes=sizes(cell))
    assert result["correct"] and out["dropped"] == 0 and out["spans_in_window"] > 0
    idle = sum(out[k] for k, _names in spans.IDLE_OF) + out[spans.UNNAMED]
    assert idle == pytest.approx(out["host_ms_per_query"], rel=1e-9)
    assert out["upload_ms"] > 0 and out["column_uploads"] > 0
    assert sum(s for _name, s in out["idle_gaps"]) == pytest.approx(1e-3 * idle * (
        result["attempted"] - result["failed"]))
    from eventql_tpu_torch.utils import trace

    assert not trace.ON and trace.drain() == []
