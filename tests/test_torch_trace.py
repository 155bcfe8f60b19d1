"""The port's query tracer (eventql_tpu_torch/utils/trace.py) and its spans
at the layer boundaries of the device routes, on the CPU.

The queries run on ``Runtime(device="cpu")``, which takes the routes'
plain PyTorch path through the same wrappers as the card. Each test
leaves the tracer as it found it: off, its buffer empty.
"""

import collections
import json
import time

import numpy as np
import pytest
import torch

from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import PlanCache, RelationTableProvider, Runtime, Transaction
from eventql_tpu_torch.kernels import _build
from eventql_tpu_torch.exec import torch_expr
from eventql_tpu_torch.utils import trace
from test_torch_expr_program import BENCH_QUERIES, bench_provider, program_on_cpu  # noqa: F401


@pytest.fixture
def tracer():
    """The tracer switched on for the process, with an empty buffer; off
    again after."""
    trace.drain()
    trace.enable()
    yield trace
    trace.disable()
    trace.drain()


def _provider(**tables):
    p = RelationTableProvider()
    for name, cols in tables.items():
        n = len(next(iter(cols.values())))
        p.add_table(name, relation_from_numpy(
            list(cols), [(SType.UINT64, np.asarray(v, np.uint64), np.ones(n, bool), None)
                         for v in cols.values()]))
    return p


def _facts(n=2000, seed=3):
    rng = np.random.default_rng(seed)
    return _provider(t={"k": rng.integers(0, 7, n), "v": rng.integers(0, 1000, n),
                        "w": rng.integers(0, 50, n)})


def _run(rt, provider, sql, txn=None):
    txn = txn or rt.new_transaction(provider)
    res = rt.build_query_plan(txn, sql).execute(0)
    return txn, res.rows


def _of(query):
    """The spans of ``query`` in the buffer, which is left empty."""
    return [s for s in trace.drain() if s.query == query]


def _by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


def test_off_records_nothing_and_returns_the_shared_no_op():
    assert not trace.ON
    trace.drain()
    assert trace.span("query.plan", 1) is trace.NO_SPAN
    assert trace.span("expr", role="where") is trace.NO_SPAN
    with trace.span("expr") as sp:
        sp.set("role", "key")
        trace.note("counter", "X")
    rt = Runtime(device="cpu")
    txn, rows = _run(rt, _facts(), "select k, sum(v) from t where v > 10 group by k;")
    assert rows and txn.trace is None and txn.trace_report() == ""
    assert trace.drain() == []


def test_group_by_spans_one_query_from_plan_to_emit():
    # a traced transaction: its spans land in its own list, and the
    # tracer is off again, its buffer empty, once the rows are emitted
    rt = Runtime(device="cpu", plan_cache=PlanCache())
    provider = _facts()
    uploads, nbytes = device_exec.COLUMN_UPLOADS, device_exec.UPLOAD_BYTES
    sql = "select k, sum(v), min(w + 1) from t where v > 10 group by k;"
    txn, rows = _run(rt, provider, sql, Transaction(provider, trace=[], device=rt.device))
    assert len(rows) == 7
    assert not trace.ON and trace.drain() == []
    spans = txn.trace
    by = _by_name(spans)
    for name in ("query.plan", "query.execute", "query.emit"):
        assert len(by[name]) == 1 and by[name][0].parent is None, name
    assert by["query.plan"][0].attrs == {"plan_cache": "miss"}
    assert {s.query for s in spans} == {txn.query_id}

    ids = {s.id: s for s in spans}
    (general,) = by["route.general"]
    assert general.attrs == {"taken": True, "counter": "GENERAL_GROUPBY_COUNT"}
    assert [s.attrs["taken"] for s in by["route.string"] + by["route.join"]] == [False, False]
    kids = [s for s in spans if s.parent == general.id]
    names = {s.name for s in kids}
    assert {"upload", "expr", "kernel.hash_groupby", "readback"} <= names, names
    assert ids[general.parent].name == "op.GroupByNode"
    assert by["op.GroupByNode"][0].attrs == {"rows": 7}
    # the WHERE, the aggregate argument w + 1; k and v go as stored
    assert sorted(s.attrs["role"] for s in by["expr"]) == ["agg", "where"]
    # the stored columns k, v, w: once each, with their bytes (narrowed
    # to 16 bits, and one validity byte a row)
    up = by["upload"]
    assert sorted(s.attrs["column"] for s in up) == ["k", "v", "w"]
    assert all(s.attrs["bytes"] == 2000 * 3 for s in up)
    assert device_exec.COLUMN_UPLOADS - uploads == 3
    assert device_exec.UPLOAD_BYTES - nbytes == 3 * 2000 * 3
    assert all(s.attrs["bytes"] > 0 for s in by["readback"])
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = ids[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)

    # the same text again: a plan-cache hit, no upload
    txn2, _rows = _run(rt, provider, sql, Transaction(provider, trace=[], device=rt.device))
    by2 = _by_name(txn2.trace)
    assert txn2.query_id != txn.query_id
    assert by2["query.plan"][0].attrs == {"plan_cache": "hit"} and not by2["upload"]
    assert device_exec.COLUMN_UPLOADS - uploads == 3


@pytest.mark.parametrize("program", [True, False], ids=["program", "torch path"])
@pytest.mark.parametrize("name,sql,_table,launches", BENCH_QUERIES,
                         ids=[q[0] for q in BENCH_QUERIES])
def test_expr_spans_carry_program_and_ops(name, sql, _table, launches, program, request):
    """A traced transaction of each benchmark query: every ``expr`` span
    says whether the expression ran as a program and how many
    instructions it had; the counters move by the launches the cell
    expects (Q1 6, Q6 2, Q2 and Q9 1, Q7 and Q8 none) and no fallback.
    On the CPU's own PyTorch path: no program, 0 instructions, no count."""
    if program:
        request.getfixturevalue("program_on_cpu")
    provider = bench_provider()
    rt = Runtime(device="cpu")
    before = (torch_expr.PROGRAM_LAUNCHES, torch_expr.PROGRAM_FALLBACKS)
    txn, _rows = _run(rt, provider, sql, Transaction(provider, trace=[], device=rt.device))
    exprs = _by_name(txn.trace)["expr"]
    assert len(exprs) == launches, name
    for s in exprs:
        assert s.attrs["program"] is program and (s.attrs["ops"] > 0) is program, s.attrs
    moved = (torch_expr.PROGRAM_LAUNCHES - before[0], torch_expr.PROGRAM_FALLBACKS - before[1])
    assert moved == ((launches, 0) if program else (0, 0)), name


def test_route_spans_of_the_order_and_top_k_routes(tracer):
    rt = Runtime(device="cpu")
    provider = _facts()
    txn, rows = _run(rt, provider, "select k, v from t where w < 20 order by v + 1 desc limit 5;")
    assert len(rows) == 5
    by = _by_name(_of(txn.query_id))
    (topk,) = by["route.topk"]
    assert topk.attrs == {"taken": True, "counter": "SCAN_TOPK_COUNT"}
    assert sorted(s.attrs["role"] for s in by["expr"]) == ["order", "where"]
    assert by["readback"] and all(s.parent == topk.id for s in by["readback"])
    txn, _rows = _run(rt, provider, "select k, v from t where w < 20 order by v, k;")
    by = _by_name(_of(txn.query_id))
    assert by["route.order"][0].attrs == {"taken": True, "counter": "SCAN_ORDER_COUNT"}


def test_string_route_notes_its_counter(tracer):
    rt = Runtime(device="cpu")
    txn, rows = _run(rt, _facts(), "select k, count(1), sum(v) from t where w > 3 group by k;")
    by = _by_name(_of(txn.query_id))
    assert by["route.string"][0].attrs == {"taken": True, "counter": "FUSED_GROUPBY_COUNT"}
    assert not by["route.general"] and by["kernel.groupby_agg"]


def test_join_report_lists_both_inputs_in_order(tracer):
    provider = _provider(a={"id": [1, 2, 3], "x": [10, 20, 30]},
                         b={"aid": [1, 1, 2, 3, 3], "y": [5, 6, 7, 8, 9]})
    rt = Runtime(device=None)
    txn = Transaction(provider, trace=[], device=None)
    _txn, rows = _run(rt, provider, "select a.x, b.y from a, b where a.id = b.aid;", txn)
    assert len(rows) == 5
    lines = txn.trace_report().splitlines()
    at = next(i for i, line in enumerate(lines) if line.lstrip().startswith("JoinNode:"))
    depth = len(lines[at]) - len(lines[at].lstrip())
    under = [line for line in lines[at + 1:at + 3]
             if len(line) - len(line.lstrip()) == depth + 2]
    assert [line.strip().split(":")[0] for line in under] == ["SequentialScanNode"] * 2
    assert under[0].endswith("3 rows") and under[1].endswith("5 rows")
    assert "JoinNode" in lines[at] and lines[at].endswith("5 rows")
    assert lines[0].startswith("query.plan: ") and "query.execute" in lines[1]


def test_the_switches_turn_the_tracer_on(monkeypatch):
    provider = _facts(n=50)
    rt = Runtime(device=None)
    sql = "select k, count(1) from t group by k;"
    assert not trace.ON
    trace.drain()
    # EVENTQL_TRACE=1 traces every transaction, each into its own list
    monkeypatch.setenv("EVENTQL_TRACE", "1")
    txn = rt.new_transaction(provider)
    assert txn.trace == [] and not trace.ON
    _run(rt, provider, sql, txn)
    assert txn.trace_report().splitlines()[0].startswith("query.plan: ")
    assert {s.query for s in txn.trace} == {txn.query_id}
    assert not trace.ON and trace.drain() == []
    monkeypatch.delenv("EVENTQL_TRACE")
    # without a switch: no list, nothing recorded
    txn = rt.new_transaction(provider)
    _run(rt, provider, sql, txn)
    assert txn.trace is None and txn.trace_report() == "" and trace.drain() == []
    # trace=[]: the caller's own list is filled
    mine = []
    txn = Transaction(provider, trace=mine, device=None)
    _run(rt, provider, sql, txn)
    assert txn.trace is mine and "GroupByNode" in txn.trace_report()
    assert not trace.ON and trace.drain() == []
    # enable(): every query's spans to the buffer, until disable()
    try:
        trace.enable()
        txn = rt.new_transaction(provider)
        _run(rt, provider, sql, txn)
        assert trace.ON and txn.trace is None
        assert {"query.plan", "query.execute", "query.emit"} <= {s.name for s in _of(txn.query_id)}
    finally:
        trace.disable()
        trace.drain()
    assert not trace.ON


def test_a_traced_transaction_under_enable_fills_both(tracer):
    provider = _facts(n=50)
    rt = Runtime(device=None)
    txn = Transaction(provider, trace=[], device=None)
    _run(rt, provider, "select k, count(1) from t group by k;", txn)
    in_buffer = _of(txn.query_id)
    assert in_buffer and [s.id for s in in_buffer] == [s.id for s in txn.trace]
    assert trace.ON


def test_an_operator_outside_execute_is_traced_for_its_transaction():
    # chart rendering and the native server run a plan's nodes with
    # execute_node, outside QueryPlan.execute
    from eventql_tpu_torch.exec.operators import execute_node

    provider = _facts(n=50)
    rt = Runtime(device=None)
    txn = Transaction(provider, trace=[], device=None)
    node = rt.build_query_plan(txn, "select k from t where v > 3;").nodes[0]
    before = len(txn.trace)
    rel = execute_node(node, txn)
    ops = [s for s in txn.trace[before:] if s.name.startswith("op.")]
    assert ops and ops[-1].parent is None and ops[-1].attrs == {"rows": rel.num_rows}
    assert {s.query for s in ops} == {txn.query_id}
    assert not trace.ON and trace.drain() == []


def test_a_full_buffer_counts_into_dropped(tracer, monkeypatch):
    monkeypatch.setattr(trace, "_BUFFER", collections.deque(maxlen=3))
    dropped = trace.DROPPED
    for i in range(5):
        with trace.span("expr", role=str(i)):
            pass
    assert trace.DROPPED - dropped == 2
    assert [s.attrs["role"] for s in trace.drain()] == ["2", "3", "4"]
    assert trace.drain() == []


def test_children_take_the_query_and_the_parent_of_their_thread(tracer):
    with trace.span("query.execute", 41) as root:
        with trace.span("op.GroupByNode") as op:
            trace.note("counter", "C")
            with trace.span("expr", role="key") as e:
                pass
    with trace.span("readback") as alone:
        pass
    assert (op.parent, op.query, e.parent, e.query) == (root.id, 41, op.id, 41)
    assert op.attrs == {"counter": "C"} and e.attrs == {"role": "key"}
    assert alone.parent is None and alone.query is None
    assert [s.name for s in trace.drain()] == ["expr", "op.GroupByNode", "query.execute",
                                               "readback"]


def test_a_build_span_and_counter_name_the_library(tracer, monkeypatch):
    monkeypatch.setattr(_build, "_lib_path", lambda name: "libc.so.6")
    monkeypatch.setattr(_build, "build_all", lambda: 0.0)
    builds = dict(_build.BUILDS)
    try:
        _build.load("_probe")
        _build.load("_probe")
    finally:
        _build._LIBS.pop("_probe", None)
    assert _build.BUILDS["_probe"] - builds.get("_probe", 0) == 1
    (b,) = [s for s in trace.drain() if s.name == "build"]
    assert b.attrs == {"library": "_probe"}


def test_spans_land_on_the_profiler_timeline(tracer, tmp_path):
    """The exported trace's clock (baseTimeNanoseconds + ts x 1000) is the
    tracer's: a span around a record_function holds it, within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with trace.span("kernel.probe") as sp:
                sp.set("i", i)
                with record_function(f"probe{i}"):
                    torch.ones(64).sum()
            time.sleep(0.002)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = int(data["baseTimeNanoseconds"])
    events = {e["name"]: e for e in data["traceEvents"] if e.get("ph") == "X"}
    spans = [s for s in trace.drain() if s.name == "kernel.probe"]
    assert len(spans) == 5
    for s in spans:
        e = events[f"probe{s.attrs['i']}"]
        start = base + float(e["ts"]) * 1e3
        end = start + float(e["dur"]) * 1e3
        assert s.start_ns - 1e6 <= start and end <= s.end_ns + 1e6, (s, start, end)
        assert start - s.start_ns < 1e6 and s.end_ns - end < 1e6
