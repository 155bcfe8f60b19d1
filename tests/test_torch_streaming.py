"""The port's streaming cursor (exec/streaming.py, QueryPlan.execute_stream)
against the JAX package's.

tests/test_streaming.py's storage cases, run through both packages on the
same data: an LSM table of several segments (with and without a primary
key, upserts across segments), a memory table, the shapes that stream
(scan, filter and projection, LIMIT / OFFSET) and those that must not
(aggregates, ORDER BY, GROUP BY), and a stream that outlives a compaction
retiring its segment files. The port streams under Runtime(device="cpu");
its streamed rows must equal its materialized rows and the JAX package's.
The server cases of that file (a process's RSS) belong to the server tier
and are not here.
"""

import json
import os
import shutil

import numpy as np
import pytest

from eventql_tpu.core.types import SType as JSType
from eventql_tpu.db.lsm import DurableTableService as JDurable
from eventql_tpu.db.table_service import TableService as JTableService
from eventql_tpu.exec import streaming as jstreaming
from eventql_tpu.exec.relation import Column as JColumn, Relation as JRelation
from eventql_tpu.exec.runtime import Runtime as JRuntime
from eventql_tpu.plan.nodes import ColumnDefinition as JCD, CreateTableNode as JCreate
from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.db.lsm import DurableTableService
from eventql_tpu_torch.db.table_service import TableService
from eventql_tpu_torch.exec import streaming
from eventql_tpu_torch.exec.relation import Column, Relation
from eventql_tpu_torch.exec.result import ResultList
from eventql_tpu_torch.exec.runtime import Runtime
from eventql_tpu_torch.plan.nodes import ColumnDefinition, CreateTableNode

_PORT = dict(durable=DurableTableService, memory=TableService, stype=SType, column=Column,
             relation=Relation, runtime=lambda: Runtime(device="cpu"), cd=ColumnDefinition,
             create=CreateTableNode, streaming=streaming)
_JAX = dict(durable=JDurable, memory=JTableService, stype=JSType, column=JColumn,
            relation=JRelation, runtime=JRuntime, cd=JCD, create=JCreate,
            streaming=jstreaming)


def _mk_lsm(pkg, path, n_rows=1000, flush=300, pk=False, name="ev"):
    """tests/test_streaming.py:_mk_lsm through ``pkg``."""
    svc = pkg["durable"](str(path), arena_flush_rows=flush)
    cd = pkg["cd"]
    svc.create_table(pkg["create"](
        name, [cd("id", "UINT64"), cd("val", "STRING"), cd("num", "DOUBLE")],
        ["id"] if pk else [], None, []))
    t = svc.tables[name]
    S, C = pkg["stype"], pkg["column"]
    for lo in range(0, n_rows, flush):
        hi = min(lo + flush, n_rows)
        t.insert_batch(pkg["relation"](
            ["id", "val", "num"],
            [C(S.UINT64, np.arange(lo, hi, dtype=np.uint64), np.ones(hi - lo, bool)),
             C.from_strings([b"v%06d" % i for i in range(lo, hi)]),
             C(S.FLOAT64, np.arange(lo, hi, dtype=np.float64) * 0.5, np.ones(hi - lo, bool))],
            hi - lo))
    return svc


def _run_both(pkg, svc, query, chunk_rows=64):
    """(streamed rows, materialized rows) through ``pkg``."""
    mod = pkg["streaming"]
    old = mod.STREAM_CHUNK_ROWS
    mod.STREAM_CHUNK_ROWS = chunk_rows
    try:
        rt = pkg["runtime"]()
        plan = rt.build_query_plan(rt.new_transaction(svc), query)
        streamed = []
        for i in range(plan.num_queries):
            r = plan.execute_stream(i)
            assert isinstance(r, mod.StreamingResultList), query
            streamed.append([list(row) for row in r.rows])
        return streamed, [plan.execute(i).rows for i in range(plan.num_queries)]
    finally:
        mod.STREAM_CHUNK_ROWS = old


def _parity(tmp_path, query, chunk_rows=64, setup=None, **kw):
    """The port's stream equals its materialized rows and the JAX
    package's stream and rows."""
    out = {}
    for name, pkg in (("jax", _JAX), ("port", _PORT)):
        svc = _mk_lsm(pkg, tmp_path / name, **kw)
        if setup is not None:
            setup(svc)
        out[name] = _run_both(pkg, svc, query, chunk_rows)
    s, m = out["port"]
    assert s == m
    assert out["port"] == out["jax"]
    return m


@pytest.mark.parametrize("pk", [False, True])
def test_lsm_stream_parity_select_star(tmp_path, pk):
    m = _parity(tmp_path, "select * from ev;", pk=pk)
    assert len(m[0]) == 1000


def test_lsm_stream_parity_filter_project(tmp_path):
    _parity(tmp_path, "select id + 1 as x, val from ev where num > 100.0;")


@pytest.mark.parametrize("query", [
    "select id from ev limit 10;",
    "select id from ev limit 50 offset 295;",
    "select id from ev where id % 2 = 0 limit 7 offset 450;",
    "select id from ev limit 100000 offset 990;",
])
def test_lsm_stream_parity_limit_offset(tmp_path, query):
    _parity(tmp_path, query, chunk_rows=37)


def test_lsm_stream_upsert_visibility(tmp_path):
    """Newest-wins primary-key visibility across segments, chunk by chunk."""

    def upsert(svc):
        for i in (0, 199, 200, 399, 599):
            svc.insert_json("ev", json.dumps({"id": i, "val": f"NEW{i}", "num": -1.0}))
        svc.tables["ev"].commit()

    m = _parity(tmp_path, "select id, val from ev;", setup=upsert, n_rows=600, flush=200,
                pk=True)
    rows = dict((r[0], r[1]) for r in m[0])
    assert rows["199"] == "NEW199" and rows["599"] == "NEW599"
    assert len(m[0]) == 600


def _memory_table(pkg):
    svc = pkg["memory"]()
    cd = pkg["cd"]
    svc.create_table(pkg["create"]("t", [cd("a", "UINT64"), cd("b", "STRING")], [], None, []))
    for i in range(257):
        svc.insert_json("t", json.dumps({"a": i, "b": f"s{i}"}))
    return svc


def test_memory_table_stream_parity():
    q = "select b, a * 2 as aa from t where a < 200;"
    s, m = _run_both(_PORT, _memory_table(_PORT), q)
    assert s == m and (s, m) == _run_both(_JAX, _memory_table(_JAX), q)


@pytest.mark.parametrize("query", [
    "select count(1) from t;",
    "select a from t order by a;",
    "select a from t group by a;",
])
def test_blocking_shapes_materialize(query):
    """Aggregates, ORDER BY and GROUP BY take the materializing execute()
    (and with it the device routes), in both packages."""
    svc = _PORT["memory"]()
    svc.create_table(CreateTableNode("t", [ColumnDefinition("a", "UINT64")], [], None, []))
    svc.insert_json("t", json.dumps({"a": 1}))
    rt = Runtime(device="cpu")
    res = rt.build_query_plan(rt.new_transaction(svc), query).execute_stream(0)
    assert isinstance(res, ResultList)
    jsvc = _JAX["memory"]()
    jsvc.create_table(JCreate("t", [JCD("a", "UINT64")], [], None, []))
    jsvc.insert_json("t", json.dumps({"a": 1}))
    jrt = JRuntime()
    want = jrt.build_query_plan(jrt.new_transaction(jsvc), query).execute_stream(0)
    assert type(want).__name__ == "ResultList" and res.rows == want.rows


def test_stream_survives_concurrent_compaction(tmp_path):
    """tests/test_streaming.py:test_stream_survives_concurrent_compaction:
    a compaction, and the removal of the retired files, under a live
    stream leave it serving the rows of its snapshot."""
    svc = DurableTableService(str(tmp_path), arena_flush_rows=100)
    svc.create_table(CreateTableNode(
        "ev", [ColumnDefinition("id", "UINT64"), ColumnDefinition("v", "UINT64")],
        ["id"], None, []))
    n = 650  # several segments + an arena tail
    for i in range(n):
        svc.insert_json("ev", '{"id": %d, "v": %d}' % (i, i * 7))
    t = svc.tables["ev"]
    assert len(t._segments) >= 5
    stream = t.stream_chunks(chunk_rows=64)
    got = [next(stream)]
    t.compact()
    shutil.rmtree(os.path.join(str(tmp_path), "ev", ".trash"), ignore_errors=True)
    assert len(t._segments) == 1
    got.extend(stream)
    ids = np.concatenate([c.columns[c.names.index("id")].data.astype(np.uint64) for c in got])
    vs = np.concatenate([c.columns[c.names.index("v")].data.astype(np.uint64) for c in got])
    assert sorted(ids.tolist()) == list(range(n))
    assert np.array_equal(vs, ids * 7)


def test_compaction_worker_stops(tmp_path):
    """The background compaction worker folds a table past the segment
    threshold and stops when asked (each test that starts it stops it)."""
    svc = DurableTableService(str(tmp_path), arena_flush_rows=10)
    svc.create_table(CreateTableNode(
        "ev", [ColumnDefinition("id", "UINT64"), ColumnDefinition("v", "UINT64")],
        ["id"], None, []))
    for i in range(10 * svc.COMPACT_SEGMENT_THRESHOLD):
        svc.insert_json("ev", '{"id": %d, "v": %d}' % (i % 25, i))
    t = svc.tables["ev"]
    assert len(t._segments) >= svc.COMPACT_SEGMENT_THRESHOLD
    svc.start_compaction_worker(interval=0.05)
    try:
        import time

        deadline = time.monotonic() + 20
        while len(t._segments) > 1 and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        svc.stop_compaction_worker()
    assert svc._compaction_thread is None and len(t._segments) == 1
    rt = Runtime(device="cpu")
    res = rt.build_query_plan(rt.new_transaction(svc), "select count(1) from ev;").execute(0)
    assert res.rows == [["25"]]
