"""The port's nested scan (columnar/nested_scan.py: Dremel row assembly and
WITHIN RECORD) against the JAX package's.

tests/test_nested.py's eleven cases, on nested records made from a seed
in the shape of its fixture (records of repeated search queries, each
with repeated result items) and written through the JAX package's
DurableTableService.insert_json into cstable v0.2 segments (two commits
and a tail left in the arena). The port opens the same directory with its
own service. Each case runs in both packages and must give the same
ResultList; the counts are also held to the records themselves.
"""

import json
import random

import pytest

from eventql_tpu.columnar.nested_scan import execute_nested_scan as jax_nested_scan
from eventql_tpu.db.lsm import DurableTableService as JDurable
from eventql_tpu.exec.runtime import Runtime as JRuntime
from eventql_tpu.plan import nodes as jqn
from eventql_tpu_torch.columnar.nested_scan import execute_nested_scan
from eventql_tpu_torch.db.lsm import DurableTableService
from eventql_tpu_torch.exec.runtime import Runtime
from eventql_tpu_torch.plan import nodes as qn

CREATE = (
    "CREATE TABLE testtable (time DATETIME, user_id string, tags REPEATED string,"
    " attr RECORD (ab_test_group uint64, page string),"
    " search_query REPEATED RECORD (time DATETIME, num_result_items uint64,"
    " result_items REPEATED RECORD (position uint64, clicked boolean)),"
    " PRIMARY KEY (time));"
)
N_RECORDS = 213


def _records(seed=11):
    rng = random.Random(seed)
    out = []
    for i in range(N_RECORDS):
        t = 1_400_000_000_000_000 + i * 1_000_003
        r = {"time": t, "user_id": f"u{rng.randrange(20)}"}
        if rng.random() < 0.5:
            r["tags"] = [f"t{rng.randrange(4)}" for _ in range(rng.randrange(1, 3))]
        if rng.random() < 0.8:
            r["attr"] = {"ab_test_group": rng.randrange(5), "page": f"p{rng.randrange(3)}"}
        if rng.random() < 0.7:
            queries = []
            for j in range(rng.randrange(1, 5)):
                items = [{"position": p, **({"clicked": rng.random() < 0.1}
                                              if rng.random() < 0.6 else {})}
                         for p in range(1, rng.randrange(0, 12) + 1)]
                q = {"time": t + j, "num_result_items": len(items)}
                if items:
                    q["result_items"] = items
                queries.append(q)
            r["search_query"] = queries
        out.append(r)
    return out


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    """The JAX package writes the table: two commits, a tail in the arena
    (committed by the close), one record written twice (the newer wins)."""
    d = str(tmp_path_factory.mktemp("nested"))
    svc = JDurable(d, arena_flush_rows=90)
    rt = JRuntime()
    rt.build_query_plan(rt.new_transaction(svc), CREATE).execute(0)
    recs = _records()
    stale = dict(recs[5], user_id="stale", search_query=[])
    svc.insert_json("testtable", json.dumps(stale))
    for r in recs:
        svc.insert_json("testtable", json.dumps(r))
    svc.commit_all()
    assert len(svc.tables["testtable"]._segments) >= 2
    return d


RECORDS = _records()
SEARCH_QUERIES = sum(len(r.get("search_query", [])) for r in RECORDS)
ITEMS = sum(q["num_result_items"] for r in RECORDS for q in r.get("search_query", []))


def _both(datadir, query):
    """The JAX ResultList's (columns, rows) and the port's, each over its
    own service on the directory."""
    out = []
    for svc, rt in ((JDurable(datadir), JRuntime()),
                    (DurableTableService(datadir), Runtime(device="cpu"))):
        res = rt.build_query_plan(rt.new_transaction(svc), query).execute(0)
        out.append((res.columns, res.rows))
    assert out[1] == out[0], query
    return out[1]


def test_count_repeated_column(datadir):
    _cols, rows = _both(datadir, "select count(search_query.time) from testtable;")
    assert rows == [[str(SEARCH_QUERIES)]]


def test_sum_repeated_column(datadir):
    _cols, rows = _both(datadir, "select sum(search_query.num_result_items) from testtable;")
    assert rows == [[str(ITEMS)]]


def test_sum_count_within_record(datadir):
    _cols, rows = _both(datadir, "select sum(count(search_query.result_items.position)"
                                 " WITHIN RECORD) from testtable;")
    assert rows == [[str(ITEMS)]]


def test_within_record_rows(datadir):
    cols, rows = _both(datadir, """
        select
          sum(search_query.num_result_items) WITHIN RECORD,
          count(search_query.result_items.position) WITHIN RECORD
        from testtable;""")
    assert len(cols) == 2 and len(rows) == N_RECORDS
    total = 0
    for r1, r2 in rows:
        r1, r2 = ("0" if x == "NULL" else x for x in (r1, r2))
        assert r1 == r2
        total += int(r1)
    assert total == ITEMS


def test_deep_nested_row_expansion(datadir):
    _cols, rows = _both(datadir, "select search_query.result_items.position from testtable;")
    # one row a value, and one (NULL) for each record or search query
    # without a value beneath it
    empty = sum(1 for r in RECORDS if not r.get("search_query")) + sum(
        1 for r in RECORDS for q in r.get("search_query", []) if not q["num_result_items"])
    assert len(rows) == ITEMS + empty


def test_multi_level_aggregate(datadir):
    cols, rows = _both(datadir, """
        select
          count(time),
          sum(count(search_query.time) WITHIN RECORD),
          sum(sum(search_query.num_result_items) WITHIN RECORD),
          sum(count(search_query.result_items.position) WITHIN RECORD)
        from testtable;""")
    assert cols == ["count(time)", "sum(count(search_query.time) WITHIN RECORD)",
                    "sum(sum(search_query.num_result_items) WITHIN RECORD)",
                    "sum(count(search_query.result_items.position) WITHIN RECORD)"]
    assert rows == [[str(N_RECORDS), str(SEARCH_QUERIES), str(ITEMS), str(ITEMS)]]


def test_multi_level_aggregate_combined(datadir):
    _cols, rows = _both(datadir, """
        select
          count(time),
          sum(count(search_query.time) WITHIN RECORD),
          sum(sum(search_query.num_result_items) WITHIN RECORD),
          sum(count(search_query.result_items.position) WITHIN RECORD),
          (
            count(time) +
            sum(count(search_query.time) WITHIN RECORD) +
            sum(sum(search_query.num_result_items) WITHIN RECORD) +
            sum(count(search_query.result_items.position) WITHIN RECORD)
          )
        from testtable;""")
    total = N_RECORDS + SEARCH_QUERIES + 2 * ITEMS
    assert rows == [[str(N_RECORDS), str(SEARCH_QUERIES), str(ITEMS), str(ITEMS), str(total)]]


def test_nested_subquery_filter_aggregate(datadir):
    cols, rows = _both(datadir, """
        select
          count(1) as num_items,
          sum(if(s.c, 1, 0)) as clicks
        from (
            select
                search_query.result_items.position as p,
                search_query.result_items.clicked as c
            from testtable) as s
            where s.p = 6;""")
    items = [i for r in RECORDS for q in r.get("search_query", [])
             for i in q.get("result_items", []) if i["position"] == 6]
    assert cols == ["num_items", "clicks"]
    assert rows == [[str(len(items)), str(sum(bool(i.get("clicked")) for i in items))]]


def test_wildcard_row_expansion(datadir):
    cols, rows = _both(datadir, "select * from testtable;")
    assert cols[0] == "time" and len(cols) == 9
    assert len(rows) >= N_RECORDS


def test_wildcard_order_limit(datadir):
    cols, rows = _both(datadir, "select * from testtable order by time desc limit 10;")
    assert len(cols) == 9 and len(rows) == 10


def test_deep_within_record_aggregation(datadir):
    """AGGREGATE_WITHIN_RECORD_DEEP emits one aggregated row per repeated
    value step (the scan ABI the planner never selects): the port's
    execute_nested_scan on the same flipped plan as the JAX package's."""
    sql = "select sum(search_query.num_result_items) WITHIN RECORD from testtable;"
    out = []
    for svc, rt, nodes, scan_fn in (
            (JDurable(datadir), JRuntime(), jqn, jax_nested_scan),
            (DurableTableService(datadir), Runtime(device="cpu"), qn, execute_nested_scan)):
        plan = rt.build_query_plan(rt.new_transaction(svc), sql)
        scan = plan.nodes[0]
        while not isinstance(scan, nodes.SequentialScanNode):
            scan = (getattr(scan, "input_table", None) or getattr(scan, "table", None)
                    or scan.children()[0])
        assert scan.aggr_strategy == nodes.SequentialScanNode.AGGREGATE_WITHIN_RECORD_FLAT
        scan.aggr_strategy = nodes.SequentialScanNode.AGGREGATE_WITHIN_RECORD_DEEP
        rel = scan_fn(scan, svc.get_reader("testtable"))
        out.append([rel.columns[0].format_value(i) for i in range(rel.num_rows)])
    assert out[1] == out[0]
    # one row a search query, and one for each record without any
    empty = sum(1 for r in RECORDS if not r.get("search_query"))
    assert len(out[1]) == SEARCH_QUERIES + empty
    assert sum(int(x) for x in out[1] if x != "NULL") == ITEMS


NESTED_ROUTE_QUERIES = [
    "select count(search_query.time) from testtable;",
    "select user_id, count(search_query.time), sum(search_query.num_result_items)"
    " from testtable group by user_id order by user_id;",
    "select search_query.time from testtable order by search_query.time desc limit 5;",
    "select user_id, search_query.result_items.position from testtable"
    " where search_query.result_items.position > 9 order by user_id;",
]


@pytest.mark.parametrize("query", NESTED_ROUTE_QUERIES)
def test_device_routes_leave_nested_scans_to_the_host_engine(datadir, monkeypatch, query):
    """The CUDA routes read a table's flat relation, where a leaf under a
    repeated record keeps one value a record: a plan whose scan needs the
    row assembly takes no route under Runtime(device="cpu") and answers
    as the host engines do. The JAX package's device route does not
    check this, and its GROUP BYs here count one value a record."""
    from eventql_tpu_torch.exec import device_exec

    counters = ("FUSED_GROUPBY_COUNT", "MULTI_SUM_GROUPBY_COUNT", "GENERAL_GROUPBY_COUNT",
                "SCAN_TOPK_COUNT", "SCAN_ORDER_COUNT")
    before = [getattr(device_exec, c) for c in counters]
    _cols, rows = _both(datadir, query)
    assert [getattr(device_exec, c) for c in counters] == before
    if "group by" in query or query.startswith("select count"):
        monkeypatch.setenv("EVENTQL_TPU_DEVICE", "1")
        rt = JRuntime()
        jax_device = rt.build_query_plan(
            rt.new_transaction(JDurable(datadir)), query).execute(0).rows
        assert jax_device != rows
