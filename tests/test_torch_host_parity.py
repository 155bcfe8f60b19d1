"""The port's copy of the host engine against the JAX package's.

Non-device queries (projections, subqueries, host GROUP BY with every
aggregate, ORDER BY / LIMIT, HAVING, joins, metadata statements, error
messages) run through both packages' parser -> planner -> numpy host
engine on the same tables; columns and rows must be equal. This guards
the copied modules (sql/, plan/, exec/operators.py, exec/vector_eval.py)
against drifting from their originals.
"""

import numpy as np
import pytest

from eventql_tpu.core.errors import SQLError
from eventql_tpu.core.types import SType
from eventql_tpu.exec.relation import Column, Relation
from eventql_tpu.exec.runtime import RelationTableProvider, Runtime
from eventql_tpu_torch.core.errors import SQLError as TorchSQLError
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import (
    RelationTableProvider as TorchProvider,
    Runtime as TorchRuntime,
)


def _tables():
    rng = np.random.default_rng(77)
    n = 400
    ones = np.ones(n, bool)
    city = [f"city{int(k):02d}".encode() for k in rng.integers(0, 9, n)]
    for i in rng.integers(0, n, 15):
        city[int(i)] = None
    tvalid = rng.random(n) < 0.9
    ev = Relation(
        ["time", "user_id", "city", "value", "temp", "delta", "flag"],
        [
            Column(SType.TIMESTAMP64,
                   (1_400_000_000_000_000
                    + rng.integers(0, 86_400_000_000, n)).astype(np.uint64),
                   ones),
            Column(SType.UINT64, rng.integers(1, 40, n).astype(np.uint64), ones),
            Column.from_strings(city),
            Column(SType.UINT64, rng.integers(0, 1000, n).astype(np.uint64), ones),
            Column(SType.FLOAT64,
                   np.where(tvalid, np.round(rng.standard_normal(n) * 10, 3), 0.0),
                   tvalid),
            Column(SType.INT64, rng.integers(-50, 50, n).astype(np.int64), ones),
            Column(SType.BOOL, rng.random(n) < 0.5, ones),
        ],
        n,
    )
    m = 30
    users = Relation(
        ["user_id", "name", "age"],
        [
            Column(SType.UINT64, np.arange(5, 5 + m).astype(np.uint64),
                   np.ones(m, bool)),
            Column.from_strings([f"user{i:02d}".encode() for i in range(m)]),
            Column(SType.UINT64, rng.integers(18, 70, m).astype(np.uint64),
                   np.ones(m, bool)),
        ],
        m,
    )
    return {"ev": ev, "users": users}


_STATE = {}


def _providers():
    if not _STATE:
        pj, pt = RelationTableProvider(), TorchProvider()
        for name, rel in _tables().items():
            pj.add_table(name, rel)
            pt.add_table(
                name,
                relation_from_numpy(
                    rel.names,
                    [(int(c.stype), c.data, c.valid, c.dictionary)
                     for c in rel.columns],
                ),
            )
        _STATE["p"] = (pj, pt)
    return _STATE["p"]


QUERIES = [
    # tableless selects and scalar functions
    "select 123 as a, 435 as b;",
    "select 1 + 2 * 3, 10 / 4, 7 % 3, pow(2, 10), -5 + 2;",
    "select 'abc' + 'def', uppercase('abc'), substr('abcdef', 2, 3), ltrim('  x');",
    "select 1 < 2, 2 <= 1, 'a' = 'a', !true, true and false, true or false;",
    "select if(1 < 2, 'y', 'n'), to_int(3.9), to_float(3), to_string(42);",
    "select from_timestamp(1400000000), date_trunc('1d', from_timestamp(1400000000));",
    "select fnv32('hello'), startswith('hello', 'he'), endswith('hello', 'lo');",
    # projections, filters, expressions over columns
    "select time, value from ev order by time limit 5;",
    "select user_id, value * 2 + 1 as x from ev where value > 900 order by time;",
    "select city, value from ev where city = 'city03' and flag order by time limit 8;",
    "select value, temp, delta from ev where temp > 5 or delta < -40 order by time;",
    "select count(1) from ev where isnull(city);",
    "select * from users order by user_id limit 3;",
    "select ev.time from ev order by time desc limit 4;",
    # subqueries
    "select t1.b, a from (select 123 as a, 435 as b) as t1;",
    "select * from (select * from (select value, time from ev)) order by time limit 5;",
    "select t1.x from (select count(1) as x from ev group by city) t1 order by x;",
    # host GROUP BY: every aggregate kind, expression keys, multi-key
    "select sum(value), count(value), min(value), max(value), mean(value) from ev;",
    "select city, min(temp), max(temp), mean(temp) from ev group by city order by city;",
    "select city, count_distinct(user_id) from ev group by city order by city;",
    "select truncate(value / 100) as b, count(1), sum(delta) from ev"
    " group by truncate(value / 100) order by b;",
    "select city, flag, count(1), sum(value) from ev group by city, flag"
    " order by city, flag;",
    "select date_trunc('1h', time) as h, count(1) from ev group by"
    " date_trunc('1h', time) order by h;",
    "select user_id, sum(temp) from ev group by user_id order by user_id;",
    "select city, sum(value) / count(1) from ev group by city order by city;",
    # ORDER BY variants and LIMIT / OFFSET
    "select user_id, value from ev order by value desc, user_id limit 10;",
    "select delta, temp from ev order by delta, temp desc limit 10;",
    "select city, sum(value) as s from ev group by city order by sum(value) desc, city;",
    "select city, sum(value) from ev group by city order by 2 desc, city;",
    "select user_id from ev order by time limit 5 offset 7;",
    # HAVING
    "select city, sum(value) from ev group by city having sum(value) > 20000"
    " order by city;",
    "select city, count(1) c from ev group by city having c > 40 order by city;",
    # joins
    "select ev.user_id, name, value from ev join users on ev.user_id = users.user_id"
    " order by ev.time limit 10;",
    "select name, count(1), sum(value) from ev join users on ev.user_id ="
    " users.user_id group by name order by name;",
    "select ev.user_id, name from ev left join users on ev.user_id = users.user_id"
    " order by ev.time limit 12;",
    "select users.user_id, value from ev right join users on ev.user_id ="
    " users.user_id where age > 60 order by users.user_id, value limit 12;",
    "select name, age, value from ev natural join users order by time limit 6;",
    "select count(1) from ev, users where ev.user_id = users.user_id and age < 30;",
    # join + GROUP BY on a joined-side column (the shape of the device
    # join route; here both packages' host engines serve it)
    "select age, count(1), sum(value), sum(value + 1) from ev join users on"
    " ev.user_id = users.user_id group by age;",
    "select name, sum(value), sum(delta) from ev join users on ev.user_id ="
    " users.user_id where value < 700 group by name;",
    "select name, min(value), max(temp), mean(delta) from ev join users on"
    " ev.user_id = users.user_id group by name order by name;",
    # metadata statements
    "show tables;",
    "describe ev;",
    "describe partitions users;",
    "explain select city, sum(value) from ev where value > 0 group by city;",
]


@pytest.mark.parametrize("query", QUERIES)
def test_host_engines_agree(query):
    pj, pt = _providers()
    rj = Runtime()
    rt = TorchRuntime(device=None)
    want = rj.execute_query(rj.new_transaction(pj), query)
    got = rt.execute_query(rt.new_transaction(pt), query)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.columns == w.columns
        assert g.rows == w.rows
        assert len(g.rows) > 0 or "offset" in query


@pytest.mark.parametrize("query", [q for q in QUERIES if " join " in q and "group by" in q])
def test_join_route_agrees_with_the_jax_host_engine(query):
    """The same join + GROUP BY queries with the port on device="cpu":
    every one takes the join route (through the kernels' plain
    versions): the integer sum / count ones its bounded branch, the
    min / max / mean one its general branch; rows and their order are
    the JAX host engine's."""
    from eventql_tpu_torch.exec import device_exec

    pj, pt = _providers()
    rj = Runtime()
    rt = TorchRuntime(device="cpu")
    want = rj.execute_query(rj.new_transaction(pj), query)[0]
    before = device_exec.JOIN_GROUPBY_COUNT
    got = rt.execute_query(rt.new_transaction(pt), query)[0]
    assert (got.columns, got.rows) == (want.columns, want.rows)
    assert device_exec.JOIN_GROUPBY_COUNT - before == 1


PARTIAL_QUERIES = [
    "select city, count(1), sum(value), min(temp), max(delta), mean(temp) from ev"
    " group by city;",
    "select user_id, count_distinct(value), sum(delta) from ev where value < 800"
    " group by user_id;",
    "select flag, city, count(value), mean(value), truncate(value / 100) from ev"
    " group by flag, city;",
    "select sum(value), count(1) from ev where delta > 40;",
]


@pytest.mark.parametrize("query", PARTIAL_QUERIES)
def test_partial_aggregation_agrees(query):
    """The copied partial aggregation (operators.GroupByPartial,
    _exec_group_by_local, _merge_partials, partitioned._concat_columns): each third
    of the table aggregated alone, the partials merged; the same as the
    JAX package's, column for column, and as the whole table's GROUP BY."""
    from eventql_tpu.exec import operators as jax_ops
    from eventql_tpu_torch.exec import operators as ops
    from eventql_tpu_torch.plan import nodes as tqn

    pj, pt = _providers()
    rj, rt = Runtime(), TorchRuntime(device=None)
    jnode = rj.build_query_plan(rj.new_transaction(pj), query).nodes[0]
    tnode = rt.build_query_plan(rt.new_transaction(pt), query).nodes[0]
    assert isinstance(tnode, tqn.GroupByNode)
    jrel, trel = pj.get_table_data("ev"), pt.get_table_data("ev")
    thirds = np.array_split(np.arange(jrel.num_rows), 3)
    want = jax_ops._merge_partials(
        jnode, [jax_ops._exec_group_by_local(jnode, jrel.gather(i)) for i in thirds])
    got = ops._merge_partials(
        tnode, [ops._exec_group_by_local(tnode, trel.gather(i)) for i in thirds])
    assert got.names == want.names
    assert [c.format_all() for c in got.columns] == [c.format_all() for c in want.columns]
    whole = rt.execute_query(rt.new_transaction(pt), query)[0]
    assert [list(r) for r in zip(*[c.format_all() for c in got.columns])] == whole.rows


ERRORS = [
    "select fnord from ev;",
    "select * from nosuchtable;",
    "select city from ev group by city having sum(value) > 7;",
    "select value % 0 from ev;",
    "select from where;",
    "select nosuchfn(value) from ev;",
]


@pytest.mark.parametrize("query", ERRORS)
def test_host_engines_raise_the_same_message(query):
    pj, pt = _providers()
    rj = Runtime()
    rt = TorchRuntime(device=None)
    with pytest.raises(SQLError) as ej:
        rj.execute_query(rj.new_transaction(pj), query)
    with pytest.raises(TorchSQLError) as et:
        rt.execute_query(rt.new_transaction(pt), query)
    assert str(et.value) == str(ej.value)
    assert type(et.value).__name__ == type(ej.value).__name__


def test_cut_out_tiers_raise_by_name():
    """No tier is cut out of the port's executor any more: the charts
    (the last one) draw what the JAX host engine draws. The query cache
    is ported: over a provider without immutable table files it is never
    consulted, and the GROUP BY answers as without it."""
    from eventql_tpu_torch.exec.runtime import Transaction

    pj, pt = _providers()
    rt = TorchRuntime(device=None)
    draw = "draw linechart; select value as y, user_id as x from ev;"
    (svg,) = rt.execute_query(rt.new_transaction(pt), draw)[0].rows[0]
    jrt = Runtime()
    assert svg.startswith("<svg") and svg == jrt.execute_query(
        jrt.new_transaction(pj), draw)[0].rows[0][0]
    q = "select city, count(1) from ev group by city;"
    txn = Transaction(pt, query_cache=object(), device=None)
    assert rt.build_query_plan(txn, q).execute(0).rows == rt.execute_query(
        rt.new_transaction(pt), q)[0].rows


def test_transaction_names_its_device():
    """A hand-made transaction has no silent host default, and a Runtime
    refuses one that is bound to another device."""
    from eventql_tpu_torch.core.errors import RuntimeError_
    from eventql_tpu_torch.exec.runtime import Transaction

    _pj, pt = _providers()
    with pytest.raises(TypeError):
        Transaction(pt)
    q = "select city, count(1) from ev group by city;"
    with pytest.raises(RuntimeError_, match="transaction on device"):
        TorchRuntime(device="cpu").build_query_plan(Transaction(pt, device=None), q)
    rt = TorchRuntime(device="cpu")
    a = rt.build_query_plan(Transaction(pt, device="cpu"), q).execute(0).rows
    b = rt.execute_query(rt.new_transaction(pt), q)[0].rows
    assert sorted(a) == sorted(b) and a


def test_execute_stream_materializes():
    _pj, pt = _providers()
    rt = TorchRuntime(device=None)
    plan = rt.build_query_plan(
        rt.new_transaction(pt), "select user_id from ev order by time limit 3;"
    )
    assert plan.execute_stream(0).rows == plan.execute(0).rows


def test_plan_cache_serves_repeats():
    from eventql_tpu_torch.exec.runtime import PlanCache

    _pj, pt = _providers()
    cache = PlanCache()
    rt = TorchRuntime(plan_cache=cache, device=None)
    q = "select city, count(1) from ev group by city order by city;"
    a = rt.execute_query(rt.new_transaction(pt), q)[0].rows
    b = rt.execute_query(rt.new_transaction(pt), q)[0].rows
    assert a == b and cache.hits == 1 and cache.misses == 1
