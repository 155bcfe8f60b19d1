"""The port's query cache (exec/query_cache.py and its hook in
operators._exec_group_by) against the JAX package's.

tests/test_query_cache.py's cases over a cstable file that the JAX
package's writer makes in tmp_path (its own tests read a reference
fixture): a repeated GROUP BY is answered from the cache with the rows of
the first run; entries are keyed by the query and by the file; a volatile
table is never cached. A hit takes no route: under Runtime(device="cpu")
the route counters stay where they were, and on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8) no kernel launches.
"""

import os

import numpy as np
import pytest

from eventql_tpu.columnar.cstable_writer import write_cstable
from eventql_tpu.columnar.providers import CSTableScanProvider as JScan
from eventql_tpu.core.types import SType
from eventql_tpu.exec.query_cache import QueryCache as JQueryCache
from eventql_tpu.exec.relation import Column, Relation
from eventql_tpu.exec.runtime import Runtime as JRuntime
from eventql_tpu_torch.columnar.providers import CSTableScanProvider
from eventql_tpu_torch.db.table_service import TableService
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.query_cache import QueryCache
from eventql_tpu_torch.exec.runtime import Runtime

QUERY = ("select count(1) cnt, time from testtable group by TRUNCATE(time / 60000000)"
         " order by cnt desc;")
ROUTED = "select user, count(1), sum(n) from testtable where n < 900 group by user;"


def _table_file(path, seed=3, n=4000):
    """A flat table of events: a microsecond timestamp over a few hours,
    a string user, a u64 count."""
    rng = np.random.default_rng(seed)
    time = (1_400_000_000_000_000 + np.sort(rng.integers(0, 4 * 3_600_000_000, n))).astype(
        np.uint64)
    users = [b"u%02d" % k for k in rng.integers(0, 23, n)]
    rel = Relation(
        ["time", "user", "n"],
        [Column(SType.UINT64, time, np.ones(n, bool)), Column.from_strings(users),
         Column(SType.UINT64, rng.integers(0, 1000, n).astype(np.uint64), np.ones(n, bool))],
        n)
    write_cstable(str(path), rel)
    return str(path)


def _routes():
    return (device_exec.FUSED_GROUPBY_COUNT, device_exec.MULTI_SUM_GROUPBY_COUNT,
            device_exec.GENERAL_GROUPBY_COUNT)


def _run(path, query, cache):
    rt = Runtime(device="cpu")
    txn = rt.new_transaction(CSTableScanProvider("testtable", path), query_cache=cache)
    return rt.build_query_plan(txn, query).execute(0)


def _jax(path, query):
    rt = JRuntime()
    return rt.build_query_plan(rt.new_transaction(JScan("testtable", path)), query).execute(0)


@pytest.mark.parametrize("query", [QUERY, ROUTED])
def test_cache_hit_produces_same_result(tmp_path, query):
    path = _table_file(tmp_path / "t.cst")
    cache = QueryCache(str(tmp_path / "qcache"))
    cold = _run(path, query, cache)
    assert len(os.listdir(cache.cache_dir)) == 1
    before = _routes()
    warm = _run(path, query, cache)
    assert _routes() == before  # the hit took no route
    assert (warm.columns, warm.rows) == (cold.columns, cold.rows)
    want = _jax(path, query)
    assert (cold.columns, sorted(cold.rows)) == (want.columns, sorted(want.rows))


def test_routed_miss_takes_the_route(tmp_path):
    path = _table_file(tmp_path / "t.cst")
    before = _routes()
    _run(path, ROUTED, QueryCache(str(tmp_path / "qcache")))
    assert _routes()[0] == before[0] + 1


def test_cache_keyed_by_query(tmp_path):
    path = _table_file(tmp_path / "t.cst")
    cache = QueryCache(str(tmp_path / "qcache"))
    r1 = _run(path, "select count(1) from testtable;", cache)
    r2 = _run(path, "select count(1) from testtable group by time;", cache)
    assert r1.rows != r2.rows
    assert len(os.listdir(cache.cache_dir)) == 2


def test_cache_keyed_by_file(tmp_path):
    """Two files, and one file rewritten: each answer is its own file's."""
    a = _table_file(tmp_path / "a.cst", seed=3)
    b = _table_file(tmp_path / "b.cst", seed=4)
    cache = QueryCache(str(tmp_path / "qcache"))
    ra, rb = _run(a, ROUTED, cache), _run(b, ROUTED, cache)
    assert ra.rows != rb.rows and len(os.listdir(cache.cache_dir)) == 2
    _table_file(tmp_path / "a.cst", seed=5, n=4001)  # a new size and mtime
    before = _routes()
    again = _run(a, ROUTED, cache)
    assert _routes()[0] == before[0] + 1 and len(os.listdir(cache.cache_dir)) == 3
    assert sorted(again.rows) == sorted(_jax(a, ROUTED).rows)


def test_entries_cross_between_the_packages(tmp_path):
    """An entry the port stored reads back through the JAX package's
    cache as the same relation: one on-disk format."""
    path = _table_file(tmp_path / "t.cst")
    cache = QueryCache(str(tmp_path / "qcache"))
    _run(path, ROUTED, cache)
    (entry,) = os.listdir(cache.cache_dir)
    key = entry[: -len(".npz")]
    got, want = cache.get(key), JQueryCache(cache.cache_dir).get(key)
    assert got.names == want.names and got.num_rows == want.num_rows
    for x, y in zip(got.columns, want.columns):
        assert int(x.stype) == int(y.stype)
        np.testing.assert_array_equal(x.data, y.data)
        np.testing.assert_array_equal(x.valid, y.valid)


def test_volatile_tables_not_cached(tmp_path):
    cache = QueryCache(str(tmp_path / "qcache"))
    rt = Runtime(device="cpu")
    txn = rt.new_transaction(TableService(), query_cache=cache)
    rt.build_query_plan(txn, "CREATE TABLE t (a uint64, PRIMARY KEY (a));").execute(0)
    rt.build_query_plan(txn, "INSERT INTO t (a) VALUES (1);").execute(0)
    assert rt.build_query_plan(txn, "select count(1) from t;").execute(0).rows == [["1"]]
    assert os.listdir(cache.cache_dir) == []
    rt.build_query_plan(txn, "INSERT INTO t (a) VALUES (2);").execute(0)
    assert rt.build_query_plan(txn, "select count(1) from t;").execute(0).rows == [["2"]]
