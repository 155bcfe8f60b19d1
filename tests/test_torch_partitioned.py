"""The port's partitioned provider (parallel/partitioned.py and its hook in
operators._exec_group_by) against the JAX package's.

tests/test_partitioned.py's parametrisation: six GROUP BY queries over a
table hash-partitioned into 1, 4 and 7 shards, each shard aggregated
alone on the host and the partials merged. Under Runtime(device="cpu")
the port answers as its single-table GROUP BY and as the JAX package's
partitioned provider, and sends no partition to the card's routes (the
JAX package does not either). The partitions themselves are the JAX
package's, row for row.
"""

import numpy as np
import pytest

from eventql_tpu.core.types import SType as JSType
from eventql_tpu.exec.relation import Column as JColumn, Relation as JRelation
from eventql_tpu.exec.runtime import Runtime as JRuntime
from eventql_tpu.parallel import partitioned as jpart
from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.relation import Column, Relation
from eventql_tpu_torch.exec.runtime import RelationTableProvider, Runtime
from eventql_tpu_torch.parallel import partitioned

QUERIES = [
    "select k, count(1), sum(v) from t group by k order by k;",
    "select k, min(v), max(v) from t group by k order by k;",
    "select city, sum(v) from t where v < 700 group by city order by city;",
    "select k % 4, count(v), mean(f) from t group by k % 4 order by k % 4;",
    "select count_distinct(v) from t;",
    "select sum(v) + count(1) from t;",
]


def _make_relation(S, C, R, n=4000, seed=5):
    """tests/test_partitioned.py:_make_relation with the given classes."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 23, n).astype(np.uint64)
    vals = rng.integers(0, 1000, n).astype(np.uint64)
    fvals = np.round(rng.standard_normal(n), 4)
    cities = [f"city{int(k) % 7}".encode() for k in keys]
    return R(["k", "v", "f", "city"],
             [C(S.UINT64, keys, np.ones(n, bool)), C(S.UINT64, vals, np.ones(n, bool)),
              C(S.FLOAT64, fvals, np.ones(n, bool)), C.from_strings(cities)], n)


def _run(rt, provider, query):
    res = rt.build_query_plan(rt.new_transaction(provider), query).execute(0)
    return res.columns, res.rows


def _routes():
    return (device_exec.FUSED_GROUPBY_COUNT, device_exec.MULTI_SUM_GROUPBY_COUNT,
            device_exec.GENERAL_GROUPBY_COUNT)


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("shards", [1, 4, 7])
def test_partitioned_matches_single_and_the_jax_package(query, shards):
    rel = _make_relation(SType, Column, Relation)
    single = RelationTableProvider()
    single.add_table("t", rel)
    parted = partitioned.PartitionedTableProvider(shards)
    parted.add_table("t", rel, "k")
    jparted = jpart.PartitionedTableProvider(shards)
    jparted.add_table("t", _make_relation(JSType, JColumn, JRelation), "k")

    rt = Runtime(device="cpu")
    before = _routes()
    dist = _run(rt, parted, query)
    assert _routes() == before  # partitions merge on the host
    host = _run(rt, single, query)
    assert dist == _run(JRuntime(), jparted, query)
    assert dist[0] == host[0]
    if "order by" in query:
        assert dist[1] == host[1]
    else:
        assert sorted(map(tuple, dist[1])) == sorted(map(tuple, host[1]))


@pytest.mark.parametrize("key", ["k", "city"])
def test_partitions_are_the_jax_packages(key):
    rel = _make_relation(SType, Column, Relation)
    jrel = _make_relation(JSType, JColumn, JRelation)
    got = partitioned.partition_relation(rel, key, 5)
    want = jpart.partition_relation(jrel, key, 5)
    assert [p.num_rows for p in got] == [p.num_rows for p in want]
    for p, q in zip(got, want):
        for a, b in zip(p.columns, q.columns):
            np.testing.assert_array_equal(a.data, b.data)
    x = np.arange(1000, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    np.testing.assert_array_equal(partitioned.hash_u64(x), jpart.hash_u64(x))


def test_shapes_that_do_not_distribute_answer_on_the_whole_table():
    """A plan execute_partitioned_group_by declines (a join child) runs
    over the concatenated partitions, as in the JAX package."""
    rel = _make_relation(SType, Column, Relation)
    parted = partitioned.PartitionedTableProvider(3)
    parted.add_table("t", rel, "k")
    parted.add_table("u", rel, "city")
    jrel = _make_relation(JSType, JColumn, JRelation)
    jparted = jpart.PartitionedTableProvider(3)
    jparted.add_table("t", jrel, "k")
    jparted.add_table("u", jrel, "city")
    q = ("select t.city, count(1) from t join u on t.v = u.v where u.k < 3"
         " group by t.city order by t.city;")
    assert _run(Runtime(device="cpu"), parted, q) == _run(JRuntime(), jparted, q)
