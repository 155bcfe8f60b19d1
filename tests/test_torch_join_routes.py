"""The port's fact-dim JOIN + GROUP BY route (exec/device_exec.py:
try_execute_device_join_groupby) against the JAX package.

Tables are made by the JAX package's own test helpers (numpy, seeded)
and handed to the port through ``relation_from_numpy``. The port runs
them with ``Runtime(device="cpu")``: the same route as on the card,
through the kernels' plain versions. ResultLists must be identical to
the JAX package's host engine (same columns, same rows, same order:
tolerance 0, counts and integer sums are exact) and, where the JAX
device route is right, to that route. ``JOIN_GROUPBY_COUNT`` proves
which plans the port's route served.
"""

import random

import numpy as np
import pytest

import test_device_exec as jax_exec
import test_fuzz_device_parity as jax_fuzz

from eventql_tpu.core.types import SType
from eventql_tpu.exec.relation import Column, Relation
from eventql_tpu.exec.runtime import RelationTableProvider as JaxProvider
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import RelationTableProvider, Runtime
from eventql_tpu_torch.kernels import join as tjoin

SEEDS = range(20)


def _hand_over(provider, names):
    p = RelationTableProvider()
    for name in names:
        rel = provider.get_table_data(name)
        p.add_table(
            name,
            relation_from_numpy(
                rel.names,
                [(int(c.stype), c.data, c.valid, c.dictionary) for c in rel.columns],
            ),
        )
    return p


def _run_port(provider, query):
    """(columns, rows) and how often the join route served the query."""
    before = device_exec.JOIN_GROUPBY_COUNT
    rt = Runtime(device="cpu")
    res = rt.build_query_plan(rt.new_transaction(provider), query).execute(0)
    return (res.columns, res.rows), device_exec.JOIN_GROUPBY_COUNT - before


def _run_jax(provider, query, device):
    return jax_fuzz._run(provider, query, device=device)


# -- the queries and tables of tests/test_device_exec.py -----------------------

ROUTABLE = [True, True, True, False]  # JOIN_QUERIES[3] is min / max / mean

TABLES = {
    "small dims": {},
    "wide dims": dict(n=6000, ndim=1500, seed=29),
    "big-dim tier": dict(n=4000, ndim=tjoin.MAX_COMPARE_DIMS + 512, seed=31),
}


@pytest.mark.parametrize("tables", TABLES)
@pytest.mark.parametrize("qi", range(len(jax_exec.JOIN_QUERIES)))
def test_join_query_matches_jax_host_engine_and_device_route(qi, tables):
    query = jax_exec.JOIN_QUERIES[qi]
    provider = jax_exec._make_join_tables(**TABLES[tables])
    want = _run_jax(provider, query, device=False)
    got, taken = _run_port(_hand_over(provider, ["f", "d"]), query)
    assert got == want, f"query={query!r}\nwant={want[1][:8]}\ngot ={got[1][:8]}"
    assert taken == (1 if ROUTABLE[qi] else 0)
    # every one of these has at most one sum: the JAX device route is right
    assert got == _run_jax(provider, query, device=True)


def test_merge_tier_of_the_jax_route_agrees():
    """The JAX route's sort-merge tier (forced, as its own tests force
    it) and the port's big-dim tier give the same rows."""
    query = jax_exec.JOIN_QUERIES[0]
    kwargs = TABLES["big-dim tier"]
    want = jax_exec._run_join_merge(query, **kwargs)
    provider = jax_exec._make_join_tables(**kwargs)
    got, taken = _run_port(_hand_over(provider, ["f", "d"]), query)
    assert taken == 1 and got[1] == want


def test_tier_is_chosen_by_the_dimension_count(monkeypatch):
    calls = []
    real_dim, real_probe = tjoin.dim_join_gid, tjoin.probe_join_gid
    monkeypatch.setattr(
        tjoin, "dim_join_gid", lambda *a: calls.append("dim") or real_dim(*a))
    monkeypatch.setattr(
        tjoin, "probe_join_gid", lambda *a: calls.append("probe") or real_probe(*a))
    query = jax_exec.JOIN_QUERIES[0]
    for ndim in (tjoin.MAX_COMPARE_DIMS, tjoin.MAX_COMPARE_DIMS + 1):
        provider = jax_exec._make_join_tables(n=500, ndim=ndim, seed=5)
        got, taken = _run_port(_hand_over(provider, ["f", "d"]), query)
        assert taken == 1 and got == _run_jax(provider, query, device=False)
    assert calls == ["dim", "probe"]


@pytest.mark.parametrize("kwargs", [{"null_fact_keys": True}, {"dup_dim_keys": True}])
def test_null_or_duplicate_keys_go_to_the_host_engine(kwargs):
    """NULL fact keys join by tag in the host engine; duplicate dim keys
    fan out: neither is routed, and the rows still agree."""
    query = jax_exec.JOIN_QUERIES[0]
    provider = jax_exec._make_join_tables(**kwargs)
    got, taken = _run_port(_hand_over(provider, ["f", "d"]), query)
    assert taken == 0
    assert got == _run_jax(provider, query, device=False)


NOT_ROUTED = {
    "left join": "select d.region, count(1) from f left join d on f.k = d.k"
                 " group by d.region order by d.region;",
    "min max": "select d.region, min(f.v), max(f.v) from f join d on f.k = d.k"
               " group by d.region order by d.region;",
    "mean": "select d.region, mean(f.v) from f join d on f.k = d.k"
            " group by d.region order by d.region;",
    "count_distinct": "select d.region, count_distinct(f.v) from f join d on"
                      " f.k = d.k group by d.region order by d.region;",
    "dim-side where": "select d.region, count(1) from f join d on f.k = d.k"
                      " where d.region = 'r1' group by d.region order by d.region;",
    "residual condition": "select d.region, count(1) from f join d on f.k = d.k"
                          " and f.v < 500 group by d.region order by d.region;",
    "fact-side group": "select f.v, count(1) from f join d on f.k = d.k"
                       " group by f.v order by f.v;",
    "two group columns": "select d.region, d.k, count(1) from f join d on"
                         " f.k = d.k group by d.region, d.k order by 1, 2;",
}


@pytest.mark.parametrize("name", NOT_ROUTED)
def test_plan_outside_the_subset_goes_to_the_host_engine(name):
    query = NOT_ROUTED[name]
    provider = jax_exec._make_join_tables()
    got, taken = _run_port(_hand_over(provider, ["f", "d"]), query)
    assert taken == 0
    assert got == _run_jax(provider, query, device=False)


ROUTED = {
    "no order by": "select d.region, count(1), sum(f.v) from f join d on"
                   " f.k = d.k group by d.region;",
    "where, no order by": "select d.region, sum(f.v) from f join d on f.k = d.k"
                          " where f.v >= 300 and f.v < 800 group by d.region;",
    "where keeps nothing": "select d.region, count(1) from f join d on f.k = d.k"
                           " where f.v > 5000 group by d.region;",
    "expression over aggregates": "select d.region, sum(f.v) + count(1) * 2 from f"
                                  " join d on f.k = d.k group by d.region;",
    "three sums": "select d.region, sum(f.v), sum(f.v * 2), sum(f.v + 1), count(1)"
                  " from f join d on f.k = d.k group by d.region;",
    "nine sums": "select d.region, " + ", ".join(
        f"sum(f.v + {i})" for i in range(9)
    ) + " from f join d on f.k = d.k group by d.region;",
    "group by the key column": "select d.k, count(1) from f join d on f.k = d.k"
                               " group by d.k;",
    "having": "select d.region, count(1) from f join d on f.k = d.k"
              " group by d.region having count(1) > 280 order by d.region;",
    "limit": "select d.region, sum(f.v) from f join d on f.k = d.k"
             " group by d.region order by 2 desc limit 3;",
}


@pytest.mark.parametrize("name", ROUTED)
def test_routable_plan_keeps_the_host_engines_presentation_order(name):
    """No ORDER BY in most of these: the rows must come in the host
    engine's order, the first surviving base row of each group."""
    query = ROUTED[name]
    provider = jax_exec._make_join_tables()
    got, taken = _run_port(_hand_over(provider, ["f", "d"]), query)
    assert taken == 1
    assert got == _run_jax(provider, query, device=False)


@pytest.mark.parametrize("prefix, readbacks", [(1, 2), (3, 2), (4000, 1)])
def test_first_rows_beyond_the_searched_prefix(monkeypatch, prefix, readbacks):
    """The route looks for each group's first surviving row in a prefix
    of the table and reads the result back once; a group without a row
    there costs a search of the rest and a second readback, and the
    order stays the host engine's."""
    from eventql_tpu_torch.kernels import sort as tsort

    monkeypatch.setattr(device_exec, "FIRST_ROWS_PREFIX", prefix)
    provider = jax_exec._make_join_tables()
    handed = _hand_over(provider, ["f", "d"])
    for name in ("no order by", "where, no order by", "three sums"):
        before = tsort.READBACKS
        got, taken = _run_port(handed, ROUTED[name])
        assert taken == 1 and tsort.READBACKS - before == readbacks
        assert got == _run_jax(provider, ROUTED[name], device=False)


def test_two_different_sums_over_a_join_stay_different():
    """Every sum has a stream of its own. The JAX device route does not
    do that: pallas_grouped_aggregate
    (eventql_tpu/kernels/pallas_groupby.py:968-983) keeps only the last
    sum stream and returns its sums for every sum entry, so there
    sum(f.v) comes back equal to sum(f.v + 1). The port must equal the
    host engine and therefore differ from that route."""
    query = ("select d.region, sum(f.v), sum(f.v + 1), count(1) from f join d"
             " on f.k = d.k group by d.region;")
    provider = jax_exec._make_join_tables()
    want = _run_jax(provider, query, device=False)
    got, taken = _run_port(_hand_over(provider, ["f", "d"]), query)
    assert taken == 1
    assert got == want
    assert got[1][0] == ["r0", "145549", "145881", "332"]
    assert all(r[1] != r[2] for r in got[1])
    jax_device = _run_jax(provider, query, device=True)
    assert jax_device != want
    assert all(r[1] == r[2] for r in jax_device[1])


def test_more_than_65536_groups_on_the_big_dim_tier(monkeypatch):
    """Bucket ids beyond 16 bits: the probe returns the whole int32
    bucket. The JAX kernels carry the bucket in two int8 limbs
    (eventql_tpu/kernels/join.py:171, :375, :501) and its SQL route does
    not guard the merge tier (eventql_tpu/exec/device_exec.py:2196-2203),
    so where the fact blocks are dense enough to take the windowed
    compare, groups from 65536 up fold onto the low ones there. The port
    must equal the host engine and therefore differ from that route."""
    d, n = 70_000, 700_000
    npr = np.random.default_rng(41)
    dk = npr.permutation(np.arange(d, dtype=np.uint64) * 3 + 1)
    fk = dk[npr.integers(0, d, n)]
    fv = npr.integers(0, 1000, n).astype(np.uint64)
    p = JaxProvider()
    ones = np.ones(n, bool)
    p.add_table("f", Relation(
        ["k", "v"], [Column(SType.UINT64, fk, ones), Column(SType.UINT64, fv, ones)], n))
    p.add_table("d", Relation(
        ["k", "g"],
        [Column(SType.UINT64, dk, np.ones(d, bool)),
         Column(SType.UINT64, np.arange(d, dtype=np.uint64) + 5, np.ones(d, bool))],
        d))
    query = ("select d.g, count(1), sum(f.v) from f join d on f.k = d.k"
             " group by d.g order by 1;")
    want = _run_jax(p, query, device=False)
    got, taken = _run_port(_hand_over(p, ["f", "d"]), query)
    assert taken == 1
    assert got == want
    assert len(got[1]) > 65536
    monkeypatch.setenv("EVENTQL_TPU_MERGE_JOIN", "1")
    jax_device = _run_jax(p, query, device=True)
    assert jax_device != want and len(jax_device[1]) <= 65536


# -- the join grammar of tests/test_fuzz_device_parity.py ----------------------


def _fuzz_case(seed):
    rng = random.Random(5000 + seed)
    provider = jax_fuzz._make_join_tables(rng)
    return provider, jax_fuzz._gen_join_query(rng)


@pytest.mark.parametrize("seed", SEEDS)
def test_join_fuzz_port_matches_jax_host_engine(seed):
    provider, query = _fuzz_case(seed)
    want = _run_jax(provider, query, device=False)
    got, _taken = _run_port(_hand_over(provider, ["facts", "dims"]), query)
    assert got == want, (
        f"seed={seed} query={query!r}\nwant={want[1][:8]}\ngot ={got[1][:8]}"
    )
    if query.count("sum(") <= 1:
        assert got == _run_jax(provider, query, device=True)


ROUTABLE_AGGS = ["count(1)", "sum(facts.v)", "count(facts.v)", "sum(facts.v + 3)",
                 "sum(facts.v * 2)", "sum(facts.v) + count(1)"]
ROUTABLE_WHERES = ["facts.v < 500", "facts.v % 3 = 0", "facts.f > 0.0",
                   "facts.v >= 100 and facts.v < 900"]


def _gen_routable_query(rng: random.Random) -> str:
    """Integer sums and counts only, inner joins only, and no ORDER BY
    half the time, so the presentation order is compared too."""
    aggs = rng.sample(ROUTABLE_AGGS, rng.randint(1, 4))
    q = (f"select dims.attr, {', '.join(aggs)} from facts join dims"
         f" on facts.k = dims.k")
    if rng.random() < 0.6:
        q += " where " + rng.choice(ROUTABLE_WHERES)
    q += " group by dims.attr"
    if rng.random() < 0.5:
        q += " order by " + ", ".join(str(i + 1) for i in range(1 + len(aggs)))
    return q + ";"


def _routable_case(seed):
    rng = random.Random(7000 + seed)
    provider = jax_fuzz._make_join_tables(rng)
    return provider, _gen_routable_query(rng)


@pytest.mark.parametrize("seed", SEEDS)
def test_routable_join_fuzz_port_matches_jax_host_engine(seed):
    provider, query = _routable_case(seed)
    want = _run_jax(provider, query, device=False)
    got, taken = _run_port(_hand_over(provider, ["facts", "dims"]), query)
    assert got == want, (
        f"seed={seed} query={query!r}\nwant={want[1][:8]}\ngot ={got[1][:8]}"
    )
    # only an empty fact table keeps such a plan off the route
    assert taken == (1 if provider.get_table_data("facts").num_rows else 0)


def test_join_fuzz_reaches_the_route():
    """Both grammars must reach the route, else the fuzz compares host
    engine with host engine."""
    hits = sum(_run_port(_hand_over(p, ["facts", "dims"]), q)[1]
               for p, q in map(_fuzz_case, SEEDS))
    routable_hits = sum(_run_port(_hand_over(p, ["facts", "dims"]), q)[1]
                        for p, q in map(_routable_case, SEEDS))
    assert hits >= 3, f"only {hits}/20 join fuzz queries took the port's route"
    assert routable_hits >= 10, (
        f"only {routable_hits}/20 routable join fuzz queries took the route")
