"""The device fuzz grammar of tests/test_fuzz_device_parity.py through
the port.

Random tables (sizes 0..20k, null masks, negative ints, uint64s near the
wrap boundary, key cardinalities 1..4099) and random GROUP BY queries
(every aggregate kind, computed keys, WHERE trees, HAVING, ORDER BY,
LIMIT) run through the JAX package's host engine and through
eventql_tpu_torch's Runtime(device="cpu"), which takes the CUDA route's
CPU form wherever the plan is routable and its own host engine
elsewhere. ResultLists must be identical. (That the JAX package's device
routes equal its host engine on this grammar is the original test's
job.)
"""

import random

import pytest

from test_fuzz_device_parity import _gen_query, _make_table, _run

from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import RelationTableProvider, Runtime

SEEDS = range(60)


def _case(seed):
    rng = random.Random(1000 + seed)
    provider = _make_table(rng)
    return provider, _gen_query(rng)


def _hand_over(provider):
    rel = provider.get_table_data("t")
    p = RelationTableProvider()
    p.add_table(
        "t",
        relation_from_numpy(
            rel.names,
            [(int(c.stype), c.data, c.valid, c.dictionary) for c in rel.columns],
        ),
    )
    return p


def _outcome(fn):
    """The ResultList, or the error: a few generated queries are type
    errors (`having mean(f) != 100`), and must be so in both packages."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared by name and message
        return ("error", type(e).__name__, str(e))


def _routed():
    return (device_exec.FUSED_GROUPBY_COUNT + device_exec.MULTI_SUM_GROUPBY_COUNT
            + device_exec.GENERAL_GROUPBY_COUNT)


def _run_port(provider, query):
    routed = _routed()

    def run():
        rt = Runtime(device="cpu")
        res = rt.build_query_plan(rt.new_transaction(provider), query).execute(0)
        return (res.columns, res.rows)

    out = _outcome(run)
    return out, _routed() - routed


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_port_matches_jax_package(seed):
    provider, query = _case(seed)
    want = _outcome(lambda: _run(provider, query, device=False))
    got, _routed = _run_port(_hand_over(provider), query)
    assert got == want, (
        f"seed={seed} query={query!r}\nwant={want[1][:8]}\ngot ={got[1][:8]}"
    )


def test_fuzz_is_not_vacuous():
    """Most of the grammar must take one of the port's device routes
    (the general route serves min / max / mean / count_distinct, float
    sums, several and computed keys), otherwise the fuzz compares host
    engine with host engine. The JAX package's own test asks the same
    of its device gate on the first 40 seeds."""
    hits = sum(_run_port(_hand_over(p), q)[1] for p, q in map(_case, range(40)))
    assert hits >= 24, f"only {hits}/40 fuzz queries took a device route"


# -- the same tables under a grammar narrowed to this slice's route -----------
# one plain key, count / sum aggregates (plain, signed, computed, several
# at once), the original WHERE terms joined by and / or

ROUTE_AGGS = ["count(1)", "count(v)", "sum(v)", "sum(k2)", "sum(v + 1)",
              "sum(k1)", "sum(v) + count(1)"]
ROUTE_WHERE = ["v < 5000", "k1 > 5", "k2 >= 0", "v % 7 = 1", "k2 < 10",
               "v = 77", "5000 >= v"]
ROUTE_SEEDS = range(50)


def _route_case(seed):
    rng = random.Random(5000 + seed)
    provider = _make_table(rng)
    key = rng.choice(["k1", "k2"])
    aggs = rng.sample(ROUTE_AGGS, rng.randint(1, 3))
    q = f"select {key}, {', '.join(aggs)} from t"
    if rng.random() < 0.7:
        terms = rng.sample(ROUTE_WHERE, rng.randint(1, 3))
        clause = terms[0]
        for t in terms[1:]:
            clause += f" {rng.choice(['and', 'or'])} {t}"
        q += " where " + clause
    q += f" group by {key} order by 1"
    if rng.random() < 0.3:
        q += f" limit {rng.choice([1, 5, 1000])}"
    return provider, q + ";"


@pytest.mark.parametrize("seed", ROUTE_SEEDS)
def test_route_fuzz_port_matches_jax_package(seed):
    provider, query = _route_case(seed)
    want = _outcome(lambda: _run(provider, query, device=False))
    got, _routed = _run_port(_hand_over(provider), query)
    assert got == want, (
        f"seed={seed} query={query!r}\nwant={want[1][:8]}\ngot ={got[1][:8]}"
    )


def test_fuzz_reaches_the_route():
    """A good share of the narrowed grammar must take the port's kernel
    route, otherwise the fuzz is host engine against host engine. (The
    tables' numeric keys only take the fully fused form, so empty
    tables, signed or computed sums and 64-bit values stay on the host
    engine, as they do in the JAX package.)"""
    hits = 0
    for seed in ROUTE_SEEDS:
        provider, query = _route_case(seed)
        hits += _run_port(_hand_over(provider), query)[1]
    assert hits >= 12, f"only {hits}/{len(ROUTE_SEEDS)} queries took the route"
