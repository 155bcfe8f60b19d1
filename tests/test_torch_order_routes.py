"""The port's device ORDER BY routes (exec/device_exec.py:
try_execute_device_scan_topk / try_execute_device_scan_order) against
the JAX package's host engine.

Tables are made by the JAX package's own test helpers (numpy, seeded)
and handed to the port through ``relation_from_numpy``. The port runs
them with ``Runtime(device="cpu")``: the same routes as on the card,
through the kernels' plain versions. ResultLists must be identical:
same columns, same rows, same order (both sorts are stable, ties to the
lower row index). The route counters prove which route served a query.
"""

import random

import numpy as np
import pytest

import test_device_topk as jax_topk
from test_fuzz_device_order import _gen_order_query, _make_table, _run

from eventql_tpu.core.types import SType
from eventql_tpu.exec.relation import Column, Relation
from eventql_tpu.exec.runtime import RelationTableProvider as JaxProvider
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import RelationTableProvider, Runtime

SEEDS = range(30)


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


def _run_port(provider, query):
    """(columns, rows) and how often each ORDER BY route was taken."""
    topk0, order0 = device_exec.SCAN_TOPK_COUNT, device_exec.SCAN_ORDER_COUNT
    rt = Runtime(device="cpu")
    res = rt.build_query_plan(rt.new_transaction(provider), query).execute(0)
    routes = (device_exec.SCAN_TOPK_COUNT - topk0,
              device_exec.SCAN_ORDER_COUNT - order0)
    return (res.columns, res.rows), routes


def _fuzz_case(seed):
    rng = random.Random(3000 + seed)
    provider = _make_table(rng)
    return provider, _gen_order_query(rng)


@pytest.mark.parametrize("seed", SEEDS)
def test_order_fuzz_port_matches_jax_host_engine(seed):
    provider, query = _fuzz_case(seed)
    want = _run(provider, query, device=False)
    got, _routes = _run_port(_hand_over(provider), query)
    assert got == want, (
        f"seed={seed} query={query!r}\nwant={want[1][:8]}\ngot ={got[1][:8]}"
    )


def test_order_fuzz_reaches_the_routes():
    """At least half the seeds must be served by a port route, else the
    fuzz compares host engine with host engine."""
    hits = 0
    for seed in SEEDS:
        provider, query = _fuzz_case(seed)
        hits += sum(_run_port(_hand_over(provider), query)[1]) > 0
    assert hits >= 15, f"only {hits}/30 order fuzz queries took a port route"


# -- the cases of tests/test_device_topk.py ------------------------------------


def _provider(names, columns, n):
    p = JaxProvider()
    p.add_table("t", Relation(names, columns, n))
    return p


def _tie_free():
    n = 64
    npr = np.random.default_rng(3)
    ones = np.ones(n, bool)
    return _provider(
        ["u", "i", "f", "s"],
        [
            Column(SType.UINT64, npr.permutation(n).astype(np.uint64), ones),
            Column(SType.INT64, (npr.permutation(n) - 32).astype(np.int64), ones),
            Column(SType.FLOAT64, ((npr.permutation(n) - 31.5) / 8.0), ones),
            Column.from_strings([b"s%03d" % k for k in npr.permutation(n)]),
        ],
        n,
    )


def _int64_ends():
    vals = np.array([5, -3, np.iinfo(np.int64).min, 0, np.iinfo(np.int64).max],
                    dtype=np.int64)
    return _provider(["i"], [Column(SType.INT64, vals, np.ones(5, bool))], 5)


def _null_strings():
    sv = [b"NULL", None, b"NULA", b"NULM", None, b"NULL"]
    return _provider(["s"], [Column.from_strings(sv)], len(sv))


def _zero_key(variant):
    """Passing rows whose top-key is 0 (UINT64_MAX under ASC) while the
    filter underfills the window: the tie with filtered rows must be
    seen and the exact sort taken."""
    n = 40
    u = np.arange(n).astype(np.uint64)
    u[-3:] = np.iinfo(np.uint64).max
    if variant == 0:
        flt = np.zeros(n, np.uint64)
        flt[: n // 2] = 1
    else:
        flt = np.ones(n, np.uint64)
        flt[5:10] = 0
    ones = np.ones(n, bool)
    return _provider(
        ["u", "flt"],
        [Column(SType.UINT64, u, ones), Column(SType.UINT64, flt, ones)],
        n,
    )


def _floats():
    """NaN sorts last in BOTH directions, -0.0 ties +0.0, NULL is 0.0."""
    f = np.array([1.5, np.nan, -0.0, 0.0, np.inf, -np.inf, 7.0, np.nan, -2.25,
                  0.0, 3.0, -0.0])
    valid = np.ones(len(f), bool)
    valid[[6, 10]] = False
    f = np.where(valid, f, 0.0)
    return _provider(
        ["f", "r"],
        [Column(SType.FLOAT64, f, valid),
         Column(SType.UINT64, np.arange(len(f)).astype(np.uint64), np.ones(len(f), bool))],
        len(f),
    )


def _unsorted_dictionary():
    """Dictionary ids are ranks only for a sorted dictionary."""
    data = np.array([0, 1, 2, 0, 1], np.int32)
    dictionary = np.array([b"pear", b"apple", b"fig"], dtype=object)
    return _provider(
        ["s"], [Column(SType.STRING, data, np.ones(5, bool), dictionary)], 5
    )


TOPK, ORDER, BOTH_DECLINE = (1, 0), (0, 1), (0, 0)
_ALL = "u, i, f, b, s"

# name -> (table, query, (top-k route count, full-order route count))
CASES = {
    "route fires": (jax_topk._table, "select u, i from t order by u limit 5;", TOPK),
    **{
        f"single key + tiebreak [{key}]": (
            jax_topk._table,
            f"select {_ALL} from t order by {key}, u, i, f, s limit 23;", TOPK)
        for key in ["u", "i", "f", "b", "s", "u desc", "i desc", "f desc",
                    "s desc", "b desc"]
    },
    **{
        f"single key only [{key}]": (
            _tie_free, f"select u, i, f, s from t order by {key} limit 10;", TOPK)
        for key in ["u", "i desc", "f", "s", "s desc", "f desc"]
    },
    "where and offset": (
        jax_topk._table,
        "select u, i from t where i > 0 and u < 40"
        " order by i desc, u, f, s limit 7 offset 5;", TOPK),
    "where keeps nothing": (
        jax_topk._table, "select u from t where u > 1000 order by u limit 5;", TOPK),
    # LIMIT 0: the top-k route declines, the ORDER BY below it is routed
    "limit 0": (jax_topk._table, "select u from t order by u, i, f, s limit 0;", ORDER),
    "limit beyond the table": (
        jax_topk._table, "select u from t order by u, i, f, s limit 10000;", TOPK),
    "offset beyond the table": (
        jax_topk._table,
        "select u from t order by u, i, f, s limit 3 offset 10000;", TOPK),
    "computed sort exprs": (
        jax_topk._table,
        "select u, i, f from t where f > -5.0"
        " order by (i * -3) + u, f desc, u, s limit 19;", TOPK),
    "int64 min desc": (_int64_ends, "select i from t order by i desc limit 5;", TOPK),
    "int64 min asc": (_int64_ends, "select i from t order by i limit 2;", TOPK),
    "string NULL vs 'NULL'": (_null_strings, "select s from t order by s limit 6;", TOPK),
    "string NULL vs 'NULL' desc": (
        _null_strings, "select s from t order by s desc limit 6;", TOPK),
    **{
        f"zero-key corner [{variant}, limit {lim}]": (
            (lambda v=variant: _zero_key(v)),
            f"select u from t where flt = 1 order by u limit {lim};", TOPK)
        for variant in (0, 1) for lim in (40, 36, 4)
    },
    **{
        f"float specials [{spec}]": (_floats, f"select f, r from t order by {spec};", route)
        for spec, route in [("f limit 12", TOPK), ("f desc limit 12", TOPK),
                            ("f desc limit 4", TOPK), ("f", ORDER), ("f desc", ORDER),
                            ("f + 1.0 desc limit 5", TOPK), ("f desc, r desc", ORDER)]
    },
    "full order": (jax_topk._table, "select u, i from t order by u, i, f, s;", ORDER),
    "full order desc lead": (
        jax_topk._table, f"select {_ALL} from t order by i desc, u, f, s;", ORDER),
    "full order where": (
        jax_topk._table, "select u, s from t where u < 30 order by s, u, i, f;", ORDER),
    "full order keeps nothing": (
        jax_topk._table, "select u from t where u > 1000 order by u;", ORDER),
    "full order float desc": (
        jax_topk._table, "select f, u from t order by f desc, u, i, s;", ORDER),
    "full order single key, no where": (
        jax_topk._table, "select f, u from t order by f;", ORDER),
    # not routable: the host sort / slice serves these
    "order above a group by": (
        jax_topk._table,
        "select u, count(1) from t group by u order by u limit 3;", BOTH_DECLINE),
    "unsorted dictionary": (
        _unsorted_dictionary, "select s from t order by s limit 4;", BOTH_DECLINE),
    "unsorted dictionary, full order": (
        _unsorted_dictionary, "select s from t order by s desc;", BOTH_DECLINE),
    "limit without order": (jax_topk._table, "select u from t limit 3;", BOTH_DECLINE),
}


@pytest.mark.parametrize("name", CASES)
def test_order_route_case(name):
    make, query, routes = CASES[name]
    provider = make()
    want = jax_topk._run(provider, query, device=False)
    got, taken = _run_port(_hand_over(provider), query)
    assert got == want, f"query={query!r}\nwant={want[1][:10]}\ngot ={got[1][:10]}"
    assert taken == routes


def test_zero_key_corner_is_answered_by_the_full_sort(monkeypatch):
    """The corner itself: the window of the top-k holds filtered rows
    and misses a passing zero-key row, so the route must rerun through
    the masked full sort (and not emit the top-k's window)."""
    from eventql_tpu_torch.kernels import sort as tsort

    sorts = []
    real = tsort.order_permutation
    monkeypatch.setattr(
        tsort, "order_permutation", lambda keys: sorts.append(len(keys)) or real(keys)
    )
    provider = _zero_key(1)  # 35 rows pass, 3 of them with key 0
    # a window of 36: the 32 passing non-zero keys, then the zero keys in
    # row order, where the filtered rows 5..8 come before the passing 37..39
    query = "select u from t where flt = 1 order by u limit 36;"
    got, taken = _run_port(_hand_over(provider), query)
    assert taken == TOPK and sorts == [2]  # mask key + the one sort key
    assert got == jax_topk._run(provider, query, device=False)
    assert [r[0] for r in got[1][-3:]] == [str(np.iinfo(np.uint64).max)] * 3


def _scan_topk_case(seed):
    """The generator of test_device_topk.test_fuzz_scan_topk_parity:
    (provider, query)."""
    keys = ["u", "i", "f", "s", "b"]
    wheres = ["u < 30", "i >= 0", "f > 0.0", "u % 3 = 1"]
    rng = random.Random(4000 + seed)
    provider = jax_topk._table(n=rng.choice([1, 9, 100, 1500]), seed=seed)
    nk = rng.choice([1, 1, 2, 3])
    order = ", ".join(
        f"{k}{' desc' if rng.random() < 0.4 else ''}" for k in rng.sample(keys, nk)
    )
    rest = ", ".join(k for k in keys if k not in order)
    q = f"select {_ALL} from t"
    if rng.random() < 0.6:
        q += " where " + rng.choice(wheres)
    q += f" order by {order}, {rest}"
    if rng.random() < 0.75:
        q += f" limit {rng.choice([1, 3, 17, 400])}"
        if rng.random() < 0.3:
            q += f" offset {rng.choice([1, 5, 50])}"
    return provider, q + ";"


@pytest.mark.parametrize("seed", range(25))
def test_scan_topk_fuzz_port_matches_jax_host_engine(seed):
    """The generator of test_device_topk.test_fuzz_scan_topk_parity."""
    provider, q = _scan_topk_case(seed)
    want = jax_topk._run(provider, q, device=False)
    got, taken = _run_port(_hand_over(provider), q)
    assert got == want, f"query={q!r}"
    assert sum(taken) == 1
