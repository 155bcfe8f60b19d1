"""The port's general GROUP BY against the JAX package.

Two levels, each fed the same seeded numpy inputs in both packages:

* kernels/groupby.py's ``masked_grouped_aggregate`` /
  ``masked_grouped_count_distinct`` (the plain version of the hash
  aggregate in kernels/hash_groupby.py) against the JAX functions of the
  same names, on the CPU: 1-3 keys with NULL keys folded in as the route
  folds them, a mask, every aggregate kind. The JAX groups come in key
  order, the port's in its own; both are compared in the order of their
  first rows. Tolerance 0 (floats are multiples of 1/64, so every sum is
  exact in any order) except one pinned case of floats that are not
  order-proof: there a group's sum may differ by n * 2^-52 * sum(|x|).
* SQL text -> ResultList: the route (exec/device_exec.py:
  execute_device_groupby, and the join route's general branch) through
  ``Runtime(device="cpu")`` against the JAX package's device route
  (``EVENTQL_TPU_DEVICE=1``) and its host engine, on the queries G1-G5
  and J1 of chip_smoke.py at a small size and on pinned cases (NaN,
  u64 >= 2^63, -0.0 beside +0.0, a WHERE that keeps nothing, an empty
  table, count_distinct of a float). Same rows in the same order:
  tolerance 0.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventql_tpu.core.types import SType
from eventql_tpu.exec.relation import Column, Relation
from eventql_tpu.exec.runtime import RelationTableProvider, Runtime
from eventql_tpu.kernels import groupby as jgroupby
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import (
    RelationTableProvider as TorchProvider,
    Runtime as TorchRuntime,
)
from eventql_tpu_torch.kernels import groupby as tgroupby
from eventql_tpu_torch.kernels import hash_groupby as hg

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the queries of its general path)

_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32,
           np.dtype(np.uint64): np.int64}


def _tensor(arr):
    arr = np.ascontiguousarray(arr)
    view = _SIGNED.get(arr.dtype)
    return torch.from_numpy(arr.view(view) if view else arr)


# -- module level -------------------------------------------------------------


def _inputs(seed, nk, n=3000, null_share=0.1):
    """Keys with NULLs (bits 0 where NULL, as the route folds them), a
    mask, and value streams of every kind the route hands over."""
    rng = np.random.default_rng(seed)
    card = {1: 300, 2: 20, 3: 7}[nk]
    keys, valids = [], []
    for j in range(nk):
        k = rng.integers(0, card, n).astype(np.uint64)
        k[:3] = [0, 0, 1]
        valid = rng.random(n) >= null_share
        valid[0] = False  # a NULL key next to a real key 0 (row 1)
        keys.append(np.where(valid, k, 0).astype(np.uint64))
        valids.append(valid)
    mask = rng.random(n) < 0.8
    u64 = rng.integers(0, 1000, n).astype(np.uint64)
    u64[rng.integers(0, n, n // 40)] += np.uint64(1 << 63)  # max >= 2^63
    i64 = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)  # negative mins
    f64 = rng.integers(-4096, 4096, n) / 64.0  # order-proof sums
    f64[rng.integers(0, n, 5)] = np.nan
    f64[rng.integers(0, n, 50)] = -0.0
    u16 = rng.integers(0, 65536, n).astype(np.uint16)  # a narrow unsigned stream
    return keys, valids, mask, dict(u64=u64, i64=i64, f64=f64, u16=u16)


# (stream, kind) pairs: every kind on every type it takes
STREAMS = [("u64", "sum"), ("u64", "min"), ("u64", "max"), ("i64", "sum"),
           ("i64", "min"), ("i64", "max"), ("f64", "sum"), ("f64", "min"),
           ("f64", "max"), ("f64", "mean"), ("u16", "min"), ("u16", "max"),
           ("u16", "sum")]


def _jax_grouped(mask, jkeys, values, kinds):
    gk, outs, first, ng = jgroupby.masked_grouped_aggregate(
        jnp.asarray(mask), tuple(jnp.asarray(k) for k in jkeys),
        tuple(jnp.asarray(v) for v in values), tuple(kinds))
    ng = int(ng)
    return np.asarray(first)[:ng], [np.asarray(o)[:ng] for o in outs]


def _same(a, b, what):
    """Exact equality; floats also in the sign of zero, NaN equal to NaN."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    if a.dtype.kind == "f":
        assert np.array_equal(a, b, equal_nan=True), what
        ok = ~np.isnan(a)
        assert np.array_equal(np.signbit(a[ok]), np.signbit(b[ok])), what
    else:
        assert np.array_equal(a.view(np.uint64), b.view(np.uint64)), what


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nk", [1, 2, 3])
def test_masked_grouped_aggregate_matches_jax(nk, masked):
    keys, valids, mask, vals = _inputs(10 + nk, nk)
    if not masked:
        mask = np.ones_like(mask)
    # JAX: the route's 2 * nk key columns (bits, then one tag per key)
    jkeys = keys + [(~v).astype(np.uint64) for v in valids]
    jvals = [np.zeros(len(mask), np.uint64)] + [
        vals[s].astype(np.uint64) if s == "u16" else vals[s] for s, _k in STREAMS]
    jfirst, jouts = _jax_grouped(mask, jkeys, jvals, ["count"] + [k for _s, k in STREAMS])
    # the port: the bits and ONE tag word (bit i: key i is NULL)
    tags = sum((~v).astype(np.int64) << i for i, v in enumerate(valids))
    tkeys = [_tensor(k) for k in keys] + [_tensor(tags)]
    first, counts, outs = tgroupby.masked_grouped_aggregate(
        None if not masked else _tensor(mask), tkeys,
        [_tensor(vals[s]) for s, _k in STREAMS], [k for _s, k in STREAMS],
        [s in ("u64", "u16") for s, _k in STREAMS])
    order = np.argsort(first.numpy())
    jorder = np.argsort(jfirst)
    assert len(order) == len(jorder) > 50
    _same(first.numpy()[order], jfirst[jorder], "first_index")
    _same(counts.numpy()[order], jouts[0][jorder], "count")
    for (s, kind), got, want in zip(STREAMS, outs, jouts[1:]):
        got = got.numpy()[order]
        _same(got, want[jorder].astype(got.dtype) if s != "u64" else want[jorder],
              f"{kind}({s})")
    # the cases the inputs were made for did occur
    f_min = outs[STREAMS.index(("f64", "min"))].numpy()
    u_max = outs[STREAMS.index(("u64", "max"))].numpy().view(np.uint64)
    assert np.isnan(f_min).any() and (u_max >= (1 << 63)).any()
    assert (outs[STREAMS.index(("i64", "min"))].numpy() < 0).any()


@pytest.mark.parametrize("nk", [1, 2, 3])
def test_masked_grouped_count_distinct_matches_jax(nk):
    keys, valids, mask, vals = _inputs(30 + nk, nk)
    jkeys = [jnp.asarray(k) for k in keys + [(~v).astype(np.uint64) for v in valids]]
    jm = jnp.asarray(mask)
    _gk, _outs, jfirst, ng = jgroupby.masked_grouped_aggregate(
        jm, tuple(jkeys), (jnp.zeros(len(mask), jnp.uint64),), ("count",))
    ng = int(ng)
    tags = sum((~v).astype(np.int64) << i for i, v in enumerate(valids))
    tkeys = [_tensor(k) for k in keys] + [_tensor(tags)]
    first, _c, _o = tgroupby.masked_grouped_aggregate(_tensor(mask), tkeys, (), ())
    order = np.argsort(first.numpy())
    jorder = np.argsort(np.asarray(jfirst)[:ng])
    for name in ("u64", "u16", "i64"):
        small = vals[name] % 5 if name != "u64" else vals[name] % np.uint64(9)
        want = np.asarray(jgroupby.masked_grouped_count_distinct(
            jm, tuple(jkeys), jnp.asarray(small.astype(np.uint64))))[:ng]
        got = tgroupby.masked_grouped_count_distinct(_tensor(mask), tkeys, _tensor(small))
        _same(got.numpy()[order], want[jorder], f"count_distinct({name})")
        assert got.max() > 1


def test_float_sum_that_is_not_order_proof():
    """Pinned: floats that are not multiples of a power of two sum to
    other last bits in another order. The port's sum (and the kernel's,
    whose atomics land in no fixed order) must stay within a relative
    n * 2^-52 of the group's sum of |x| of the JAX package's."""
    rng = np.random.default_rng(5)
    n = 20_000
    k = rng.integers(0, 9, n).astype(np.uint64)
    x = rng.standard_normal(n) * 1e6
    jfirst, (jsum,) = _jax_grouped(np.ones(n, bool), [k], [x], ["sum"])
    first, counts, (got,) = tgroupby.masked_grouped_aggregate(
        None, [_tensor(k)], [_tensor(x)], ["sum"])
    order, jorder = np.argsort(first.numpy()), np.argsort(jfirst)
    got, want = got.numpy()[order], jsum[jorder]
    mass = np.array([np.abs(x[k == k[f]]).sum() for f in first.numpy()[order]])
    tol = counts.numpy()[order] * 2.0**-52 * mass
    assert np.all(np.abs(got - want) <= tol)
    assert np.any(got != want)  # not order-proof indeed: the bits differ


@pytest.mark.parametrize("case", ["no keys", "all rows masked", "bool and f64 keys",
                                  "int16 and int32 keys"])
def test_hash_groupby_plain_shapes(case):
    """The wrapper's plain version on shapes the route makes: no group
    key (one group), a mask that keeps nothing, keys of every dtype the
    kernel reads."""
    rng = np.random.default_rng(3)
    n = 500
    v = _tensor(rng.integers(0, 100, n).astype(np.int64))
    if case == "no keys":
        g = hg.hash_groupby([], n, values=[v], kinds=["sum"])
        assert (g.first_index.tolist(), g.counts.tolist(), g.aggregates[0].tolist()) == (
            [0], [n], [int(v.sum())])
        return
    if case == "all rows masked":
        g = hg.hash_groupby([v], n, mask=torch.zeros(n, dtype=torch.bool), values=[v],
                            kinds=["max"], distinct=[v])
        assert g.first_index.numel() == 0 and g.distinct[0].numel() == 0
        return
    if case == "bool and f64 keys":
        f = np.round(rng.standard_normal(n), 1)
        f[::7] = -0.0
        f[::11] = 0.0
        keys = [_tensor(rng.random(n) < 0.5), _tensor(f)]
        want = {(bool(a), float(b).hex()) for a, b in zip(keys[0].numpy(), f)}
    else:
        a = rng.integers(-5, 5, n)
        keys = [_tensor(a.astype(np.int16)), _tensor((a * 1000).astype(np.int32) % 7)]
        want = {(int(x), int(y)) for x, y in zip(keys[0].numpy(), keys[1].numpy())}
    g = hg.in_first_row_order(hg.hash_groupby(keys, n, values=[v], kinds=["min"]))
    assert len(g.first_index) == len(want)
    assert g.first_index.tolist() == sorted(g.first_index.tolist())
    assert int(g.counts.sum()) == n


@pytest.mark.parametrize("bad", ["mean of ints", "f64 count_distinct", "2-d key",
                                 "short stream", "unknown kind", "ten keys"])
def test_hash_groupby_refuses_what_the_kernel_does_not_take(bad):
    n = 10
    k = torch.arange(n)
    f = torch.arange(n, dtype=torch.float64)
    args = {
        "mean of ints": dict(keys=[k], values=[k], kinds=["mean"]),
        "f64 count_distinct": dict(keys=[k], distinct=[f]),
        "2-d key": dict(keys=[k.reshape(2, 5)]),
        "short stream": dict(keys=[k[:5]]),
        "unknown kind": dict(keys=[k], values=[k], kinds=["median"]),
        "ten keys": dict(keys=[k] * 10),
    }[bad]
    with pytest.raises((ValueError, TypeError)):
        hg.hash_groupby(n=n, **args)


# -- SQL level ----------------------------------------------------------------


def _providers_of(tables):
    """name -> (names, [(stype, data, valid, dictionary)]) in both packages."""
    pj, pt = RelationTableProvider(), TorchProvider()
    for name, (names, cols) in tables.items():
        n = len(cols[0][1])
        pj.add_table(name, Relation(
            names, [Column(st, d, v, dic) for st, d, v, dic in cols], n))
        pt.add_table(name, relation_from_numpy(
            names, [(int(st), d.copy(), v.copy(), None if dic is None else dic.copy())
                    for st, d, v, dic in cols]))
    return pj, pt


def _run_jax(provider, query, device):
    prev = os.environ.get("EVENTQL_TPU_DEVICE")
    os.environ["EVENTQL_TPU_DEVICE"] = "1" if device else "0"
    try:
        rt = Runtime()
        res = rt.build_query_plan(rt.new_transaction(provider), query).execute(0)
        return (res.columns, res.rows)
    finally:
        if prev is None:
            os.environ.pop("EVENTQL_TPU_DEVICE", None)
        else:
            os.environ["EVENTQL_TPU_DEVICE"] = prev


def _run_port(provider, query):
    """(columns, rows), and the general and join route counters' rise."""
    g0, j0 = device_exec.GENERAL_GROUPBY_COUNT, device_exec.JOIN_GROUPBY_COUNT
    rt = TorchRuntime(device="cpu")
    res = rt.build_query_plan(rt.new_transaction(provider), query).execute(0)
    return ((res.columns, res.rows),
            (device_exec.GENERAL_GROUPBY_COUNT - g0, device_exec.JOIN_GROUPBY_COUNT - j0))


_SMALL = {}


def _smoke_tables():
    """chip_smoke.py's table and its small dimension table, at 20 000 rows."""
    if not _SMALL:
        n = 20_000
        cols, dictionary = chip_smoke.make_table(n, seed=42)
        ones = np.ones(n, bool)
        t = ([name for name, _st in chip_smoke.COLUMNS],
             [(st, cols[name], ones, dictionary if st == SType.STRING else None)
              for name, st in chip_smoke.COLUMNS])
        ordinal, region = chip_smoke.make_dims(seed=43)["d1"]
        regions = np.array([b"r%04d" % i for i in range(chip_smoke.N_REGIONS)], dtype=object)
        d = len(ordinal)
        d1 = (["k", "region"],
              [(SType.UINT64, ordinal.astype(np.uint64) * chip_smoke.DIM_MULT + 3,
                np.ones(d, bool), None),
               (SType.STRING, region.astype(np.int32), np.ones(d, bool), regions)])
        _SMALL["p"] = _providers_of({"t": t, "d1": d1})
    return _SMALL["p"]


QUERIES = {**chip_smoke.GENERAL_SQL, chip_smoke.J1[0]: chip_smoke.J1[1]}


@pytest.mark.parametrize("name", QUERIES)
def test_chip_smoke_general_queries_match_jax(name):
    """G1-G5 and J1 (the general path of chip_smoke.py) at 20 000 rows:
    the port's route equals the JAX package's device route and its host
    engine, rows and their order (no ORDER BY: first-row order)."""
    query = QUERIES[name]
    pj, pt = _smoke_tables()
    got, (general, join) = _run_port(pt, query)
    assert (general, join) == ((0, 1) if name == chip_smoke.J1[0] else (1, 0))
    assert len(got[1]) > 10
    assert got == _run_jax(pj, query, device=True)
    assert got == _run_jax(pj, query, device=False)


def _pinned_tables():
    n = 100
    k = (np.arange(n) % 3).astype(np.uint64)
    f = np.arange(n, dtype=np.float64) / 4
    f[7] = np.nan  # group k = 1
    z = np.where(np.arange(n) % 2 == 0, -0.0, 0.0)  # every group: both zeros
    v = np.arange(n, dtype=np.uint64)
    v[3] = np.uint64((1 << 63) + 5)  # group k = 0
    x = np.arange(n, dtype=np.float64)
    ones = np.ones(n, bool)
    t = (["k", "f", "z", "v", "x"],
         [(SType.UINT64, k, ones, None), (SType.FLOAT64, f, ones, None),
          (SType.FLOAT64, z, ones, None), (SType.UINT64, v, ones, None),
          (SType.FLOAT64, x, ones, None)])
    empty = (["k", "v"], [(SType.UINT64, np.zeros(0, np.uint64), np.zeros(0, bool), None)] * 2)
    return _providers_of({"t": t, "e": empty})


PINNED = {
    # (query, routed by the general route, equal to the JAX host engine too)
    "nan": ("select k, min(f), max(f), mean(f) from t group by k;", True, True),
    "u64 max >= 2^63": ("select k, max(v), min(v), sum(v) from t group by k;", True, True),
    # the JAX host engine's np.minimum.at keeps whichever zero comes last
    # (-0.0 for k = 2 here); the JAX device route, and the port, +0.0
    "-0.0 beside +0.0": ("select k, min(z), max(z), sum(z), mean(z) from t group by k;",
                         True, False),
    "where keeps nothing": ("select k, min(v), count_distinct(v) from t where v > 5000"
                            " and v < 10 group by k;", True, True),
    "empty table": ("select k, min(v), max(v) from e group by k;", False, True),
}


@pytest.mark.parametrize("name", PINNED)
def test_pinned_cases_match_the_jax_device_route(name):
    query, routed, host_too = PINNED[name]
    pj, pt = _pinned_tables()
    got, (general, _join) = _run_port(pt, query)
    assert general == (1 if routed else 0)
    assert got == _run_jax(pj, query, device=True)
    assert (got == _run_jax(pj, query, device=False)) == host_too
    rows = got[1]
    if name == "nan":
        assert rows[1][1:] == ["nan", "nan", "nan"]
    if name == "u64 max >= 2^63":
        assert rows[0][1] == str((1 << 63) + 5)
    if name == "-0.0 beside +0.0":
        assert all(r[1] == r[2] == "0.000000" for r in rows)


def test_count_distinct_of_a_float_is_declined():
    """count_distinct takes a u64 argument: over a float column both
    packages refuse the plan with the same type error. The route's gate
    (kept from the JAX route) declines a float argument all the same:
    shown on a plan whose count_distinct argument is swapped for the
    float argument of its max."""
    pj, pt = _pinned_tables()
    query = "select k, count_distinct(x) from t group by k;"
    errors = []
    for run in (lambda: _run_port(pt, query), lambda: _run_jax(pj, query, True)):
        with pytest.raises(Exception) as exc:
            run()
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "count_distinct<float64>" in errors[0]

    from eventql_tpu_torch.plan import nodes as qn

    rt = TorchRuntime(device="cpu")
    plan = rt.build_query_plan(
        rt.new_transaction(pt), "select k, count_distinct(v), max(x) from t group by k;")
    node = plan.nodes[0]
    while not isinstance(node, qn.GroupByNode):
        node = node.table
    assert device_exec.device_plan_eligible(node)
    distinct_call, max_call = (sl.expr for sl in node.select_list[1:])
    distinct_call.args = [max_call.args[0]]
    assert max_call.args[0].return_type() == SType.FLOAT64
    assert not device_exec.device_plan_eligible(node)
