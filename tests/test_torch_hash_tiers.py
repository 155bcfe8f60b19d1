"""The tiers of the port's grouped aggregate (kernels/hash_groupby.py),
on the CPU.

* ``tier_of`` and ``distinct_form`` at their boundaries: one slot either
  side of the shared cap and of the direct-global memory limit, a span
  product that overflows int64, a key with no span (the card tests hold
  the launcher's own rule, ``evql_hash_tier``, to the same cases).
* The spans the routes derive (exec/device_exec.py:
  execute_device_groupby and the join route's general branch) for a NULL
  key whose 0 lies outside the column's min / max, a u32 key of 2^31 and
  more, negative int64 keys, a one-value column, a two-key product, the
  NULL tag word, a computed key and a count_distinct payload; each
  routed result equal to the JAX package's device route and host engine
  (tolerance 0), both as the plain version returns it and as a direct
  tier returns it (one entry per slot, empty slots with count 0).
* ``hash_groupby_plain`` raising on a masked-in key outside its span.
"""

import os
import sys

import numpy as np
import pytest
import torch

from eventql_tpu.core.types import SType
from eventql_tpu.exec.relation import Column, Relation
from eventql_tpu.exec.runtime import RelationTableProvider, Runtime
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import (
    RelationTableProvider as TorchProvider,
    Runtime as TorchRuntime,
)
from eventql_tpu_torch.kernels import hash_groupby as hg
from eventql_tpu_torch.kernels.groupby import widen

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the tier rule's boundary cases)

SMEM = 232448  # the shared memory one H100 block may opt in to

# -- the tier rule ---------------------------------------------------------------

EDGES = [(n, *e) for n in (100_003, 1_000_003) for e in chip_smoke.tier_edges(SMEM, n)]


@pytest.mark.parametrize("n,spans,nv,rows,tier", EDGES)
def test_tier_of_at_its_boundaries(n, spans, nv, rows, tier):
    key_spans = None if None in spans else [(0, s, False) for s in spans]
    assert hg.tier_of(key_spans, nv, rows, SMEM) == tier


def test_tier_of_named_boundaries():
    n = 1_000_003
    cap = SMEM // (8 + 8 * 3)  # one copy of the slots: 8 + 8 nv bytes a slot
    top = hg.direct_limit(n) // (8 * (2 + 3))
    assert hg.direct_limit(n) == 4 * (1 << 21) + 4 * n  # the hash tier's table + row slots
    assert [hg.tier_of([(0, s, False)], 3, n, SMEM) for s in (cap, cap + 1)] == [
        "shared", "global"]
    assert [hg.tier_of([(0, s, False)], 3, n, SMEM) for s in (top, top + 1)] == [
        "global", "hash"]
    # a product beyond int64 (2^31 * 2^31 * 4 = 2^64), a key with no span
    assert hg.tier_of([(0, 1 << 31, False)] * 2 + [(0, 4, False)], 0, n, SMEM) == "hash"
    assert hg.tier_of([(0, 10, False), None], 0, n, SMEM) == "hash"
    assert hg.tier_of(None, 0, n, SMEM) == "hash"
    assert hg.tier_of([], 16, n, SMEM) == "shared"  # no key: one slot


@pytest.mark.parametrize("n,slots,span,rows,form",
                         [(n, *e) for n in (100_003, 1_000_003)
                          for e in chip_smoke.distinct_edges(SMEM, n)])
def test_distinct_form_at_its_boundaries(n, slots, span, rows, form):
    assert hg.distinct_form(slots, None if span is None else (0, span, False), rows,
                            SMEM) == form


# -- the plain version's span check ----------------------------------------------


@pytest.mark.parametrize("case", ["key below", "key above", "payload outside",
                                  "u32 read signed", "u64 base below"])
def test_plain_version_raises_on_a_key_outside_its_span(case):
    n = 100
    k = torch.arange(n, dtype=torch.int64) + 10  # [10, 110)
    mask = torch.ones(n, dtype=torch.bool)
    kw = dict(keys=[k], n=n, mask=mask, key_spans=[(10, 100, False)])
    hg.hash_groupby_plain(**kw)  # in its span: fine
    if case == "key below":
        kw["key_spans"] = [(11, 100, False)]
    elif case == "key above":
        kw["key_spans"] = [(10, 99, False)]
    elif case == "payload outside":
        kw.update(distinct=[k % 7], distinct_spans=[(0, 6, False)])
    elif case == "u32 read signed":
        u32 = torch.from_numpy((np.arange(n, dtype=np.uint32) + (1 << 31)).view(np.int32))
        hg.hash_groupby_plain([u32], n, key_spans=[((1 << 31), n, True)])
        kw = dict(keys=[u32], n=n, key_spans=[((1 << 31), n, False)])
    else:
        u64 = torch.from_numpy((np.arange(n, dtype=np.uint64) + (1 << 63)).view(np.int64))
        hg.hash_groupby_plain([u64], n, key_spans=[((1 << 63), n, True)])
        kw = dict(keys=[u64], n=n, key_spans=[((1 << 63) + 1, n, True)])
    with pytest.raises(ValueError, match="outside its span"):
        hg.hash_groupby_plain(**kw)


def test_plain_version_checks_only_masked_in_rows():
    k = torch.tensor([0, 1, 500, 2], dtype=torch.int64)
    mask = torch.tensor([True, True, False, True])
    g = hg.hash_groupby_plain([k], 4, mask, key_spans=[(0, 3, False)])
    assert g.counts.tolist() == [1, 1, 1]
    with pytest.raises(ValueError):
        hg.hash_groupby_plain([k], 4, None, key_spans=[(0, 3, False)])


# -- the slots of a direct tier, on the host ------------------------------------


def _as_slots(keys, n, mask=None, values=(), kinds=(), values_unsigned=None, distinct=(),
              key_spans=None, distinct_spans=None, device=None):
    """What a direct tier returns (one entry per slot of the key spans'
    mixed-radix number, an empty slot with count 0 and first row
    INT64_MAX), made from the plain version's groups; the hash tier's
    groups as they are."""
    g = hg.hash_groupby_plain(keys, n, mask, values, kinds, values_unsigned, distinct,
                              key_spans, distinct_spans, device=device)
    if hg.tier_of(key_spans, min(len(values), hg.MAX_VALUES), n, SMEM) == "hash":
        return g
    slot = torch.zeros_like(g.first_index)
    stride = 1
    for k, (base, span, unsigned) in zip(keys, key_spans):
        slot += (widen(k[:n], unsigned)[g.first_index] - hg._bits64(base)) * stride
        stride *= span

    def spread(x, fill=0):
        out = torch.full((stride,), fill, dtype=x.dtype)
        out[slot] = x
        return out

    return hg.Grouped(spread(g.first_index, (1 << 63) - 1), spread(g.counts),
                      tuple(spread(a) for a in g.aggregates),
                      tuple(spread(d) for d in g.distinct))


def test_in_first_row_order_drops_empty_slots():
    k = torch.tensor([3, 1, 3, 0, 1], dtype=torch.int64)
    v = torch.tensor([5, 6, 7, 8, 9], dtype=torch.int64)
    g = _as_slots([k], 5, values=[v], kinds=["max"], key_spans=[(0, 6, False)])
    assert g.counts.tolist() == [1, 2, 0, 2, 0, 0]
    o = hg.in_first_row_order(g)
    assert (o.first_index.tolist(), o.counts.tolist(), o.aggregates[0].tolist()) == (
        [0, 1, 3], [2, 2, 1], [7, 9, 8])
    first, counts, aggs, _dist, (keys,) = device_exec._read_groups(g, (k,))
    assert (first.tolist(), counts.tolist(), aggs[0].tolist(), keys.tolist()) == (
        [0, 1, 3], [2, 2, 1], [7, 9, 8], [3, 1, 0])


# -- the spans the routes derive -------------------------------------------------


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


N = 4000


def _tables():
    rng = np.random.default_rng(21)
    ones = np.ones(N, bool)
    some = rng.random(N) < 0.85
    # a nullable key whose values lie in [100, 200), NULL rows holding 150
    knull = np.where(some, rng.integers(100, 200, N), 150).astype(np.int64)
    words = np.array([b"apple", b"fig", b"kiwi", b"lime", b"pear"], dtype=object)
    dk = rng.integers(0, 40, N).astype(np.uint64) * 7 + 3
    t = (["knull", "ku32", "kneg", "kone", "s", "cat", "a", "b", "v", "dk"],
         [(SType.INT64, knull, some, None),
          (SType.UINT64, (1 << 31) + rng.integers(0, 3000, N).astype(np.uint64), ones, None),
          (SType.INT64, rng.integers(-1000, -500, N).astype(np.int64), ones, None),
          (SType.INT64, np.full(N, 7, np.int64), ones, None),
          (SType.STRING, rng.integers(0, len(words), N).astype(np.int32), ones, words),
          (SType.INT64, rng.integers(-3, 4, N).astype(np.int64), ones, None),
          (SType.INT64, rng.integers(0, 9, N).astype(np.int64), rng.random(N) < 0.9, None),
          (SType.INT64, rng.integers(-2, 2, N).astype(np.int64), rng.random(N) < 0.9, None),
          (SType.UINT64, rng.integers(0, 1000, N).astype(np.uint64), ones, None),
          (SType.UINT64, dk, ones, None)])
    regions = np.array([b"r%02d" % i for i in range(6)], dtype=object)
    d = (["k", "region"],
         [(SType.UINT64, np.arange(30, dtype=np.uint64) * 7 + 3, np.ones(30, bool), None),
          (SType.STRING, (np.arange(30) % 6).astype(np.int32), np.ones(30, bool), regions)])
    return {"t": t, "d": d}


def _span_of(col, unsigned, nullable=False):
    lo, hi = int(col.min()), int(col.max())
    if nullable:
        lo, hi = min(lo, 0), max(hi, 0)
    return (lo, hi - lo + 1, unsigned)


def _cols():
    names, cols = _tables()["t"]
    return {name: c[1] for name, c in zip(names, cols)}


# query -> (the key spans and the count_distinct spans the route must
# derive, as a function of the table's columns; the tier at N rows)
ROUTES = {
    "NULL key, its 0 outside the stats": (
        "select knull, count(1), min(v), max(v) from t group by knull;",
        lambda c: ([_span_of(c["knull"], False, nullable=True), (0, 2, False)], None),
        "shared"),
    "u32 key of 2^31 and more": (
        "select ku32, count(1), max(v) from t group by ku32;",
        lambda c: ([_span_of(c["ku32"], True)], None), "shared"),
    "negative int64 keys": (
        "select kneg, min(v) from t group by kneg;",
        lambda c: ([_span_of(c["kneg"], False)], None), "shared"),
    "one-value column": (
        "select kone, max(v), sum(v), mean(v) from t group by kone;",
        lambda c: ([(7, 1, False)], None), "shared"),
    "two-key product": (
        "select s, cat, count(1), min(v) from t group by s, cat;",
        lambda c: ([(0, 5, False), _span_of(c["cat"], False)], None), "shared"),
    "tag word, both keys nullable": (
        "select a, b, count(1), max(v) from t group by a, b;",
        lambda c: ([_span_of(c["a"], False, True), _span_of(c["b"], False, True),
                    (0, 4, False)], None), "shared"),
    "tag word, the second key nullable": (
        "select s, a, count(1), max(v) from t group by s, a;",
        lambda c: ([(0, 5, False), _span_of(c["a"], False, True), (0, 4, False)], None),
        "shared"),
    "computed key": (
        "select kneg + 1, count(1), min(v) from t group by kneg + 1;",
        lambda c: ([None, (0, 2, False)], None), "hash"),  # its validity: a tag word
    "count_distinct payload": (
        "select s, count_distinct(ku32), count_distinct(v + 1) from t group by s;",
        lambda c: ([(0, 5, False)], [_span_of(c["ku32"], True), None]), "shared"),
    "join buckets": (
        "select d.region, min(t.v), max(t.v), count_distinct(t.v) from t join d"
        " on t.dk = d.k group by d.region;",
        lambda c: ([(0, 6, False)], [_span_of(c["v"], True)]), "shared"),
}


@pytest.mark.parametrize("slotted", [False, True])
@pytest.mark.parametrize("name", ROUTES)
def test_derived_spans_and_results_match_jax(name, slotted, monkeypatch):
    query, spans_of, tier = ROUTES[name]
    pj, pt = _providers_of(_tables())
    calls = []
    run = _as_slots if slotted else hg.hash_groupby

    def recording(*args, **kwargs):
        import inspect

        kw = inspect.signature(hg.hash_groupby_plain).bind(*args, **kwargs).arguments
        calls.append(kw)
        return run(**kw)

    monkeypatch.setattr(hg, "hash_groupby", recording)
    g0, j0 = device_exec.GENERAL_GROUPBY_COUNT, device_exec.JOIN_GROUPBY_COUNT
    rt = TorchRuntime(device="cpu")
    res = rt.build_query_plan(rt.new_transaction(pt), query).execute(0)
    got = (res.columns, res.rows)
    routed = (device_exec.GENERAL_GROUPBY_COUNT - g0, device_exec.JOIN_GROUPBY_COUNT - j0)
    assert routed == ((0, 1) if name == "join buckets" else (1, 0))
    assert len(calls) == 1
    key_spans, distinct_spans = spans_of(_cols())
    assert [None if s is None else tuple(s) for s in calls[0]["key_spans"]] == key_spans
    if distinct_spans is not None:
        assert list(calls[0]["distinct_spans"]) == distinct_spans
    nv = min(len(calls[0].get("values", ())), hg.MAX_VALUES)
    assert hg.tier_of(calls[0]["key_spans"], nv, calls[0]["n"], SMEM) == tier
    assert len(got[1]) == 1 if name == "one-value column" else len(got[1]) > 1
    assert got == _run_jax(pj, query, device=True)
    assert got == _run_jax(pj, query, device=False)
