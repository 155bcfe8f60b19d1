"""The port's on-device group compaction and the hash aggregate's
explicit device, on the CPU.

* ``compact_groups`` (kernels/hash_groupby.py), the counterpart of the
  JAX route's ``_device_compact_groups``: the occupied slots, their
  order (first rows, a per-slot key, slot order) and the streams read at
  each group's first row.
* SQL text -> ResultList through ``Runtime(device="cpu")`` against the
  JAX package's device route (``execute_device_groupby`` /
  ``try_execute_device_join_groupby``, ``EVENTQL_TPU_DEVICE=1``), each
  JAX route shown to have served its query: every tier of the hash
  aggregate (shared, direct global, hash), a key span of 2^16 with under
  1 % of its slots occupied, a nullable key (the tag word), a negative
  base, a WHERE that keeps nothing, select entries read from a group's
  first row (numeric, float, u64 and dictionary columns), count_distinct
  in the shared bitmap and set forms, and the join route's bounded and
  general branches with unmatched fact rows. Each case runs twice: as
  the plain version returns its groups, and as a direct tier returns them
  on the card (one entry per slot, empty slots with count 0), so that the
  compaction drops slots as it does there. Identical ResultLists, row
  order included (tolerance 0), and the bytes read back
  (``kernels/sort.READBACK_BYTES``) at most the packed int64 words of the
  groups: O(groups), whatever the number of slots.
* ``hash_groupby`` / ``hash_groupby_plain`` with no stream: one group of
  the first n rows on the given device, ValueError without one; a stream
  on another device raises; the general route passes the transaction's
  device for ``SELECT count(1) FROM t``.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from eventql_tpu.core.types import SType
from eventql_tpu.exec import device_exec as jax_device_exec
from eventql_tpu.exec.relation import Column, Relation
from eventql_tpu.exec.runtime import RelationTableProvider, Runtime
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import (
    RelationTableProvider as TorchProvider,
    Runtime as TorchRuntime,
)
from eventql_tpu_torch.kernels import groupby as tgroupby
from eventql_tpu_torch.kernels import hash_groupby as hg
from eventql_tpu_torch.kernels import sort as tsort
from eventql_tpu_torch.kernels.groupby import widen

SMEM = 232448  # the shared memory one H100 block may opt in to

# -- compact_groups ----------------------------------------------------------------


def _slots_result():
    """Six slots, three occupied (slots 0, 1, 3), first rows 3, 0, 1."""
    return hg.Grouped(torch.tensor([3, 0, (1 << 63) - 1, 1, (1 << 63) - 1, (1 << 63) - 1]),
                      torch.tensor([2, 2, 0, 1, 0, 0]),
                      (torch.tensor([7, 9, 0, 8, 0, 0]),
                       torch.tensor([0.5, -0.0, 0.0, float("nan"), 0.0, 0.0],
                                    dtype=torch.float64)),
                      (torch.tensor([1, 2, 0, 1, 0, 0]),))


@pytest.mark.parametrize("order, want_slots", [("first_row", [1, 3, 0]), (None, [0, 1, 3]),
                                               ("key", [3, 0, 1])])
def test_compact_groups_orders_and_gathers(order, want_slots):
    g = _slots_result()
    stream = torch.tensor([10, 11, 12, 13], dtype=torch.int16)
    key = torch.tensor([5, 9, 0, 1, 0, 0]) if order == "key" else order
    out, (at_first,) = hg.compact_groups(g, key, (stream,))
    assert out.dense
    assert out.first_index.tolist() == [g.first_index[s].item() for s in want_slots]
    assert out.counts.tolist() == [g.counts[s].item() for s in want_slots]
    assert out.aggregates[0].tolist() == [g.aggregates[0][s].item() for s in want_slots]
    assert torch.equal(out.aggregates[1].view(torch.int64),
                       g.aggregates[1].view(torch.int64)[want_slots])
    assert out.distinct[0].tolist() == [g.distinct[0][s].item() for s in want_slots]
    assert at_first.dtype == torch.int16
    assert at_first.tolist() == [stream[g.first_index[s]].item() for s in want_slots]


def test_compact_groups_of_a_dense_result_keeps_every_entry():
    """A dense result (the hash tier's, the plain version's) has no empty
    slot to drop: a group with count 0 cannot occur there, so none is
    looked for; the groups are only ordered."""
    g = hg.Grouped(torch.tensor([4, 2, 9]), torch.tensor([1, 3, 2]),
                   (torch.tensor([1, 2, 3]),), (), dense=True)
    out, _ = hg.compact_groups(g)
    assert out.first_index.tolist() == [2, 4, 9] and out.aggregates[0].tolist() == [2, 1, 3]
    same, _ = hg.compact_groups(g, order=None)
    assert same.first_index is g.first_index and same.counts is g.counts  # no copy


def test_compact_groups_with_no_group():
    g = hg.Grouped(torch.full((4,), (1 << 63) - 1), torch.zeros(4, dtype=torch.int64),
                   (torch.zeros(4, dtype=torch.int64),), ())
    out, (rows,) = hg.compact_groups(g, gather=(torch.arange(10),))
    assert out.counts.numel() == 0 and rows.numel() == 0
    before = (tsort.READBACKS, tsort.READBACK_BYTES)
    first, counts, aggs, dist, words = device_exec._read_groups(g)
    assert (len(first), aggs.shape, dist.shape, words.shape) == (0, (1, 0), (0, 0), (0, 0))
    assert (tsort.READBACKS, tsort.READBACK_BYTES) == before  # nothing to copy


# -- the routes against the JAX device route -----------------------------------------

N = 140_000  # enough rows that a span of 2^16 slots takes the direct global tier
SPARSE = 1 << 16


def _tables():
    rng = np.random.default_rng(15)
    ones = np.ones(N, bool)
    some = rng.random(N) < 0.8
    words = np.array([b"apple", b"fig", b"kiwi", b"lime", b"pear"], dtype=object)
    w = rng.integers(0, SPARSE, N).astype(np.uint64)
    w[:2] = [0, SPARSE - 1]  # the span: exactly 2^16
    v = rng.integers(0, 1000, N).astype(np.uint64)
    dk = rng.integers(0, 60, N).astype(np.uint64) * 7 + 3  # half without a dimension row
    t = (["k", "w", "v", "kn", "kneg", "f", "ts", "s", "dk"],
         [(SType.STRING, rng.integers(0, len(words), N).astype(np.int32), ones, words),
          (SType.UINT64, w, ones, None),
          (SType.UINT64, v, ones, None),
          (SType.INT64, np.where(some, rng.integers(100, 200, N), 0).astype(np.int64), some,
           None),
          (SType.INT64, rng.integers(-1000, -500, N).astype(np.int64), ones, None),
          (SType.FLOAT64, rng.integers(-64, 64, N) / 8.0, ones, None),
          (SType.UINT64, rng.integers(0, 1 << 63, N, dtype=np.uint64) * 2 + 1, ones, None),
          (SType.STRING, rng.integers(0, len(words), N).astype(np.int32), rng.random(N) < 0.9,
           words),
          (SType.UINT64, dk, ones, None)])
    regions = np.array([b"r%02d" % i for i in range(6)], dtype=object)
    d = (["k", "region"],
         [(SType.UINT64, np.arange(30, dtype=np.uint64) * 7 + 3, np.ones(30, bool), None),
          (SType.STRING, (np.arange(30) % 6).astype(np.int32), np.ones(30, bool), regions)])
    return {"t": t, "d": d}


_PROVIDERS = {}


def _providers():
    """The tables in both packages, made once (the port's column caches
    carry over between queries, as they do in a server)."""
    if not _PROVIDERS:
        pj, pt = RelationTableProvider(), TorchProvider()
        for name, (names, cols) in _tables().items():
            n = len(cols[0][1])
            pj.add_table(name, Relation(
                names, [Column(st, d, v, dic) for st, d, v, dic in cols], n))
            pt.add_table(name, relation_from_numpy(
                names, [(int(st), d.copy(), v.copy(), None if dic is None else dic.copy())
                        for st, d, v, dic in cols]))
        _PROVIDERS["p"] = (pj, pt)
    return _PROVIDERS["p"]


# the JAX device routes, by the port's names for them
JAX_ROUTES = {"general": "execute_device_groupby", "join": "try_execute_device_join_groupby",
              "bucket": "try_execute_pallas_string_groupby"}


def _run_jax(provider, query, monkeypatch):
    """(columns, rows) of the JAX package with its device routes on, and
    the routes that served the query."""
    served = []
    for route, name in JAX_ROUTES.items():
        real = getattr(jax_device_exec, name)

        def spy(*a, _real=real, _route=route, **k):
            out = _real(*a, **k)
            if out is not None:
                served.append(_route)
            return out

        monkeypatch.setattr(jax_device_exec, name, spy)
    monkeypatch.setenv("EVENTQL_TPU_DEVICE", "1")
    rt = Runtime()
    res = rt.build_query_plan(rt.new_transaction(provider), query).execute(0)
    monkeypatch.undo()
    return (res.columns, res.rows), served


def _port_routes():
    return (device_exec.GENERAL_GROUPBY_COUNT, device_exec.JOIN_GROUPBY_COUNT,
            device_exec.FUSED_GROUPBY_COUNT + device_exec.MULTI_SUM_GROUPBY_COUNT)


def _as_slots(keys, n, mask=None, values=(), kinds=(), values_unsigned=None, distinct=(),
              key_spans=None, distinct_spans=None, device=None):
    """What the card returns for the call: in a direct tier one entry per
    slot of the key spans' mixed-radix number (an empty slot with count 0
    and first row INT64_MAX), made from the plain version's groups; the
    hash tier's groups dense, as they are."""
    g = hg.hash_groupby_plain(keys, n, mask, values, kinds, values_unsigned, distinct,
                              key_spans, distinct_spans, device=device)
    spans = () if not keys and key_spans is None else key_spans
    if hg.tier_of(spans, min(len(values), hg.MAX_VALUES), n, SMEM) == "hash":
        return g
    slot = torch.zeros_like(g.first_index)
    stride = 1
    for k, (base, span, unsigned) in zip(keys, spans):
        slot += (widen(k[:n], unsigned)[g.first_index] - hg._bits64(base)) * stride
        stride *= span

    def spread(x, fill=0):
        out = torch.full((stride,), fill, dtype=x.dtype)
        out[slot] = x
        return out

    return hg.Grouped(spread(g.first_index, (1 << 63) - 1), spread(g.counts),
                      tuple(spread(a) for a in g.aggregates),
                      tuple(spread(d) for d in g.distinct))


# name -> (query, the route (JAX_ROUTES), the tier of its hash_groupby
# call at N rows (None: no call), the count_distinct forms)
CASES = {
    "shared tier": ("select k, count(1), min(v), max(f), mean(f) from t group by k;",
                    "general", "shared", []),
    "direct global, span 2^16 under 1 % occupied": (
        "select w, count(1), max(v) from t where v < 3 group by w;", "general", "global", []),
    "hash tier": ("select w + 1, count(1), sum(v) from t where v < 3 group by w + 1;",
                  "general", "hash", []),
    "nullable key, the tag word": ("select kn, count(1), max(v) from t group by kn;",
                                   "general", "shared", []),
    "negative base": ("select kneg, count(1), min(v), sum(f) from t group by kneg;",
                      "general", "shared", []),
    "where keeps nothing": ("select k, count(1), min(v) from t where v > 5000 group by k;",
                            "general", "shared", []),
    "first rows: numeric, float and u64": (
        "select w, v, f, ts, min(v) from t where v < 3 group by w;", "general", "global", []),
    "first rows: a dictionary column": ("select k, s, max(v) from t group by k;",
                                        "general", "shared", []),
    "count_distinct, shared bitmap and set": (
        "select k, count_distinct(v), count_distinct(v + 1) from t group by k;", "general",
        "shared", ["bitmap_shared", "set"]),
    "bucket route, span 2^16 under 1 % occupied": (
        "select w, count(1), sum(v) from t where v < 3 group by w;", "bucket", None, []),
    "join, bounded branch": (
        "select d.region, count(1), sum(t.v) from t join d on t.dk = d.k group by d.region;",
        "join", None, []),
    "join, general branch": (
        "select d.region, min(t.v), max(t.f), count_distinct(t.v) from t join d"
        " on t.dk = d.k group by d.region;", "join", "shared", ["bitmap_shared"]),
}


@pytest.mark.parametrize("slotted", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_compacted_routes_match_the_jax_device_route(name, slotted, monkeypatch):
    query, route, tier, forms = CASES[name]
    pj, pt = _providers()
    want, served = _run_jax(pj, query, monkeypatch)
    assert served == [route]  # the JAX device route answered, not its host engine

    calls = []
    run = _as_slots if slotted else hg.hash_groupby

    def recording(*args, **kwargs):
        kw = inspect.signature(hg.hash_groupby_plain).bind(*args, **kwargs).arguments
        calls.append(kw)
        return run(**kw)

    monkeypatch.setattr(hg, "hash_groupby", recording)
    counters = _port_routes()
    reads = (tsort.READBACKS, tsort.READBACK_BYTES)
    rt = TorchRuntime(device="cpu")
    res = rt.build_query_plan(rt.new_transaction(pt), query).execute(0)
    got = (res.columns, res.rows)
    nreads, nbytes = tsort.READBACKS - reads[0], tsort.READBACK_BYTES - reads[1]
    routed = [b - a for a, b in zip(counters, _port_routes())]
    assert routed == [int(route == r) for r in JAX_ROUTES]
    assert got == want

    ng = len(got[1])
    if tier is None:
        assert calls == []
        words = 2 + 2 + 1  # bucket ids or first rows, counts, the count and the sum, bucket ids
    else:
        (kw,) = calls
        assert kw["device"] == torch.device("cpu")
        nv = min(len(kw.get("values", ())), hg.MAX_VALUES)
        assert hg.tier_of(kw["key_spans"], nv, kw["n"], SMEM) == tier
        slots = hg._slots(kw["key_spans"])
        assert [hg.distinct_form(slots, sp, kw["n"], SMEM)
                for sp in kw.get("distinct_spans") or ()] == forms
        # first rows, counts, aggregates, distinct counts, and at most the
        # data and validity of every input column (or the join's bucket)
        words = 2 + len(kw.get("values", ())) + len(kw.get("distinct", ())) + 2 * 9
    assert nreads == (1 if ng else 0)
    assert nbytes <= 8 * words * ng, (nbytes, ng)
    if name == "where keeps nothing":
        assert ng == 0
    if "span 2^16" in name:
        assert 0 < ng < SPARSE // 100
        # the slots alone (first row, count, sum a slot) would be 60 times more
        assert nbytes * 60 < 8 * 3 * SPARSE
    if name.startswith("join"):
        assert 0 < ng <= 6


def test_chip_smoke_compaction_queries_match_numpy_and_jax(monkeypatch):
    """G6 and G7 of chip_smoke.py's phase 4 at 2^17 rows (a dozen groups
    of w's 2^20 slots): the port's route equals the numpy answer the
    script holds the card to, and the JAX package's device route."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    n = 1 << 17
    cols, dictionary = chip_smoke.make_table(n, seed=42)
    ones = np.ones(n, bool)
    pj, pt = RelationTableProvider(), TorchProvider()
    pj.add_table("t", Relation(
        [name for name, _st in chip_smoke.COLUMNS],
        [Column(st, cols[name], ones, dictionary if st == SType.STRING else None)
         for name, st in chip_smoke.COLUMNS], n))
    pt.add_table("t", chip_smoke.provider_of(cols, dictionary, n).get_table_data("t"))
    for name, sql, expected in chip_smoke.compaction_queries(cols, n):
        assert 5 < len(expected) < 100, name
        want, served = _run_jax(pj, sql, monkeypatch)
        assert served == ["general"], name
        g0 = device_exec.GENERAL_GROUPBY_COUNT
        rt = TorchRuntime(device="cpu")
        res = rt.build_query_plan(rt.new_transaction(pt), sql).execute(0)
        assert device_exec.GENERAL_GROUPBY_COUNT - g0 == 1, name
        assert res.rows == expected, name
        assert (res.columns, res.rows) == want, name


# -- the explicit device -------------------------------------------------------------


@pytest.mark.parametrize("fn", ["hash_groupby", "hash_groupby_plain"])
@pytest.mark.parametrize("n", [0, 1, 77])
def test_no_stream_is_one_group_on_the_given_device(fn, n):
    g = getattr(hg, fn)([], n, device=torch.device("cpu"))
    assert g.first_index.device == torch.device("cpu")
    assert (g.first_index.tolist(), g.counts.tolist()) == (([0], [n]) if n else ([], []))
    assert g.aggregates == () and g.distinct == ()


@pytest.mark.parametrize("fn", ["hash_groupby", "hash_groupby_plain"])
def test_no_stream_and_no_device_raises(fn):
    with pytest.raises(ValueError, match="pass device"):
        getattr(hg, fn)([], 10)
    with pytest.raises(ValueError, match="pass device"):
        tgroupby.masked_grouped_aggregate(None, [], [], [], n=10)


@pytest.mark.parametrize("fn", ["hash_groupby", "hash_groupby_plain"])
@pytest.mark.parametrize("stream", ["key", "value", "mask"])
def test_a_stream_on_another_device_raises(fn, stream):
    n = 8
    here = torch.arange(n, dtype=torch.int64)
    there = torch.zeros(n, dtype=torch.int64, device="meta")
    kw = {"key": dict(keys=[there]),
          "value": dict(keys=[here], values=[there], kinds=["sum"]),
          "mask": dict(keys=[here], mask=torch.ones(n, dtype=torch.bool, device="meta"))}[stream]
    with pytest.raises(ValueError, match="on meta"):
        getattr(hg, fn)(n=n, device=torch.device("cpu"), **kw)


def test_the_plain_aggregate_takes_its_device():
    first, counts, aggs = tgroupby.masked_grouped_aggregate(None, [], [], [], n=5,
                                                            device=torch.device("cpu"))
    assert (first.tolist(), counts.tolist(), aggs) == ([0], [5], ())


@pytest.mark.parametrize("query", ["select count(1) from t;",
                                   "select count(1) from t where v < 3;"])
def test_keyless_count_passes_the_transactions_device(query, monkeypatch):
    """SELECT count(1) FROM t hands the hash aggregate no tensor (no key,
    no value, and no mask without a WHERE): the route names the
    transaction's device, so that on the card the kernel launches."""
    pj, pt = _providers()
    want, served = _run_jax(pj, query, monkeypatch)
    assert served == ["general"]
    calls = []
    real = hg.hash_groupby

    def spy(*args, **kwargs):
        calls.append(inspect.signature(hg.hash_groupby_plain).bind(*args, **kwargs).arguments)
        return real(*args, **kwargs)

    monkeypatch.setattr(hg, "hash_groupby", spy)
    rt = TorchRuntime(device="cpu")
    txn = rt.new_transaction(pt)
    res = rt.build_query_plan(txn, query).execute(0)
    assert (res.columns, res.rows) == want
    (kw,) = calls
    assert kw["device"] == txn.device == torch.device("cpu")
    assert list(kw["keys"]) == [] and list(kw.get("values", ())) == []
    assert (kw.get("mask") is None) == ("where" not in query)
