"""The port's mesh tier (exec/mesh_exec.py over a MeshTableProvider of 8
shards on the CPU) against the JAX package's mesh tier and host engine.

The tables and queries of tests/test_mesh_sql.py go through the JAX
``MeshTableProvider`` over the 8-device virtual CPU mesh (conftest) and
through the port's ``MeshTableProvider(n_shards=8, device="cpu")``, whose
shards run the kernels' plain versions; ResultLists must be identical
(tolerance 0: counts and integer sums exact, floats of these tables are
sums of numbers with 3 decimals, the same on both sides in this order).
The route counters prove the mesh route served each query. The seeds of
tests/test_fuzz_mesh.py run against the JAX host engine (cheaper than
its mesh tier, and its mesh tier's own test holds the two equal). Each
pinned case fixes one place where a sharded run can go wrong.
"""

import random

import numpy as np
import pytest

import test_fuzz_device_order as jax_order_fuzz
import test_fuzz_device_parity as jax_fuzz
import test_mesh_sql as jax_mesh

from eventql_tpu.core.types import SType
from eventql_tpu.exec.relation import Column, Relation
from eventql_tpu.exec.runtime import RelationTableProvider as JaxProvider
from eventql_tpu.exec.runtime import Runtime as JaxRuntime
from eventql_tpu.parallel import distributed as jax_dist
from eventql_tpu.parallel.mesh_provider import MeshTableProvider as JaxMesh
from eventql_tpu_torch.exec import mesh_exec
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import Runtime
from eventql_tpu_torch.kernels import hash_groupby
from eventql_tpu_torch.parallel.distributed import exchange_tally
from eventql_tpu_torch.parallel.mesh_provider import MeshTableProvider

P = 8
_JAX_MESH = []


def _port_rel(rel):
    return relation_from_numpy(
        rel.names, [(int(c.stype), c.data, c.valid, c.dictionary) for c in rel.columns])


def _port_mesh(tables, n_shards=P):
    p = MeshTableProvider(n_shards=n_shards, device="cpu")
    for name, rel in tables.items():
        p.add_table(name, _port_rel(rel))
    return p


def _jax_provider(tables, mesh=False):
    """The JAX host engine's provider, or its mesh tier's over one mesh
    for the file (its compiled programs are cached per mesh)."""
    if mesh and not _JAX_MESH:
        _JAX_MESH.append(jax_dist.make_mesh(P))
    p = JaxMesh(mesh=_JAX_MESH[0]) if mesh else JaxProvider()
    for name, rel in tables.items():
        p.add_table(name, rel)
    return p


def _run_port(provider, query):
    rt = Runtime(device=None)  # the mesh routes run on the provider's shards
    res = rt.build_query_plan(rt.new_transaction(provider), query).execute(0)
    return res.columns, res.rows


def _run_jax(provider, query):
    rt = JaxRuntime()
    res = rt.build_query_plan(rt.new_transaction(provider), query).execute(0)
    return res.columns, res.rows


def _counters():
    return (mesh_exec.MESH_GROUPBY_RUNS, mesh_exec.MESH_TOPK_RUNS, mesh_exec.MESH_JOIN_RUNS)


_STATE = {}


def _tables():
    if not _STATE:
        _STATE["t"] = {"t": jax_mesh._make_relation()}
        _STATE["join"] = jax_mesh._make_join_tables(JaxProvider())._tables
    return _STATE


# -- test_mesh_sql.py's queries against the JAX mesh tier ---------------------

ROUTED = ([(q, 0) for q in jax_mesh.QUERIES]
          + [(q, 1) for q in jax_mesh.TOPK_QUERIES])


@pytest.mark.parametrize("query,route", ROUTED)
def test_mesh_matches_the_jax_mesh_tier(query, route):
    tables = _tables()["t"]
    want = _run_jax(_jax_provider(tables, mesh=True), query)
    before = _counters()
    got = _run_port(_port_mesh(tables), query)
    assert got == want
    assert [b - a for a, b in zip(before, _counters())] == [
        int(route == 0), int(route == 1), 0], "the mesh route did not serve the query"


@pytest.mark.parametrize("query", jax_mesh.JOIN_QUERIES)
def test_mesh_join_matches_the_jax_mesh_tier(query):
    tables = _tables()["join"]
    want = _run_jax(_jax_provider(tables, mesh=True), query)
    assert want == _run_jax(_jax_provider(tables), query)
    before = _counters()
    got = _run_port(_port_mesh(tables), query)
    assert got == want
    assert [b - a for a, b in zip(before, _counters())] == [0, 0, 1]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_shard_counts(n_shards):
    """Any number of shards, a power of two or not, gives the host's rows."""
    tables = _tables()["t"]
    for q in ("select k, count(1), sum(v) from t group by k order by k;",
              "select k, count_distinct(v), min(i) from t group by k order by k;",
              "select k, v from t where v < 900 order by v desc limit 10;"):
        assert _run_port(_port_mesh(tables, n_shards), q) == _run_jax(
            _jax_provider(tables), q), (n_shards, q)


def test_shapes_the_mesh_declines_go_to_the_host_engine():
    tables = _tables()["t"]
    for q in ("select count(1) from t;",
              "select substring(city, 1, 4), count(1) from t"
              " group by substring(city, 1, 4) order by 1;",
              "select k, sum(v) from t where v > 100000 group by k;",
              "select count(1), sum(v) from t where v > 100000;"):
        before = _counters()
        assert _run_port(_port_mesh(tables), q) == _run_jax(_jax_provider(tables), q), q
        assert _counters() == before, q


@pytest.mark.parametrize("query,route", [
    ("select count(1) from t;", "GENERAL_GROUPBY_COUNT"),
    ("select k, sum(v) from t where v > 100000 group by k;", "FUSED_GROUPBY_COUNT"),
    ("select count(1), sum(v) from t where v > 100000;", "GENERAL_GROUPBY_COUNT")])
def test_shapes_the_mesh_declines_take_the_runtimes_device_routes(query, route):
    """Under a Runtime with a device the plans the mesh declines go to the
    single-card routes, as the JAX package's do with its device switch on
    (tolerance 0)."""
    from eventql_tpu_torch.exec import device_exec

    tables = _tables()["t"]
    before, single = _counters(), getattr(device_exec, route)
    rt = Runtime(device="cpu")
    res = rt.build_query_plan(rt.new_transaction(_port_mesh(tables)), query).execute(0)
    assert (res.columns, res.rows) == _run_jax(_jax_provider(tables), query)
    assert _counters() == before
    assert getattr(device_exec, route) == single + 1


def test_multi_key_limit_takes_the_mesh_top_k():
    """The JAX tier serves this through its mesh sort with a window; the
    port through each shard's stable sort and a merge of candidates."""
    tables = _tables()["t"]
    q = "select k, v from t where v < 5 order by k, v limit 3;"
    before = mesh_exec.MESH_TOPK_RUNS
    assert _run_port(_port_mesh(tables), q) == _run_jax(_jax_provider(tables, mesh=True), q)
    assert mesh_exec.MESH_TOPK_RUNS == before + 1
    # three shards: not a power of two, as the JAX gate says: the host engine
    assert _run_port(_port_mesh(tables, 3), q) == _run_jax(_jax_provider(tables), q)
    assert mesh_exec.MESH_TOPK_RUNS == before + 1


def _order_counters(module):
    return module.MESH_ORDER_RUNS, module.MESH_BUCKET_SORT_RUNS


def _jax_mesh_of(tables, n_shards):
    """The JAX mesh tier over a mesh of ``n_shards`` virtual devices (the
    file's mesh for 8)."""
    if n_shards == P:
        return _jax_provider(tables, mesh=True)
    p = JaxMesh(n_devices=n_shards)
    for name, rel in tables.items():
        p.add_table(name, rel)
    return p


# test_mesh_sql.py's full scan ORDER BY queries, its packed multi-key
# query (string rank 5 bits + u16 10 bits + u16 16 bits: one u64 key,
# the sample sort) and its unbounded one (a float key: the compare-split)
ORDER_ROUTED = ([(q, 1) for q in jax_mesh.ORDER_QUERIES]
                + [("select city, k, v from t where v < 200 order by city, k desc, v;", 1),
                   ("select f, k from t where v < 100 order by f, k;", 0),
                   ("select k, v, i from t order by i desc;", 1)])


@pytest.mark.parametrize("n_shards", [1, 2, 8])
@pytest.mark.parametrize("query,bucket", ORDER_ROUTED)
def test_full_scan_order_by_matches_the_jax_mesh_tier(query, bucket, n_shards):
    """Row for row the JAX mesh tier's ResultList, through the same path:
    the sample sort (``MESH_BUCKET_SORT_RUNS``) or the compare-split."""
    from eventql_tpu.exec import mesh_exec as jax_mesh_exec

    tables = _tables()["t"]
    jb = _order_counters(jax_mesh_exec)
    want = _run_jax(_jax_mesh_of(tables, n_shards), query)
    jax_delta = [b - a for a, b in zip(jb, _order_counters(jax_mesh_exec))]
    before = _order_counters(mesh_exec)
    got = _run_port(_port_mesh(tables, n_shards), query)
    assert got == want
    delta = [b - a for a, b in zip(before, _order_counters(mesh_exec))]
    assert delta == jax_delta == [1, bucket]
    assert want == _run_jax(_jax_provider(tables), query)


@pytest.mark.parametrize("case", ["overflow", "u64_max", "nan"])
def test_full_scan_order_by_falls_back_to_the_compare_split(case):
    """Where the sample sort cannot be exact the compare-split serves, as
    in the JAX tier: all-equal keys overflow a bucket; a passing row whose
    key is the sentinel (u64 max, or NaN, which sorts last) would drop out
    of the exchange with the filtered rows. The JAX mesh tier takes the
    same path (its counters) and both equal its host engine."""
    from eventql_tpu.exec import mesh_exec as jax_mesh_exec

    n = 8 * 100
    rng = np.random.default_rng(17)
    rowid = (SType.UINT64, np.arange(n))
    if case == "overflow":
        tables = {"t": _rel(v=(SType.UINT64, np.full(n, 42)), rowid=rowid)}
        q = "select rowid, v from t order by v;"
    elif case == "u64_max":
        v = rng.integers(0, 50, n).astype(np.uint64)
        v[[5, 300, 799]] = np.uint64((1 << 64) - 1)
        tables = {"t": _rel(v=(SType.UINT64, v), w=(SType.UINT64, np.arange(n) % 3),
                            rowid=rowid)}
        q = "select rowid, v from t where w < 2 order by v;"
    else:
        f = np.round(rng.standard_normal(n), 2)
        f[[7, 410]] = np.nan
        tables = {"t": Relation(["f", "rowid"], [
            Column(SType.FLOAT64, f, np.ones(n, bool)),
            Column(SType.UINT64, np.arange(n, dtype=np.uint64), np.ones(n, bool))], n)}
        q = "select rowid, f from t order by f;"
    jb = _order_counters(jax_mesh_exec)
    want = _run_jax(_jax_mesh_of(tables, P), q)
    assert [b - a for a, b in zip(jb, _order_counters(jax_mesh_exec))] == [1, 0]
    assert want == _run_jax(_jax_provider(tables), q)
    before = _order_counters(mesh_exec)
    port = _port_mesh(tables)
    with exchange_tally(port.mesh) as tally:
        got = _run_port(port, q)
    assert got == want
    assert [b - a for a, b in zip(before, _order_counters(mesh_exec))] == [1, 0]
    ops = set(tally.by_op())
    assert {"bucket_all_to_all", "sort_exchange"} <= ops
    assert ("bucket_overflow" in ops) and ("order_collide" in ops)


def test_full_scan_order_by_exchange():
    """The sample sort's exchange: the passing rows' keys and row ids
    (16 bytes a row) at most twice over in the buckets, and the
    collectives of its decision."""
    tables = _tables()["t"]
    port = _port_mesh(tables)
    q = "select k, v from t order by v, k;"
    with exchange_tally(port.mesh) as tally:
        got = _run_port(port, q)
    assert got == _run_jax(_jax_provider(tables), q) and len(got[1]) == 3000
    by_op = tally.by_op()
    assert set(by_op) == {"order_collide", "order_npass", "bucket_samples",
                          "bucket_all_to_all", "bucket_overflow"}
    n_local = 3000 // P
    C = int(2.0 * n_local / P)
    assert by_op["bucket_all_to_all"] == P * (P - 1) * C * 16


def test_full_scan_order_by_on_three_shards_goes_to_the_host():
    """The JAX tier's mesh sort needs a power of two shards: on three its
    host engine sorts, and so does the port's."""
    tables = _tables()["t"]
    q = jax_mesh.ORDER_QUERIES[0]
    assert _run_port(_port_mesh(tables, 3), q) == _run_jax(_jax_provider(tables), q)


# -- test_fuzz_mesh.py's seeds ----------------------------------------------


@pytest.mark.parametrize("seed", range(40))
def test_fuzz_seeds(seed):
    """The port serves every seed as the JAX host engine does, the full
    scan ORDER BY seeds through the mesh sorts."""
    rng = random.Random(1000 + seed)
    host = jax_fuzz._make_table(rng)
    query = jax_fuzz._gen_query(rng)
    want = _run_jax(host, query)
    got = _run_port(_port_mesh({"t": host.get_table_data("t")}), query)
    assert got == want, f"seed={seed} query={query!r}"


def test_fuzz_seeds_take_the_mesh_routes():
    routed = 0
    for seed in range(40):
        rng = random.Random(1000 + seed)
        host = jax_fuzz._make_table(rng)
        query = jax_fuzz._gen_query(rng)
        before = sum(_counters())
        _run_port(_port_mesh({"t": host.get_table_data("t")}), query)
        routed += sum(_counters()) > before
    assert routed >= 15, f"only {routed} of 40 fuzz queries took a mesh route"


@pytest.mark.parametrize("seed", range(30))
def test_order_fuzz_seeds(seed):
    """tests/test_fuzz_device_order.py's seeds (1 to 5000 rows with NULLs,
    NaN, -0.0, infinities, INT64 extremes, u64 max, strings with the
    literal "NULL"; one to three keys, asc / desc, WHERE, LIMIT / OFFSET)
    over 8 shards against the JAX host engine: a full ORDER BY takes the
    mesh sorts, a LIMIT the mesh top-k."""
    rng = random.Random(3000 + seed)
    host = jax_order_fuzz._make_table(rng)
    query = jax_order_fuzz._gen_order_query(rng)
    want = _run_jax(host, query)
    got = _run_port(_port_mesh({"t": host.get_table_data("t")}), query)
    assert got == want, f"seed={seed} query={query!r}"


def test_order_fuzz_seeds_take_the_mesh_sorts():
    ordered = bucket = 0
    for seed in range(30):
        rng = random.Random(3000 + seed)
        host = jax_order_fuzz._make_table(rng)
        query = jax_order_fuzz._gen_order_query(rng)
        before = _order_counters(mesh_exec)
        _run_port(_port_mesh({"t": host.get_table_data("t")}), query)
        after = _order_counters(mesh_exec)
        ordered += after[0] > before[0]
        bucket += after[1] > before[1]
    assert ordered >= 8 and 0 < bucket < ordered, (ordered, bucket)


# -- the exchange --------------------------------------------------------------


def test_group_by_exchange_is_o_groups_not_o_rows():
    """3000 rows in 37 groups over 8 shards: what crosses is each
    shard's compact table (key, count, sum, first row), at most 8 words
    a group and shard; one shard-length int64 table alone would be
    3000 * 8 * 7 / 8 bytes."""
    tables = _tables()["t"]
    port = _port_mesh(tables)
    with exchange_tally(port.mesh) as tally:
        _run_port(port, "select k, count(1), sum(v) from t group by k;")
    moved = tally.bytes()
    assert tally.by_op().keys() == {"sql_groupby_gather"}
    assert 0 < moved <= 8 * 8 * 37 * (P - 1)
    assert moved < 3000 * 8 * (P - 1) // P // 2


def test_join_and_top_k_exchanges_are_small():
    tables = _tables()["join"]
    port = _port_mesh(tables)
    with exchange_tally(port.mesh) as tally:
        _run_port(port, jax_mesh.JOIN_QUERIES[0])
    assert 0 < tally.bytes("sql_join_gather") <= 8 * 4 * 7 * (P - 1)  # 7 regions
    with exchange_tally(port.mesh) as tally:
        _run_port(port, "select k, v from f order by v desc limit 10;")
    # 10 candidates a shard (row id, key, mask), and one zero-key count
    by_op = tally.by_op()
    assert by_op.keys() == {"sql_topk_gather", "topk_npz"}
    assert 0 < by_op["sql_topk_gather"] <= (P - 1) * 10 * (8 + 8 + 1)
    assert by_op["topk_npz"] == (P - 1) * 8


# -- pinned cases --------------------------------------------------------------


def _rel(**cols):
    """A JAX Relation of (stype, values) columns, every value valid."""
    n = len(next(iter(cols.values()))[1])
    out = [Column(stype, np.asarray(data, dtype=np.uint64 if stype == SType.UINT64
                                    else None), np.ones(n, bool))
           for stype, data in cols.values()]
    return Relation(list(cols), out, n)


def test_every_shard_takes_the_global_span(monkeypatch):
    """Shard 0 holds keys 0..9, shard 7 keys 100..109: every shard's call
    of the hash aggregate has the whole column's span [0, 110), so the
    same key lies in the same slot on every shard."""
    n = 8 * 128
    k = np.full(n, 50, np.uint64)
    k[:128] = np.arange(128) % 10
    k[-128:] = 100 + np.arange(128) % 10
    tables = {"t": _rel(k=(SType.UINT64, k), v=(SType.UINT64, np.arange(n) % 7))}
    spans = []
    real = hash_groupby.hash_groupby

    def spy(keys, n, mask=None, values=(), kinds=(), values_unsigned=None, distinct=(),
            key_spans=None, distinct_spans=None, *, device=None):
        spans.append(None if key_spans is None else list(key_spans))
        return real(keys, n, mask, values, kinds, values_unsigned, distinct, key_spans,
                    distinct_spans, device=device)

    monkeypatch.setattr(hash_groupby, "hash_groupby", spy)
    q = "select k, count(1), max(v) from t group by k;"
    assert _run_port(_port_mesh(tables), q) == _run_jax(_jax_provider(tables), q)
    # P shard calls, then the merge
    assert spans[:P] == [[(0, 110, True)]] * P


def test_padding_rows_belong_to_no_group():
    """1001 rows pad to 1008 over 8 shards of 126: the padding reads 0,
    outside the key's span [5, 9] and inside ``v < 10``; the plain
    version raises on a masked-in key outside its span, so the padding
    must be masked out."""
    n = 1001
    rng = np.random.default_rng(3)
    tables = {"t": _rel(k=(SType.UINT64, rng.integers(5, 10, n).astype(np.uint64)),
                        v=(SType.UINT64, rng.integers(0, 20, n).astype(np.uint64)))}
    for q in ("select k, count(1), sum(v), min(v) from t where v < 10 group by k;",
              "select count(1), min(v) from t;",
              "select k, v from t where v < 10 order by v limit 5;"):
        assert _run_port(_port_mesh(tables), q) == _run_jax(_jax_provider(tables), q), q


def test_groups_come_in_the_order_of_their_first_global_rows():
    """Key 3 fills shard 0 but for its last row; keys 1 and 2 open
    shard 1. Without ORDER BY the host engine emits groups by first
    appearance: 3, 7, 1, 2 (first rows 0, 127, 128, 129); a shard-local
    first row would put 1 first."""
    n = 8 * 128
    k = np.full(n, 2, np.uint64)
    k[:127] = 3
    k[127] = 7
    k[128] = 1
    tables = {"t": _rel(k=(SType.UINT64, k), v=(SType.UINT64, np.arange(n) % 5))}
    for q in ("select k, count(1) from t group by k;",
              "select k, mean(v), count_distinct(v) from t group by k;"):
        got = _run_port(_port_mesh(tables), q)
        assert got == _run_jax(_jax_provider(tables), q)
        assert [r[0] for r in got[1]] == ["3", "7", "1", "2"]


def test_top_k_ties_go_to_the_lowest_global_row():
    n = 1024
    vals = np.full(n, 7, np.uint64)
    vals[[3, 200, 900]] = 9
    tables = {"t": _rel(v=(SType.UINT64, vals), rowid=(SType.UINT64, np.arange(n)))}
    for q in ("select rowid, v from t order by v desc limit 8;",
              "select rowid, v from t order by v limit 5 offset 130;"):
        got = _run_port(_port_mesh(tables), q)
        assert got == _run_jax(_jax_provider(tables), q)
    assert [r[0] for r in _run_port(_port_mesh(tables),
                                    "select rowid from t order by v desc limit 5;")[1]] == [
        "3", "200", "900", "0", "1"]


def test_top_k_zero_key_corner():
    """tests/test_mesh_sql.py's regression: a passing row at the largest
    key (top key 0) beside a filtered high row; the port re-takes the
    window through the stable sort and stays exact."""
    n = 1024
    vals = np.zeros(n, np.uint64)
    vals[0] = np.uint64(0xFFFFFFFFFFFFFFFF)
    vals[1], vals[700] = 5, 7
    flag = np.ones(n, np.uint64)
    flag[700] = 0
    tables = {"t": _rel(v=(SType.UINT64, vals), flag=(SType.UINT64, flag),
                        rowid=(SType.UINT64, np.arange(n)))}
    q = "select rowid, v from t where flag = 1 order by v desc limit 3;"
    for shards in (2, 8):
        got = _run_port(_port_mesh(tables, shards), q)
        assert got == _run_jax(_jax_provider(tables), q)
        assert len(got[1]) == 3


def test_u64_min_max_beyond_2_63_across_shards():
    """min / max of a u64 column take the unsigned order in each shard and
    in the merge: 2^63 + 5 in one shard beats 7 in another for max."""
    n = 8 * 128
    v = np.full(n, 7, np.uint64)
    v[5] = np.uint64((1 << 63) + 5)
    v[900] = np.uint64((1 << 64) - 1)
    k = (np.arange(n) % 3).astype(np.uint64)
    tables = {"t": _rel(k=(SType.UINT64, k), v=(SType.UINT64, v))}
    q = "select k, min(v), max(v), sum(v), count(1) from t group by k;"
    got = _run_port(_port_mesh(tables), q)
    assert got == _run_jax(_jax_provider(tables), q)
    assert [r[2] for r in got[1]] == [str((1 << 64) - 1), "7", str((1 << 63) + 5)]


def test_join_sums_stay_apart_and_buckets_keep_their_high_bits():
    """The join route's two faults of the JAX device route (ROADMAP C8: two
    different sums come out equal; C9: buckets from 65536 up fold onto
    the low ones) are not the JAX mesh tier's; the port's mesh join
    equals the host engine on both: 70 000 dimension rows take B5 on
    every shard, and 65 987 groups cross the merge."""
    import test_device_exec as jax_exec

    tables = jax_exec._make_join_tables()._tables
    q = ("select d.region, sum(f.v), sum(f.v + 1), count(1) from f join d"
         " on f.k = d.k group by d.region;")
    got = _run_port(_port_mesh(tables), q)
    assert got == _run_jax(_jax_provider(tables), q)
    assert all(r[1] != r[2] for r in got[1])

    d, n = 70_000, 200_000
    npr = np.random.default_rng(41)
    dk = npr.permutation(np.arange(d, dtype=np.uint64) * 3 + 1)
    tables = {"f": _rel(k=(SType.UINT64, dk[npr.integers(0, d, n)]),
                        v=(SType.UINT64, npr.integers(0, 1000, n))),
              "d": _rel(k=(SType.UINT64, dk), g=(SType.UINT64, np.arange(d) + 5))}
    q = "select d.g, count(1), sum(f.v) from f join d on f.k = d.k group by d.g order by 1;"
    before = mesh_exec.MESH_JOIN_RUNS
    got = _run_port(_port_mesh(tables), q)
    assert mesh_exec.MESH_JOIN_RUNS == before + 1
    assert got == _run_jax(_jax_provider(tables), q)
    assert len(got[1]) > 65536
