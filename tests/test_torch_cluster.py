"""The port's cluster fan-out against the JAX package's.

A coordinator (parallel/cluster.py ClusterTableProvider) ships encoded
partial-aggregate plans (plan/coder.py, plan/qtree_coder.py) to worker
servers over the native protocol (QUERY_PARTIALAGGR), merges their
partials, pushes ORDER BY ... LIMIT down (QUERY_REMOTE) and pulls the
rows of every other plan. Here: the JAX package's test_cluster.py cases
and its TCP-over-mesh composition (test_mesh_sql.py) through both
packages with equal answers (the port's workers at mesh_shards=4 where
the JAX test sets EVENTQL_TPU_MESH_DEVICES=4); a JAX coordinator over
port workers and the reverse; encode_plan byte for byte; partials and
relations serialized by one package and read by the other (u64 sums of
2^63 and more, a NULL key, mean as (sum, count)). The port runs its
coordinator and workers with device="cpu" (the kernels' plain versions).
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

import eventql_tpu.core.types as jax_types
import eventql_tpu.db.table_service as jax_table_service
import eventql_tpu.exec.operators as jax_operators
import eventql_tpu.exec.query_cache as jax_query_cache
import eventql_tpu.exec.relation as jax_relation
import eventql_tpu.exec.runtime as jax_runtime
import eventql_tpu.parallel.cluster as jax_cluster
import eventql_tpu.plan.coder as jax_coder
import eventql_tpu.plan.nodes as jax_nodes
import eventql_tpu.server.native_tcp as jax_native_tcp
import eventql_tpu_torch.core.types as port_types
import eventql_tpu_torch.db.table_service as port_table_service
import eventql_tpu_torch.exec.operators as port_operators
import eventql_tpu_torch.exec.query_cache as port_query_cache
import eventql_tpu_torch.exec.relation as port_relation
import eventql_tpu_torch.exec.runtime as port_runtime
import eventql_tpu_torch.parallel.cluster as port_cluster
import eventql_tpu_torch.plan.coder as port_coder
import eventql_tpu_torch.plan.nodes as port_nodes
import eventql_tpu_torch.server.native_tcp as port_native_tcp
from eventql_tpu_torch.exec import device_exec, mesh_exec
from eventql_tpu_torch.parallel.mesh_provider import MeshTableProvider

JAX = SimpleNamespace(
    name="jax", types=jax_types, table_service=jax_table_service, operators=jax_operators,
    query_cache=jax_query_cache, relation=jax_relation, runtime=jax_runtime,
    cluster=jax_cluster, coder=jax_coder, nodes=jax_nodes, nt=jax_native_tcp, device={},
)
PORT = SimpleNamespace(
    name="port", types=port_types, table_service=port_table_service, operators=port_operators,
    query_cache=port_query_cache, relation=port_relation, runtime=port_runtime,
    cluster=port_cluster, coder=port_coder, nodes=port_nodes, nt=port_native_tcp,
    device={"device": "cpu"},
)

SCHEMA = ("CREATE TABLE ev (t uint64, dim string, v uint64, x double,"
          " PRIMARY KEY (t));")
ROWS_1 = ['{"t": 1, "dim": "a", "v": 10, "x": 1.5}',
          '{"t": 2, "dim": "b", "v": 20, "x": 2.5}',
          '{"t": 3, "dim": "a", "v": 30, "x": 3.0}']
ROWS_2 = ['{"t": 4, "dim": "b", "v": 40, "x": 4.0}',
          '{"t": 5, "dim": "c", "v": 50, "x": 0.5}']


def _worker(pkg, rows, schema=SCHEMA, **kw):
    server = pkg.nt.NativeTCPServer(pkg.table_service.TableService(), port=0,
                                    **{**pkg.device, **kw}).start()
    c = pkg.nt.NativeTCPClient("127.0.0.1", server.port)
    c.query(schema)
    c.insert_json("ev", rows)
    c.close()
    return server


def _addrs(*servers):
    return [("127.0.0.1", s.port) for s in servers]


@pytest.fixture(scope="module")
def workers():
    """Two workers a package with disjoint rows of one table."""
    out = {pkg.name: (_worker(pkg, ROWS_1), _worker(pkg, ROWS_2)) for pkg in (JAX, PORT)}
    yield out
    for pair in out.values():
        for w in pair:
            w.stop()


def _coordinator(pkg, workers, of=None):
    """``pkg``'s ClusterTableProvider over the workers of package ``of``
    (default: its own)."""
    return pkg.cluster.ClusterTableProvider(_addrs(*workers[(of or pkg).name]))


def _run(pkg, provider, sql):
    rt = pkg.runtime.Runtime(**pkg.device)
    return rt.build_query_plan(rt.new_transaction(provider), sql).execute(0).rows


def _both(case, *args):
    want = case(JAX, *args)
    got = case(PORT, *args)
    assert got == want
    return got


def _group_by(pkg, provider, sql):
    rt = pkg.runtime.Runtime(**pkg.device)
    node = rt.build_query_plan(rt.new_transaction(provider), sql).nodes[0]
    while not isinstance(node, pkg.nodes.GroupByNode):
        node = node.table if hasattr(node, "table") else node.subquery
    return node


# -- test_cluster.py ------------------------------------------------------------


def test_cluster_describe(workers):
    got = _both(lambda pkg: [c[0] for c in _coordinator(pkg, workers).describe("ev").columns])
    assert got == ["t", "dim", "v", "x"]


CLUSTER_SQL = {
    "group_by_sum_count": ("select dim, sum(v), count(1) from ev group by dim order by dim;",
                           [["a", "40", "2"], ["b", "60", "2"], ["c", "50", "1"]]),
    "global_aggregate": ("select sum(v), count(1), max(x), min(v) from ev;",
                         [["150", "5", "4.000000", "10"]]),
    # worker means alone would be 20 and 45: the merge is (sum, count)
    "mean_merges_weighted": ("select mean(v) from ev;", [["30.000000"]]),
    "group_by_with_where": ("select dim, sum(v) from ev where v >= 20 group by dim order by dim;",
                            [["a", "30"], ["b", "60"], ["c", "50"]]),
    "remote_scan_fallback": ("select t, v from ev order by t;",
                             [[str(t), str(10 * t)] for t in range(1, 6)]),
    "remote_scan_string_columns": ("select dim from ev where v = 50;", [["c"]]),
}


@pytest.mark.parametrize("name", list(CLUSTER_SQL))
def test_cluster_queries(workers, name):
    sql, want = CLUSTER_SQL[name]
    assert _both(lambda pkg: _run(pkg, _coordinator(pkg, workers), sql)) == want


@pytest.mark.parametrize("coordinator", ["jax_over_port_workers", "port_over_jax_workers"])
@pytest.mark.parametrize("name", list(CLUSTER_SQL))
def test_one_packages_coordinator_over_the_others_workers(workers, coordinator, name):
    """The wire is one: the shipped plans, partials and row sets of
    either package are read by the other."""
    sql, want = CLUSTER_SQL[name]
    pkg, of = (JAX, PORT) if coordinator.startswith("jax") else (PORT, JAX)
    assert _run(pkg, _coordinator(pkg, workers, of), sql) == want


def test_partial_roundtrip_bytes(workers):
    def case(pkg):
        provider = _coordinator(pkg, workers)
        node = _group_by(pkg, provider, "select dim, sum(v), mean(x) from ev group by dim;")
        partial = pkg.operators._exec_group_by_local(node, provider.get_table_data("ev"))
        back = pkg.cluster.partial_from_bytes(pkg.cluster.partial_to_bytes(partial),
                                              pkg.cluster._make_template_partial(node))
        assert back.n_groups == partial.n_groups
        for a, b in zip(partial.key_cols, back.key_cols):
            np.testing.assert_array_equal(a.data, b.data)
        return back.n_groups, [k.data.tolist() for k in back.key_cols]

    assert _both(case) == (3, [[0, 1, 2]])


def test_relation_roundtrip_bytes(workers):
    def case(pkg):
        rel = _coordinator(pkg, workers).get_table_data("ev")
        back = pkg.cluster.relation_from_bytes(pkg.cluster.relation_to_bytes(rel))
        assert back.num_rows == rel.num_rows and back.names == rel.names
        for a, b in zip(rel.columns, back.columns):
            np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(a.valid, b.valid)
        return back.names, [c.data.tolist() for c in back.columns]

    names, cols = _both(case)
    assert names == ["t", "dim", "v", "x"] and cols[0] == [1, 2, 3, 4, 5]


def test_plan_coder_roundtrip(workers):
    def case(pkg):
        node = _group_by(pkg, _coordinator(pkg, workers),
                         "select dim, sum(v * 2) from ev where x > 1.0 group by dim;")
        back = pkg.coder.decode_plan(pkg.coder.encode_plan(node))
        got = [sl.expr.to_sql() for sl in back.select_list], back.table.where_expr.to_sql()
        assert got == ([sl.expr.to_sql() for sl in node.select_list],
                       node.table.where_expr.to_sql())
        return got

    _both(case)


def test_partialaggr_server_side_cache(tmp_path):
    """Workers cache partial aggregates keyed by the shipped plan and the
    table's data version; a mutation makes a fresh entry."""
    def case(pkg):
        cache_dir = tmp_path / pkg.name
        cache = pkg.query_cache.QueryCache(str(cache_dir))
        server = _worker(pkg, ['{"t": 1, "dim": "a", "v": 10, "x": 1.0}',
                               '{"t": 2, "dim": "b", "v": 20, "x": 2.0}'], query_cache=cache)
        try:
            provider = pkg.cluster.ClusterTableProvider(_addrs(server))
            sql = "select dim, sum(v) from ev group by dim order by dim;"

            def entries():
                return len([f for f in os.listdir(cache_dir) if f.endswith(".bin")])

            out = [(_run(pkg, provider, sql), entries())]
            out.append((_run(pkg, provider, sql), entries()))
            c = pkg.nt.NativeTCPClient("127.0.0.1", server.port)
            c.insert_json("ev", ['{"t": 3, "dim": "a", "v": 5, "x": 0.5}'])
            c.close()
            out.append((_run(pkg, provider, sql), entries()))
            return out
        finally:
            server.stop()

    assert _both(case) == [([["a", "10"], ["b", "20"]], 1), ([["a", "10"], ["b", "20"]], 1),
                           ([["a", "15"], ["b", "20"]], 2)]


def test_partialaggr_cache_not_reused_across_restarts(monkeypatch):
    """table_version carries a per-process boot epoch, so a restarted
    server never repeats a version."""
    def case(pkg):
        svc = pkg.table_service.TableService()
        svc.create_table(pkg.nodes.CreateTableNode(
            "t", [pkg.nodes.ColumnDefinition("k", "UINT64")], [], None, []))
        v1 = svc.table_version("t")
        svc.insert_json("t", '{"k": 1}')
        v2 = svc.table_version("t")
        old = pkg.table_service._BOOT_EPOCH
        monkeypatch.setattr(pkg.table_service, "_BOOT_EPOCH", "fffffffffff0")
        restarted = svc.table_version("t").split("-")[0] != old
        return v1.endswith("-0"), v2 != v1, restarted

    assert _both(case) == (True, True, True)


def test_cluster_exec_stats_rows_scanned(workers):
    """Shard partials carry their worker's rows_scanned to the
    coordinator's ExecutionContext; each shard completes one task."""
    def case(pkg):
        provider = _coordinator(pkg, workers)
        rt = pkg.runtime.Runtime(**pkg.device)
        txn = rt.new_transaction(provider)
        provider.exec_ctx = txn.exec_ctx
        rt.build_query_plan(txn, "select dim, sum(v) from ev group by dim;").execute(0)
        snap = txn.exec_ctx.snapshot()
        return (snap["rows_scanned"], snap["num_tasks"], snap["num_tasks_completed"],
                txn.exec_ctx.progress_permill())

    assert _both(case) == (5, 2, 2, 1000)


def test_native_client_result_stats():
    def case(pkg):
        server = _worker(pkg, ['{"t": %d, "dim": "a", "v": 1, "x": 0.5}' % i for i in range(7)])
        try:
            c = pkg.nt.NativeTCPClient("127.0.0.1", server.port)
            c.query("select dim, sum(v) from ev group by dim;")
            stats = c.last_result_stats
            c.close()
            return stats["rows_scanned"], stats["bytes_scanned"] > 0
        finally:
            server.stop()

    assert _both(case) == (7, True)


# -- plans on the wire -----------------------------------------------------------

PLAN_SQL = [
    "select k, count(1), sum(v) from t where v < 50 group by k;",
    "select k, sum(v + 1) from t where v < 50 and k > 2 group by k;",
    "select name, count_distinct(v) from t group by name;",
    "select k, v from t where v >= 10;",
    "select k, v from t order by v desc, k limit 7 offset 2;",
    "select min(v), max(v), mean(v) from t group by k;",
    "select if(k > 5, 1, 0), count(1) from t group by if(k > 5, 1, 0);",
    "select k from t where name REGEX 'n[0-3]' group by k;",
    "select k from t where isnull(v) group by k;",
    "select k, sum(v / 64), max(x) from t where x > 0.5 or k = 3 group by k;",
]


def _plan_provider(pkg, n=300, seed=3):
    rng = np.random.default_rng(seed)
    S, C = pkg.types.SType, pkg.relation.Column
    rel = pkg.relation.Relation(
        ["k", "v", "name", "x"],
        [C(S.UINT64, rng.integers(0, 13, n).astype(np.uint64), np.ones(n, bool)),
         C(S.UINT64, rng.integers(0, 100, n).astype(np.uint64), np.ones(n, bool)),
         C.from_strings([f"n{i % 7}".encode() for i in range(n)]),
         C(S.FLOAT64, rng.standard_normal(n), np.ones(n, bool))], n)
    p = pkg.runtime.RelationTableProvider()
    p.add_table("t", rel)
    return p


def _shipped(pkg, sql):
    rt = pkg.runtime.Runtime(**pkg.device)
    return rt.build_query_plan(rt.new_transaction(_plan_provider(pkg)), sql).nodes[0]


@pytest.mark.parametrize("sql", PLAN_SQL)
def test_encode_plan_byte_for_byte(sql):
    """Either package's coordinator can drive the other's workers: the
    same SQL encodes to the same bytes (binary default and the JSON debug
    encoding), and each package decodes the other's bytes back to them."""
    blobs = _both(lambda pkg: pkg.coder.encode_plan(_shipped(pkg, sql)))
    assert blobs[:1] != b"{"
    _both(lambda pkg: pkg.coder.encode_plan(_shipped(pkg, sql), binary=False))
    for pkg in (JAX, PORT):
        assert pkg.coder.encode_plan(pkg.coder.decode_plan(blobs)) == blobs


# -- partials across the packages ------------------------------------------------

U64 = [(1 << 63) + 5, (1 << 63) + 11, (1 << 64) - 2, 3, 7]


def _u64_relation(pkg):
    """k with a NULL, u64 values whose sums pass 2^63 and wrap, x float."""
    S, C = pkg.types.SType, pkg.relation.Column
    n = 10
    k = np.array([1, 2, 1, 0, 2, 1, 0, 2, 1, 0], np.uint64)
    k_valid = np.array([1, 1, 1, 0, 1, 1, 0, 1, 1, 1], bool)
    v = np.array(U64 + U64[::-1], np.uint64)
    x = np.arange(n, dtype=np.float64) / 4
    return pkg.relation.Relation(
        ["k", "v", "x"],
        [C(S.UINT64, k, k_valid), C(S.UINT64, v, np.ones(n, bool)),
         C(S.FLOAT64, x, np.ones(n, bool))], n)


U64_SQL = ("select k, count(1), sum(v), min(v), max(v), mean(x), sum(x) from t"
           " group by k order by k;")


def _u64_partials(pkg, halves):
    """The partials of the two halves of the relation under ``pkg``."""
    rel = _u64_relation(pkg)
    p = pkg.runtime.RelationTableProvider()
    p.add_table("t", rel)
    node = _group_by(pkg, p, U64_SQL)
    parts = [pkg.operators._exec_group_by_local(node, rel.gather(np.arange(lo, hi)))
             for lo, hi in halves]
    return node, parts


@pytest.mark.parametrize("writer", ["jax", "port", "port_mesh"])
def test_partials_from_the_other_package(writer):
    """partial_from_bytes of the other package's partial_to_bytes: a NULL
    group key, u64 sums of 2^63 and more (wrapping mod 2^64), min / max
    of u64, mean as (sum, count), float sums; the merge of the two
    halves equals the whole table's answer in both packages. The port's
    worker partial also comes from its mesh route
    (try_execute_mesh_groupby(partial=True) on 2 CPU shards)."""
    halves = [(0, 5), (5, 10)]
    if writer == "port_mesh":
        rel = _u64_relation(PORT)
        blobs = []
        for lo, hi in halves:
            mp = MeshTableProvider(n_shards=2, device="cpu")
            mp.add_table("t", rel.gather(np.arange(lo, hi)))
            rt = PORT.runtime.Runtime(device="cpu")
            txn = rt.new_transaction(mp)
            node = _group_by(PORT, mp, U64_SQL.replace(", mean(x), sum(x)", ", mean(x)"))
            part = mesh_exec.try_execute_mesh_groupby(node, txn, partial=True)
            assert part is not None
            blobs.append(PORT.cluster.partial_to_bytes(part, rows_scanned=hi - lo))
        sql = U64_SQL.replace(", mean(x), sum(x)", ", mean(x)")
    else:
        src = JAX if writer == "jax" else PORT
        _node, parts = _u64_partials(src, halves)
        blobs = [src.cluster.partial_to_bytes(p, rows_scanned=5) for p in parts]
        sql = U64_SQL
    rows = {}
    for pkg in (JAX, PORT):
        p = pkg.runtime.RelationTableProvider()
        p.add_table("t", _u64_relation(pkg))
        node = _group_by(pkg, p, sql)
        template = pkg.cluster._make_template_partial(node)
        partials = [pkg.cluster.partial_from_bytes(b, template) for b in blobs]
        assert [q.rows_scanned for q in partials] == [5, 5]
        merged = pkg.operators._merge_partials(node, partials)
        rt = pkg.runtime.Runtime(**({"device": None} if pkg is PORT else {}))
        want = rt.build_query_plan(rt.new_transaction(p), sql.replace(" order by k", "")).execute(0)
        got = [[merged.columns[j].format_value(i) for j in range(len(merged.columns))]
               for i in range(merged.num_rows)]
        assert sorted(got) == sorted(want.rows)
        rows[pkg.name] = sorted(got)
    assert rows["jax"] == rows["port"]
    sums = {r[0]: int(r[2]) for r in rows["port"]}
    assert sums["1"] == sum(U64[i % 5] if i < 5 else U64[::-1][i - 5] for i in (0, 2, 5, 8)) % (1 << 64)
    assert max(sums.values()) >= 1 << 63 and "NULL" in sums


# -- the TCP-over-mesh composition (test_mesh_sql.py) ------------------------------


def _mesh_cluster(pkg, rows_of, schema, **kw):
    w1 = _worker(pkg, rows_of(0), schema, **kw)
    w2 = _worker(pkg, rows_of(1000), schema, **kw)
    return (w1, w2), pkg.cluster.ClusterTableProvider(_addrs(w1, w2))


def _compose(sql, schema, rows_of, counters, **worker):
    """The JAX cluster of host workers against the port's of workers
    made with ``worker`` (a mesh of 4 CPU shards by default); returns the
    port's rows and how much ``counters`` rose."""
    servers, provider = _mesh_cluster(JAX, rows_of, schema)
    try:
        want = _run(JAX, provider, sql)
    finally:
        for s in servers:
            s.stop()
    servers, provider = _mesh_cluster(PORT, rows_of, schema, **(worker or {"mesh_shards": 4}))
    try:
        before = sum(getattr(mesh_exec, c) for c in counters)
        got = _run(PORT, provider, sql)
        rose = sum(getattr(mesh_exec, c) for c in counters) - before
    finally:
        for s in servers:
            s.stop()
    assert got == want
    return got, rose


# a worker's mesh: 4 shards; the server's device alone (one shard); none
# on a host-engine server, which aggregates in numpy (no mesh counter)
WORKER_MESHES = {"mesh_shards_4": ({"mesh_shards": 4}, 2),
                 "device_alone": ({"device": "cpu"}, 2),
                 "host_engine": ({"device": None}, 0)}


@pytest.mark.parametrize("mesh", list(WORKER_MESHES))
def test_cluster_workers_aggregate_on_mesh(mesh):
    worker, runs = WORKER_MESHES[mesh]
    rng = np.random.default_rng(31)
    data = {t0: [(int(rng.integers(0, 7)), int(rng.integers(0, 100))) for _ in range(40)]
            for t0 in (0, 1000)}
    got, rose = _compose(
        "select k, count(1), sum(v), min(v), max(v), mean(v) from ev where v < 90"
        " group by k order by k;",
        "CREATE TABLE ev (t uint64, k uint64, v uint64, PRIMARY KEY (t));",
        lambda t0: ['{"t": %d, "k": %d, "v": %d}' % (t0 + i, k, v)
                    for i, (k, v) in enumerate(data[t0])],
        ["MESH_GROUPBY_RUNS"], **worker)
    assert rose == runs and len(got) == 7


@pytest.mark.parametrize("mesh", list(WORKER_MESHES))
def test_cluster_workers_serve_topk_on_mesh(mesh):
    worker, runs = WORKER_MESHES[mesh]
    rng = np.random.default_rng(41)
    data = {t0: rng.integers(0, 10000, 300).tolist() for t0 in (0, 1000)}
    got, rose = _compose(
        "select t, v from ev order by v desc limit 7;",
        "CREATE TABLE ev (t uint64, v uint64, PRIMARY KEY (t));",
        lambda t0: ['{"t": %d, "v": %d}' % (t0 + i, v) for i, v in enumerate(data[t0])],
        ["MESH_TOPK_RUNS", "MESH_ORDER_RUNS"], **worker)
    assert rose == runs and len(got) == 7


def test_coordinator_routes_serve_the_pulled_rows():
    """A shape the partial fan-out refuses (a JOIN) pulls every worker's
    rows and runs on the coordinator's routes: the port's join route
    answers as the JAX host engine does."""
    schema = "CREATE TABLE ev (t uint64, k uint64, v uint64, PRIMARY KEY (t));"

    def case(pkg):
        def worker(t0, dims):
            server = _worker(pkg, ['{"t": %d, "k": %d, "v": %d}' % (t0 + i, i % 9, i)
                                   for i in range(50)], schema)
            c = pkg.nt.NativeTCPClient("127.0.0.1", server.port)
            c.query("CREATE TABLE d (id uint64, g string, PRIMARY KEY (id));")
            c.insert_json("d", ['{"id": %d, "g": "g%d"}' % (i, i % 3) for i in dims])
            c.close()
            return server

        servers = (worker(0, range(0, 4)), worker(1000, range(4, 8)))
        try:
            before = device_exec.JOIN_GROUPBY_COUNT
            rows = _run(pkg, pkg.cluster.ClusterTableProvider(_addrs(*servers)),
                        "select d.g, count(1), sum(ev.v) from ev join d on ev.k = d.id"
                        " group by d.g;")
            return rows, device_exec.JOIN_GROUPBY_COUNT - before
        finally:
            for s in servers:
                s.stop()

    want, _ = case(JAX)
    got, routed = case(PORT)
    assert got == want and len(got) == 3 and routed == 1


def test_not_ported_paths_name_what_is_missing(tmp_path):
    """cluster_provider_from_config, which named config/ as missing until
    the cluster tier was ported, builds over a registry file the provider
    the JAX package builds: its live workers and address book."""
    from eventql_tpu.config import config_directory as jax_cd
    from eventql_tpu_torch.config import config_directory as port_cd

    path = str(tmp_path / "cluster.cfg")
    cdir = port_cd.ConfigDirectory(path)
    cdir.cluster_create("c", replication_factor=2)
    for i, status in enumerate(("SERVER_UP", "SERVER_DOWN", "SERVER_UP")):
        cdir.update_server_config(port_cd.ServerConfig(f"n{i}", f"127.0.0.1:{9100 + i}", status))
    got = PORT.cluster.cluster_provider_from_config(path)
    want = JAX.cluster.cluster_provider_from_config(path)
    assert (got.workers, got.server_map) == (want.workers, want.server_map)
    assert got.server_map == {"n0": ("127.0.0.1", 9100), "n2": ("127.0.0.1", 9102)}
    assert [s.server_id for s in jax_cd.ConfigDirectory(path).list_servers()] == ["n0", "n1", "n2"]


def test_coordinator_ddl_inserts_and_streamed_rows():
    """A coordinator broadcasts CREATE TABLE to every worker, sends each
    insert to one worker round robin and streams a SELECT a worker at a
    time (get_table_chunks), as the JAX coordinator does."""
    def case(pkg):
        servers = [pkg.nt.NativeTCPServer(pkg.table_service.TableService(), port=0,
                                          **pkg.device).start() for _ in range(2)]
        try:
            provider = pkg.cluster.ClusterTableProvider(_addrs(*servers))
            _run(pkg, provider, SCHEMA)
            for row in ROWS_1 + ROWS_2:
                provider.insert_json("ev", row)
            per_worker = [s.table_service.get_table_data("ev").num_rows for s in servers]
            chunks = [[c.data.tolist() for c in ch.columns]
                      for ch in provider.get_table_chunks("ev", 2)]
            return per_worker, chunks, _run(pkg, provider, "select sum(v), count(1) from ev;")
        finally:
            for s in servers:
                s.stop()

    per_worker, chunks, total = _both(case)
    assert per_worker == [3, 2] and len(chunks) == 3 and total == [["150", "5"]]
