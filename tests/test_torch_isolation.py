"""The port stands alone: it imports neither jax nor the JAX package,
and it does not hide a missing GPU behind the CPU.

Checked at run time in a fresh interpreter (this test process itself
has jax loaded by tests/conftest.py) and statically over the sources.
"""

import os
import re
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROGRAM = r"""
import sys
import numpy as np
import eventql_tpu_torch
from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.core.types import SType
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.relation import relation_from_numpy
from eventql_tpu_torch.exec.runtime import RelationTableProvider, Runtime

n = 1000
rng = np.random.default_rng(3)
rel = relation_from_numpy(
    ["k", "v"],
    [
        (SType.STRING, rng.integers(0, 4, n).astype(np.int32), np.ones(n, bool),
         np.array([b"a", b"b", b"c", b"d"], dtype=object)),
        (SType.UINT64, rng.integers(0, 1000, n).astype(np.uint64),
         np.ones(n, bool), None),
    ],
)
p = RelationTableProvider()
p.add_table("t", rel)
rt = eventql_tpu_torch.Runtime(device="cpu")
res = rt.build_query_plan(
    rt.new_transaction(p),
    "select k, count(1), sum(v) from t where v < 800 group by k order by k;",
).execute(0)
assert [r[0] for r in res.rows] == ["a", "b", "c", "d"], res.rows
assert sum(int(r[1]) for r in res.rows) == int((rel.columns[1].data < 800).sum())
assert device_exec.FUSED_GROUPBY_COUNT == 1
res = rt.build_query_plan(
    rt.new_transaction(p), "select k, v from t order by v desc, k limit 3;"
).execute(0)
top = np.lexsort((rel.columns[0].data, -rel.columns[1].data.astype(np.int64)))[:3]
assert [int(r[1]) for r in res.rows] == [int(rel.columns[1].data[i]) for i in top]
res = rt.build_query_plan(
    rt.new_transaction(p), "select v from t where v < 10 order by v;"
).execute(0)
assert [int(r[0]) for r in res.rows] == sorted(
    int(x) for x in rel.columns[1].data if x < 10)
assert (device_exec.SCAN_TOPK_COUNT, device_exec.SCAN_ORDER_COUNT) == (1, 1)
m = 16
p.add_table("d", relation_from_numpy(
    ["k", "g"],
    [
        (SType.UINT64, (np.arange(m) * 50).astype(np.uint64), np.ones(m, bool), None),
        (SType.UINT64, (np.arange(m) % 3).astype(np.uint64), np.ones(m, bool), None),
    ],
))
res = rt.build_query_plan(
    rt.new_transaction(p),
    "select d.g, count(1), sum(t.v), sum(t.v + 1) from t join d on t.v = d.k"
    " group by d.g order by d.g;",
).execute(0)
v = rel.columns[1].data
hit = (v % 50 == 0) & (v // 50 < m)
assert [[int(x) for x in r] for r in res.rows] == [
    [g, int((hit & (v // 50 % 3 == g)).sum()),
     int(v[hit & (v // 50 % 3 == g)].sum()),
     int((v[hit & (v // 50 % 3 == g)] + 1).sum())] for g in range(3)], res.rows
assert device_exec.JOIN_GROUPBY_COUNT == 1
res = rt.build_query_plan(
    rt.new_transaction(p),
    "select k, min(v), max(v), count_distinct(v) from t group by k order by k;",
).execute(0)
k = rel.columns[0].data
assert [[int(x) for x in r[1:]] for r in res.rows] == [
    [int(v[k == i].min()), int(v[k == i].max()), len(np.unique(v[k == i]))]
    for i in range(4)], res.rows
assert device_exec.GENERAL_GROUPBY_COUNT == 1

# the mesh tier on 4 CPU shards: GROUP BY, JOIN + GROUP BY, top-k and a
# kernel-tier aggregate, each equal to the host engine / numpy
from eventql_tpu_torch.exec import mesh_exec
from eventql_tpu_torch.parallel import distributed
from eventql_tpu_torch.parallel.mesh_provider import MeshTableProvider

mp = MeshTableProvider(n_shards=4, device="cpu")
for name in ("t", "d"):
    mp.add_table(name, p.get_table_data(name))
host_rt = Runtime(device=None)
for q in ("select k, count(1), sum(v), min(v), count_distinct(v) from t group by k;",
          "select d.g, count(1), sum(t.v) from t join d on t.v = d.k group by d.g;",
          "select k, v from t where v < 900 order by v desc limit 7;"):
    got = host_rt.build_query_plan(host_rt.new_transaction(mp), q).execute(0).rows
    want = host_rt.build_query_plan(host_rt.new_transaction(p), q).execute(0).rows
    assert got == want, (q, got, want)
assert (mesh_exec.MESH_GROUPBY_RUNS, mesh_exec.MESH_JOIN_RUNS,
        mesh_exec.MESH_TOPK_RUNS) == (1, 1, 1)
# the full ORDER BY: one key and two packed keys (the sample sort), a
# computed key beside a string (the compare-split)
for q in ("select v, k from t order by v desc;",
          "select k, v from t where v < 900 order by k desc, v;",
          "select k, v from t where v < 900 order by v + 1, k;"):
    got = host_rt.build_query_plan(host_rt.new_transaction(mp), q).execute(0).rows
    want = host_rt.build_query_plan(host_rt.new_transaction(p), q).execute(0).rows
    assert got == want, (q, got[:5], want[:5])
assert (mesh_exec.MESH_ORDER_RUNS, mesh_exec.MESH_BUCKET_SORT_RUNS) == (3, 2)
mesh = distributed.make_mesh(4, "cpu")
gid = (k % 3).astype(np.int32)
counts, sums = distributed.distributed_sum_count(
    mesh, *distributed.shard_table(mesh, [v < 800, gid, v]), 3)
assert counts.tolist() == np.bincount(gid[v < 800], minlength=3).tolist()
assert sums.tolist() == [int(v[(v < 800) & (gid == g)].sum()) for g in range(3)]
# the kernel tier's sorts, top-k and grouped aggregates against numpy
import torch
vs, ids = distributed.shard_table(mesh, [v, np.arange(n)])
(sv,), (sp,) = distributed.distributed_sort(mesh, [vs], [ids])
assert torch.cat(sv).tolist() == np.sort(v).tolist()
assert v[torch.cat(sp).numpy()].tolist() == np.sort(v).tolist()
perm = torch.cat(distributed.distributed_order_permutation(mesh, [vs], [True]))
assert v[perm.numpy()].tolist() == np.sort(v)[::-1].tolist()
bk, bp, bc, over = distributed.distributed_bucket_sort(mesh, vs, ids)
assert not bool(over)
assert sum((t[:c].tolist() for t, c in zip(bk, bc.tolist())), []) == np.sort(v).tolist()
tv, ti = distributed.distributed_topk(mesh, vs, ids, 5)
assert tv.tolist() == np.sort(v)[::-1][:5].tolist() and v[ti.numpy()].tolist() == tv.tolist()
ms, gs = distributed.shard_table(mesh, [v < 800, k % 3])
gk, (cnt, sm), _valid = distributed.distributed_grouped_aggregate(
    mesh, ms, [gs], [vs, vs], ["count", "sum"])
assert gk[0].tolist() == [0, 1, 2]
assert cnt.tolist() == np.bincount((k % 3)[v < 800], minlength=3).tolist()
assert sm.tolist() == [int(v[(v < 800) & (k % 3 == g)].sum()) for g in range(3)]
gk, dc, _valid = distributed.distributed_count_distinct(mesh, ms, [gs], vs)
assert dc.tolist() == [len(np.unique(v[(v < 800) & (k % 3 == g)])) for g in range(3)]
gk, (mx,), valid = distributed.distributed_grouped_aggregate_sharded(
    mesh, ms, [gs], [vs], ["max"])
assert sum((t[m].tolist() for t, m in zip(mx, valid)), []) == [
    int(v[(v < 800) & (k % 3 == g)].max()) for g in range(3)]
# the process mesh's module: its entry points on a one-process group
from eventql_tpu_torch.parallel import multihost
multihost.init_multihost(f"127.0.0.1:{multihost_port}", 1, 0, backend="gloo", timeout_s=60)
gm = multihost.global_mesh(4, "cpu")
assert (gm.size, gm.local, gm.world) == (4, [0, 1, 2, 3], 1)
gs, gv = multihost.make_global_table(gm, [k % 3, v])
gk, (sm,), _valid = distributed.distributed_grouped_aggregate(gm, None, [gs], [gv], ["sum"])
assert multihost.fetch_replicated(sm).tolist() == [int(v[k % 3 == g].sum()) for g in range(3)]
assert multihost.fetch_sharded(gm, gv).tolist() == v.astype(np.int64).tolist()
torch.distributed.destroy_process_group()
try:
    distributed.make_mesh(2, "cuda")
except RuntimeError_ as e:
    assert "CUDA" in str(e)
else:
    raise AssertionError("make_mesh(device='cuda') did not raise without a GPU")
try:
    MeshTableProvider(n_shards=2)
except RuntimeError_ as e:
    assert "CUDA" in str(e)
else:
    raise AssertionError("MeshTableProvider() did not raise without a GPU")

bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "jaxlib" or m == "eventql_tpu" or m.startswith("eventql_tpu.")]
assert not bad, bad

import torch
assert not torch.cuda.is_available()
for make in (lambda: Runtime(), lambda: Runtime(device="cuda"),
             lambda: eventql_tpu_torch.Runtime()):
    try:
        make()
    except RuntimeError_ as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("Runtime(device='cuda') did not raise without a GPU")

# a CUDA tensor is never served by the plain version: without a card
# the tensor cannot even be made, and the wrapper has no other path
from eventql_tpu_torch.kernels import (
    extract, groupby, groupby_agg, hash_groupby, join, sort)
assert groupby_agg.LAUNCHES == {"groupby_agg": 0, "groupby_multi_agg": 0}
assert hash_groupby.LAUNCHES == {"hash_groupby": 0}
assert extract.LAUNCHES == {"extract_ge": 0}
assert join.LAUNCHES == {"dim_join_gid": 0, "probe_join_gid": 0, "build_join_table": 0}
keys = torch.tensor([7, -1, 9, 8])
assert join.join_gid(keys, torch.tensor([9, -1]), torch.tensor([4, 5], dtype=torch.int32)
                     ).tolist() == [-1, 5, 4, -1]
key = groupby.sortable_u64(torch.tensor([3, -1, 2]), descending=True)
assert sort.topk_permutation(key, 1).tolist() == [1]
assert extract.extract_ge(torch.tensor([1, 7, 9], dtype=torch.int32), 7, 2).tolist() == [1, 2]
g = hash_groupby.hash_groupby([torch.tensor([5, 3, 5])], 3, values=[torch.tensor([1, 2, 4])],
                              kinds=["max"])
assert (g.first_index.tolist(), g.counts.tolist(), g.aggregates[0].tolist()) == (
    [1, 0], [1, 2], [2, 4])
assert hash_groupby.LAUNCHES == {"hash_groupby": 0}
print("ISOLATED-OK")
"""


_STORAGE_MODULES = [
    "columnar.native", "columnar.cstable", "columnar.cstable_writer",
    "columnar.cstable_v2", "db.tablet_index", "db.shredded_record_list",
    "db.table_service", "columnar.shredder", "parallel.partitioned", "db.lsm",
    "columnar.csv_ingest", "columnar.providers", "exec.query_cache",
    "exec.streaming", "columnar.nested_scan",
]

_STORAGE_PROGRAM = r"""
import importlib, json, os, sys, tempfile
for name in MODULES:
    importlib.import_module("eventql_tpu_torch." + name)
from eventql_tpu_torch.columnar.providers import CSTableScanProvider
from eventql_tpu_torch.db.lsm import DurableTableService
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.query_cache import QueryCache
from eventql_tpu_torch.exec.runtime import Runtime

rt = Runtime(device="cpu")
def q(svc, sql, cache=None):
    return rt.build_query_plan(rt.new_transaction(svc, query_cache=cache), sql)

d = tempfile.mkdtemp()
svc = DurableTableService(d, arena_flush_rows=50)
q(svc, "CREATE TABLE t (id uint64, k string, v uint64, PRIMARY KEY (id));").execute(0)
q(svc, "CREATE TABLE n (id uint64, tags REPEATED string, PRIMARY KEY (id));").execute(0)
for i in range(120):
    svc.insert_json("t", json.dumps({"id": i % 100, "k": "k%d" % (i % 3), "v": i}))
    svc.insert_json("n", json.dumps({"id": i, "tags": ["a", "b"][: i % 3]}))
svc.commit_all()
svc = DurableTableService(d)
latest = {i % 100: i for i in range(120)}  # the newest write of each id wins
assert q(svc, "select k, count(1), sum(v) from t group by k order by k;").execute(0).rows == [
    ["k%d" % g, str(sum(1 for v in latest.values() if v % 3 == g)),
     str(sum(v for v in latest.values() if v % 3 == g))] for g in range(3)]
assert device_exec.FUSED_GROUPBY_COUNT == 1
assert q(svc, "select count(tags) from n;").execute(0).rows == [["120"]]
stream = q(svc, "select id from t where v >= 115;").execute_stream(0)
assert [r[0] for r in stream.rows] == ["15", "16", "17", "18", "19"]
svc.tables["t"].compact()
seg = [f for f in os.listdir(os.path.join(d, "t")) if f.endswith(".cst")][0]
provider = CSTableScanProvider("t", os.path.join(d, "t", seg))
cache = QueryCache(os.path.join(d, "qcache"))
sql = "select k, count(1) from t group by k;"
assert q(provider, sql, cache).execute(0).rows == q(provider, sql, cache).execute(0).rows
assert device_exec.FUSED_GROUPBY_COUNT == 2 and len(os.listdir(cache.cache_dir)) == 1
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "jaxlib" or m == "eventql_tpu" or m.startswith("eventql_tpu.")]
assert not bad, bad
print("STORAGE-ISOLATED-OK")
"""


def test_storage_modules_run_without_jax():
    """The storage tier's modules import and serve (a stored table written,
    reopened, grouped on the route, a nested count, a stream, a
    compaction, a query cache hit) with neither jax nor eventql_tpu
    loaded."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-c", f"MODULES = {_STORAGE_MODULES!r}\n" + _STORAGE_PROGRAM],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "STORAGE-ISOLATED-OK" in out.stdout


_SERVING_MODULES = [
    "plan.qtree_coder", "plan.coder", "db.metadata", "server.auth", "server.native_tcp",
    "server.http_api", "server.listener", "parallel.conn_pool", "parallel.cluster",
    "cli.evqld", "cli.console",
]

_SERVING_PROGRAM = r"""
import importlib, json, sys, urllib.request
for name in MODULES:
    importlib.import_module("eventql_tpu_torch." + name)
from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.db.table_service import TableService
from eventql_tpu_torch.exec import device_exec, mesh_exec
from eventql_tpu_torch.parallel.cluster import ClusterTableProvider
from eventql_tpu_torch.server.http_api import EventQLServer
from eventql_tpu_torch.server.listener import Listener
from eventql_tpu_torch.server.native_tcp import NativeTCPClient, NativeTCPServer

def http(port, query):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/sql",
                                 data=json.dumps({"query": query}).encode())
    return json.loads(urllib.request.urlopen(req, timeout=30).read())["results"][0]["rows"]

rows = ['{"t": %d, "k": "k%d", "v": %d}' % (i, i % 3, i) for i in range(90)]
want = [["k%d" % g, str(sum(range(g, 90, 3)))] for g in range(3)]
sql = "select k, sum(v) from ev group by k order by k;"
svc = TableService()
http_server = EventQLServer(svc, device="cpu").start(bind=False)
native = NativeTCPServer(svc, device="cpu")
lis = Listener(http_server, native, port=0).start()
c = NativeTCPClient("127.0.0.1", lis.port)
c.query("CREATE TABLE ev (t uint64, k string, v uint64, PRIMARY KEY (t));")
c.insert_json("ev", rows)
assert c.query(sql)[0][1] == want and http(lis.port, sql) == want
c.close()
assert device_exec.FUSED_GROUPBY_COUNT == 2
lis.stop()
http_server.stop()

workers = []
for part in (rows[:45], rows[45:]):
    w = NativeTCPServer(TableService(), port=0, device="cpu", mesh_shards=2).start()
    c = NativeTCPClient("127.0.0.1", w.port)
    c.query("CREATE TABLE ev (t uint64, k string, v uint64, PRIMARY KEY (t));")
    c.insert_json("ev", part)
    c.close()
    workers.append(w)
addrs = [("127.0.0.1", w.port) for w in workers]
coordinator = EventQLServer(port=0, device="cpu",
                            query_provider_factory=lambda: ClusterTableProvider(addrs)).start()
assert http(coordinator.port, sql) == want
assert mesh_exec.MESH_GROUPBY_RUNS == 2
coordinator.stop()
for w in workers:
    w.stop()

for make in (lambda: NativeTCPServer(svc), lambda: EventQLServer(svc)):
    try:
        make()
    except RuntimeError_ as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("a server on device='cuda' started without a GPU")
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "jaxlib" or m == "eventql_tpu" or m.startswith("eventql_tpu.")]
assert not bad, bad
print("SERVING-ISOLATED-OK")
"""


def test_serving_modules_run_without_jax():
    """The serving tier's modules import and serve (native protocol and
    HTTP on one port, a coordinator over two workers that aggregate on
    their meshes) with neither jax nor eventql_tpu loaded; a server left
    on its default device raises without a card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-c", f"MODULES = {_SERVING_MODULES!r}\n" + _SERVING_PROGRAM],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SERVING-ISOLATED-OK" in out.stdout


def test_serving_modules_read_no_environment():
    """The serving tier takes its device and its mesh as arguments: none
    of its modules reads an environment variable."""
    for name in _SERVING_MODULES:
        path = os.path.join(REPO, "eventql_tpu_torch", *name.split(".")) + ".py"
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        assert "environ" not in text and "getenv" not in text, path


_CLUSTER_MODULES = [
    "exec.chart_style", "exec.chart", "config.config_directory",
    "config.config_directory_zookeeper", "config.zookeeper", "config.process_config",
    "db.metadata_file", "db.metadata_service", "db.metadata_transport", "db.server_allocator",
    "db.replication", "db.rebalance", "db.leader", "db.metadata_replication", "db.monitor",
    "db.autosplit",
]

_CLUSTER_PROGRAM = r"""
import importlib, json, sys, tempfile
for name in MODULES:
    importlib.import_module("eventql_tpu_torch." + name)
from eventql_tpu_torch.config import config_directory_zookeeper
from eventql_tpu_torch.config.config_directory import SERVER_UP, ConfigDirectory, ServerConfig
from eventql_tpu_torch.config.zookeeper import ZooKeeperServer
from eventql_tpu_torch.db import autosplit
from eventql_tpu_torch.db.metadata_service import MetadataService, MetadataStore
from eventql_tpu_torch.db.metadata_transport import remote_factory_from_cdir
from eventql_tpu_torch.db.replication import ReplicationWorker
from eventql_tpu_torch.db.table_service import TableService
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.exec.runtime import Runtime
from eventql_tpu_torch.parallel.cluster import cluster_provider_from_config
from eventql_tpu_torch.server.native_tcp import NativeTCPServer

zk = ZooKeeperServer().start()
url = "zk://%s/iso" % zk.address
cdir = ConfigDirectory(url)
cdir.cluster_create("iso", replication_factor=2)
servers = []
for i in range(3):
    s = NativeTCPServer(TableService(), port=0, device="cpu", metadata_service=MetadataService(
        MetadataStore(tempfile.mkdtemp())))
    s.query_provider_factory = lambda: cluster_provider_from_config(url)
    servers.append(s.start())
    cdir.update_server_config(ServerConfig("node%d" % (i + 1), "127.0.0.1:%d" % s.port, SERVER_UP))
rt = Runtime(device="cpu")
def q(sql):
    p = cluster_provider_from_config(url)
    try:
        return rt.build_query_plan(rt.new_transaction(p), sql).execute(0).rows
    finally:
        p.close()
q("CREATE TABLE ev (t uint64, k string, v uint64, PRIMARY KEY (t));")
p = cluster_provider_from_config(url)
for i in range(30):
    p.insert_json("ev", json.dumps({"t": i, "k": "k%d" % (i % 3), "v": i}))
p.close()
assert autosplit.run_once(servers[0].table_service, cdir, threshold_rows=10,
                          remote_factory=remote_factory_from_cdir(cdir))
workers = [ReplicationWorker(s.table_service, url, "node%d" % (i + 1))
           for i, s in enumerate(servers)]
assert any("loaded" in a for a in workers[2].lifecycle_once())
assert any("split finalized" in a for a in workers[0].lifecycle_once())
assert len(q("describe partitions ev;")) == 2
assert q("select k, sum(v) from ev group by k order by k;") == [
    ["k%d" % g, str(sum(range(g, 30, 3)))] for g in range(3)]
for s in servers:
    s.stop()
zk.stop()
config_directory_zookeeper.reset_sessions()
before = device_exec.FUSED_GROUPBY_COUNT
svc = TableService()
tx = lambda sql: rt.build_query_plan(rt.new_transaction(svc), sql).execute(0)
tx("CREATE TABLE t (k string, v uint64);")
svc.insert_json_batch("t", json.dumps([{"k": "a%d" % (i % 5), "v": i} for i in range(50)]))
svg = tx("DRAW BARCHART; SELECT k AS x, sum(v) AS y FROM t GROUP BY k ORDER BY x;").rows[0][0]
assert svg.startswith("<svg") and device_exec.FUSED_GROUPBY_COUNT == before + 1
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "jaxlib" or m == "eventql_tpu" or m.startswith("eventql_tpu.")]
assert not bad, bad
print("CLUSTER-ISOLATED-OK")
"""


def test_cluster_modules_run_without_jax():
    """The cluster tier's modules import and serve (an embedded ZooKeeper
    registry, three native servers with metadata services, routed and
    replicated inserts, an autosplit whose split a replica loads and
    another finalizes, a query over the new partitions, a DRAW on the
    GROUP BY route) with neither jax nor eventql_tpu loaded."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-c", f"MODULES = {_CLUSTER_MODULES!r}\n" + _CLUSTER_PROGRAM],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "CLUSTER-ISOLATED-OK" in out.stdout


def test_cluster_modules_read_no_environment():
    """None of the cluster tier's modules reads an environment variable."""
    for name in _CLUSTER_MODULES:
        path = os.path.join(REPO, "eventql_tpu_torch", *name.split(".")) + ".py"
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        assert "environ" not in text and "getenv" not in text, path


_TOOLS_MODULES = [
    "client.mysql_wire", "client.cclient", "cli.zkserver", "cli.cstable_tool", "cli.evqlctl",
    "cli.mysql2evql", "cli.evqlslap", "cli.evqlbench", "server.embedded", "columnar.sstable",
    "mapreduce.js", "mapreduce.js.lexer", "mapreduce.js.parser", "mapreduce.js.interp",
    "mapreduce.js_runtime", "mapreduce.api", "mapreduce.service", "mapreduce.distributed",
    "native._build",
]

_TOOLS_PROGRAM = r"""
import contextlib, importlib, io, json, os, subprocess, sys, tempfile, urllib.request
for name in MODULES:
    importlib.import_module("eventql_tpu_torch." + name)
from eventql_tpu_torch.cli import cstable_tool, evqlbench, evqlctl, mysql2evql
from eventql_tpu_torch.client.cclient import CClient
from eventql_tpu_torch.columnar.sstable import SSTableReader, SSTableWriter
from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.exec import device_exec
from eventql_tpu_torch.native import _build
from eventql_tpu_torch.server.embedded import EmbeddedServer
from eventql_tpu_torch.server.listener import Listener

d = tempfile.mkdtemp()
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert evqlbench.main(["--device", "cpu", "--rows", "4096", "-n", "1"]) == 0
    assert evqlctl.main(["-C", os.path.join(d, "c.json"), "cluster-create"]) == 0
    assert evqlctl.main(["-C", os.path.join(d, "c.json"), "cluster-list"]) == 0
assert "result rows: " in out.getvalue() and device_exec.FUSED_GROUPBY_COUNT == 2
w = SSTableWriter(os.path.join(d, "t.sst"))
w.append(b"k", b"v")
w.finalize()
assert SSTableReader(os.path.join(d, "t.sst")).rows() == [(b"k", b"v")]

# the embedded server on the CPU: a dump imported by mysql2evql, a GROUP
# BY through the C client, a MapReduce JS job over HTTP, a segment dumped
# by cstable_tool
srv = EmbeddedServer({"server.device": "cpu", "server.datadir": os.path.join(d, "data")})
assert srv.start() == 0
srv.listener = Listener(srv.http, srv.native, port=0).start()
dump = os.path.join(d, "dump.sql")
with open(dump, "w") as f:
    f.write("CREATE TABLE `ev` (\n  `id` bigint(20),\n  `k` varchar(8),\n  `v` bigint(20),\n"
            "  PRIMARY KEY (`id`)\n);\nINSERT INTO `ev` VALUES "
            + ",".join("(%d,'k%d',%d)" % (i, i % 3, i) for i in range(60)) + ";\n")
with contextlib.redirect_stdout(io.StringIO()):
    assert mysql2evql.main(["--source_file", dump, "--source_table", "ev",
                            "--port", str(srv.port)]) == 0
c = CClient("127.0.0.1", srv.port)
want = [["k%d" % g, str(sum(range(g, 60, 3)))] for g in range(3)]
assert c.query("select k, sum(v) from ev group by k order by k;")[0][1] == want
c.close()
assert device_exec.FUSED_GROUPBY_COUNT == 3
program = (
    'var m = EVQL.mapTable({table: "ev", map_fn: function(row) {'
    ' return [[row.k, parseInt(row.v, 10)]]; }});'
    ' var r = EVQL.reduce({sources: [m], shards: 1, reduce_fn: function(key, values) {'
    ' var s = 0; while (values.hasNext()) { s += parseInt(values.next(), 10); }'
    ' return [[key, s]]; }});'
    ' EVQL.downloadResults([r]);')
req = urllib.request.Request("http://127.0.0.1:%d/api/v1/mapreduce/execute" % srv.port,
                             data=program.encode())
body = urllib.request.urlopen(req, timeout=60).read().decode()
assert body.count("event: result") == 3 and "job_finished" in body, body
srv.table_service.commit_all()
seg_dir = os.path.join(d, "data", "ev")
seg = os.path.join(seg_dir, sorted(f for f in os.listdir(seg_dir) if f.endswith(".cst"))[0])
assert cstable_tool.main(["dump", seg], out=io.StringIO()) == 0
srv.shutdown()
host = subprocess.run([_build.path(_build.SMOKE_BIN), "server.device=cpu"],
                      capture_output=True, text=True, timeout=120, env=_build.host_env())
assert host.returncode == 0 and "embedded server smoke OK" in host.stdout, host.stderr

for make in (lambda: EmbeddedServer({}).start(),
             lambda: evqlbench.main(["--rows", "16", "-n", "1"])):
    try:
        make()
    except RuntimeError_ as e:
        assert "CUDA" in str(e)
    else:
        raise AssertionError("a tool on device='cuda' ran without a GPU")
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "jaxlib" or m == "eventql_tpu" or m.startswith("eventql_tpu.")]
assert not bad, bad
print("TOOLS-ISOLATED-OK")
"""


def test_tools_and_mapreduce_modules_run_without_jax():
    """The other CLIs, the clients, the embedded server and its C host,
    MapReduce with its JS runtime and the sstable files import and run (a
    benchmark and a registry, a dump imported into an embedded server on
    the CPU, a GROUP BY through the C client on the route, a JavaScript
    job over HTTP, a segment dumped) with neither jax nor eventql_tpu
    loaded; the embedded server and evqlbench left on their default device
    raise without a card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-c", f"MODULES = {_TOOLS_MODULES!r}\n" + _TOOLS_PROGRAM],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "TOOLS-ISOLATED-OK" in out.stdout


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_port_runs_without_jax_and_refuses_a_missing_gpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-c", f"multihost_port = {_free_port()}\n" + _PROGRAM],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ISOLATED-OK" in out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import jax\b|from jax\b|import eventql_tpu\b(?!_torch)"
    r"|from eventql_tpu(\.| ))",
    re.M,
)


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "profile_order.py")
    for root, _dirs, files in os.walk(os.path.join(REPO, "eventql_tpu_torch")):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh", ".c")):
                yield os.path.join(root, f)


def test_port_sources_name_no_jax_import():
    paths = list(_port_sources())
    assert len(paths) > 20
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            m = _FORBIDDEN.search(fh.read())
        assert m is None, f"{path}: {m.group(0)!r}"


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_build_needs_a_compiler(tmp_path, monkeypatch):
    """Without nvcc the build raises; nothing else is tried."""
    import pytest

    from eventql_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build_all()
    assert _build.sources() == ["extract", "groupby_agg", "hash_groupby", "join"]
