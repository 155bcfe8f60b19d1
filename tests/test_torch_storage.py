"""The port's storage tier against the JAX package's.

The storage modules (columnar/ readers, writers and shredder, db/ table
services, tablet index and record ids, the partitioned provider, the
query cache, the streaming cursor, the nested scan) are copies of the JAX
package's files with their imports renamed. Here: each copy's source
against its original; the same relations through both writers (the files
byte for byte), both readers on one file, both shredders, both tablet
indexes, both table services through the same statements (insert, upsert
by primary key, commit, reopen, compact, garbage collection); the wire
helpers db/shredded_record_list.py imports from the port's
server/native_tcp.py against the JAX package's; and SQL over a stored
table under Runtime(device="cpu"), whose routes must serve it, against
the JAX host engine. The serving and cluster tiers' copies (plan coders, servers,
cluster fan-out, CLIs, charts, the config directory, the partition
metadata and the cluster's workers) and those of the tools, the clients,
the embedded server and MapReduce with its JS interpreter and sstable
files are held to their originals here too, each deliberate difference
listed by the region it lies in.
"""

import importlib
import json
import os
import random
from types import SimpleNamespace

import numpy as np
import pytest

from eventql_tpu.server import native_tcp
from eventql_tpu_torch.exec import device_exec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "columnar.native", "columnar.cstable", "columnar.cstable_writer",
    "columnar.cstable_v2", "db.tablet_index", "db.shredded_record_list",
    "db.table_service", "columnar.shredder", "parallel.partitioned", "db.lsm",
    "columnar.csv_ingest", "columnar.providers", "exec.query_cache",
    "exec.streaming", "columnar.nested_scan",
]


def _pkg(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    ns = SimpleNamespace(**{m.split(".")[1]: mod(m) for m in MODULES})
    ns.types = mod("core.types")
    ns.relation = mod("exec.relation")
    ns.runtime = mod("exec.runtime")
    ns.nodes = mod("plan.nodes")
    ns.root = root
    return ns


JAX = _pkg("eventql_tpu")
PORT = _pkg("eventql_tpu_torch")


def _runtime(pkg):
    """The JAX host engine, or the port on the routes' plain versions."""
    if pkg is JAX:
        return JAX.runtime.Runtime()
    return PORT.runtime.Runtime(device="cpu")


def _sql(pkg, provider, query):
    rt = _runtime(pkg)
    res = rt.build_query_plan(rt.new_transaction(provider), query).execute(0)
    return res.columns, res.rows


# -- the copies' sources --------------------------------------------------------

def _source(root, mod):
    with open(os.path.join(REPO, root, *mod.split(".")) + ".py") as f:
        return f.read()


@pytest.mark.parametrize("mod", MODULES)
def test_copy_differs_from_its_original_only_in_its_imports(mod):
    """Each module is the JAX package's file with `eventql_tpu` renamed."""
    port = _source("eventql_tpu_torch", mod).replace("eventql_tpu_torch", "eventql_tpu")
    assert port == _source("eventql_tpu", mod)


# The serving tier's copies: module -> the regions where the copy differs
# from its original on purpose, each from the text that opens it up to
# the text that follows it (None: the end of the file), both found in the
# copy and in the original with the port's name replaced. Outside them
# the copy is the original.
SERVING_COPIES = {
    "plan.qtree_coder": [],
    "db.metadata": [],
    "server.auth": [],
    "server.listener": [],
    "parallel.conn_pool": [],
    # encode_plan takes binary=True and reads no environment variable
    "plan.coder": [("import json\n", "from eventql_tpu.core.errors"),
                   ("def encode_plan(", "def decode_plan(")],
    # the device and the mesh are arguments
    "server.native_tcp": [
        ("    def __init__(\n        self, table_service, host=", "    def start(self):"),
        ("    def _mesh_provider_for(", "    def _handle_partialaggr("),
        ("                # TCP-over-", "                partial = self._mesh_partial("),
    ],
    # the device is an argument
    "server.http_api": [
        ("        client_auth=None,\n", "        # queries may run against"),
        ("        self.runtime = Runtime(", "        self.stats = ServerStats()"),
    ],
    # the cluster provider, its partition metadata tier (routed and
    # replicated inserts, per-partition jobs, failover, the per-host cap,
    # DESCRIBE PARTITIONS) and cluster_provider_from_config over the
    # config directory
    "parallel.cluster": [],
    # --device / --mesh_shards; no --standalone
    "cli.evqld": [
        ('"""Server binary', "from __future__"),
        ('    ap = argparse.ArgumentParser(prog="evqld"', '        "--config_dir",'),
        ("        client_auth=client_auth,\n", "    # the primary port sniffs"),
        ("        query_cache=query_cache,\n", "    from eventql_tpu.server.listener import Listener"),
        ('        f" native://{nhost}:{native.port}"', "    stop = []"),
    ],
    # the cluster tier: DRAW charts, the config directory and ZooKeeper,
    # the versioned partition metadata and its transport, the replication,
    # leader, metadata replication, monitor and autosplit workers, rebalance
    # and the server allocator
    **{mod: [] for mod in (
        "exec.chart_style", "exec.chart", "config.__init__", "config.config_directory",
        "config.config_directory_zookeeper", "config.zookeeper", "config.process_config",
        "db.metadata_file", "db.metadata_service", "db.metadata_transport",
        "db.server_allocator", "db.replication", "db.rebalance", "db.leader",
        "db.metadata_replication", "db.monitor", "db.autosplit")},
    # the other CLIs, the clients, MapReduce with its JS interpreter and its
    # sstable files
    **{mod: [] for mod in (
        "client.__init__", "client.mysql_wire", "cli.zkserver", "cli.cstable_tool",
        "cli.evqlctl", "cli.mysql2evql", "cli.evqlslap", "columnar.sstable",
        "mapreduce.__init__", "mapreduce.js.__init__", "mapreduce.js.lexer",
        "mapreduce.js.parser", "mapreduce.js.interp", "mapreduce.js_runtime",
        "mapreduce.api", "mapreduce.service")},
    # a map shard whose partition split while the job ran maps the
    # partitions that now cover its keyrange (ROADMAP C16), where the JAX
    # scheduler drops it
    "mapreduce.distributed": [("            # tolerate failed shards (reference: map_table",
                               "    def _reduce(")],
    # --device for the query's runtime
    "cli.evqlbench": [
        ('    ap.add_argument("--rows"', "    args = ap.parse_args(argv)"),
        ("    rt = Runtime(", "    txn = rt.new_transaction(tables)"),
    ],
    # the C client library is built into the port's own build directory,
    # never under native/
    "client.cclient": [("import ctypes\n", "    lib.evql_client_init.restype")],
    # the device is an argument (server.device)
    "server.embedded": [("        self.table_service = table_service\n",
                         "        self._started = True")],
    # --device for the embedded engine
    "cli.console": [
        ("class LocalBackend:", "class HTTPBackend:"),
        ('    ap.add_argument("--output_file"', "    args = ap.parse_args(argv)"),
        ("        else LocalBackend(", "    out_fh = open("),
    ],
}


def _region(text, start, end):
    a = text.index(start)
    return a, len(text) if end is None else text.index(end, a + len(start))


@pytest.mark.parametrize("mod", list(SERVING_COPIES))
def test_serving_copy_differs_only_in_its_imports_and_listed_regions(mod):
    port = _source("eventql_tpu_torch", mod).replace("eventql_tpu_torch", "eventql_tpu")
    orig = _source("eventql_tpu", mod)
    for start, end in SERVING_COPIES[mod]:
        pa, pb = _region(port, start, end)
        oa, ob = _region(orig, start, end)
        assert port[pa:pb] != orig[oa:ob], f"{mod}: {start!r} no longer differs"
        port = port[:pa] + orig[oa:ob] + port[pb:]
    assert port == orig


@pytest.mark.parametrize("value", [0, 1, 127, 128, 300, 1 << 31, (1 << 63) + 5, (1 << 64) - 1])
def test_wire_helpers_equal_the_servers(value):
    srl = PORT.shredded_record_list
    enc = srl.write_varint(value)
    assert enc == native_tcp.write_varint(value)
    buf = b"\x07" + enc + b"tail"
    assert srl.read_varint(buf, 1) == native_tcp.read_varint(buf, 1) == (value, 1 + len(enc))
    s = bytes(range(value % 251))
    enc = srl.write_lenencstr(s)
    assert enc == native_tcp.write_lenencstr(s)
    assert srl.read_lenencstr(enc + b"x", 0) == native_tcp.read_lenencstr(enc + b"x", 0)


# -- cstable files ---------------------------------------------------------------


def _relation(pkg, n, seed):
    """u64 (values of 2^63 and more, NULLs), i64, float64 (NULLs), bool and
    string (NULLs, an empty string) columns."""
    rng = np.random.default_rng(seed)
    S, C = pkg.types.SType, pkg.relation.Column
    u = rng.integers(0, 1 << 40, n).astype(np.uint64)
    u[rng.random(n) < 0.3] |= np.uint64(1 << 63)
    uv = rng.random(n) < 0.8
    fv = rng.random(n) < 0.9
    words = [b"alpha", b"", b"gamma", b"\xc3\xa9t\xc3\xa9", b"NULL"]
    strs = [words[i] if m else None for i, m in zip(rng.integers(0, 5, n), rng.random(n) < 0.85)]
    return pkg.relation.Relation(
        ["u", "i", "f", "b", "s"],
        [C(S.UINT64, np.where(uv, u, 0).astype(np.uint64), uv),
         C(S.INT64, rng.integers(-1000, 1000, n).astype(np.int64), np.ones(n, bool)),
         C(S.FLOAT64, np.where(fv, rng.standard_normal(n), 0.0), fv),
         C(S.BOOL, rng.random(n) < 0.5, np.ones(n, bool)),
         C.from_strings(strs)],
        n)


def _write(pkg, version, path, rel):
    if version == 1:
        pkg.cstable_writer.write_cstable(path, rel)
    else:
        pkg.cstable_v2.write_cstable_v2(path, rel, transaction_id=3)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("n", [0, 1, 300, 5000])
def test_writers_give_the_same_bytes(tmp_path, version, n):
    _write(JAX, version, str(tmp_path / "j.cst"), _relation(JAX, n, seed=n))
    _write(PORT, version, str(tmp_path / "p.cst"), _relation(PORT, n, seed=n))
    assert (tmp_path / "p.cst").read_bytes() == (tmp_path / "j.cst").read_bytes()


def _same_columns(a, b):
    assert a.names == b.names and a.num_rows == b.num_rows
    for x, y in zip(a.columns, b.columns):
        assert int(x.stype) == int(y.stype)
        assert x.data.dtype == y.data.dtype
        np.testing.assert_array_equal(x.data, y.data)
        np.testing.assert_array_equal(x.valid, y.valid)
        if x.dictionary is None:
            assert y.dictionary is None
        else:
            assert list(x.dictionary) == list(y.dictionary)


@pytest.mark.parametrize("version", [1, 2])
def test_readers_decode_one_file_alike(tmp_path, version):
    path = str(tmp_path / "t.cst")
    _write(JAX, version, path, _relation(JAX, 2000, seed=9))
    j, p = JAX.cstable.CSTableReader(path), PORT.cstable.CSTableReader(path)
    assert (p.num_rows, getattr(p, "transaction_id", None)) == (
        j.num_rows, getattr(j, "transaction_id", None))
    assert [(c.name, int(c.stype)) for c in p.columns] == [
        (c.name, int(c.stype)) for c in j.columns]
    _same_columns(p.to_relation(), j.to_relation())
    for c in j.columns:
        dj, dp = j.decode_column(c.name), p.decode_column(c.name)
        for field in ("rlvls", "dlvls"):
            np.testing.assert_array_equal(getattr(dp, field), getattr(dj, field))
        assert list(np.asarray(dp.values, dtype=object)) == list(
            np.asarray(dj.values, dtype=object))


def test_codec_helpers_agree():
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 1 << 62, 777).astype(np.uint64)
    vals[::7] |= np.uint64(1 << 63)
    enc = PORT.cstable_writer.leb128_encode(vals)
    assert enc == JAX.cstable_writer.leb128_encode(vals)
    np.testing.assert_array_equal(PORT.cstable.leb128_decode(enc, len(vals)), vals)
    for bits in (1, 7, 17, 31):
        small = rng.integers(0, 1 << bits, 517).astype(np.uint64)
        packed = PORT.cstable_writer.simdbp128_pack(small, bits)
        assert packed == JAX.cstable_writer.simdbp128_pack(small, bits)
        np.testing.assert_array_equal(
            PORT.cstable.simdbp128_unpack(packed, 517, bits),
            JAX.cstable.simdbp128_unpack(packed, 517, bits))


# -- nested records: shredder, v0.2 nested segments ------------------------------


def _defs(pkg):
    CD = pkg.nodes.ColumnDefinition
    return [
        CD("id", "uint64"),
        CD("tags", "string", repeated=True),
        CD("events", "RECORD", repeated=True, subcolumns=[
            CD("time", "uint64"), CD("vals", "uint64", repeated=True)]),
    ]


def _records(seed, n=60):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        r = {"id": i}
        if rng.random() < 0.8:
            r["tags"] = [f"t{rng.randrange(5)}" for _ in range(rng.randrange(4))]
        if rng.random() < 0.8:
            r["events"] = [
                {"time": rng.randrange(1 << 40),
                 **({"vals": [rng.randrange(100) for _ in range(rng.randrange(4))]}
                    if rng.random() < 0.7 else {})}
                for _ in range(rng.randrange(3))]
        out.append(r)
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_shredder_and_materializer_agree(seed):
    recs = _records(seed)
    sj = JAX.shredder.shred_records(_defs(JAX), recs)
    sp = PORT.shredder.shred_records(_defs(PORT), recs)
    assert sorted(sp) == sorted(sj)
    meta = lambda m: (m.path, int(m.stype), m.rlevel_max, m.dlevel_max, m.repeated)  # noqa: E731
    for path in sj:
        (*lj, mj), (*lp, mp) = sj[path], sp[path]
        assert meta(mp) == meta(mj)
        for a, b in zip(lp, lj):
            assert list(np.asarray(a, dtype=object).ravel()) == list(
                np.asarray(b, dtype=object).ravel())
    paths = ["id", "tags", "events.time", "events.vals"]
    rj = JAX.shredder.ShreddedTableReader(_defs(JAX), recs)
    rp = PORT.shredder.ShreddedTableReader(_defs(PORT), recs)
    assert PORT.shredder.materialize_records(rp, paths) == \
        JAX.shredder.materialize_records(rj, paths)
    assert [meta(m) for m in PORT.shredder.leaf_metas(_defs(PORT))] == [
        meta(m) for m in JAX.shredder.leaf_metas(_defs(JAX))]


# -- tablet index -----------------------------------------------------------------


def test_tablet_index_files_and_lookups_agree(tmp_path):
    import hashlib

    ids = {hashlib.sha1(b"%d" % i).digest(): 1000 + 7 * i for i in range(300)}
    pj, pp = str(tmp_path / "j.cst.idx"), str(tmp_path / "p.cst.idx")
    JAX.tablet_index.write_index(pj, ids)
    PORT.tablet_index.write_index(pp, ids)
    assert open(pp, "rb").read() == open(pj, "rb").read()
    probe = list(ids)[::3] + [hashlib.sha1(b"absent%d" % i).digest() for i in range(9)]
    head = np.arange(len(probe), dtype=np.uint64) * 50
    got = PORT.tablet_index.TabletIndex.load(pj).lookup_max(probe, head.copy())
    want = JAX.tablet_index.TabletIndex.load(pj).lookup_max(probe, head.copy())
    np.testing.assert_array_equal(got, want)
    assert PORT.tablet_index.index_path_for("/a/seg.cst") == \
        JAX.tablet_index.index_path_for("/a/seg.cst")


def test_tablet_index_cache_evicts_alike(tmp_path):
    import hashlib

    paths = []
    for i in range(4):
        p = str(tmp_path / f"s{i}.idx")
        JAX.tablet_index.write_index(
            p, {hashlib.sha1(b"%d-%d" % (i, j)).digest(): j + 1 for j in range(100)})
        paths.append(p)
    cj = JAX.tablet_index.TabletIndexCache(max_bytes=2 * 100 * 28)
    cp = PORT.tablet_index.TabletIndexCache(max_bytes=2 * 100 * 28)
    for p in paths + paths[:2] + [str(tmp_path / "none.idx")]:
        a, b = cp.lookup(p), cj.lookup(p)
        assert (a is None) == (b is None)
        assert (cp._order, cp._bytes) == (cj._order, cj._bytes)


# -- table services ---------------------------------------------------------------

CREATE = ("CREATE TABLE ev (id uint64, name string, score double, flag boolean,"
          " PRIMARY KEY (id));")


def _statements(seed):
    """Inserts of 40 keys, a quarter of them written again (upserts),
    NULL fields and u64 ids of 2^63 and more."""
    rng = random.Random(seed)
    out = []
    for i in range(60):
        k = rng.randrange(40)
        key = k if k % 5 else (1 << 63) + k
        row = {"id": key}
        if rng.random() < 0.8:
            row["name"] = f"n{rng.randrange(7)}-{i}"
        if rng.random() < 0.8:
            row["score"] = rng.randrange(-64, 64) / 8
        if rng.random() < 0.5:
            row["flag"] = rng.random() < 0.5
        out.append(json.dumps(row))
    return out


QUERIES = [
    "select id, name, score, flag from ev order by id;",
    "select count(1), count(name), sum(score) from ev;",
    "select name, count(1) from ev group by name order by name;",
]


def _service(pkg, kind, datadir):
    if kind == "memory":
        return pkg.table_service.TableService()
    return pkg.lsm.DurableTableService(datadir, arena_flush_rows=9)


def _answers(pkg, svc):
    return [_sql(pkg, svc, q) for q in QUERIES]


@pytest.mark.parametrize("kind", ["memory", "lsm"])
def test_table_services_answer_alike(tmp_path, kind):
    """Insert and upsert through insert_json, then (LSM) commit, reopen,
    compact and collect the garbage: after every step both packages give
    the same rows, and the same segment count."""
    out = {}
    for pkg in (JAX, PORT):
        d = str(tmp_path / pkg.root)
        svc = _service(pkg, kind, d)
        _sql(pkg, svc, CREATE)
        for stmt in _statements(5):
            svc.insert_json("ev", stmt)
        steps = [_answers(pkg, svc)]
        if kind == "lsm":
            svc.commit_all()
            segments = len(svc.tables["ev"]._segments)
            svc = pkg.lsm.DurableTableService(d)
            steps.append(_answers(pkg, svc))
            svc.tables["ev"].compact()
            steps.append((segments, len(svc.tables["ev"]._segments), _answers(pkg, svc)))
            removed = pkg.lsm.collect_garbage(d)
            steps.append((removed, _answers(pkg, pkg.lsm.DurableTableService(d))))
        out[pkg.root] = steps
    assert out["eventql_tpu_torch"] == out["eventql_tpu"]
    if kind == "lsm":
        segments, after, _rows = out["eventql_tpu"][2]
        assert segments > 1 and after == 1 and out["eventql_tpu"][3][0] > 0


def test_batch_inserts_and_record_ids_agree(tmp_path):
    """insert_batch with explicit versions: stale versions drop at write
    time alike, and the record ids of a batch are the same bytes."""
    out = {}
    for pkg in (JAX, PORT):
        svc = pkg.lsm.DurableTableService(str(tmp_path / pkg.root), arena_flush_rows=50)
        _sql(pkg, svc, "CREATE TABLE t (k uint64, v uint64, PRIMARY KEY (k));")
        t = svc.tables["t"]
        S, C = pkg.types.SType, pkg.relation.Column
        n = 80
        keys = (np.arange(n) % 30).astype(np.uint64) | np.uint64(1 << 63)
        rel = pkg.relation.Relation(
            ["k", "v"], [C(S.UINT64, keys, np.ones(n, bool)),
                         C(S.UINT64, np.arange(n, dtype=np.uint64), np.ones(n, bool))], n)
        ids = t._batch_record_ids(rel)
        kept = [t.insert_batch(rel, versions=np.arange(n) + 10)]
        kept.append(t.insert_batch(rel, versions=np.arange(n) + 10))  # a replay
        kept.append(t.insert_batch(rel, versions=np.arange(n) + 500))
        out[pkg.root] = (ids, kept, _sql(pkg, svc, "select k, v from t order by k;"))
    assert out["eventql_tpu_torch"] == out["eventql_tpu"]


# -- SQL over a stored table on the routes --------------------------------------

STORED_QUERIES = [
    ("select k, count(1), sum(v) from t where v < 800 group by k order by k;",
     "FUSED_GROUPBY_COUNT"),
    ("select k, sum(v), sum(w), count(1) from t group by k order by k;",
     "MULTI_SUM_GROUPBY_COUNT"),
    ("select k, min(v), max(w), mean(v) from t group by k;", "GENERAL_GROUPBY_COUNT"),
    ("select id, v from t order by v desc, id limit 7;", "SCAN_TOPK_COUNT"),
    ("select id, v from t where v < 20 order by v, id;", "SCAN_ORDER_COUNT"),
    ("select d.region, count(1), sum(t.v) from t join d on t.dk = d.k group by d.region;",
     "JOIN_GROUPBY_COUNT"),
]


def _stored(pkg, datadir, n=3000):
    """Two commits of a fact table (string key, u64 columns, u64 primary
    key) and a dimension table, read back by a new service."""
    rng = np.random.default_rng(12)
    S, C, R = pkg.types.SType, pkg.relation.Column, pkg.relation.Relation
    svc = pkg.lsm.DurableTableService(datadir, arena_flush_rows=n + 1)
    _sql(pkg, svc, "CREATE TABLE t (id uint64, k string, v uint64, w uint64, dk uint64,"
                   " PRIMARY KEY (id));")
    _sql(pkg, svc, "CREATE TABLE d (k uint64, region string);")
    keys = np.array([b"k%03d" % i for i in range(37)], dtype=object)
    ones = np.ones(n // 2, bool)
    for c in range(2):
        lo = c * n // 2
        svc.tables["t"].insert_batch(R(["id", "k", "v", "w", "dk"], [
            C(S.UINT64, np.arange(lo, lo + n // 2, dtype=np.uint64), ones),
            C(S.STRING, rng.integers(0, 37, n // 2).astype(np.int32), ones, keys),
            C(S.UINT64, rng.integers(0, 1000, n // 2).astype(np.uint64), ones),
            C(S.UINT64, rng.integers(0, 1 << 20, n // 2).astype(np.uint64), ones),
            C(S.UINT64, rng.integers(0, 60, n // 2).astype(np.uint64) * 7 + 3, ones)],
            n // 2))
        svc.tables["t"].commit()
    dims = 40
    regions = np.array([b"r%d" % i for i in range(5)], dtype=object)
    svc.tables["d"].insert_batch(R(["k", "region"], [
        C(S.UINT64, np.arange(dims, dtype=np.uint64) * 7 + 3, np.ones(dims, bool)),
        C(S.STRING, rng.integers(0, 5, dims).astype(np.int32), np.ones(dims, bool), regions)],
        dims))
    svc.commit_all()
    return pkg.lsm.DurableTableService(datadir)


@pytest.mark.parametrize("query,counter", STORED_QUERIES)
def test_sql_over_a_stored_table_takes_the_routes(tmp_path, query, counter):
    want = _sql(JAX, _stored(JAX, str(tmp_path / "j")), query)
    svc = _stored(PORT, str(tmp_path / "p"))
    before = getattr(device_exec, counter)
    assert _sql(PORT, svc, query) == want
    assert getattr(device_exec, counter) == before + 1


def test_stored_relation_keeps_the_routes_inputs(tmp_path):
    """The merge of two segments hands the routes C-contiguous columns in
    their STypes' dtypes and one string dictionary with int32 ids, and a
    route's spans equal those of the same table built from numpy."""
    svc = _stored(PORT, str(tmp_path))
    rel = svc.get_table_data("t")
    for c in rel.columns:
        assert c.data.dtype == PORT.relation.dtype_for(c.stype)
        assert c.data.flags.c_contiguous and c.valid.flags.c_contiguous
    k = rel.columns[rel.names.index("k")]
    assert k.data.dtype == np.int32 and len(k.dictionary) == 37
    again = PORT.relation.relation_from_numpy(
        rel.names, [(int(c.stype), c.data, c.valid, c.dictionary) for c in rel.columns])
    for a, b in zip(rel.columns, again.columns):
        assert device_exec._stored_span(a) == device_exec._stored_span(b)
