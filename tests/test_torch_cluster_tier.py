"""The port's cluster tier against the JAX package's: metadata files,
autosplit, ZooKeeper, and the two packages side by side.

config/ (the config directory, its ZooKeeper backend, the jute-protocol
client and embedded server, the process config) and db/ (metadata files,
metadata service and transport, autosplit, rebalance, the server
allocator, leader, monitor, replication, metadata replication) are
copies of the JAX package's files with their imports renamed
(tests/test_torch_storage.py holds each to its original). Here the JAX
package's test_metadata_file.py, test_autosplit.py and test_zookeeper.py
scenarios run as cases parametrised over both packages, and differential
checks hold the two together: the same operations give the same
MetadataFile bytes and partition maps after splits and rebalances, and
the same answers and DESCRIBE PARTITIONS rows through
cluster_provider_from_config. The replicated cluster over native servers
is in test_torch_cluster_replication.py.
"""

import importlib
import json
import threading
import time
from types import SimpleNamespace

import pytest

_MODULES = (
    "config.config_directory", "config.config_directory_zookeeper", "config.zookeeper",
    "config.process_config", "core.errors", "db.metadata", "db.metadata_file",
    "db.metadata_service", "db.metadata_transport", "db.table_service", "db.autosplit",
    "db.rebalance", "db.server_allocator", "db.leader", "db.monitor", "db.replication",
    "db.metadata_replication", "db.lsm", "db.shredded_record_list", "exec.runtime",
    "parallel.cluster", "server.native_tcp",
)


def package(root):
    """The modules of one package by their last name; ``runtime()`` and
    ``native(...)`` build its Runtime and NativeTCPServer (the port's on
    the kernels' plain versions)."""
    ns = SimpleNamespace(root=root)
    for mod in _MODULES:
        setattr(ns, mod.split(".")[1], importlib.import_module(f"{root}.{mod}"))
    ns.device = {} if root == "eventql_tpu" else {"device": "cpu"}
    ns.runtime_ = lambda: ns.runtime.Runtime(**ns.device)
    ns.native = lambda svc, **kw: ns.native_tcp.NativeTCPServer(svc, **{**ns.device, **kw})
    return ns


JAX = package("eventql_tpu")
PORT = package("eventql_tpu_torch")


@pytest.fixture(params=[JAX, PORT], ids=["jax", "port"])
def pkg(request):
    return request.param


def sql(pkg, provider, query):
    rt = pkg.runtime_()
    return rt.build_query_plan(rt.new_transaction(provider), query).execute(0)


# -- test_metadata_file.py: operations, discovery, store and coordinator --------


def mkfile(pkg, entries, keyspace="uint64", flags=0, txnid="t0", seq=1):
    return pkg.metadata_file.MetadataFile(txnid=txnid, seq=seq, keyspace=keyspace,
                                          partition_key="time", entries=entries, flags=flags)


def entry(pkg, begin, pid, servers, **kw):
    mf = pkg.metadata_file
    return mf.PartitionEntry(begin, pid, servers=[mf.Placement(s) for s in servers], **kw)


def three_partitions(pkg):
    # ["", p1) [10, p2) [20, p3)
    return mkfile(pkg, [entry(pkg, "", "p1", ["s1", "s2"]), entry(pkg, 10, "p2", ["s2", "s3"]),
                        entry(pkg, 20, "p3", ["s3", "s4"])])


def op(pkg, kind, args, input_txnid="t0"):
    mf = pkg.metadata_file
    return mf.MetadataOperation("db1", "tbl", getattr(mf, kind), args, input_txnid)


def split_op(pkg, pid, point, input_txnid="t0", **kw):
    return op(pkg, "METAOP_SPLIT_PARTITION", {
        "partition_id": pid, "split_point": point, "split_partition_id_low": f"{pid}_lo",
        "split_partition_id_high": f"{pid}_hi", "split_servers_low": ["s5"],
        "split_servers_high": ["s6"], "placement_id": 7, **kw}, input_txnid)


@pytest.mark.parametrize("pid,point", [("p1", 5), ("p2", 15), ("p3", 25)])
def test_split_marks_entry_splitting(pkg, pid, point):
    out = split_op(pkg, pid, point).apply(three_partitions(pkg))
    assert out.seq == 2
    e = next(e for e in out.entries if e.partition_id == pid)
    assert e.splitting and e.split_point == point
    assert e.split_partition_id_low == f"{pid}_lo"
    assert [p.server_id for p in e.split_servers_low] == ["s5"]
    assert e.split_servers_low[0].placement_id == 7
    assert len(out.entries) == 3 and sum(e.splitting for e in out.entries) == 1


@pytest.mark.parametrize("pid,point,kw,match", [
    ("p2", 9, {}, "out of range"),  # below begin
    ("p2", 20, {}, "out of range"),  # at or above end
    ("nope", 15, {}, "not found"),
    ("p2", 15, {"split_servers_low": []}, "can't be empty"),
])
def test_split_rejected(pkg, pid, point, kw, match):
    with pytest.raises(pkg.errors.RuntimeError_, match=match):
        split_op(pkg, pid, point, **kw).apply(three_partitions(pkg))


def test_split_point_equal_begin_allowed(pkg):
    # reference checks split_point < begin only (strict less)
    assert split_op(pkg, "p2", 10).apply(three_partitions(pkg)).entries[1].splitting


def test_double_split_rejected(pkg):
    once = split_op(pkg, "p2", 15).apply(three_partitions(pkg))
    with pytest.raises(pkg.errors.RuntimeError_, match="already splitting"):
        split_op(pkg, "p2", 16, input_txnid=once.txnid).apply(once)


def test_finalize_immediately(pkg):
    out = split_op(pkg, "p2", 15, finalize_immediately=True).apply(three_partitions(pkg))
    assert [e.partition_id for e in out.entries] == ["p1", "p2_lo", "p2_hi", "p3"]
    lo, hi = out.entries[1], out.entries[2]
    assert (lo.begin, hi.begin) == (10, 15)
    assert [p.server_id for p in lo.servers] == ["s5"]
    assert [p.server_id for p in hi.servers] == ["s6"]
    assert not lo.splitting and not hi.splitting


@pytest.mark.parametrize("which", ["lo", "hi"])
@pytest.mark.parametrize("parent", ["p1", "p2", "p3"])
def test_subsplit_pending_child(pkg, which, parent):
    """Splitting a pending split child finalizes the parent split and
    leaves the requested child splitting."""
    base = split_op(pkg, parent, {"p1": 5, "p2": 15, "p3": 25}[parent]).apply(
        three_partitions(pkg))
    child = f"{parent}_{which}"
    point = {("p1", "lo"): 2, ("p1", "hi"): 7, ("p2", "lo"): 12, ("p2", "hi"): 17,
             ("p3", "lo"): 22, ("p3", "hi"): 27}[(parent, which)]
    out = split_op(pkg, child, point, input_txnid=base.txnid).apply(base)
    pids = [e.partition_id for e in out.entries]
    assert f"{parent}_lo" in pids and f"{parent}_hi" in pids and parent not in pids
    target = next(e for e in out.entries if e.partition_id == child)
    other = next(e for e in out.entries
                 if e.partition_id.startswith(parent) and e.partition_id != child)
    assert target.splitting and target.split_point == point and not other.splitting
    assert [p.server_id for p in target.servers] == (["s5"] if which == "lo" else ["s6"])


def test_subsplit_point_out_of_child_range(pkg):
    base = split_op(pkg, "p2", 15).apply(three_partitions(pkg))
    with pytest.raises(pkg.errors.RuntimeError_, match="out of range"):
        split_op(pkg, "p2_lo", 17, input_txnid=base.txnid).apply(base)


def test_user_defined_partitions_cannot_split(pkg):
    f = mkfile(pkg, [entry(pkg, 1, "p1", ["s1"])], flags=pkg.metadata_file.MFILE_USERDEFINED)
    with pytest.raises(pkg.errors.RuntimeError_, match="user defined"):
        split_op(pkg, "p1", 5).apply(f)


def test_finalize_split(pkg):
    base = split_op(pkg, "p2", 15).apply(three_partitions(pkg))
    out = op(pkg, "METAOP_FINALIZE_SPLIT", {"partition_id": "p2"}, base.txnid).apply(base)
    assert [e.partition_id for e in out.entries] == ["p1", "p2_lo", "p2_hi", "p3"]
    assert out.entries[1].begin == 10 and out.entries[2].begin == 15
    assert not any(e.splitting for e in out.entries)
    with pytest.raises(pkg.errors.RuntimeError_, match="not splitting"):
        op(pkg, "METAOP_FINALIZE_SPLIT", {"partition_id": "p2"}).apply(three_partitions(pkg))


def test_join_and_finalize_join(pkg):
    f = three_partitions(pkg)
    joined = op(pkg, "METAOP_JOIN_SERVERS", {"ops": [
        {"partition_id": "p1", "server_id": "s9", "placement_id": 3}]}, f.txnid).apply(f)
    assert [p.server_id for p in joined.entries[0].servers_joining] == ["s9"]
    with pytest.raises(pkg.errors.RuntimeError_, match="already exists"):
        op(pkg, "METAOP_JOIN_SERVERS", {"ops": [{"partition_id": "p1", "server_id": "s9"}]},
           joined.txnid).apply(joined)
    with pytest.raises(pkg.errors.RuntimeError_, match="not included"):
        op(pkg, "METAOP_FINALIZE_JOIN", {"partition_id": "p1", "server_id": "s9",
                                         "placement_id": 4}, joined.txnid).apply(joined)
    final = op(pkg, "METAOP_FINALIZE_JOIN", {"partition_id": "p1", "server_id": "s9",
                                             "placement_id": 3}, joined.txnid).apply(joined)
    assert [p.server_id for p in final.entries[0].servers] == ["s1", "s2", "s9"]
    assert final.entries[0].servers_joining == []


def test_remove_dead_servers_strips_every_list(pkg):
    Placement = pkg.metadata_file.Placement
    f = three_partitions(pkg)
    f.entries[0].servers_joining.append(Placement("sdead"))
    f.entries[1].servers.append(Placement("sdead"))
    base = split_op(pkg, "p3", 25).apply(f)
    base.entries[2].split_servers_low.append(Placement("sdead"))
    out = op(pkg, "METAOP_REMOVE_DEAD_SERVERS", {"server_ids": ["sdead"]},
             base.txnid).apply(base)
    for e in out.entries:
        assert "sdead" not in e.all_server_ids()
        assert "sdead" not in [p.server_id for p in e.split_servers_low + e.split_servers_high]


def test_create_partition(pkg):
    mf, err = pkg.metadata_file, pkg.errors.RuntimeError_
    with pytest.raises(err, match="not allowed"):  # an infinite keyspace
        op(pkg, "METAOP_CREATE_PARTITION", {"partition_id": "x", "begin": 5, "end": 8,
                                            "servers": ["s1"]}).apply(three_partitions(pkg))
    f = mkfile(pkg, [entry(pkg, 0, "a", ["s1"], end=10), entry(pkg, 20, "c", ["s1"], end=30)],
               flags=mf.MFILE_FINITE)
    out = op(pkg, "METAOP_CREATE_PARTITION", {"partition_id": "b", "begin": 10, "end": 20,
                                              "servers": ["s2"], "placement_id": 1},
             f.txnid).apply(f)
    assert [e.partition_id for e in out.entries] == ["a", "b", "c"]
    with pytest.raises(err, match="overlapping"):
        op(pkg, "METAOP_CREATE_PARTITION", {"partition_id": "d", "begin": 25, "end": 35,
                                            "servers": ["s2"]}, out.txnid).apply(out)
    u = mkfile(pkg, [entry(pkg, 5, "a", ["s1"])], flags=mf.MFILE_USERDEFINED)
    with pytest.raises(err, match="overlapping"):
        op(pkg, "METAOP_CREATE_PARTITION", {"partition_id": "dup", "begin": 5,
                                            "servers": ["s2"]}, u.txnid).apply(u)


def test_discovery(pkg):
    mf = pkg.metadata_file
    discover = mf.discover_partition
    f = three_partitions(pkg)
    f.entries[1].servers_joining.append(mf.Placement("sj"))
    f.entries[0].servers_leaving.append(mf.Placement("sl"))
    r = discover(f, "s2", "p2", keyrange_begin=10)
    assert r.code == "SERVE" and (r.keyrange_begin, r.keyrange_end) == (10, 20)
    assert {(t.server_id, t.is_joining) for t in r.replication_targets} == {
        ("s3", False), ("sj", True)}
    assert discover(f, "sj", "p2", keyrange_begin=10).code == "LOAD"
    assert discover(f, "sx", "p2", keyrange_begin=10).code == "UNLOAD"
    assert discover(f, "sl", "p1", keyrange_begin="").code == "SERVE"  # leaving still serves
    r = discover(f, "s3", "p3", lookup_by_id=True)
    assert r.code == "SERVE" and (r.keyrange_begin, r.keyrange_end) == (20, "")
    assert discover(f, "zz", "gone", lookup_by_id=True).code == "UNLOAD"


def test_discovery_while_splitting_and_after(pkg):
    discover = pkg.metadata_file.discover_partition
    base = split_op(pkg, "p2", 15).apply(three_partitions(pkg))
    r = discover(base, "s5", "p2_lo", keyrange_begin=10)
    assert r.code == "LOAD" and (r.keyrange_begin, r.keyrange_end) == (10, 15)
    assert r.replication_targets == []
    r = discover(base, "s2", "p2", keyrange_begin=10)
    assert r.code == "SERVE" and r.is_splitting and r.split_partition_ids == ["p2_lo", "p2_hi"]
    assert {(t.partition_id, t.server_id, t.keyrange_begin, t.keyrange_end)
            for t in r.replication_targets} == {("p2_lo", "s5", 10, 15), ("p2_hi", "s6", 15, 20)}
    final = op(pkg, "METAOP_FINALIZE_SPLIT", {"partition_id": "p2"}, base.txnid).apply(base)
    r = discover(final, "s2", "p2", keyrange_begin=10, keyrange_end=20)
    assert r.code == "UNLOAD"
    assert {(t.partition_id, t.server_id) for t in r.replication_targets} == {
        ("p2_lo", "s5"), ("p2_hi", "s6")}


def coordinated(pkg, tmp_path, n_servers=3):
    cdir = pkg.config_directory.ConfigDirectory(str(tmp_path / "registry.json"))
    cdir.cluster_create("c1", replication_factor=2)
    ms = pkg.metadata_service
    services = {f"s{i}": ms.MetadataService(ms.MetadataStore(str(tmp_path / f"s{i}")))
                for i in range(1, n_servers + 1)}
    coord = ms.MetadataCoordinator(cdir, local_server_id="s1", local_service=services["s1"],
                                   remote_service_factory=lambda sid: services[sid])
    f = pkg.metadata_file.MetadataFile.initial("uint64", "time", "tbl", ["s1", "s2"])
    coord.create_file("db1", "tbl", f, list(services))
    return cdir, services, coord, f


def test_create_file_replicates_and_sets_head(pkg, tmp_path):
    cdir, services, coord, f = coordinated(pkg, tmp_path)
    for svc in services.values():
        got = svc.get_file("db1", "tbl", f.txnid)
        assert pkg.metadata_service.file_checksum(got) == pkg.metadata_service.file_checksum(f)
    cfg = cdir.get_table_config("db1", "tbl")
    assert (cfg["metadata_txnid"], cfg["metadata_txnseq"]) == (f.txnid, 1)
    assert cfg["metadata"]["partitions"][0]["servers"] == ["s1", "s2"]


def test_perform_and_commit_and_cas(pkg, tmp_path):
    cdir, services, coord, f = coordinated(pkg, tmp_path)
    pid = f.entries[0].partition_id
    out = coord.perform_and_commit_operation("db1", "tbl",
                                             split_op(pkg, pid, 100, input_txnid=f.txnid))
    cfg = cdir.get_table_config("db1", "tbl")
    assert (cfg["metadata_txnid"], cfg["metadata_txnseq"]) == (out.txnid, 2)
    for svc in services.values():
        assert svc.get_file("db1", "tbl", out.txnid).seq == 2
    with pytest.raises(pkg.errors.RuntimeError_, match="concurrent modification"):
        coord.perform_and_commit_operation("db1", "tbl",
                                           split_op(pkg, pid, 200, input_txnid=f.txnid))
    with pytest.raises(pkg.errors.RuntimeError_, match="can't be empty"):
        coord.perform_and_commit_operation("db1", "tbl", split_op(
            pkg, pid, 50, input_txnid=out.txnid, split_servers_high=[]))


@pytest.mark.parametrize("down", [("s3",), ("s1", "s2", "s3")])
def test_minority_failure_tolerated_majority_aborts(pkg, tmp_path, down):
    cdir, services, coord, f = coordinated(pkg, tmp_path)

    def factory(sid):
        if sid in down:
            raise ConnectionError("down")
        return services[sid]

    coord.remote_service_factory = factory
    op_ = split_op(pkg, f.entries[0].partition_id, 100, input_txnid=f.txnid)
    if len(down) == 1:
        out = coord.perform_and_commit_operation("db1", "tbl", op_)
        assert cdir.get_table_config("db1", "tbl")["metadata_txnid"] == out.txnid
    else:
        with pytest.raises(pkg.errors.RuntimeError_):
            coord.perform_and_commit_operation("db1", "tbl", op_)
        assert cdir.get_table_config("db1", "tbl")["metadata_txnid"] == f.txnid


def test_metadata_client_lookup_and_discovery(pkg, tmp_path):
    cdir, services, coord, f = coordinated(pkg, tmp_path)
    pid = f.entries[0].partition_id
    client = pkg.metadata_service.MetadataClient(coord)
    assert client.find_partition("db1", "tbl", 5).partition_id == pid
    coord.perform_and_commit_operation("db1", "tbl", split_op(
        pkg, pid, 100, input_txnid=f.txnid, finalize_immediately=True))
    assert client.find_partition("db1", "tbl", 5).partition_id == f"{pid}_lo"
    assert client.find_partition("db1", "tbl", 100).partition_id == f"{pid}_hi"
    assert [e.partition_id for e in client.list_partitions("db1", "tbl", 0, 100)] == [
        f"{pid}_lo"]
    r = services["s2"].discover("db1", "tbl", 2, {
        "requester_id": "s5", "partition_id": f"{pid}_lo", "lookup_by_id": True})
    assert r.code == "SERVE" and r.txnseq == 2
    with pytest.raises(pkg.errors.RuntimeError_, match="not available"):
        services["s2"].discover("db1", "tbl", 99, {"requester_id": "s1", "partition_id": pid})


# -- test_autosplit.py -------------------------------------------------------------


def autosplit_setup(pkg, tmp_path, pk_type="uint64"):
    svc = pkg.table_service.TableService()
    sql(pkg, svc, f"CREATE TABLE ev (t {pk_type}, dim string, v uint64, PRIMARY KEY (t));")
    cdir = pkg.config_directory.ConfigDirectory(str(tmp_path / "registry.json"))
    cdir.cluster_create()
    meta = pkg.metadata.TableMetadata.initial(pk_type, "t", "ev", ["s1"])
    cdir.update_table_config("default", "ev", {"metadata": meta.to_json()})
    return svc, cdir


def insert(svc, rows):
    for t, dim, v in rows:
        svc.insert_json("ev", json.dumps({"t": t, "dim": dim, "v": v}))


def partition_map(pkg, cdir, table="ev"):
    return pkg.metadata.TableMetadata.from_json(
        cdir.get_table_config("default", table)["metadata"])


def test_autosplit_at_median_and_below_threshold(pkg, tmp_path):
    svc, cdir = autosplit_setup(pkg, tmp_path)
    insert(svc, [(i, "a", i) for i in range(10)])
    assert pkg.autosplit.run_once(svc, cdir, threshold_rows=10) == []
    insert(svc, [(i, "a", i) for i in range(10, 20)])
    changes = pkg.autosplit.run_once(svc, cdir, threshold_rows=10)
    assert len(changes) == 1 and "split at" in changes[0]
    meta = partition_map(pkg, cdir)
    assert len(meta.entries) == 2 and meta.entries[1].begin == 10
    assert meta.lookup(9).partition_id == meta.entries[0].partition_id
    assert meta.lookup(10).partition_id == meta.entries[1].partition_id
    assert meta.entries[1].servers == ["s1"]


def test_autosplit_passes_converge(pkg, tmp_path):
    svc, cdir = autosplit_setup(pkg, tmp_path)
    insert(svc, [(i, "a", i) for i in range(40)])
    for _ in range(3):
        pkg.autosplit.run_once(svc, cdir, threshold_rows=10)
    meta = partition_map(pkg, cdir)
    begins = [e.begin for e in meta.entries]
    assert begins == sorted(begins, key=lambda b: (b != "", b))
    for e in meta.entries:
        begin, end = meta.keyrange(e.partition_id)
        assert (40 if end == "" else end) - (0 if begin == "" else begin) <= 10
    assert pkg.autosplit.run_once(svc, cdir, threshold_rows=10) == []


def test_autosplit_single_key_and_string_keyspace(pkg, tmp_path):
    svc, cdir = autosplit_setup(pkg, tmp_path)
    insert(svc, [(7, "a", i) for i in range(25)])
    assert pkg.autosplit.run_once(svc, cdir, threshold_rows=10) == []
    svc, cdir = autosplit_setup(pkg, tmp_path / "s", pk_type="string")
    insert(svc, [(chr(ord("a") + i % 26) + str(i), "x", i) for i in range(30)])
    assert len(pkg.autosplit.run_once(svc, cdir, threshold_rows=10)) == 1
    meta = partition_map(pkg, cdir)
    assert len(meta.entries) == 2 and isinstance(meta.entries[1].begin, str)


def test_autosplit_worker_respects_leadership(pkg, tmp_path):
    class NotLeader:
        is_leader = False

    svc, cdir = autosplit_setup(pkg, tmp_path)
    insert(svc, [(i, "a", i) for i in range(20)])
    w = pkg.autosplit.AutoSplitWorker(svc, str(tmp_path / "registry.json"), leader=NotLeader(),
                                      threshold_rows=10)
    assert w.run_once() == [] and len(partition_map(pkg, cdir).entries) == 1


# -- test_zookeeper.py: the jute protocol and the ZooKeeper config directory ----


@pytest.fixture
def zk_server(pkg):
    srv = pkg.zookeeper.ZooKeeperServer().start()
    yield srv
    srv.stop()


@pytest.fixture
def zk(pkg, zk_server):
    client = pkg.zookeeper.ZooKeeperClient(zk_server.address)
    yield client
    client.close()


def until(fn, deadline_s=10.0):
    """Poll ``fn`` until it is true or the deadline passes; its last value."""
    end = time.monotonic() + deadline_s
    while not fn() and time.monotonic() < end:
        time.sleep(0.02)
    return fn()


def test_zk_session_and_nodes(pkg, zk):
    z = pkg.zookeeper
    assert zk.session_id != 0 and zk.negotiated_timeout >= 4000
    assert zk.create("/a", b"hello") == "/a"
    data, stat = zk.get("/a")
    assert (data, stat.version) == (b"hello", 0)
    assert zk.set("/a", b"world").version == 1
    zk.delete("/a")
    assert zk.exists("/a") is None
    zk.create("/x", b"")
    for call, code in ((lambda: zk.create("/x", b""), z.ZNODEEXISTS),
                       (lambda: zk.create("/no/such/parent", b""), z.ZNONODE),
                       (lambda: zk.get("/missing"), z.ZNONODE)):
        with pytest.raises(z.ZKError) as e:
            call()
        assert e.value.code == code


def test_zk_version_cas_children_sequences(pkg, zk):
    z = pkg.zookeeper
    zk.create("/v", b"1")
    _, stat = zk.get("/v")
    zk.set("/v", b"2", stat.version)
    with pytest.raises(z.ZKError) as e:
        zk.set("/v", b"3", stat.version)
    assert e.value.code == z.ZBADVERSION and zk.get("/v")[0] == b"2"
    zk.ensure_path("/parent")
    zk.create("/parent/c1", b"")
    zk.create("/parent/c2", b"")
    assert zk.get_children("/parent") == ["c1", "c2"]
    with pytest.raises(z.ZKError) as e:
        zk.delete("/parent")
    assert e.value.code == z.ZNOTEMPTY
    zk.ensure_path("/seq")
    assert [zk.create("/seq/n-", b"", flags=z.SEQUENCE) for _ in range(2)] == [
        "/seq/n-0000000000", "/seq/n-0000000001"]


def test_zk_ephemeral_dies_with_session(pkg, zk_server):
    z = pkg.zookeeper
    c1, c2 = z.ZooKeeperClient(zk_server.address), z.ZooKeeperClient(zk_server.address)
    try:
        c1.create("/eph", b"mine", flags=z.EPHEMERAL)
        assert c2.exists("/eph") is not None
        with pytest.raises(z.ZKError) as e:
            c2.create("/eph", b"", flags=z.EPHEMERAL)
        assert e.value.code == z.ZNODEEXISTS
        c1.close()
        assert until(lambda: c2.exists("/eph") is None)
        c2.create("/eph", b"", flags=z.EPHEMERAL)
    finally:
        c2.close()


def test_zk_watches(pkg, zk_server):
    z = pkg.zookeeper
    events, fired = [], threading.Event()

    def watcher(etype, state, path):
        events.append((etype, path))
        fired.set()

    watching = z.ZooKeeperClient(zk_server.address, watcher=watcher)
    writer = z.ZooKeeperClient(zk_server.address)
    try:
        writer.create("/w", b"0")
        watching.get("/w", watch=True)
        writer.set("/w", b"1")
        assert fired.wait(5) and events == [(z.EVENT_CHANGED, "/w")]
        fired.clear()
        writer.set("/w", b"2")  # one-shot: not re-armed
        assert not fired.wait(0.3)
        for arm, act, event in (
                (lambda: watching.get_children("/", watch=True),
                 lambda: writer.create("/w2", b""), (z.EVENT_CHILD, "/")),
                (lambda: watching.exists("/future", watch=True),
                 lambda: writer.create("/future", b""), (z.EVENT_CREATED, "/future")),
                (lambda: watching.get("/w", watch=True),
                 lambda: writer.delete("/w"), (z.EVENT_DELETED, "/w"))):
            events.clear()
            fired.clear()
            arm()
            act()
            assert fired.wait(5) and event in events
    finally:
        watching.close()
        writer.close()


def test_zk_concurrent_clients(pkg, zk_server):
    """Parallel increments through version CAS all land."""
    z = pkg.zookeeper
    c0 = z.ZooKeeperClient(zk_server.address)
    c0.create("/ctr", b"0")

    def worker():
        c = z.ZooKeeperClient(zk_server.address)
        for _ in range(20):
            while True:
                data, stat = c.get("/ctr")
                try:
                    c.set("/ctr", str(int(data) + 1).encode(), stat.version)
                    break
                except z.ZKError as e:
                    if e.code != z.ZBADVERSION:
                        raise
        c.close()

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert int(c0.get("/ctr")[0]) == 80
    c0.close()


@pytest.fixture
def zk_cdir(pkg, zk_server):
    cdir = pkg.config_directory.ConfigDirectory(f"zk://{zk_server.address}/testcluster")
    yield cdir
    pkg.config_directory_zookeeper.reset_sessions()


def test_zk_config_directory(pkg, zk_cdir):
    cd, err = pkg.config_directory, pkg.errors.RuntimeError_
    assert isinstance(zk_cdir, pkg.config_directory_zookeeper.ZookeeperConfigDirectory)
    assert zk_cdir.cluster == "testcluster" and zk_cdir.get_cluster_config() is None
    zk_cdir.cluster_create("testcluster", replication_factor=3)
    assert zk_cdir.get_cluster_config()["replication_factor"] == 3
    with pytest.raises(err, match="already exists"):
        zk_cdir.cluster_create("testcluster")
    zk_cdir.update_server_config(cd.ServerConfig("s1", "127.0.0.1:9175", cd.SERVER_UP))
    zk_cdir.update_server_config(cd.ServerConfig("s2", "127.0.0.1:9176", cd.SERVER_DOWN))
    status = {s.server_id: s.server_status for s in zk_cdir.list_servers()}
    assert status == {"s1": cd.SERVER_UP, "s2": cd.SERVER_DOWN}
    assert zk_cdir.worker_addrs() == [("127.0.0.1", 9175)]
    zk_cdir.update_server_config(cd.ServerConfig("s1", "127.0.0.1:9175", cd.SERVER_DOWN))
    assert {s.server_id: s.server_status for s in zk_cdir.list_servers()}["s1"] == cd.SERVER_DOWN
    zk_cdir.remove_server("s2")
    assert [s.server_id for s in zk_cdir.list_servers()] == ["s1"]
    zk_cdir.create_namespace("db1")
    with pytest.raises(err, match="already exists"):
        zk_cdir.create_namespace("db1")
    assert zk_cdir.list_namespaces() == ["db1"]
    zk_cdir.update_table_config("db1", "t1", {"schema": {"cols": []}})
    zk_cdir.update_table_config("db1", "t1", {"partition_size": 42, "metadata_txnid": "aaa"})
    cfg = zk_cdir.get_table_config("db1", "t1")
    assert cfg["schema"] == {"cols": []} and cfg["partition_size"] == 42
    assert zk_cdir.get_table_config("db1", "missing") is None
    assert zk_cdir.commit_metadata_txn("db1", "t1", "aaa", "bbb", 2)
    assert not zk_cdir.commit_metadata_txn("db1", "t1", "aaa", "ccc", 3)
    assert zk_cdir.commit_metadata_txn("db1", "t1", "bbb", "ccc", 3)
    cfg = zk_cdir.get_table_config("db1", "t1")
    assert (cfg["metadata_txnid"], cfg["metadata_txnseq"]) == ("ccc", 3)
    doc = zk_cdir._read()
    assert doc["cluster"]["name"] == "testcluster"
    assert doc["servers"]["s1"]["server_status"] == cd.SERVER_DOWN
    assert doc["namespaces"]["db1"]["tables"]["t1"]["partition_size"] == 42


def test_zk_leader_election(pkg, zk_server):
    z = pkg.zookeeper
    url = f"zk://{zk_server.address}/lead"
    pkg.config_directory.ConfigDirectory(url).cluster_create("lead")
    leader = pkg.leader.Leader(url, "server-a", rebalance_interval=999)
    other = z.ZooKeeperClient(zk_server.address)
    try:
        assert leader.try_acquire() and leader.is_leader
        with pytest.raises(z.ZKError):
            other.create("/eventql/lead/leader", b"server-b", flags=z.EPHEMERAL)
        assert leader.try_acquire()  # idempotent
        leader.release()
        assert not leader.is_leader
        other.create("/eventql/lead/leader", b"server-b", flags=z.EPHEMERAL)
        assert pkg.config_directory.ConfigDirectory(url).current_leader() == "server-b"
    finally:
        other.close()
        pkg.config_directory_zookeeper.reset_sessions()


def test_distributed_query_over_zookeeper_registry(pkg, zk_server):
    """Workers register in ZooKeeper; a coordinator found through it fans
    a GROUP BY out over the native protocol."""
    cd = pkg.config_directory
    url = f"zk://{zk_server.address}/qcluster"
    cdir = cd.ConfigDirectory(url)
    cdir.cluster_create("qcluster", replication_factor=1)
    rowsets = [['{"t": 1, "dim": "a", "v": 10}', '{"t": 2, "dim": "b", "v": 20}'],
               ['{"t": 3, "dim": "a", "v": 30}', '{"t": 4, "dim": "c", "v": 5}']]
    servers = []
    try:
        for i, rows in enumerate(rowsets):
            server = pkg.native(pkg.table_service.TableService(), port=0).start()
            servers.append(server)
            c = pkg.native_tcp.NativeTCPClient("127.0.0.1", server.port)
            c.query("CREATE TABLE ev (t uint64, dim string, v uint64, PRIMARY KEY (t));")
            c.insert_json("ev", rows)
            c.close()
            cdir.update_server_config(cd.ServerConfig(f"node{i}", f"127.0.0.1:{server.port}",
                                                      cd.SERVER_UP))
        provider = pkg.cluster.cluster_provider_from_config(url)
        rows = sql(pkg, provider, "select dim, sum(v) from ev group by dim order by dim;").rows
        assert rows == [["a", "40"], ["b", "20"], ["c", "5"]]
        provider.close()
    finally:
        stop_all(servers)
        pkg.config_directory_zookeeper.reset_sessions()


def stop_all(servers):
    """Stop servers at once (each waits out its accept loop's poll)."""
    threads = [threading.Thread(target=s.stop) for s in servers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)


# -- the two packages side by side -------------------------------------------------


def deterministic_txnids(monkeypatch):
    """random_txnid in both packages from one counter a package."""
    for pkg in (JAX, PORT):
        counter = iter(range(1, 1 << 30))
        monkeypatch.setattr(pkg.metadata_file, "random_txnid",
                            lambda c=counter: "%040x" % next(c))


def metadata_chain(pkg, tmp_path):
    """A chain of METADATA operations on three metadata servers: create,
    split, subsplit, finalize, join, finalize join, remove a dead server.
    Returns the stored files' bytes by path, and the derived partition
    map of the head."""
    cdir, services, coord, f = coordinated(pkg, tmp_path)
    pid = f.entries[0].partition_id
    out = coord.perform_and_commit_operation("db1", "tbl", split_op(
        pkg, pid, 1000, input_txnid=f.txnid))
    out = coord.perform_and_commit_operation("db1", "tbl", split_op(
        pkg, f"{pid}_lo", 400, input_txnid=out.txnid))
    out = coord.perform_and_commit_operation("db1", "tbl", op(
        pkg, "METAOP_FINALIZE_SPLIT", {"partition_id": f"{pid}_lo"}, out.txnid))
    out = coord.perform_and_commit_operation("db1", "tbl", op(
        pkg, "METAOP_JOIN_SERVERS", {"ops": [{"partition_id": f"{pid}_hi", "server_id": "s9",
                                              "placement_id": 2}]}, out.txnid))
    out = coord.perform_and_commit_operation("db1", "tbl", op(
        pkg, "METAOP_FINALIZE_JOIN", {"partition_id": f"{pid}_hi", "server_id": "s9",
                                      "placement_id": 2}, out.txnid))
    coord.perform_and_commit_operation("db1", "tbl", op(
        pkg, "METAOP_REMOVE_DEAD_SERVERS", {"server_ids": ["s6"]}, out.txnid))
    stored = {str(p.relative_to(tmp_path)): p.read_bytes()
              for p in sorted(tmp_path.rglob("*.json")) if p.name != "registry.json"}
    return stored, cdir.get_table_config("db1", "tbl")


def test_metadata_chain_bytes_and_head_alike(tmp_path, monkeypatch):
    deterministic_txnids(monkeypatch)
    jax_files, jax_head = metadata_chain(JAX, tmp_path / "jax")
    port_files, port_head = metadata_chain(PORT, tmp_path / "port")
    assert len(jax_files) == 3 * 7  # seven transactions on each of three servers
    assert port_files == jax_files
    assert port_head == jax_head


def splits_and_rebalance(pkg, tmp_path):
    """Autosplit passes over a local table, then a rebalance after a
    server leaves; the partition map after each step."""
    svc, cdir = autosplit_setup(pkg, tmp_path)
    cd = pkg.config_directory
    for i in range(4):
        cdir.update_server_config(cd.ServerConfig(f"s{i + 1}", f"127.0.0.1:{9000 + i}",
                                                  cd.SERVER_UP))
    meta = pkg.metadata.TableMetadata.initial("uint64", "t", "ev", ["s1", "s2"])
    cdir.update_table_config("default", "ev", {"metadata": meta.to_json()})
    insert(svc, [((i * 7919) % 1000, "a", i) for i in range(300)])
    maps = []
    for _ in range(3):
        changes = pkg.autosplit.run_once(svc, cdir, threshold_rows=60)
        maps.append((changes, cdir.get_table_config("default", "ev")["metadata"]))
    cdir.remove_server("s2")
    changes = pkg.rebalance.rebalance(cdir)
    maps.append((changes, cdir.get_table_config("default", "ev")["metadata"]))
    maps.append(pkg.server_allocator.allocate(cdir, 2, "default"))
    return maps


def test_partition_maps_after_splits_and_rebalance_alike(tmp_path):
    want = splits_and_rebalance(JAX, tmp_path / "jax")
    assert splits_and_rebalance(PORT, tmp_path / "port") == want
    assert len(want[2][1]["partitions"]) > 4
    assert any("removed placement" in c for c in want[3][0])


def cluster_answers(pkg, tmp_path):
    """Three native servers of a package, a table created and filled
    through cluster_provider_from_config, split, then queried."""
    cd = pkg.config_directory
    cfg = str(tmp_path / "cluster.json")
    cdir = cd.ConfigDirectory(cfg)
    cdir.cluster_create("test", replication_factor=2)
    servers = []
    try:
        for i in range(3):
            ms = pkg.metadata_service
            server = pkg.native(pkg.table_service.TableService(), port=0,
                                metadata_service=ms.MetadataService(
                                    ms.MetadataStore(str(tmp_path / f"node{i + 1}"))))
            server.query_provider_factory = lambda: pkg.cluster.cluster_provider_from_config(cfg)
            servers.append(server.start())
            cdir.update_server_config(cd.ServerConfig(f"node{i + 1}", f"127.0.0.1:{server.port}",
                                                      cd.SERVER_UP))
        p = pkg.cluster.cluster_provider_from_config(cfg)
        sql(pkg, p, "CREATE TABLE ev (t uint64, dim string, v uint64, PRIMARY KEY (t));")
        for i in range(40):
            p.insert_json("ev", json.dumps({"t": (i * 37) % 101, "dim": "abc"[i % 3], "v": i}))
        meta = pkg.metadata.TableMetadata.from_json(
            cdir.get_table_config("default", "ev")["metadata"])
        meta.split(meta.entries[0].partition_id, 50)
        cdir.update_table_config("default", "ev", {"metadata": meta.to_json()})
        p.close()
        p = pkg.cluster.cluster_provider_from_config(cfg)
        out = [sql(pkg, p, q).rows for q in (
            "select dim, count(1), sum(v) from ev group by dim order by dim;",
            "select t, v from ev order by v desc limit 5;",
            "select count(1) from ev where t >= 50;")]
        out.append([r[:1] + r[2:] for r in sql(pkg, p, "describe partitions ev;").rows])
        out.append([r[1] for r in sql(pkg, p, "describe partitions ev;").rows])
        p.close()
        return out
    finally:
        stop_all(servers)


def test_cluster_answers_and_describe_partitions_alike(tmp_path):
    """The same statements through cluster_provider_from_config give the
    same rows; DESCRIBE PARTITIONS the same ids, keyranges and servers."""
    want = cluster_answers(JAX, tmp_path / "jax")
    got = cluster_answers(PORT, tmp_path / "port")
    assert got == want
    assert len(want[3]) == 2 and all(s.count("node") == 2 for s in want[4])


@pytest.mark.parametrize("text,standalone", [
    ("[cluster]\nname = c1\nrebalance_interval = 5\n", False),
    ("[server]\nname = n1\nlisten = 127.0.0.1:9000\n", True),
])
def test_process_config_layers_alike(tmp_path, text, standalone):
    """Defaults, an ini file, the standalone preset and overrides, in both
    packages; a bad integer raises the same message."""
    path = tmp_path / "evqld.conf"
    path.write_text(text)
    out = []
    for pkg in (JAX, PORT):
        cfg = pkg.process_config.ProcessConfig.load(
            str(path), overrides={"server.gc_mode": "AUTOMATIC", "x.n": "seven"},
            standalone=standalone)
        with pytest.raises(pkg.errors.RuntimeError_) as e:
            cfg.get_int("x.n")
        out.append((cfg.items(), cfg.get_int("cluster.rebalance_interval"),
                    cfg.get_bool("server.noleader"), str(e.value)))
    assert out[1] == out[0]
    assert ("server.gc_mode", "AUTOMATIC") in out[0][0]
