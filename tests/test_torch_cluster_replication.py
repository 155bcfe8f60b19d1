"""The port's replicated cluster against the JAX package's.

Three native servers a package, registered in a config directory with
replication factor 2: the JAX package's test_replication.py and
test_metadata_cluster.py scenarios as cases parametrised over both
packages (the port's servers and coordinators on the kernels' plain
versions): routed and replicated inserts, keyrange-scoped partition
queries, replica failover and the tolerate policy, repair, push repair
over REPL_INSERT, rebalance, the leader, the monitor, the METADATA chain
over META_* frames, metadata replication and the autosplit lifecycle
(LOAD, FINALIZE_SPLIT, UNLOAD). The messages of a refused write and of a
partition with no live replica are the JAX package's, word for word.
"""

import json

import numpy as np
import pytest

from tests.test_torch_cluster_tier import JAX, PORT, sql, stop_all


@pytest.fixture(params=[JAX, PORT], ids=["jax", "port"])
def pkg(request):
    return request.param


def _start_cluster(pkg, tmp_path, metadata):
    cd = pkg.config_directory
    cfg = str(tmp_path / "cluster.json")
    cdir = cd.ConfigDirectory(cfg)
    cdir.cluster_create("test", replication_factor=2)
    servers = []
    for i in range(3):
        kw = {}
        if metadata:
            ms = pkg.metadata_service
            kw["metadata_service"] = ms.MetadataService(
                ms.MetadataStore(str(tmp_path / f"node{i + 1}")))
        server = pkg.native(pkg.table_service.TableService(), port=0, **kw)
        server.query_provider_factory = lambda: pkg.cluster.cluster_provider_from_config(cfg)
        servers.append(server.start())
        cdir.update_server_config(cd.ServerConfig(f"node{i + 1}", f"127.0.0.1:{server.port}",
                                                  cd.SERVER_UP))
    return cfg, cdir, servers


@pytest.fixture
def cluster3(pkg, tmp_path):
    """3 workers registered in a config dir with replication factor 2."""
    cfg, cdir, servers = _start_cluster(pkg, tmp_path, metadata=False)
    try:
        yield cfg, cdir, servers
    finally:
        stop_all(servers)


@pytest.fixture
def meta_cluster(pkg, tmp_path):
    """The same, each worker hosting a MetadataService on its own dir."""
    cfg, cdir, servers = _start_cluster(pkg, tmp_path, metadata=True)
    try:
        yield cfg, cdir, servers
    finally:
        stop_all(servers)


def provider(pkg, cfg):
    return pkg.cluster.cluster_provider_from_config(cfg)


def create(pkg, p, table="ev", extra=""):
    sql(pkg, p, f"CREATE TABLE {table} (t uint64, v uint64{extra}, PRIMARY KEY (t));")


def table_map(pkg, cdir, table="ev"):
    return pkg.metadata.TableMetadata.from_json(
        cdir.get_table_config("default", table)["metadata"])


def set_map(cdir, meta, table="ev"):
    cdir.update_table_config("default", table, {"metadata": meta.to_json()})


def node(sid):
    return int(sid[len("node"):]) - 1


def test_metadata_lookup_and_split(pkg):
    meta = pkg.metadata.TableMetadata.initial("uint64", "t", "ev", ["a", "b"])
    assert meta.lookup(0).servers == ["a", "b"]
    pid = meta.entries[0].partition_id
    meta.split(pid, 100)
    assert meta.lookup(99).partition_id == pid and meta.lookup(100).partition_id != pid
    assert meta.keyrange(pid) == ("", 100)
    assert meta.keyrange(meta.entries[1].partition_id) == (100, "")
    assert [e.begin for e in pkg.metadata.TableMetadata.from_json(meta.to_json()).entries] == [
        "", 100]
    with pytest.raises(pkg.errors.RuntimeError_):
        meta.split(pid, 500)


def test_replicated_insert_and_partition_query(pkg, cluster3):
    cfg, cdir, servers = cluster3
    p = provider(pkg, cfg)
    create(pkg, p)
    meta = table_map(pkg, cdir)
    assert len(meta.entries) == 1 and len(meta.entries[0].servers) == 2
    for i in range(20):
        p.insert_json("ev", json.dumps({"t": i, "v": i}))
    owners = set(meta.entries[0].servers)
    for i, server in enumerate(servers):
        assert server.table_service.get_table_data("ev").num_rows == (
            20 if f"node{i + 1}" in owners else 0)
    assert sql(pkg, p, "select count(1), sum(v) from ev;").rows == [["20", "190"]]
    p.close()


def test_split_scopes_queries_and_routes_inserts(pkg, cluster3):
    cfg, cdir, servers = cluster3
    p = provider(pkg, cfg)
    create(pkg, p)
    for i in range(10):
        p.insert_json("ev", json.dumps({"t": i, "v": 1}))
    meta = table_map(pkg, cdir)
    meta.split(meta.entries[0].partition_id, 5)
    set_map(cdir, meta)
    p2 = provider(pkg, cfg)
    assert sql(pkg, p2, "select count(1) from ev;").rows == [["10"]]
    p2.insert_json("ev", json.dumps({"t": 27, "v": 1}))
    assert sql(pkg, p2, "select count(1) from ev;").rows == [["11"]]
    p2.insert_json("ev", json.dumps({"t": 7, "v": 9}))  # an upsert
    assert sql(pkg, p2, "select count(1), sum(v) from ev;").rows == [["11", "19"]]
    p.close()
    p2.close()


def test_replica_failover(pkg, cluster3):
    cfg, cdir, servers = cluster3
    p = provider(pkg, cfg)
    create(pkg, p)
    for i in range(12):
        p.insert_json("ev", json.dumps({"t": i, "v": 2}))
    servers[node(table_map(pkg, cdir).entries[0].servers[0])].stop()  # the primary
    p2 = provider(pkg, cfg)
    assert sql(pkg, p2, "select count(1), sum(v) from ev;").rows == [["12", "24"]]
    assert p2.num_failed_shards == 0
    p2.insert_json("ev", json.dumps({"t": 100, "v": 2}))  # 1 of 2 is a majority
    assert sql(pkg, p2, "select count(1) from ev;").rows == [["13"]]
    p.close()
    p2.close()


def refused_write_and_dead_partition(pkg, cfg, cdir, servers):
    """The messages of an insert no replica acknowledges and of a query
    whose partition has no live replica (strict policy)."""
    p = provider(pkg, cfg)
    create(pkg, p)
    p.insert_json("ev", json.dumps({"t": 1, "v": 1}))
    addrs = dict(p.server_map)
    for sid in table_map(pkg, cdir).entries[0].servers:
        servers[node(sid)].stop()
    p.close()
    p = pkg.cluster.ClusterTableProvider(p.workers, cdir=cdir, server_map=addrs)
    out = []
    with pytest.raises(pkg.errors.RuntimeError_) as e:
        p.insert_json("ev", json.dumps({"t": 2, "v": 1}))
    out.append(str(e.value))
    p.failed_shard_policy = "strict"
    with pytest.raises(pkg.errors.SQLError) as e:
        sql(pkg, p, "select count(1) from ev;")
    out.append(str(e.value).split(" (")[0])
    p.close()
    return out


def test_a_write_without_a_majority_is_refused_with_the_jax_message(tmp_path):
    out = {}
    for pkg in (JAX, PORT):
        cfg, cdir, servers = _start_cluster(pkg, tmp_path / pkg.root, metadata=False)
        try:
            out[pkg.root] = refused_write_and_dead_partition(pkg, cfg, cdir, servers)
        finally:
            stop_all(servers)
    assert out["eventql_tpu_torch"] == out["eventql_tpu"]
    assert out["eventql_tpu"][0] == (
        "couldn't perform enough replica writes for the requested consistency level;"
        " only 0 out of 1 (required) writes succeeded")
    assert out["eventql_tpu"][1].startswith("no live replica for partition ")


def test_insert_missing_pk_errors(pkg, cluster3):
    cfg, cdir, servers = cluster3
    p = provider(pkg, cfg)
    create(pkg, p)
    with pytest.raises(pkg.errors.SQLError, match="missing field: t"):
        p.insert_json("ev", json.dumps({"v": 5}))
    p.close()


def test_pushdown_topk(pkg, cluster3):
    cfg, cdir, servers = cluster3
    p = provider(pkg, cfg)
    create(pkg, p)
    for i in range(50):
        p.insert_json("ev", json.dumps({"t": i, "v": (i * 37) % 101}))
    meta = table_map(pkg, cdir)
    meta.split(meta.entries[0].partition_id, 25)
    set_map(cdir, meta)
    p2 = provider(pkg, cfg)
    vals = sorted(((i * 37) % 101, i) for i in range(50))[::-1]
    assert sql(pkg, p2, "select t, v from ev order by v desc limit 5;").rows == [
        [str(i), str(v)] for v, i in vals[:5]]
    assert sql(pkg, p2, "select v from ev order by v desc limit 3 offset 4;").rows == [
        [str(v)] for v, _i in vals[4:7]]
    p.close()
    p2.close()


def test_replication_repair_catches_up(pkg, cluster3):
    """A replica that missed writes while down converges through the
    anti-entropy pull."""
    cfg, cdir, servers = cluster3
    p = provider(pkg, cfg)
    create(pkg, p)
    victim_id = table_map(pkg, cdir).entries[0].servers[1]
    victim = servers[node(victim_id)]
    victim_svc, victim_port = victim.table_service, victim.port
    victim.stop()
    p.close()
    p = provider(pkg, cfg)
    for i in range(15):
        p.insert_json("ev", json.dumps({"t": i, "v": i * 2}))
    assert victim_svc.get_table_data("ev").num_rows == 0
    revived = pkg.native(victim_svc, port=victim_port).start()
    try:
        worker = pkg.replication.ReplicationWorker(victim_svc, cfg, victim_id, interval=999)
        assert worker.repair_once() == 15
        assert victim_svc.get_table_data("ev").num_rows == 15
        assert worker.repair_once() == 0
        assert sql(pkg, p, "select count(1), sum(v) from ev;").rows == [["15", "210"]]
    finally:
        revived.stop()
    p.close()


def test_rebalance_backfills_new_replica(pkg, cluster3):
    cfg, cdir, servers = cluster3
    p = provider(pkg, cfg)
    create(pkg, p)
    for i in range(10):
        p.insert_json("ev", json.dumps({"t": i, "v": 5}))
    old_owners = list(table_map(pkg, cdir).entries[0].servers)
    cdir.remove_server(old_owners[0])
    changes = pkg.rebalance.rebalance(cdir)
    assert any("removed placement" in c for c in changes)
    assert any("added replica" in c for c in changes)
    new_owners = table_map(pkg, cdir).entries[0].servers
    assert old_owners[0] not in new_owners and len(new_owners) == 2
    newcomer = [s for s in new_owners if s not in old_owners][0]
    worker = pkg.replication.ReplicationWorker(servers[node(newcomer)].table_service, cfg,
                                               newcomer, interval=999)
    assert worker.repair_once() == 10
    p2 = provider(pkg, cfg)
    assert sql(pkg, p2, "select count(1), sum(v) from ev;").rows == [["10", "50"]]
    p.close()
    p2.close()


def test_describe_partitions_and_show_servers(pkg, cluster3):
    cfg, cdir, servers = cluster3
    p = provider(pkg, cfg)
    create(pkg, p)
    meta = table_map(pkg, cdir)
    meta.split(meta.entries[0].partition_id, 100)
    set_map(cdir, meta)
    p2 = provider(pkg, cfg)
    rows = sql(pkg, p2, "describe partitions ev;").rows
    assert [r[0] for r in rows] == [e.partition_id for e in meta.entries]
    assert [r[1] for r in rows] == [",".join(e.servers) for e in meta.entries]
    assert [r[2:4] for r in rows] == [["", "100"], ["100", ""]]
    show = sql(pkg, p2, "cluster show servers;").rows
    assert sorted(r[:3] for r in show) == sorted(
        [f"127.0.0.1:{s.port}", "SERVER_UP", f"127.0.0.1:{s.port}"] for s in servers)
    p.close()
    p2.close()


def test_monitor_publishes_load(pkg, cluster3):
    cfg, cdir, servers = cluster3
    p = provider(pkg, cfg)
    create(pkg, p)
    p.insert_json("ev", json.dumps({"t": 1, "v": 1}))
    pkg.monitor.Monitor(servers[0].table_service, cfg, "node1",
                        f"127.0.0.1:{servers[0].port}").publish_once()
    assert cdir.get_server_config("node1").load_partitions >= 1
    p.close()


def tolerate_and_strict(pkg, cfg, cdir, servers):
    p = provider(pkg, cfg)
    create(pkg, p)
    for i in range(10):
        p.insert_json("ev", json.dumps({"t": i, "v": 1}))
    meta = table_map(pkg, cdir)
    meta.split(meta.entries[0].partition_id, 5)
    meta.entries[1].servers = ["node3"]
    set_map(cdir, meta)
    servers[2].stop()
    p2 = provider(pkg, cfg)
    out = [sql(pkg, p2, "select count(1) from ev;").rows, p2.num_failed_shards]
    p3 = provider(pkg, cfg)
    p3.failed_shard_policy = "strict"
    with pytest.raises(pkg.errors.SQLError) as e:
        sql(pkg, p3, "select count(1) from ev;")
    out.append(str(e.value).split(" (")[0])
    for x in (p, p2, p3):
        x.close()
    return out


def test_tolerate_failed_shards_partial_results(tmp_path):
    """With every replica of a partition down the tolerate policy answers
    from the live partitions and counts the failed shard, strict raises:
    the same in both packages."""
    out = {}
    for pkg in (JAX, PORT):
        cfg, cdir, servers = _start_cluster(pkg, tmp_path / pkg.root, metadata=False)
        try:
            out[pkg.root] = tolerate_and_strict(pkg, cfg, cdir, servers)
        finally:
            stop_all(servers)
    assert out["eventql_tpu_torch"] == out["eventql_tpu"]
    assert out["eventql_tpu"][:2] == [[["5"]], 1]
    assert out["eventql_tpu"][2].startswith("no live replica for partition ")


def test_leader_election_and_failover(pkg, cluster3):
    cfg, cdir, servers = cluster3
    l1, l2 = pkg.leader.Leader(cfg, "node1"), pkg.leader.Leader(cfg, "node2")
    try:
        assert l1.try_acquire() and not l2.try_acquire()
        assert l1.is_leader and not l2.is_leader
        p = provider(pkg, cfg)
        create(pkg, p)
        meta = table_map(pkg, cdir)
        meta.entries[0].servers = meta.entries[0].servers[:1]  # under-replicated
        set_map(cdir, meta)
        l1.run_leader_duties()
        assert len(table_map(pkg, cdir).entries[0].servers) == 2
        l1.release()
        assert l2.try_acquire()
        p.close()
    finally:
        l1.release()
        l2.release()


def test_gc_trash_sweep(pkg, tmp_path):
    import os

    lsm = pkg.lsm
    svc = lsm.DurableTableService(str(tmp_path), arena_flush_rows=2)
    create(pkg, svc)
    for i in range(8):
        svc.insert_json("ev", json.dumps({"t": i, "v": i}))
    table = svc.tables["ev"]
    nsegs = len(table._segments)
    assert nsegs >= 3
    table.compact()
    trash = os.path.join(str(tmp_path), "ev", ".trash")
    trashed = os.listdir(trash)
    assert len([f for f in trashed if f.endswith(".cst")]) == nsegs
    assert lsm.collect_garbage(str(tmp_path)) == len(trashed) and os.listdir(trash) == []
    assert sql(pkg, svc, "select count(1) from ev;").rows == [["8"]]


def push_repair_rows(pkg, cluster3, table, rows):
    """Rows written to the first replica's local store alone, then pushed
    to the second over REPL_INSERT; (pushed, a second push, the second
    replica's rows)."""
    cfg, cdir, servers = cluster3
    p = provider(pkg, cfg)
    create(pkg, p, table, extra=", s string")
    owners = table_map(pkg, cdir, table).entries[0].servers
    first, second = servers[node(owners[0])], servers[node(owners[1])]
    for row in rows:
        first.table_service.insert_json(table, json.dumps(row))
    assert second.table_service.get_table_data(table).num_rows == 0
    worker = pkg.replication.ReplicationWorker(first.table_service, cfg, owners[0])
    pushed, again = worker.push_once(), worker.push_once()
    rel = second.table_service.get_table_data(table)
    got = sorted(tuple(rel.columns[rel.names.index(c)].value_at(i).payload() for c in ("t", "v"))
                 for i in range(rel.num_rows))
    p.close()
    return pushed, again, got


def test_repl_insert_op_and_push_repair(pkg, cluster3):
    rows = [{"t": i, "v": i, "s": f"x{i}"} for i in range(12)]
    assert push_repair_rows(pkg, cluster3, "pev", rows) == (12, 0, [(i, i) for i in range(12)])


def test_push_repair_big_uint64_keys_lossless(pkg, cluster3):
    big = (1 << 53) + 1
    assert push_repair_rows(pkg, cluster3, "big", [{"t": big, "v": 7, "s": "y"}]) == (
        1, 0, [(big, 7)])


def test_shredded_record_list_roundtrip_alike():
    """The same record list encodes to the same bytes in both packages."""
    out = []
    for pkg in (JAX, PORT):
        srl = pkg.shredded_record_list
        lst = srl.ShreddedRecordList(
            record_ids=[bytes(range(20)), bytes(range(20, 40))], record_versions=[1, 300],
            columns=[srl.ShreddedColumn("k", [(1, 0, b"a"), (0, 0, b"")]),
                     srl.ShreddedColumn("v", [(1, 0, b"5"), (1, 0, b"2.5")])])
        buf = lst.encode()
        assert buf[0] == 0x01 and srl.ShreddedRecordList.decode(buf) == lst
        out.append(buf)
    assert out[1] == out[0]


# -- test_metadata_cluster.py: the METADATA chain over the native protocol ---------


def test_create_table_stores_chain_on_metadata_servers(pkg, meta_cluster):
    cfg, cdir, servers = meta_cluster
    p = provider(pkg, cfg)
    create(pkg, p)
    tcfg = cdir.get_table_config("default", "ev")
    assert tcfg["metadata_txnid"] and tcfg["metadata_txnseq"] == 1
    assert tcfg["metadata_servers"] == ["node1", "node2"]
    assert [e["servers"] for e in tcfg["metadata"]["partitions"]] == [["node1", "node2"]]
    for server in servers[:2]:
        proxy = pkg.metadata_transport.MetadataServiceProxy("127.0.0.1", server.port)
        f = proxy.get_file("default", "ev", tcfg["metadata_txnid"])
        assert f.seq == 1 and [pl.server_id for pl in f.entries[0].servers] == ["node1", "node2"]
        proxy.close()
    p.close()


def meta_split(pkg, pid, point, txnid, low, high, servers):
    mf = pkg.metadata_file
    return mf.MetadataOperation("default", "ev", mf.METAOP_SPLIT_PARTITION, {
        "partition_id": pid, "split_point": point, "split_partition_id_low": low,
        "split_partition_id_high": high, "split_servers_low": servers,
        "split_servers_high": servers, "finalize_immediately": True}, input_txnid=txnid)


def test_cas_split_over_the_wire(pkg, meta_cluster):
    cfg, cdir, servers = meta_cluster
    p = provider(pkg, cfg)
    create(pkg, p)
    tcfg = cdir.get_table_config("default", "ev")
    pid = tcfg["metadata"]["partitions"][0]["partition_id"]
    coord = pkg.metadata_transport.make_coordinator(cdir)
    op = meta_split(pkg, pid, 100, tcfg["metadata_txnid"], "l" * 20, "h" * 20,
                    ["node1", "node2"])
    assert coord.perform_and_commit_operation("default", "ev", op).seq == 2
    tcfg2 = cdir.get_table_config("default", "ev")
    assert tcfg2["metadata_txnid"] == op.output_txnid
    assert [e["begin"] for e in tcfg2["metadata"]["partitions"]] == ["", 100]
    stale = meta_split(pkg, "l" * 20, 50, tcfg["metadata_txnid"], "x" * 20, "y" * 20, ["node1"])
    with pytest.raises(pkg.errors.RuntimeError_, match="concurrent modification"):
        coord.perform_and_commit_operation("default", "ev", stale)
    p.close()


def test_discovery_and_partition_rpcs_over_the_wire(pkg, meta_cluster):
    cfg, cdir, servers = meta_cluster
    p = provider(pkg, cfg)
    create(pkg, p)
    tcfg = cdir.get_table_config("default", "ev")
    pid = tcfg["metadata"]["partitions"][0]["partition_id"]
    proxy = pkg.metadata_transport.MetadataServiceProxy("127.0.0.1", servers[0].port)
    resp = proxy.discover("default", "ev", tcfg["metadata_txnseq"],
                          {"requester_id": "node1", "partition_id": pid, "lookup_by_id": True})
    assert resp.code == "SERVE"
    assert {t.server_id for t in resp.replication_targets} == {"node2"}
    assert proxy.discover("default", "ev", tcfg["metadata_txnseq"], {
        "requester_id": "node3", "partition_id": pid, "lookup_by_id": True}).code == "UNLOAD"
    proxy.close()
    nt = pkg.native_tcp
    c = nt.NativeTCPClient("127.0.0.1", servers[0].port)
    listing = c.meta_request(nt.OP_META_LISTPARTITIONS, {"db": "default", "table": "ev"})
    found = c.meta_request(nt.OP_META_FINDPARTITION,
                           {"db": "default", "table": "ev", "key": 42})
    assert len(listing["partitions"]) == 1
    assert found["partition_id"] == listing["partitions"][0]["partition_id"] == pid
    assert found["servers"] == ["node1", "node2"]
    c.close()
    p.close()


def test_a_server_without_a_metadata_service_refuses_meta_ops(pkg, cluster3):
    cfg, cdir, servers = cluster3
    nt = pkg.native_tcp
    c = nt.NativeTCPClient("127.0.0.1", servers[0].port)
    with pytest.raises(Exception, match="no metadata service on this server"):
        c.meta_request(nt.OP_META_LISTPARTITIONS, {"db": "default", "table": "ev"})
    c.close()


def test_majority_tolerates_one_dead_metadata_server(pkg, meta_cluster):
    cfg, cdir, servers = meta_cluster
    p = provider(pkg, cfg)
    create(pkg, p)
    f = pkg.metadata_file.MetadataFile.initial("uint64", "t", "ev3", ["node1", "node2", "node3"])
    pkg.metadata_transport.make_coordinator(cdir).create_file(
        "default", "ev3", f, ["node1", "node2", "node3"])
    servers[2].stop()
    mf = pkg.metadata_file
    op = mf.MetadataOperation("default", "ev3", mf.METAOP_SPLIT_PARTITION, {
        "partition_id": f.entries[0].partition_id, "split_point": 7,
        "split_partition_id_low": "a" * 20, "split_partition_id_high": "b" * 20,
        "split_servers_low": ["node1"], "split_servers_high": ["node1"],
        "finalize_immediately": True}, input_txnid=f.txnid)
    out = pkg.metadata_transport.make_coordinator(cdir).perform_and_commit_operation(
        "default", "ev3", op)
    assert out.seq == 2
    assert cdir.get_table_config("default", "ev3")["metadata_txnid"] == op.output_txnid
    p.close()


def test_metadata_replication_catches_up_lagging_server(pkg, meta_cluster):
    cfg, cdir, servers = meta_cluster
    p = provider(pkg, cfg)
    create(pkg, p)
    tcfg = cdir.get_table_config("default", "ev")
    svc2 = servers[1].metadata_service
    svc2.drop_file("default", "ev", tcfg["metadata_txnid"])
    assert not svc2.store.has_file("default", "ev", tcfg["metadata_txnid"])
    actions = pkg.metadata_replication.MetadataReplication(svc2, cfg, "node2").replicate_once()
    assert any("fetched metadata txn" in a for a in actions), actions
    assert svc2.get_file("default", "ev", tcfg["metadata_txnid"]).seq == tcfg["metadata_txnseq"]
    assert pkg.metadata_replication.MetadataReplication(
        servers[2].metadata_service, cfg, "node3").replicate_once() == []
    p.close()


def test_autosplit_and_full_split_lifecycle(pkg, meta_cluster):
    """needsSplit -> SPLIT_PARTITION (splitting) -> the split targets LOAD
    the child keyranges -> a serving replica finalizes -> the displaced
    replica UNLOADs its rows."""
    cfg, cdir, servers = meta_cluster
    p = provider(pkg, cfg)
    create(pkg, p)
    for i in range(30):
        p.insert_json("ev", json.dumps({"t": i, "v": 1}))
    changes = pkg.autosplit.run_once(servers[0].table_service, cdir, threshold_rows=10,
                                     remote_factory=pkg.metadata_transport
                                     .remote_factory_from_cdir(cdir))
    assert changes
    tcfg = cdir.get_table_config("default", "ev")
    assert tcfg["metadata_txnseq"] == 2 and len(tcfg["metadata"]["partitions"]) == 1
    proxy = pkg.metadata_transport.MetadataServiceProxy("127.0.0.1", servers[0].port)
    head = proxy.get_file("default", "ev", tcfg["metadata_txnid"])
    assert head.entries[0].splitting
    assert "node3" in {pl.server_id for pl in head.entries[0].split_servers_low}
    workers = [pkg.replication.ReplicationWorker(s.table_service, cfg, f"node{i + 1}")
               for i, s in enumerate(servers)]
    assert any("loaded" in a for a in workers[2].lifecycle_once())
    assert servers[2].table_service.get_table_data("ev").num_rows == 30
    assert any("split finalized" in a for a in workers[0].lifecycle_once())
    tcfg2 = cdir.get_table_config("default", "ev")
    assert tcfg2["metadata_txnseq"] == 3 and len(tcfg2["metadata"]["partitions"]) == 2
    head2 = proxy.get_file("default", "ev", tcfg2["metadata_txnid"])
    assert not any(e.splitting for e in head2.entries)
    proxy.close()
    p2 = provider(pkg, cfg)
    assert sql(pkg, p2, "select count(1) from ev;").rows == [["30"]]
    p2.close()
    placed = set()
    for e in head2.entries:
        placed |= {pl.server_id for pl in e.servers}
    for i, s in enumerate(servers):
        if f"node{i + 1}" not in placed:
            assert any("unloaded" in a for a in workers[i].lifecycle_once())
            assert s.table_service.get_table_data("ev").num_rows == 0
    p.close()


def test_routed_rows_read_back_from_every_replica_alike(tmp_path):
    """Rows routed through each package's coordinator land on the same
    replicas: every node holds the same keys in both packages."""
    out = {}
    rng = np.random.default_rng(3)
    keys = rng.permutation(60).tolist()
    for pkg in (JAX, PORT):
        cfg, cdir, servers = _start_cluster(pkg, tmp_path / pkg.root, metadata=False)
        try:
            p = provider(pkg, cfg)
            create(pkg, p)
            meta = table_map(pkg, cdir)
            meta.split(meta.entries[0].partition_id, 30)
            meta.entries[1].servers = ["node2", "node3"]
            set_map(cdir, meta)
            p.close()
            p = provider(pkg, cfg)
            for k in keys:
                p.insert_json("ev", json.dumps({"t": k, "v": k * 3}))
            held = []
            for s in servers:
                rel = s.table_service.get_table_data("ev")
                t = rel.columns[rel.names.index("t")]
                held.append(sorted(t.value_at(i).payload() for i in range(rel.num_rows)))
            out[pkg.root] = held
            p.close()
        finally:
            stop_all(servers)
    assert out["eventql_tpu_torch"] == out["eventql_tpu"]
    assert out["eventql_tpu"] == [list(range(30)), list(range(60)), list(range(30, 60))]
