"""ZooKeeper-backed cluster config directory.

Mirrors the reference's ZooKeeper backend
(reference: config/config_directory_zookeeper.cc): cluster state lives
under ``/eventql/<cluster>`` with the same znode layout —

    /eventql/<cluster>/config                     cluster config
    /eventql/<cluster>/servers/<id>               server config
    /eventql/<cluster>/servers-online/<id>        ephemeral liveness
    /eventql/<cluster>/namespaces/<ns>/config     namespace marker
    /eventql/<cluster>/namespaces/<ns>/tables/<t> table config
    /eventql/<cluster>/leader                     ephemeral leader lock

(path layout: config_directory_zookeeper.cc:121-331,555-622,1000-1012).
Liveness is an ephemeral node tied to the process's session; leader
election is a create-race on the ephemeral ``/leader`` node; table
config CAS uses setData's version check.

Construct via ``ConfigDirectory("zk://host:port/cluster")``. One
ZooKeeper session is pooled per (process, address) so ephemeral nodes
live exactly as long as the process.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.config.config_directory import (
    SERVER_DOWN,
    SERVER_UP,
    ConfigDirectory,
    ServerConfig,
)
from eventql_tpu_torch.config.zookeeper import (
    EPHEMERAL,
    ZBADVERSION,
    ZNODEEXISTS,
    ZNONODE,
    ZKError,
    ZooKeeperClient,
)

# process-wide session pool: ephemerals must outlive the (per-operation)
# ConfigDirectory instances, so sessions are shared per address
_sessions: Dict[str, ZooKeeperClient] = {}
_sessions_lock = threading.Lock()


def _session(addr: str) -> ZooKeeperClient:
    with _sessions_lock:
        zk = _sessions.get(addr)
        if zk is not None and not zk._closed:
            return zk
        zk = ZooKeeperClient(addr)
        _sessions[addr] = zk
        return zk


def reset_sessions():
    """Close all pooled sessions (drops this process's ephemerals)."""
    with _sessions_lock:
        for zk in _sessions.values():
            zk.close()
        _sessions.clear()


class ZookeeperConfigDirectory(ConfigDirectory):
    def __init__(self, path: str):
        if getattr(self, "_initialized", False):
            return  # ConfigDirectory.__new__ dispatch re-invokes __init__
        self._initialized = True
        self.path = path
        rest = path[len("zk://"):]
        addr, _, cluster = rest.partition("/")
        self.addr = addr
        self.cluster = cluster or "default"
        self.prefix = f"/eventql/{self.cluster}"

    # -- plumbing ---------------------------------------------------------
    @property
    def _zk(self) -> ZooKeeperClient:
        return _session(self.addr)

    def _get_json(self, path: str) -> Optional[dict]:
        try:
            data, _ = self._zk.get(path)
        except ZKError as e:
            if e.code == ZNONODE:
                return None
            raise
        if not data:
            return None
        return json.loads(data.decode())

    def _children(self, path: str) -> List[str]:
        try:
            return self._zk.get_children(path)
        except ZKError as e:
            if e.code == ZNONODE:
                return []
            raise

    def _set_json(self, path: str, doc: dict, version: int = -1):
        self._zk.ensure_path(path.rsplit("/", 1)[0])
        payload = json.dumps(doc, sort_keys=True).encode()
        try:
            self._zk.set(path, payload, version)
        except ZKError as e:
            if e.code != ZNONODE:
                raise
            try:
                self._zk.create(path, payload)
            except ZKError as e2:
                if e2.code != ZNODEEXISTS:
                    raise
                self._zk.set(path, payload, -1)

    # -- cluster ---------------------------------------------------------
    def cluster_create(self, name: str = "default",
                       replication_factor: int = 1):
        zk = self._zk
        zk.ensure_path(self.prefix)
        doc = {
            "name": name,
            "created": int(time.time()),
            "replication_factor": int(replication_factor),
        }
        try:
            zk.create(self.prefix + "/config",
                      json.dumps(doc, sort_keys=True).encode())
        except ZKError as e:
            if e.code == ZNODEEXISTS:
                raise RuntimeError_("cluster already exists")
            raise
        for sub in ("/servers", "/servers-online", "/namespaces"):
            zk.ensure_path(self.prefix + sub)

    def get_cluster_config(self) -> Optional[dict]:
        return self._get_json(self.prefix + "/config")

    # -- servers ---------------------------------------------------------
    def update_server_config(self, cfg: ServerConfig):
        zk = self._zk
        doc = {
            "server_addr": cfg.server_addr,
            "buildinfo": cfg.buildinfo,
            "load_partitions": cfg.load_partitions,
            "load_disk_used": cfg.load_disk_used,
        }
        self._set_json(f"{self.prefix}/servers/{cfg.server_id}", doc)
        live = f"{self.prefix}/servers-online/{cfg.server_id}"
        if cfg.server_status == SERVER_UP:
            zk.ensure_path(self.prefix + "/servers-online")
            try:
                zk.create(live, cfg.server_addr.encode(), flags=EPHEMERAL)
            except ZKError as e:
                if e.code != ZNODEEXISTS:
                    raise
        else:
            try:
                zk.delete(live)
            except ZKError as e:
                if e.code != ZNONODE:
                    raise

    def remove_server(self, server_id: str):
        zk = self._zk
        try:
            zk.delete(f"{self.prefix}/servers/{server_id}")
        except ZKError as e:
            if e.code == ZNONODE:
                raise RuntimeError_(f"server not found: {server_id}")
            raise
        try:
            zk.delete(f"{self.prefix}/servers-online/{server_id}")
        except ZKError as e:
            if e.code != ZNONODE:
                raise

    def list_servers(self) -> List[ServerConfig]:
        live = set(self._children(self.prefix + "/servers-online"))
        out = []
        for sid in sorted(self._children(self.prefix + "/servers")):
            s = self._get_json(f"{self.prefix}/servers/{sid}") or {}
            out.append(ServerConfig(
                server_id=sid,
                server_addr=s.get("server_addr", ""),
                server_status=SERVER_UP if sid in live else SERVER_DOWN,
                buildinfo=s.get("buildinfo", ""),
                load_partitions=s.get("load_partitions", 0),
                load_disk_used=s.get("load_disk_used", 0),
            ))
        return out

    # -- namespaces / tables ---------------------------------------------
    def create_namespace(self, name: str):
        zk = self._zk
        zk.ensure_path(f"{self.prefix}/namespaces")
        try:
            zk.create(f"{self.prefix}/namespaces/{name}")
        except ZKError as e:
            if e.code == ZNODEEXISTS:
                raise RuntimeError_(f"database already exists: {name}")
            raise
        for sub in ("config", "tables"):
            try:
                zk.create(f"{self.prefix}/namespaces/{name}/{sub}")
            except ZKError as e:
                if e.code != ZNODEEXISTS:
                    raise

    def list_namespaces(self) -> List[str]:
        return sorted(self._children(self.prefix + "/namespaces"))

    def _table_path(self, db: str, table: str) -> str:
        return f"{self.prefix}/namespaces/{db}/tables/{table}"

    def update_table_config(self, db: str, table: str, props: Dict):
        # read-modify-write under setData's version CAS
        path = self._table_path(db, table)
        for _ in range(16):
            try:
                data, stat = self._zk.get(path)
            except ZKError as e:
                if e.code != ZNONODE:
                    raise
                self._zk.ensure_path(path.rsplit("/", 1)[0])
                doc = dict(props)
                try:
                    self._zk.create(
                        path, json.dumps(doc, sort_keys=True).encode())
                    return
                except ZKError as e2:
                    if e2.code != ZNODEEXISTS:
                        raise
                    continue
            doc = json.loads(data.decode()) if data else {}
            doc.update(props)
            try:
                self._zk.set(path, json.dumps(doc, sort_keys=True).encode(),
                             stat.version)
                return
            except ZKError as e:
                if e.code != ZBADVERSION:
                    raise
        raise RuntimeError_("table config update contention")

    def get_table_config(self, db: str, table: str) -> Optional[Dict]:
        return self._get_json(self._table_path(db, table))

    def commit_metadata_txn(
        self,
        db: str,
        table: str,
        input_txnid: str,
        output_txnid: str,
        seq: int,
        derived_view: Optional[Dict] = None,
    ) -> bool:
        """CAS the metadata head via znode-version-checked setData
        (the reference commits through the coordination service's
        atomic config update, metadata_coordinator.cc:84-89)."""
        path = self._table_path(db, table)
        for _ in range(16):
            try:
                data, stat = self._zk.get(path)
            except ZKError as e:
                if e.code != ZNONODE:
                    raise
                if input_txnid is not None:
                    return False
                data, stat = b"", None
            doc = json.loads(data.decode()) if data else {}
            if doc.get("metadata_txnid") != input_txnid:
                return False
            doc["metadata_txnid"] = output_txnid
            doc["metadata_txnseq"] = int(seq)
            if derived_view is not None:
                doc["metadata"] = derived_view
            payload = json.dumps(doc, sort_keys=True).encode()
            try:
                if stat is None:
                    self._zk.ensure_path(path.rsplit("/", 1)[0])
                    self._zk.create(path, payload)
                else:
                    self._zk.set(path, payload, stat.version)
                return True
            except ZKError as e:
                if e.code not in (ZBADVERSION, ZNODEEXISTS):
                    raise
                # concurrent writer — re-read and re-check the txn id
        return False

    # -- leader election ---------------------------------------------------
    def try_acquire_leader(self, server_name: str) -> bool:
        """Create-race on the ephemeral /leader node
        (config_directory_zookeeper.cc:991-1012)."""
        zk = self._zk
        zk.ensure_path(self.prefix)
        try:
            zk.create(self.prefix + "/leader", server_name.encode(),
                      flags=EPHEMERAL)
            return True
        except ZKError as e:
            if e.code != ZNODEEXISTS:
                raise
        # already leader from this session?
        try:
            data, _ = zk.get(self.prefix + "/leader")
            return data.decode() == server_name
        except ZKError:
            return False

    def release_leader(self):
        try:
            self._zk.delete(self.prefix + "/leader")
        except ZKError as e:
            if e.code != ZNONODE:
                raise

    def current_leader(self) -> Optional[str]:
        try:
            data, _ = self._zk.get(self.prefix + "/leader")
            return data.decode()
        except ZKError as e:
            if e.code == ZNONODE:
                return None
            raise

    # -- whole-registry view (read-only callers: rebalance, allocator,
    # autosplit, replication use cdir._read()) -----------------------------
    def _read(self) -> dict:
        doc = {
            "cluster": self.get_cluster_config(),
            "servers": {},
            "namespaces": {},
        }
        for s in self.list_servers():
            doc["servers"][s.server_id] = {
                "server_addr": s.server_addr,
                "server_status": s.server_status,
                "buildinfo": s.buildinfo,
                "load_partitions": s.load_partitions,
                "load_disk_used": s.load_disk_used,
            }
        for ns in self.list_namespaces():
            tables = {}
            for t in self._children(
                    f"{self.prefix}/namespaces/{ns}/tables"):
                tables[t] = self._get_json(self._table_path(ns, t)) or {}
            doc["namespaces"][ns] = {"tables": tables}
        return doc

    def _mutate(self, fn):
        raise RuntimeError_(
            "zookeeper config directory has no whole-document mutate; "
            "use the typed update methods")
