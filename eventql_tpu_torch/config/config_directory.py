"""Standalone config directory — the cluster coordination registry.

The reference coordinates clusters through a ConfigDirectory interface
(reference: config/config_directory.h — cluster config, ServerConfig
entries, namespaces, table configs) with a ZooKeeper backend
(config_directory_zookeeper.cc) or an in-process standalone backend
(config_directory_standalone.cc). This is the standalone analog: a
JSON file shared by all local processes, updated under an fcntl lock
so concurrent evqld/evqlctl invocations serialize their edits.
"""

from __future__ import annotations

import fcntl
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from eventql_tpu_torch.core.errors import RuntimeError_

SERVER_UP = "SERVER_UP"
SERVER_DOWN = "SERVER_DOWN"


@dataclass
class ServerConfig:
    """One cluster member (reference: ServerConfig proto fields used by
    cluster-add-server / cluster-status)."""

    server_id: str
    server_addr: str = ""
    server_status: str = SERVER_DOWN
    buildinfo: str = "eventql_tpu_torch v0.1"
    load_partitions: int = 0
    load_disk_used: int = 0


class ConfigDirectory:
    """File-backed cluster registry.

    Layout of the JSON document::

        {"cluster": {"name": ..., "created": ...},
         "servers": {server_id: {...ServerConfig...}},
         "namespaces": {db_name: {"tables": {table: {...props...}}}}}

    Constructing with a ``zk://host:port/cluster`` path returns the
    ZooKeeper backend instead (reference:
    config/config_directory.cc:34-68 picks the backend from
    cluster.coordinator; zookeeper vs standalone).
    """

    def __new__(cls, path: str):
        if cls is ConfigDirectory and isinstance(path, str) \
                and path.startswith("zk://"):
            from eventql_tpu_torch.config.config_directory_zookeeper import (
                ZookeeperConfigDirectory,
            )

            return ZookeeperConfigDirectory(path)
        return super().__new__(cls)

    def __init__(self, path: str):
        self.path = path

    # -- locked read-modify-write ---------------------------------------
    def _mutate(self, fn):
        lock_path = self.path + ".lock"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(lock_path, "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            doc = self._read()
            result = fn(doc)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2, sort_keys=True)
            os.replace(tmp, self.path)
            return result

    def _read(self) -> dict:
        if not os.path.exists(self.path):
            return {"cluster": None, "servers": {}, "namespaces": {}}
        with open(self.path) as f:
            return json.load(f)

    # -- cluster ---------------------------------------------------------
    def cluster_create(self, name: str = "default", replication_factor: int = 1):
        def fn(doc):
            if doc["cluster"] is not None:
                raise RuntimeError_("cluster already exists")
            doc["cluster"] = {
                "name": name,
                "created": int(time.time()),
                "replication_factor": int(replication_factor),
            }

        self._mutate(fn)

    def get_cluster_config(self) -> Optional[dict]:
        return self._read()["cluster"]

    # -- servers ---------------------------------------------------------
    def update_server_config(self, cfg: ServerConfig):
        def fn(doc):
            doc["servers"][cfg.server_id] = {
                "server_addr": cfg.server_addr,
                "server_status": cfg.server_status,
                "buildinfo": cfg.buildinfo,
                "load_partitions": cfg.load_partitions,
                "load_disk_used": cfg.load_disk_used,
            }

        self._mutate(fn)

    def remove_server(self, server_id: str):
        def fn(doc):
            if server_id not in doc["servers"]:
                raise RuntimeError_(f"server not found: {server_id}")
            del doc["servers"][server_id]

        self._mutate(fn)

    def list_servers(self) -> List[ServerConfig]:
        doc = self._read()
        out = []
        for sid in sorted(doc["servers"]):
            s = doc["servers"][sid]
            out.append(
                ServerConfig(
                    server_id=sid,
                    server_addr=s.get("server_addr", ""),
                    server_status=s.get("server_status", SERVER_DOWN),
                    buildinfo=s.get("buildinfo", ""),
                    load_partitions=s.get("load_partitions", 0),
                    load_disk_used=s.get("load_disk_used", 0),
                )
            )
        return out

    def get_server_config(self, server_id: str) -> Optional[ServerConfig]:
        for s in self.list_servers():
            if s.server_id == server_id:
                return s
        return None

    # -- namespaces / tables ---------------------------------------------
    def create_namespace(self, name: str):
        def fn(doc):
            if name in doc["namespaces"]:
                raise RuntimeError_(f"database already exists: {name}")
            doc["namespaces"][name] = {"tables": {}}

        self._mutate(fn)

    def list_namespaces(self) -> List[str]:
        return sorted(self._read()["namespaces"])

    def update_table_config(self, db: str, table: str, props: Dict):
        def fn(doc):
            ns = doc["namespaces"].setdefault(db, {"tables": {}})
            ns["tables"].setdefault(table, {}).update(props)

        self._mutate(fn)

    def get_table_config(self, db: str, table: str) -> Optional[Dict]:
        ns = self._read()["namespaces"].get(db)
        if ns is None:
            return None
        return ns["tables"].get(table)

    def commit_metadata_txn(
        self,
        db: str,
        table: str,
        input_txnid: str,
        output_txnid: str,
        seq: int,
        derived_view: Optional[Dict] = None,
    ) -> bool:
        """Compare-and-swap the table's metadata head pointer: advance
        to output_txnid iff the stored head still equals input_txnid
        (reference: metadata_coordinator.cc:84-89 commits through the
        coordination service's atomic table-config update; doc
        partitioning.txt §5.1). Returns False when the CAS loses."""

        def fn(doc):
            ns = doc["namespaces"].setdefault(db, {"tables": {}})
            cfg = ns["tables"].setdefault(table, {})
            if cfg.get("metadata_txnid") != input_txnid:
                return False
            cfg["metadata_txnid"] = output_txnid
            cfg["metadata_txnseq"] = int(seq)
            if derived_view is not None:
                cfg["metadata"] = derived_view
            return True

        return self._mutate(fn)

    # -- worker address book ---------------------------------------------
    def worker_addrs(self) -> List[tuple]:
        """(host, port) of all live servers — the coordinator's fan-out
        list for ClusterTableProvider."""
        out = []
        for s in self.list_servers():
            if s.server_status != SERVER_UP or not s.server_addr:
                continue
            host, _, port = s.server_addr.rpartition(":")
            out.append((host or "127.0.0.1", int(port)))
        return out
