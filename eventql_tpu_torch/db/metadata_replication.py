"""Metadata chain replication: lagging metadata servers catch up.

A server named in a table's `metadata_servers` that does not hold the
head METADATA transaction file (it was down during the CAS, or joined
later) fetches it from a peer metadata server and stores it durably
(reference: db/metadata_replication.cc replicate() — META_GETFILE from
each live peer until one answers). The reference drives this off
table-config change callbacks; the standalone registry has no watch
mechanism, so this runs as a periodic sweep.
"""

from __future__ import annotations

import threading
from typing import List, Optional


class MetadataReplication:
    def __init__(
        self,
        metadata_service,
        config_dir_path: str,
        server_name: str,
        interval: float = 5.0,
    ):
        self.metadata_service = metadata_service
        self.config_dir_path = config_dir_path
        self.server_name = server_name
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetadataReplication":
        self._thread = threading.Thread(
            target=self._run, name="metadata-replication", daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 5)

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.replicate_once()
            except Exception:
                pass  # transient; next sweep retries

    def replicate_once(self, db: str = "default") -> List[str]:
        """Fetch every head file this server should hold but doesn't.
        Returns human-readable action lines."""
        from eventql_tpu_torch.config.config_directory import SERVER_UP, ConfigDirectory
        from eventql_tpu_torch.db.metadata_transport import MetadataServiceProxy

        cdir = ConfigDirectory(self.config_dir_path)
        addr_of = {}
        for s in cdir.list_servers():
            if s.server_status == SERVER_UP and s.server_addr:
                host, _, port = s.server_addr.rpartition(":")
                addr_of[s.server_id] = (host or "127.0.0.1", int(port))

        actions: List[str] = []
        doc = cdir._read()
        tables = doc.get("namespaces", {}).get(db, {}).get("tables", {})
        for table_name, cfg in tables.items():
            txnid = cfg.get("metadata_txnid")
            servers = cfg.get("metadata_servers", [])
            if not txnid or self.server_name not in servers:
                continue
            if self.metadata_service.store.has_file(db, table_name, txnid):
                continue
            for sid in servers:
                if sid == self.server_name or sid not in addr_of:
                    continue
                proxy = MetadataServiceProxy(*addr_of[sid])
                try:
                    f = proxy.get_file(db, table_name, txnid)
                    self.metadata_service.store.store_file(db, table_name, f)
                    actions.append(
                        f"{table_name}: fetched metadata txn {txnid[:8]}"
                        f" from {sid}"
                    )
                    break
                except Exception:
                    continue
                finally:
                    proxy.close()
        return actions
