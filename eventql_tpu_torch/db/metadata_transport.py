"""Remote METADATA-service access over the native protocol.

`MetadataServiceProxy` presents the MetadataService surface
(create_file / get_file / drop_file / perform_operation / discover)
backed by META_* RPCs, so the MetadataCoordinator can fan CAS
transactions across metadata servers exactly like the reference's
MetadataClient does over its TCPClient (reference:
db/metadata_client.cc, db/metadata_coordinator.cc:43-140,
transport/native/ops/meta_*.cc).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

from eventql_tpu_torch.core.errors import RuntimeError_
from eventql_tpu_torch.db.metadata_file import (
    DiscoveryResponse,
    MetadataFile,
    MetadataOperation,
)


class MetadataServiceProxy:
    """The MetadataService surface over one native-protocol connection.

    Connections are opened lazily and re-opened after an IO error so a
    long-lived coordinator survives server restarts."""

    def __init__(self, host: str, port: int, auth_token: str = ""):
        self.host = host
        self.port = port
        self.auth_token = auth_token
        self._client = None
        self._lock = threading.Lock()

    def _conn(self):
        from eventql_tpu_torch.server.native_tcp import NativeTCPClient

        if self._client is None:
            self._client = NativeTCPClient(
                self.host, self.port, auth_token=self.auth_token
            )
        return self._client

    def _request(self, opcode: int, req: dict):
        with self._lock:
            try:
                return self._conn().meta_request(opcode, req)
            except (OSError, ConnectionError):
                # one reconnect attempt, then propagate
                self.close()
                return self._conn().meta_request(opcode, req)

    def close(self):
        if self._client is not None:
            try:
                self._client.close()
            except Exception:
                pass
            self._client = None

    # -- MetadataService surface -----------------------------------------
    def create_file(self, db: str, table: str, f: MetadataFile):
        from eventql_tpu_torch.server import native_tcp as nt

        self._request(
            nt.OP_META_CREATEFILE,
            {"db": db, "table": table, "file": f.to_json()},
        )

    def get_file(self, db: str, table: str, txnid: str) -> MetadataFile:
        from eventql_tpu_torch.server import native_tcp as nt

        resp = self._request(
            nt.OP_META_GETFILE, {"db": db, "table": table, "txnid": txnid}
        )
        return MetadataFile.from_json(resp["file"])

    def drop_file(self, db: str, table: str, txnid: str):
        from eventql_tpu_torch.server import native_tcp as nt

        self._request(
            nt.OP_META_DROPFILE, {"db": db, "table": table, "txnid": txnid}
        )

    def perform_operation(self, op: MetadataOperation) -> Tuple[str, dict]:
        from eventql_tpu_torch.server import native_tcp as nt

        resp = self._request(nt.OP_META_PERFORMOP, {"op": op.to_json()})
        return resp["checksum"], resp["file"]

    def discover(
        self, db: str, table: str, min_txnseq: int, request: dict
    ) -> DiscoveryResponse:
        from eventql_tpu_torch.server import native_tcp as nt

        resp = self._request(
            nt.OP_META_DISCOVER,
            {
                "db": db,
                "table": table,
                "min_txnseq": min_txnseq,
                "request": request,
            },
        )
        return DiscoveryResponse.from_json(resp)


def remote_factory_from_cdir(
    cdir, auth_token: str = ""
) -> Callable[[str], MetadataServiceProxy]:
    """server_id → MetadataServiceProxy, resolving addresses through the
    cluster registry (reference: config_directory.h getServerConfig) and
    caching one connection per server."""
    cache: Dict[str, MetadataServiceProxy] = {}
    lock = threading.Lock()

    def factory(server_id: str) -> MetadataServiceProxy:
        with lock:
            proxy = cache.get(server_id)
            if proxy is not None:
                return proxy
            cfg = cdir.get_server_config(server_id)
            if cfg is None or not cfg.server_addr:
                raise RuntimeError_(f"unknown metadata server: {server_id}")
            host, _, port = cfg.server_addr.rpartition(":")
            proxy = MetadataServiceProxy(
                host or "127.0.0.1", int(port), auth_token=auth_token
            )
            cache[server_id] = proxy
            return proxy

    return factory


def make_coordinator(
    cdir,
    local_server_id: Optional[str] = None,
    local_service=None,
    auth_token: str = "",
):
    """The fully wired MetadataCoordinator for a cluster node: local
    store served in-process, remote stores over META_* RPCs."""
    from eventql_tpu_torch.db.metadata_service import MetadataCoordinator

    return MetadataCoordinator(
        cdir,
        local_server_id=local_server_id,
        local_service=local_service,
        remote_service_factory=remote_factory_from_cdir(
            cdir, auth_token=auth_token
        ),
    )
