"""Embedded-server bridge for the C API (native/evql_server.c).

The reference exposes EventQL as an embeddable C library
(reference: src/eventql/eventql.h:340-408 — evql_server_init/start/
listen/handle/shutdown; evqld.cc itself is a thin wrapper over it).
This module is the Python side of our equivalent: a C host links
libevql_server.so, which drives these functions through the CPython
API. The server wiring matches cli/evqld.py (HTTP + native on one
sniffed port, durable datadir, cluster registration).
"""

from __future__ import annotations

import select
import socket
import time


class EmbeddedServer:
    def __init__(self, conf: dict):
        self.conf = dict(conf)
        self.table_service = None
        self.http = None
        self.native = None
        self.listener = None
        self._started = False

    # -- lifecycle (evql_server_start) -----------------------------------
    def start(self):
        from eventql_tpu_torch.db.table_service import TableService
        from eventql_tpu_torch.server.http_api import EventQLServer
        from eventql_tpu_torch.server.native_tcp import NativeTCPServer

        datadir = self.conf.get("server.datadir")
        table_service = None
        mr_cachedir = None
        query_cache = None
        if datadir:
            import os

            from eventql_tpu_torch.db.lsm import DurableTableService
            from eventql_tpu_torch.exec.query_cache import QueryCache

            table_service = DurableTableService(datadir)
            mr_cachedir = os.path.join(datadir, "cache")
            query_cache = QueryCache(mr_cachedir)
        else:
            table_service = TableService()

        self.table_service = table_service
        # where the queries' routes run: server.device = cuda (raises
        # without a card) or cpu (the kernels' plain versions)
        device = self.conf.get("server.device", "cuda")
        self.http = EventQLServer(
            table_service=table_service, mr_cachedir=mr_cachedir,
            device=device,
        )
        self.http.start(bind=False)
        self.native = NativeTCPServer(
            table_service, port=0, query_cache=query_cache, device=device
        ).start()
        self._started = True
        return 0

    # -- evql_server_listen ----------------------------------------------
    def listen(self, kill_fd: int) -> int:
        """Bind the sniffed listener per server.listen and block until
        kill_fd becomes readable (kill_fd == -1: block forever —
        the reference contract, eventql.h:358-364)."""
        from eventql_tpu_torch.server.listener import Listener

        addr = self.conf.get("server.listen", "127.0.0.1:0")
        host, _, port = addr.partition(":")
        self.listener = Listener(
            self.http, self.native, host=host or "127.0.0.1",
            port=int(port or 0),
        ).start()
        while True:
            if kill_fd < 0:
                time.sleep(3600)
                continue
            r, _w, _x = select.select([kill_fd], [], [], None)
            if r:
                return 0

    @property
    def port(self) -> int:
        if self.listener is not None:
            return self.listener.port
        return self.native.port if self.native else 0

    # -- evql_server_handle ------------------------------------------------
    def handle_fd(self, fd: int) -> int:
        """Serve one accepted connection on fd in a new thread (the
        protocol is sniffed like the listener's accept path)."""
        import threading

        conn = socket.socket(fileno=fd)

        def run():
            try:
                first = conn.recv(1, socket.MSG_PEEK)
                if first == b"\x5e":
                    self.native._handle_connection(conn)
                    conn.close()
                else:
                    self.http.handle_socket(conn, conn.getpeername())
            except (OSError, ConnectionError):
                try:
                    conn.close()
                except OSError:
                    pass

        threading.Thread(target=run, daemon=True).start()
        return 0

    # -- evql_server_shutdown ----------------------------------------------
    def shutdown(self):
        if self.listener is not None:
            self.listener.stop()
            self.listener = None
        if self.native is not None:
            self.native.stop()
        if self.http is not None:
            self.http.stop()
        commit = getattr(self.table_service, "commit_all", None)
        if commit is not None:
            commit()
        self._started = False


# reference built-in defaults (evqld.cc:223-252) surfaced through
# evql_server_getconf when the conf didn't set a key
_DEFAULTS = {
    "server.listen": "localhost:9175",
    "server.indexbuild_threads": "2",
    "server.gc_mode": "AUTOMATIC",
    "server.gc_interval": "30000000",
    "server.cachedir_maxsize": "68719476736",
    "server.noleader": "false",
    "cluster.rebalance_interval": "60000000",
    "server.query_max_concurrent_shards": "256",
    "server.query_max_concurrent_shards_per_host": "6",
    "server.query_failed_shard_policy": "tolerate",
}


def create(conf: dict) -> EmbeddedServer:
    return EmbeddedServer(conf)


def getconf(server: EmbeddedServer, key: str):
    v = server.conf.get(key)
    if v is None:
        v = _DEFAULTS.get(key)
    return v
