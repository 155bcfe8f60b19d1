"""Server load monitor.

The reference's Monitor publishes per-server load info (partitions
hosted, disk used) into the coordination service on an interval so the
leader/allocator can make placement decisions
(reference: db/monitor.cc:38-110, published via
config_directory.h:72). Here the load lands on the server's registry
entry; `evqlctl cluster-list` displays it and the rebalance pass
prefers the least-loaded servers.
"""

from __future__ import annotations

import os
import threading
from typing import Optional


class Monitor:
    def __init__(
        self,
        table_service,
        config_dir_path: str,
        server_name: str,
        server_addr: str,
        datadir: Optional[str] = None,
        interval: float = 10.0,
    ):
        self.table_service = table_service
        self.config_dir_path = config_dir_path
        self.server_name = server_name
        self.server_addr = server_addr
        self.datadir = datadir
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self.publish_once()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=self.interval + 5)

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.publish_once()
            except Exception:
                pass  # registry contention; retry next tick

    def publish_once(self):
        from eventql_tpu_torch.config.config_directory import (
            SERVER_UP,
            ConfigDirectory,
            ServerConfig,
        )
        from eventql_tpu_torch.utils.stats import evqld_stats

        n_partitions = 0
        for t in getattr(self.table_service, "tables", {}).values():
            n_partitions += max(1, len(getattr(t, "_segments", [])))

        disk_used = 0
        if self.datadir and os.path.isdir(self.datadir):
            for root, _dirs, files in os.walk(self.datadir):
                for f in files:
                    try:
                        disk_used += os.path.getsize(os.path.join(root, f))
                    except OSError:
                        pass

        evqld_stats().num_partitions.set(n_partitions)
        ConfigDirectory(self.config_dir_path).update_server_config(
            ServerConfig(
                server_id=self.server_name,
                server_addr=self.server_addr,
                server_status=SERVER_UP,
                load_partitions=n_partitions,
                load_disk_used=disk_used,
            )
        )
