"""Layered process configuration.

Mirrors the reference's three config layers (reference:
config/process_config.{h,cc}, defaults evqld.cc:223-260):
built-in defaults ← ini config file ← `-C name=value` CLI overrides,
with typed getters. The `--standalone` preset flips the same keys the
reference does (evqld.cc:253-259).
"""

from __future__ import annotations

import configparser
from typing import Dict, Optional

from eventql_tpu_torch.core.errors import RuntimeError_

# reference: evqld.cc:223-252
DEFAULTS = {
    "cluster.rebalance_interval": "60000000",
    "cluster.allow_anonymous": "true",
    "cluster.allow_drop_table": "true",
    "cluster.allow_create_database": "true",
    "server.listen": "localhost:9175",
    "server.indexbuild_threads": "2",
    "server.replication_threads_max": "4",
    "server.gc_mode": "MANUAL",
    "server.gc_interval": "30000000",
    "server.cachedir_maxsize": "68719476736",
    "server.noleader": "false",
    "server.noalloc": "false",
    "server.c2s_io_timeout": "60000000",
    "server.c2s_idle_timeout": "1800000000",
    "server.s2s_io_timeout": "10000000",
    "server.s2s_idle_timeout": "10000000",
    "server.s2s_pool_max_connections_per_host": "0",
    "server.s2s_pool_max_connections": "0",
    "server.s2s_pool_linger_timeout": "1000000",
    "server.http_io_timeout": "1000000",
    "server.heartbeat_interval": "1000000",
    "server.query_progress_rate_limit": "250000",
    "server.query_max_concurrent_shards": "256",
    "server.query_max_concurrent_shards_per_host": "6",
    "server.query_failed_shard_policy": "tolerate",
    "server.loadinfo_publish_interval": "900000000",
    "server.load_limit_hard": "0.98",
    "server.load_limit_soft": "0.95",
    "server.partitions_loading_limit_soft": "4",
    "server.partitions_loading_limit_hard": "64",
}

# reference: evqld.cc:253-259
STANDALONE_PRESET = {
    "cluster.coordinator": "standalone",
    "cluster.allowed_hosts": "0.0.0.0/0",
    "server.name": "localhost",
    "server.client_auth_backend": "trust",
    "server.noleader": "true",
}


class ProcessConfig:
    def __init__(self, values: Optional[Dict[str, str]] = None):
        self._values = dict(DEFAULTS)
        if values:
            self._values.update(values)

    @staticmethod
    def load(
        config_file: Optional[str] = None,
        overrides: Optional[Dict[str, str]] = None,
        standalone: bool = False,
    ) -> "ProcessConfig":
        cfg = ProcessConfig()
        if config_file:
            cfg.load_file(config_file)
        if standalone:
            cfg._values.update(STANDALONE_PRESET)
        if overrides:
            cfg._values.update(overrides)
        return cfg

    def load_file(self, path: str):
        # ini sections become key prefixes: [server] listen=... →
        # server.listen (reference uses inih the same way)
        parser = configparser.ConfigParser()
        read = parser.read(path)
        if not read:
            raise RuntimeError_(f"can't read config file: {path}")
        for section in parser.sections():
            for key, value in parser.items(section):
                self._values[f"{section}.{key}"] = value

    def set(self, key: str, value: str):
        self._values[key] = value

    def has(self, key: str) -> bool:
        return key in self._values

    def get_string(self, key: str) -> str:
        if key not in self._values:
            raise RuntimeError_(f"missing config option: {key}")
        return self._values[key]

    def get_int(self, key: str) -> int:
        v = self.get_string(key)
        try:
            return int(v)
        except ValueError:
            raise RuntimeError_(f"invalid integer config option: {key}={v}")

    def get_float(self, key: str) -> float:
        v = self.get_string(key)
        try:
            return float(v)
        except ValueError:
            raise RuntimeError_(f"invalid float config option: {key}={v}")

    def get_bool(self, key: str) -> bool:
        return self.get_string(key).lower() == "true"

    def items(self):
        return sorted(self._values.items())
